"""Dispersion relation, group velocities and wavenumber (refraction)
tendencies: the counterpart of :mod:`msgwam_tpu.ops.dispersion`.

Everything is elementwise over the ray batch.  ``phi`` may be a tensor of
per-ray latitudes or a Python float (the saturation cap evaluates ω̂ at the
configured ``phi0``).
"""

from __future__ import annotations

import math

import torch

from ..constants import RAD_EARTH, ROT_EARTH


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else math.sin(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def omega(k, l, m, phi, bvf):
    """Intrinsic frequency ω̂ = sqrt((N²k_h² + f²m²)/|k|²)."""
    ff = 2.0 * ROT_EARTH * _sin(phi)
    kh2 = k * k + l * l
    k2 = kh2 + m * m
    return torch.sqrt((bvf * bvf * kh2 + ff * ff * m * m) / k2)


def cg_r(k, l, m, phi, bvf):
    """Vertical group velocity cg_r = −m(ω̂²−f²)/(ω̂|k|²); it has no height
    dependence in this model."""
    ff = 2.0 * ROT_EARTH * _sin(phi)
    k2 = k * k + l * l + m * m
    om = omega(k, l, m, phi, bvf)
    return -m * (om * om - ff * ff) / om / k2


def group_velocities(k, l, m, phi, u_ray, v_ray, bvf, hprop: bool):
    """``(cg_lam, cg_phi, cg_rr)``; with ``hprop=False`` the horizontal
    components are exactly zero."""
    ff = 2.0 * ROT_EARTH * _sin(phi)
    k2 = k * k + l * l + m * m
    om = omega(k, l, m, phi, bvf)
    cgr = -m * (om * om - ff * ff) / om / k2
    if hprop:
        horiz = (bvf * bvf - om * om) / (om * k2)
        cglam = k * horiz + u_ray
        cgphi = l * horiz + v_ray
    else:
        cglam = torch.zeros_like(k)
        cgphi = torch.zeros_like(k)
    return cglam, cgphi, cgr


def wavenumber_tendencies(
    k, l, m, phi, r,
    u_ray, v_ray, du_dr, dv_dr,
    bvf,
    hprop: bool,
    du_dlam=None, dv_dlam=None, du_dphi=None, dv_dphi=None,
):
    """Refraction tendencies ``(dk/dt, dl/dt, dm/dt)``, fused with the
    group velocities."""
    cglam, cgphi, cgr = group_velocities(k, l, m, phi, u_ray, v_ray, bvf, hprop)
    radius = RAD_EARTH + r

    # dm/dt is active regardless of hprop
    dm = (k * cglam + l * cgphi) / radius - (k * du_dr + l * dv_dr)

    if not hprop:
        zero = torch.zeros_like(k)
        return zero, zero, dm

    om = omega(k, l, m, phi, bvf)
    k2 = k * k + l * l + m * m
    tanphi = torch.tan(phi)

    if du_dlam is None:
        grad_lam = torch.zeros_like(k)
    else:
        grad_lam = (k * du_dlam + l * dv_dlam) / radius / _cos(phi)
    if du_dphi is None:
        grad_phi = torch.zeros_like(k)
    else:
        grad_phi = (k * du_dphi + l * dv_dphi) / radius

    dk = k / radius * (tanphi * cgphi - cgr) - grad_lam

    # df²/dφ = 8 Ω² sin φ cos φ
    df2_dphi = 8.0 * ROT_EARTH * ROT_EARTH * _sin(phi) * _cos(phi)
    dl = (
        -(l * cgr + k * tanphi * cglam + m * m / (2.0 * om * k2) * df2_dphi)
        / radius
        - grad_phi
    )
    return dk, dl, dm
