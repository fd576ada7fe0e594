"""Wave-breaking saturation: the counterpart of
:mod:`msgwam_tpu.ops.saturation`.

The ray state is extrapolated one step forward with the supplied rates,
the static-instability threshold

    A_max = κ² · ½ ρ̄(r_f) · ω̂ · N² / (m_f² (ω̂² − f²))

is compared with the *integrated* action ``dens · (dkk dll dmm_f)``, and
exceeding rays are clamped (:func:`saturate_direct`) or relaxed
(:func:`saturation_tendency`).  ``faithful=True`` applies the cap to the
density as the reference does (quirk 1); ``faithful=False`` applies
``A_max / phase_volume``.
"""

from __future__ import annotations

import math

import torch

from ..constants import ROT_EARTH
from .dispersion import omega
from .interp import basis_interp, grid_interp


def saturation_cap(
    dt, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area,
    centers, rhobar,
    bvf, kappa, phi0,
    interp_backend: str = "gather",
):
    """End-of-step extrapolation + threshold: ``(max_dens_final,
    phase_volume)``."""
    r_final = r + r_rate * dt
    dr_final = dr + dr_rate * dt
    m_final = m + m_rate * dt
    dmm_final = rr_mm_area / dr_final
    if interp_backend == "mxu":
        rhobar_final = basis_interp(
            r_final, centers[0], centers[1] - centers[0], rhobar
        )
    else:
        rhobar_final = grid_interp(r_final, centers, rhobar)

    ff = 2.0 * ROT_EARTH * math.sin(phi0)
    omh = omega(k, l, m, phi0, bvf)  # pre-step m and phi0, as the reference
    phase_volume = dkk * dll * dmm_final

    # the same guarded divisions as the JAX package: a ray whose m_final²
    # or ω̂²−f² underflows gets an infinite ("unsaturable") cap
    m2 = m_final * m_final
    d2 = omh * omh - ff * ff
    eps = 1e-14
    bad = (m2 <= eps) | (d2 <= eps)
    m2s = torch.where(m2 <= eps, torch.ones_like(m2), m2)
    d2s = torch.where(d2 <= eps, torch.ones_like(d2), d2)
    max_dens_final = torch.where(
        bad, torch.full_like(m2, math.inf),
        kappa * kappa * 0.5 * rhobar_final * omh * bvf * bvf / m2s / d2s,
    )
    return max_dens_final, phase_volume


def _capped(dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate, dkk, dll,
            rr_mm_area, centers, rhobar, bvf, kappa, phi0, faithful, active,
            interp_backend):
    max_dens, phase_vol = saturation_cap(
        dt, r, r_rate, dr, dr_rate, k, l, m, m_rate,
        dkk, dll, rr_mm_area, centers, rhobar, bvf, kappa, phi0,
        interp_backend=interp_backend,
    )
    cap = max_dens if faithful else max_dens / phase_vol
    exceed = max_dens < dens * phase_vol
    if active is not None:
        exceed = exceed & active
    return cap, exceed


def saturate_direct(
    dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area, centers, rhobar,
    bvf, kappa, phi0,
    faithful: bool = True,
    active=None,
    interp_backend: str = "gather",
):
    """Clamp densities that exceed the cap; returns the new density."""
    cap, exceed = _capped(dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
                          dkk, dll, rr_mm_area, centers, rhobar, bvf, kappa,
                          phi0, faithful, active, interp_backend)
    return torch.where(exceed, cap, dens)


def saturation_tendency(
    dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area, centers, rhobar,
    bvf, kappa, phi0,
    faithful: bool = True,
    active=None,
    interp_backend: str = "gather",
):
    """Relaxation tendency ``(cap − dens)/dt`` on exceeding rays, zero
    elsewhere."""
    cap, exceed = _capped(dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
                          dkk, dll, rr_mm_area, centers, rhobar, bvf, kappa,
                          phi0, faithful, active, interp_backend)
    return torch.where(exceed, (cap - dens) / dt, torch.zeros_like(dens))
