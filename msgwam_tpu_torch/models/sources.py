"""Ray sources: the counterpart of :mod:`msgwam_tpu.models.sources`.

The reference initial condition (:func:`wave_packet_ic`), the launch
spectrum (:func:`gaussian_spectrum_source`, deterministic or drawn from a
``torch.Generator``) and the lifecycle: :func:`cull` flips the mask of
dead rays and :func:`relaunch` refills inactive slots from a template.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import GridConfig, ModelConfig
from ..constants import ROT_EARTH
from ..ops.dispersion import omega
from ..ops.interp import grid_interp
from ..state import (Background, RayState, RayStatics, State, coriolis,
                     default_device, torch_dtype)


def wave_packet_ic(
    grid_cfg: GridConfig,
    cfg: ModelConfig,
    bg: Background,
    n_ray: int = 60,
    rr_min: float = 0.0,
    rr_max: float = 15000.0,
    wavelength_h: float = 50e3,
    direction_deg: float = 90.0,
    lambda_z: float = 5e3,
    alpha: float = 0.01,
    envelope_sigma: float = 2000.0,
    dtype=torch.float64,
    device=None,
) -> Tuple[RayState, RayStatics]:
    """The reference driver's initial condition: a vertically stacked wave
    packet of ``n_ray`` contiguous ray volumes at a fraction ``alpha²`` of
    the static-instability threshold under a Gaussian envelope.

    Built with host NumPy, as in the JAX package, so that it is bitwise
    the reference's; only the result goes to ``device``: the card unless
    another device is given (:func:`msgwam_tpu_torch.state.default_device`).
    """
    device = default_device(device)
    k_abs = 2.0 * math.pi / wavelength_h
    direction = math.radians(direction_deg)
    ones = np.ones((n_ray,))

    k = ones * k_abs * math.sin(direction)
    l = ones * k_abs * math.cos(direction)
    m = ones * (-2.0 * math.pi / lambda_z)
    lam = np.zeros((n_ray,))
    phi = ones * cfg.phi0

    edges = np.linspace(rr_min, rr_max, n_ray + 1)
    r = 0.5 * (edges[:-1] + edges[1:])
    dr = ones * (edges[1] - edges[0])
    rr_mm_area = 5e-5 * dr
    dm = rr_mm_area / dr
    dkk = ones * 1e-4
    dll = ones * 1e-4

    f0 = 2.0 * ROT_EARTH * np.sin(cfg.phi0)
    rhobar_ray = np.interp(r, bg.centers.detach().cpu().numpy().astype(np.float64),
                           bg.rhobar.detach().cpu().numpy().astype(np.float64))
    omh = np.sqrt(
        (cfg.bvf**2 * (k**2 + l**2) + f0**2 * m**2) / (k**2 + l**2 + m**2)
    )
    amplitude = (
        alpha**2 * rhobar_ray / 2.0 * omh / m**2 / (omh**2 - f0**2)
        * cfg.bvf**2
    )
    profile = np.exp(-((r - r.mean()) ** 2) / 2.0 / envelope_sigma**2)
    dens = amplitude * profile / dkk / dll / dm

    dtype = torch_dtype(dtype)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    rays = RayState(dens=t(dens), lam=t(lam), phi=t(phi), r=t(r), dr=t(dr),
                    k=t(k), l=t(l), m=t(m), dm=t(dm))
    statics = RayStatics(
        dkk=t(dkk), dll=t(dll), rr_mm_area=t(rr_mm_area),
        active=torch.ones((n_ray,), dtype=torch.bool, device=device),
    )
    return rays, statics


def _truncated_normal(gen: torch.Generator, lo: float, hi: float, n: int,
                      dtype) -> torch.Tensor:
    """Standard normal draws cut at ``[lo, hi]`` by inverting the CDF of a
    uniform draw between ``Phi(lo)`` and ``Phi(hi)``; the result is clamped
    to the bounds, so they hold exactly in ``dtype``."""
    erf = lambda x: math.erf(x / math.sqrt(2.0))
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=gen.device)
    u = erf(lo) + (erf(hi) - erf(lo)) * u
    x = math.sqrt(2.0) * torch.special.erfinv(u)
    return torch.clamp(x.to(dtype), lo, hi)


def gaussian_spectrum_source(
    cfg: ModelConfig,
    bg: Background,
    n_ray: int,
    z_launch: float = 1000.0,
    dz_launch: float = 1000.0,
    m_center: float = -2.0 * math.pi / 5e3,
    m_sigma: float = 2.0 * math.pi / 20e3,
    m_halfwidth: float = 3.0,
    wavelength_h: float = 50e3,
    amplitude_alpha: float = 0.01,
    key: Optional[torch.Generator] = None,
    dtype=torch.float64,
    device=None,
) -> Tuple[RayState, RayStatics]:
    """Gaussian source spectrum: ``n_ray`` ray volumes launched at
    ``z_launch`` with vertical wavenumbers over a Gaussian spectrum around
    ``m_center``, wave-action density at a fraction ``amplitude_alpha²`` of
    saturation.  Computed on ``device``, like the JAX package computes it
    with jnp.

    Without ``key`` the wavenumbers are linspaced over ``±m_halfwidth``
    standard deviations.  With a ``torch.Generator`` as ``key`` the draw is
    stochastic, as the JAX package's keyed draw: ``m`` from a normal cut
    exactly at ``±m_halfwidth`` standard deviations, an amplitude jitter
    ``exp(0.3 N)`` and launch heights offset uniformly within
    ``±dz_launch / 2``, drawn in that order from the generator (on its own
    device, then moved to ``device``).  The generator advances with every
    draw.  Its numbers are not JAX's: the same seed gives the same draw
    here and another one there, so the two packages agree in distribution
    only.
    """
    dtype = torch_dtype(dtype)
    device = bg.centers.device if device is None else device
    ones = torch.ones((n_ray,), dtype=dtype, device=device)
    k_abs = 2.0 * math.pi / wavelength_h
    if key is None:
        mm = torch.linspace(
            m_center - m_halfwidth * m_sigma,
            m_center + m_halfwidth * m_sigma,
            n_ray, dtype=dtype, device=device,
        )
        amp_jitter = 1.0
        z_off = 0.0
    else:
        draw = _truncated_normal(key, -m_halfwidth, m_halfwidth, n_ray, dtype)
        mm = m_center + m_sigma * draw.to(device)
        amp_jitter = torch.exp(0.3 * torch.randn(
            (n_ray,), generator=key, dtype=dtype, device=key.device)).to(device)
        z_off = dz_launch * (torch.rand((n_ray,), generator=key, dtype=dtype,
                                        device=key.device).to(device) - 0.5)
    # keep m strictly negative (upward group propagation)
    mm = torch.clamp(mm, max=-k_abs)

    r = ones * z_launch + z_off
    dr = ones * dz_launch
    rr_mm_area = 5e-5 * dr
    dm = rr_mm_area / dr
    k = ones * k_abs
    l = torch.zeros((n_ray,), dtype=dtype, device=device)
    dkk = ones * 1e-4
    dll = ones * 1e-4

    f0 = coriolis(torch.tensor(cfg.phi0, dtype=dtype, device=device))
    rhobar_ray = grid_interp(r, bg.centers.to(dtype), bg.rhobar.to(dtype))
    omh = omega(k, l, mm, cfg.phi0, cfg.bvf)
    spectrum = torch.exp(-((mm - m_center) ** 2) / 2.0 / m_sigma**2)
    amplitude = (
        amplitude_alpha**2 * rhobar_ray / 2.0 * omh / mm**2
        / (omh**2 - f0**2) * cfg.bvf**2
    )
    dens = amplitude * spectrum * amp_jitter / dkk / dll / dm

    rays = RayState(dens=dens, lam=torch.zeros_like(r), phi=ones * cfg.phi0,
                    r=r, dr=dr, k=k, l=l, m=mm, dm=dm)
    statics = RayStatics(
        dkk=dkk, dll=dll, rr_mm_area=rr_mm_area,
        active=torch.ones((n_ray,), dtype=torch.bool, device=device),
    )
    return rays, statics


def cull(state: State, statics: RayStatics, bg: Background, cfg: ModelConfig):
    """Deactivate dead rays (a mask flip; the state is untouched and the
    RHS masks their tendencies to zero): rays wholly out of the vertical
    domain, at a critical level (``|m| > cfg.m_max``), or with a
    non-finite density, height or wavenumber."""
    rays = state.rays
    r_low = rays.r - 0.5 * rays.dr
    r_up = rays.r + 0.5 * rays.dr
    out = (r_low >= bg.faces[-1]) | (r_up <= bg.faces[0])
    critical = torch.abs(rays.m) > cfg.m_max
    finite = (torch.isfinite(rays.dens) & torch.isfinite(rays.r)
              & torch.isfinite(rays.m))
    active = statics.active & ~out & ~critical & finite
    return state, statics._replace(active=active)


def relaunch(state: State, statics: RayStatics,
             source: Tuple[RayState, RayStatics]):
    """Refill inactive slots from a source template (slot reuse); active
    rays are untouched."""
    src_rays, src_statics = source
    act = statics.active

    def pick(live, fresh):
        return torch.where(act, live, fresh)

    rays = RayState(*(pick(a, b) for a, b in zip(state.rays, src_rays)))
    statics = RayStatics(
        dkk=pick(statics.dkk, src_statics.dkk),
        dll=pick(statics.dll, src_statics.dll),
        rr_mm_area=pick(statics.rr_mm_area, src_statics.rr_mm_area),
        active=act | src_statics.active,
    )
    return State(rays, state.mean), statics
