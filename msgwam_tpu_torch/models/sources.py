"""Ray sources: the counterpart of :mod:`msgwam_tpu.models.sources`.

This slice has the reference initial condition (:func:`wave_packet_ic`)
and the deterministic launch spectrum (:func:`gaussian_spectrum_source`).
The keyed (random) spectrum, ``cull`` and ``relaunch`` are later work
(ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import GridConfig, ModelConfig
from ..constants import ROT_EARTH
from ..ops.dispersion import omega
from ..ops.interp import grid_interp
from ..state import Background, RayState, RayStatics, coriolis, torch_dtype


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
    the reference's; only the result goes to ``device``.
    """
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
    key=None,
    dtype=torch.float64,
    device=None,
) -> Tuple[RayState, RayStatics]:
    """Gaussian source spectrum: ``n_ray`` ray volumes launched at
    ``z_launch`` with vertical wavenumbers linspaced over a Gaussian
    spectrum around ``m_center``, wave-action density at a fraction
    ``amplitude_alpha²`` of saturation.  Computed on ``device``, like the
    JAX package computes it with jnp.

    Only the deterministic spectrum is in this slice: a ``key`` raises.
    """
    if key is not None:
        raise NotImplementedError(
            "keyed (stochastic) sources are not ported yet (ROADMAP queue 1, "
            "item 3); the port will take a torch.Generator")
    dtype = torch_dtype(dtype)
    device = bg.centers.device if device is None else device
    ones = torch.ones((n_ray,), dtype=dtype, device=device)
    k_abs = 2.0 * math.pi / wavelength_h
    mm = torch.linspace(
        m_center - m_halfwidth * m_sigma,
        m_center + m_halfwidth * m_sigma,
        n_ray, dtype=dtype, device=device,
    )
    # keep m strictly negative (upward group propagation)
    mm = torch.clamp(mm, max=-k_abs)

    r = ones * z_launch
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
    dens = amplitude * spectrum / dkk / dll / dm

    rays = RayState(dens=dens, lam=torch.zeros_like(r), phi=ones * cfg.phi0,
                    r=r, dr=dr, k=k, l=l, m=mm, dm=dm)
    statics = RayStatics(
        dkk=dkk, dll=dll, rr_mm_area=rr_mm_area,
        active=torch.ones((n_ray,), dtype=torch.bool, device=device),
    )
    return rays, statics
