"""The coupled wave/mean-flow right-hand side: the counterpart of
:mod:`msgwam_tpu.models.rhs`.

Per evaluation: winds and shears interpolated to the rays, the per-ray
physics (group velocity, refraction, optional online saturation), the
deposit of the pseudo-momentum flux onto the staggered grid, boundary
padding by copy, the flux divergence and the wind tendencies.

``cfg.rhs_backend="xla"`` is the composable torch path (any
configuration); ``"pallas"`` runs the fused CUDA kernel K2
(:mod:`msgwam_tpu_torch.ops.rhs_cuda`) at full width
(``window_cells=0``), with the same torch glue around it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..constants import RAD_EARTH
from ..ops.dispersion import cg_r, group_velocities, wavenumber_tendencies
from ..ops.interp import basis_interp, grid_interp
from ..ops.projection import project_backend
from ..ops.saturation import saturation_tendency
from ..state import Background, MeanState, RayState, RayStatics, State, coriolis


def gather_winds(rays: RayState, mean: MeanState, bg: Background,
                 backend: str = "gather"):
    """Interpolate winds and vertical shears onto ray heights: the
    centered difference of u, v on cell centers gives the shear on interior
    faces, and both are linearly interpolated (clamped) to each ray's
    center.  ``"gather"`` matches ``np.interp`` exactly; ``"mxu"`` uses two
    dense hat-basis matmuls."""
    dz = bg.centers[1] - bg.centers[0]
    du_dz = (mean.u[1:] - mean.u[:-1]) / dz
    dv_dz = (mean.v[1:] - mean.v[:-1]) / dz
    if backend == "mxu":
        uv = basis_interp(rays.r, bg.centers[0], dz,
                          torch.stack([mean.u, mean.v], dim=1))
        # shear lives on interior faces: faces[1:-1]
        sh = basis_interp(rays.r, bg.faces[1], dz,
                          torch.stack([du_dz, dv_dz], dim=1))
        return uv[:, 0], uv[:, 1], sh[:, 0], sh[:, 1]
    u_ray = grid_interp(rays.r, bg.centers, mean.u)
    v_ray = grid_interp(rays.r, bg.centers, mean.v)
    du_dr = grid_interp(rays.r, bg.faces[1:-1], du_dz)
    dv_dr = grid_interp(rays.r, bg.faces[1:-1], dv_dz)
    return u_ray, v_ray, du_dr, dv_dr


def rhs(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
) -> State:
    """d(state)/dt.  Frozen fields come back as the Python float ``0.0``
    (a structural zero), never as a tensor of zeros."""
    if axis_name is not None:
        raise NotImplementedError(
            "ray sharding (axis_name) is not ported yet (ROADMAP queue 1, "
            "item 9)")
    if cfg.rhs_backend == "pallas":
        return _rhs_via_fused_kernel(dt, state, statics, bg, cfg)
    if cfg.rhs_backend != "xla":
        raise ValueError(f"unknown rhs backend {cfg.rhs_backend!r}; "
                         "available: 'xla', 'pallas'")
    return _rhs_xla(dt, state, statics, bg, cfg)


def _mean_tendencies(pm_interior, mean: MeanState, bg: Background,
                     cfg: ModelConfig):
    """Boundary padding by copy, flux divergence and the wind tendencies
    (structural zeros when the mean flow is not prognostic)."""
    pm_flux = torch.cat([pm_interior[:, :1], pm_interior, pm_interior[:, -1:]],
                        dim=1)
    dz = bg.faces[1] - bg.faces[0]
    pm_flux_gradient = (pm_flux[:, 1:] - pm_flux[:, :-1]) / dz  # (2, n_cell)
    if not cfg.prognostic_mean:
        return 0.0, 0.0
    ff = coriolis(cfg.phi0)
    du_st = ff * mean.v - (bg.pressure_gradient[0] + pm_flux_gradient[0]) / bg.rhobar
    dv_st = -ff * mean.u - (bg.pressure_gradient[1] + pm_flux_gradient[1]) / bg.rhobar
    return du_st.to(mean.u.dtype), dv_st.to(mean.v.dtype)


def _rhs_xla(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
) -> State:
    rays, mean = state
    active = statics.active

    u_ray, v_ray, du_dr, dv_dr = gather_winds(rays, mean, bg, cfg.interp_backend)

    # Structurally-zero tendencies are Python scalars (0.0): the integrator
    # then leaves those fields untouched.  cg_r is height-independent, so
    # the ray-volume stretching and the dm-extent tendency are exactly zero.
    ddrr_st = 0.0
    ddmm_st = 0.0
    if cfg.hprop:
        cglam, cgphi, cgr = group_velocities(
            rays.k, rays.l, rays.m, rays.phi, u_ray, v_ray, cfg.bvf, True
        )
        radius = RAD_EARTH + rays.r
        dlam_st = cglam / radius / torch.cos(rays.phi)
        dphi_st = cgphi / radius
        dkk_st, dll_st, dmm_st = wavenumber_tendencies(
            rays.k, rays.l, rays.m, rays.phi, rays.r,
            u_ray, v_ray, du_dr, dv_dr,
            cfg.bvf, True,
        )
    else:
        # horizontal propagation off: positions and horizontal wavenumbers
        # are frozen
        cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
        dlam_st = dphi_st = dkk_st = dll_st = 0.0
        dmm_st = -(rays.k * du_dr + rays.l * dv_dr)
    drr_st = cgr

    if cfg.saturate_online:
        dens_st = saturation_tendency(
            dt, rays.dens, rays.r, drr_st, rays.dr, ddrr_st,
            rays.k, rays.l, rays.m, dmm_st,
            statics.dkk, statics.dll, statics.rr_mm_area,
            bg.centers, bg.rhobar,
            cfg.bvf, cfg.kappa, cfg.phi0,
            faithful=cfg.faithful_saturation,
            active=active,
            interp_backend=cfg.interp_backend,
        )
    else:
        dens_st = 0.0

    # rays → mean flow: pseudo-momentum flux onto the staggered grid
    phase_vol = torch.abs(statics.dkk * statics.dll * rays.dm)
    flux_vals = torch.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens])
    pm_interior = project_backend(cfg.projection_backend)(
        flux_vals,
        rays.r - 0.5 * rays.dr,
        rays.r + 0.5 * rays.dr,
        phase_vol,
        active,
        bg.centers,
        cfg.max_span,
        accum=cfg.flux_accum,
    )  # (2, n_cell - 1)
    du_st, dv_st = _mean_tendencies(pm_interior, mean, bg, cfg)

    # inactive slots are frozen: zero tendencies everywhere
    def msk(t):
        if isinstance(t, float):
            return t
        return torch.where(active, t, torch.zeros_like(t)).to(rays.dens.dtype)

    ray_st = RayState(
        dens=msk(dens_st), lam=msk(dlam_st), phi=msk(dphi_st),
        r=msk(drr_st), dr=msk(ddrr_st),
        k=msk(dkk_st), l=msk(dll_st), m=msk(dmm_st), dm=msk(ddmm_st),
    )
    return State(ray_st, MeanState(du_st, dv_st))


def _rhs_via_fused_kernel(dt, state, statics, bg, cfg) -> State:
    """RHS through the fused CUDA kernel K2: the kernel returns the three
    active ray tendencies and the interior flux; the mean-flow glue is the
    composable path's.  Only the full-width kernel (``window_cells=0``) is
    ported."""
    if cfg.window_cells != 0:
        raise NotImplementedError(
            f"rhs_backend='pallas' with window_cells={cfg.window_cells} needs "
            f"the height-windowed kernels K3/K4 (ROADMAP queue 2), which are "
            f"not ported yet; set window_cells=0 for the full-width kernel K2")
    from ..ops.rhs_cuda import rhs_fused

    rays, mean = state
    tend, pm_interior = rhs_fused(dt, state, statics, bg, cfg)
    du_st, dv_st = _mean_tendencies(pm_interior, mean, bg, cfg)
    dtype = rays.dens.dtype
    # structural zeros as on the composable path (dens too, when online
    # saturation is off)
    dens_st = tend["dens"].to(dtype) if cfg.saturate_online else 0.0
    ray_st = RayState(
        dens=dens_st, lam=0.0, phi=0.0,
        r=tend["r"].to(dtype), dr=0.0,
        k=0.0, l=0.0, m=tend["m"].to(dtype), dm=0.0,
    )
    return State(ray_st, MeanState(du_st, dv_st))
