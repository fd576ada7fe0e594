"""The coupled wave/mean-flow right-hand side: the counterpart of
:mod:`msgwam_tpu.models.rhs`.

Per evaluation: winds and shears interpolated to the rays, the per-ray
physics (group velocity, refraction, optional online saturation), the
deposit of the pseudo-momentum flux onto the staggered grid, boundary
padding by copy, the flux divergence and the wind tendencies.

``cfg.rhs_backend="xla"`` is the composable torch path (any
configuration); ``"pallas"`` runs a fused CUDA kernel with the same torch
glue around it: K2 (:mod:`msgwam_tpu_torch.ops.rhs_cuda`) at full width
for ``window_cells=0``, K3 (:mod:`msgwam_tpu_torch.ops.rhs_cuda_windowed`)
with its per-tile height window otherwise.  Both routes are
differentiable: the kernels' backward differentiates :func:`ray_tendencies`
(:mod:`msgwam_tpu_torch.ops.adjoint`).

Under ray sharding ``axis_name`` is the ProcessGroup of the ranks that
share the rays: each rank deposits its own rays, and the interior flux is
summed over the ranks (:func:`msgwam_tpu_torch.ops.collective.
all_reduce_flux`) before the wind tendencies, as the JAX package's
``psum`` is.  A sharded call is differentiable: the rays read the
replicated wind and background through :func:`msgwam_tpu_torch.ops.
collective.replicated`, whose backward sums their cotangent over the ranks
(one all-reduce an evaluation), and the flux's sum passes its cotangent
through unchanged.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..constants import RAD_EARTH
from ..ops import collective
from ..ops.dispersion import cg_r, group_velocities, wavenumber_tendencies
from ..ops.interp import basis_interp, grid_interp
from ..ops.projection import abs1, project_backend
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
    axis_name=None,
) -> State:
    """d(state)/dt.  Frozen fields come back as the Python float ``0.0``
    (a structural zero), never as a tensor of zeros.  ``axis_name``: the
    ProcessGroup to sum the flux over (ray sharding), or ``None``."""
    if axis_name is not None:
        collective.check_group(axis_name)
    if cfg.rhs_backend == "pallas":
        return _rhs_via_fused_kernel(dt, state, statics, bg, cfg, axis_name)
    if cfg.rhs_backend != "xla":
        raise ValueError(f"unknown rhs backend {cfg.rhs_backend!r}; "
                         "available: 'xla', 'pallas'")
    return _rhs_xla(dt, state, statics, bg, cfg, axis_name)


def _summed(pm_interior, cfg: ModelConfig, axis_name):
    """The rank's interior flux summed over ``axis_name``'s ranks, where
    the wind reads it (a prognostic wind); as it is otherwise."""
    if axis_name is None or not cfg.prognostic_mean:
        return pm_interior
    return collective.all_reduce_flux(pm_interior, axis_name)


def ray_side(mean: MeanState, bg: Background, axis_name):
    """The replicated wind and background as a rank's rays read them:
    under ray sharding, through :func:`msgwam_tpu_torch.ops.collective.
    replicated` (one all-reduce of their cotangent in the backward, where
    a gradient is recorded); as they are otherwise.  ``mean=None`` for the
    background alone."""
    if axis_name is None:
        return mean, bg
    if mean is None:
        return None, Background(*collective.replicated(axis_name, *bg))
    out = collective.replicated(axis_name, *mean, *bg)
    return MeanState(*out[:2]), Background(*out[2:])


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
    axis_name=None,
) -> State:
    ray_mean, ray_bg = ray_side(state.mean, bg, axis_name)
    ray_st, pm_interior = ray_tendencies(dt, State(state.rays, ray_mean),
                                         statics, ray_bg, cfg)
    pm_interior = _summed(pm_interior, cfg, axis_name)
    du_st, dv_st = _mean_tendencies(pm_interior, state.mean, bg, cfg)
    return State(ray_st, MeanState(du_st, dv_st))


def ray_tendencies(dt, state: State, statics: RayStatics, bg: Background,
                   cfg: ModelConfig):
    """The composable path's ray tendencies (a :class:`RayState`, zero on
    inactive slots, structural zeros as :func:`rhs` gives them) and the
    ``(2, n_cell - 1)`` interior flux: what a fused RHS kernel returns, and
    what its backward differentiates (:func:`msgwam_tpu_torch.ops.
    rhs_cuda.rhs_fused`)."""
    rays = state.rays
    active = statics.active

    u_ray, v_ray, du_dr, dv_dr = gather_winds(rays, state.mean, bg,
                                              cfg.interp_backend)

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
    phase_vol = abs1(statics.dkk * statics.dll * rays.dm)
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
    return ray_st, pm_interior


def _rhs_via_fused_kernel(dt, state, statics, bg, cfg, axis_name=None) -> State:
    """RHS through a fused CUDA kernel: K2 at full width
    (``window_cells=0``), else K3 with its per-tile window (``-1``
    resolves to the 16-cell floor).  The kernel returns the three active
    ray tendencies and the interior flux; the mean-flow glue is the
    composable path's."""
    if cfg.window_cells != 0:
        from ..ops.rhs_cuda_windowed import rhs_fused_windowed as rhs_fused
    else:
        from ..ops.rhs_cuda import rhs_fused

    rays, mean = state
    ray_mean, ray_bg = ray_side(mean, bg, axis_name)
    tend, pm_interior = rhs_fused(dt, State(rays, ray_mean), statics, ray_bg,
                                  cfg)
    pm_interior = _summed(pm_interior, cfg, axis_name)
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
