"""K3 and K4: the height-windowed fused RHS, and the same kernel with the
RK3 stage update fused in, as hand-written Hopper kernels.

Replaces ``msgwam_tpu/ops/rhs_pallas_windowed.py`` (``_kernel`` with
``staged=False``/``True``, entry points ``_rhs_adaptive_call``,
``_rhs_staged_call``, ``rhs_fused_windowed`` and
``rk3_step_fused_windowed``), reached through ``rhs_backend="pallas"`` with
``window_cells != 0`` (the default ``-1`` resolves to the 16-cell floor):
:func:`rhs_fused_windowed` is the RHS of ``models/rhs.py`` there (K3), and
:func:`rk3_step_fused_windowed` the step ``rk3_step`` takes (K4, three
launches per step).  The CUDA source is ``csrc/rhs_windowed.cu``.

Each 256-ray tile takes a window ``[win, win + W)`` of cells from its
active rays, tries the second tier ``W2`` when the first does not hold
them, and reads the whole table past that (the exact full-width path);
the tables' reads stay inside the window.  The window never changes a
result: K3's outputs equal K2's (:mod:`.rhs_cuda`).  Its rule is
:mod:`.ray_physics`' ``tile_windows``, and
:mod:`msgwam_tpu_torch.diagnostics` mirrors it.

K4 writes y' over dens/r/m **in place** after the first stage: the first
stage reads the caller's state and writes new arrays, which the second
and third stages then update in place (each ray is read whole, and its
deposit inputs staged, before it is written), so the caller's state is
never modified.  The wind's stage update stays in torch glue in float32,
as in the JAX package (``coriolis(phi0)``, ``dzf = faces[1] - faces[0]``,
the flux divergence divided by ρ̄).

Like K2, both take float32 only: a float64 state raises ``TypeError``
(the JAX kernels cast it to float32 and back).  Both are forward only.
For CPU tensors each entry point runs its plain twin
(:func:`rhs_fused_windowed_reference`,
:func:`rk3_step_fused_windowed_reference`); ``LAUNCHES`` counts kernel
launches per entry point.
"""

from __future__ import annotations

import torch

from .. import _build
from ..state import MeanState, State, coriolis
from . import ray_physics, rhs_cuda
from .projection_cuda import n_blocks_for

LAUNCHES = {"rhs_fused_windowed": 0, "rk3_step_fused_windowed": 0}


def window_for(cfg, n_tab: int) -> tuple:
    """``(c_pad, w1, w2)`` of the windowed kernels for ``n_tab`` centers."""
    c_pad = rhs_cuda.c_pad_for(n_tab)
    return (c_pad, *rhs_cuda.resolve_window_cells(cfg, c_pad))


def launch(params, scalars, tables, fields, active, window, online: bool,
           faithful: bool, outs=None, q=None, stage=None, tiers: bool = False):
    """One launch of the kernel on checked inputs: returns ``(outs, flux,
    tiers)``.

    K3 (``stage is None``): ``outs`` are the three tendencies, new arrays
    unless given; ``tiers`` asks for one byte per tile (1 first window, 2
    second tier, 0 full width).  K4 (``stage = (c, b, first)``): ``outs``
    receive y' (they may be ``fields[0]``, ``fields[1]`` and ``fields[5]``
    themselves) and ``q`` holds the three RK3 registers, updated in
    place."""
    dt, bvf, kappa, f0 = scalars
    du_dz, dv_dz, rhobar = tables
    c_pad, w1, w2 = window
    n = fields[0].shape[0]
    device = fields[0].device
    n_tab = rhobar.shape[0]
    nb = n_blocks_for(n)
    if outs is None:
        outs = tuple(torch.empty_like(fields[0]) for _ in range(3))
    flux = torch.empty((2, n_tab - 1), dtype=torch.float32, device=device)
    partials = torch.empty((nb, 2, n_tab - 1), dtype=torch.float64,
                           device=device)
    tier_t = (torch.empty(-(-n // ray_physics.TILE), dtype=torch.int8,
                          device=device) if tiers else None)
    cc, bc, first = stage if stage is not None else (0.0, 0.0, False)
    q_ptrs = [x.data_ptr() for x in q] if stage is not None else [None] * 3
    err = _build.library().msgwam_rhs_windowed(
        params.data_ptr(), dt, bvf, kappa, f0,
        du_dz.data_ptr(), dv_dz.data_ptr(), rhobar.data_ptr(), n_tab,
        c_pad, w1, w2, *(f.data_ptr() for f in fields), active.data_ptr(), n,
        *(o.data_ptr() for o in outs), *q_ptrs,
        flux.data_ptr(), partials.data_ptr(),
        None if tier_t is None else tier_t.data_ptr(), nb,
        int(bool(online)), int(bool(faithful)), int(stage is not None),
        cc, bc, int(bool(first)),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "msgwam_rhs_windowed")
    LAUNCHES["rk3_step_fused_windowed" if stage is not None
             else "rhs_fused_windowed"] += 1
    return outs, flux, tier_t


def rhs_fused_windowed(dt, state, statics, bg, cfg):
    """Adaptive-window fused-RHS entry point (K3), a drop-in for
    :func:`msgwam_tpu_torch.ops.rhs_cuda.rhs_fused`: returns
    ``(tendencies, pm_interior)``."""
    _build.forward_only("rhs_fused_windowed", state, statics, bg)
    rhs_cuda.check_inputs(state, statics, bg, "rhs_fused_windowed")
    if state.rays.r.device.type == "cpu":
        return rhs_fused_windowed_reference(dt, state, statics, bg, cfg)
    params, scalars, tables = rhs_cuda.prepare_inputs(dt, state, statics, bg, cfg)
    outs, flux, _ = launch(params, scalars, tables,
                           rhs_cuda.ray_fields(state, statics), statics.active,
                           window_for(cfg, bg.centers.shape[0]),
                           cfg.saturate_online, cfg.faithful_saturation)
    return dict(zip(("dens", "r", "m"), outs)), flux


def rhs_fused_windowed_reference(dt, state, statics, bg, cfg):
    """Plain PyTorch twin of K3, in the state's own dtype."""
    params, scalars, tables = rhs_cuda.prepare_inputs(dt, state, statics, bg, cfg)
    tend, flux, _ = ray_physics.fused(
        params, scalars, tables, rhs_cuda.ray_fields(state, statics),
        statics.active, cfg.saturate_online, cfg.faithful_saturation,
        window_for(cfg, bg.centers.shape[0]))
    return tend, flux


def _stage_kernel(params, scalars, tables, fields, active, window, cfg, stage, q):
    """One K4 launch: ``(y', q', flux)``, y' into new arrays at the first
    stage and in place after it."""
    ys = (fields[0], fields[1], fields[5])
    if stage[2]:
        ys = tuple(torch.empty_like(y) for y in ys)
        q = tuple(torch.empty_like(y) for y in ys)
    _, flux, _ = launch(params, scalars, tables, fields, active, window,
                        cfg.saturate_online, cfg.faithful_saturation, outs=ys,
                        q=q, stage=stage)
    return ys, q, flux


def stage_reference(params, scalars, tables, fields, active, window, cfg,
                     stage, q):
    """The twin of one K4 launch: K3's twin, then the stage update."""
    cc, bc, first = stage
    tend, flux, _ = ray_physics.fused(params, scalars, tables, fields, active,
                                      cfg.saturate_online,
                                      cfg.faithful_saturation, window)
    q = q if q is not None else (None,) * 3
    out = [ray_physics.rk3_stage(tend[f], y, qq, scalars[0], cc, bc, first)
           for f, y, qq in zip(("dens", "r", "m"),
                               (fields[0], fields[1], fields[5]), q)]
    return tuple(o[0] for o in out), tuple(o[1] for o in out), flux


def _rk3_step(dt, state, statics, bg, cfg, stage_fn):
    """One RK3 step: three launches of ``stage_fn`` and the wind's stage
    update in torch glue (``rhs_pallas_windowed.py:459-508``)."""
    params, scalars, tables = rhs_cuda.prepare_inputs(dt, state, statics, bg, cfg)
    window = window_for(cfg, bg.centers.shape[0])
    fields = list(rhs_cuda.ray_fields(state, statics))
    u, v = state.mean
    dzc = params[1]
    dzf = bg.faces[1] - bg.faces[0]
    ff0 = coriolis(cfg.phi0)
    pg, rhobar = bg.pressure_gradient, bg.rhobar
    q = qu = qv = None
    for cc, bc, first in ray_physics.RK3_STAGES:
        if not first:
            tables = ((u[1:] - u[:-1]) / dzc, (v[1:] - v[:-1]) / dzc, rhobar)
        ys, q, flux = stage_fn(params, scalars, tables, fields, statics.active,
                               window, cfg, (cc, bc, first), q)
        fields[0], fields[1], fields[5] = ys
        if cfg.prognostic_mean:
            pm_flux = torch.cat([flux[:, :1], flux, flux[:, -1:]], dim=1)
            grad = (pm_flux[:, 1:] - pm_flux[:, :-1]) / dzf
            du_st = ff0 * v - (pg[0] + grad[0]) / rhobar
            dv_st = -ff0 * u - (pg[1] + grad[1]) / rhobar
            u, qu = ray_physics.rk3_stage(du_st, u, qu, dt, cc, bc, first)
            v, qv = ray_physics.rk3_stage(dv_st, v, qv, dt, cc, bc, first)
    rays = state.rays._replace(dens=fields[0], r=fields[1], m=fields[5])
    return State(rays, MeanState(u, v))


def rk3_step_fused_windowed(dt, state, statics, bg, cfg, axis_name=None):
    """One Williamson RK3 step with the stage arithmetic fused into the
    windowed kernel (K4): three launches per step, the new state returned
    and the caller's left as it was.  ``hprop=False``, float32, forward
    only."""
    if axis_name is not None:
        raise NotImplementedError(
            "ray sharding (axis_name) is not ported yet (ROADMAP queue 1, "
            "item 9)")
    _build.forward_only("rk3_step_fused_windowed", state, statics, bg)
    rhs_cuda.check_inputs(state, statics, bg, "rk3_step_fused_windowed")
    on_card = state.rays.r.device.type == "cuda"
    return _rk3_step(dt, state, statics, bg, cfg,
                     _stage_kernel if on_card else stage_reference)


def rk3_step_fused_windowed_reference(dt, state, statics, bg, cfg):
    """Plain PyTorch twin of :func:`rk3_step_fused_windowed`, on any
    device, in the state's own dtype."""
    return _rk3_step(dt, state, statics, bg, cfg, stage_reference)
