"""K3 and K4: the height-windowed fused RHS, and the same kernel with the
RK3 stage update fused in, as hand-written Hopper kernels.

Replaces ``msgwam_tpu/ops/rhs_pallas_windowed.py`` (``_kernel`` with
``staged=False``/``True``, entry points ``_rhs_adaptive_call``,
``_rhs_staged_call``, ``rhs_fused_windowed`` and
``rk3_step_fused_windowed``), reached through ``rhs_backend="pallas"`` with
``window_cells != 0`` (the default ``-1`` resolves to the 16-cell floor):
:func:`rhs_fused_windowed` is the RHS of ``models/rhs.py`` there (K3), and
:func:`rk3_step_fused_windowed` the step ``rk3_step`` takes (K4, three
launches per step).  The CUDA source is ``csrc/rhs_windowed.cu``, one
template with K2 (:mod:`.rhs_cuda`).

Each launch is the whole stage: the kernel reads the background and the
wind on the device (the shear tables from ``u``, ``v``), runs the per-ray
stage and the deposit over a persistent grid, and its last blocks sum the
flux in a fixed order; K4's last block then updates the wind (u, v and
their RK3 registers), so a step is three launches and no torch glue.  The
block plan is :func:`msgwam_tpu_torch.ops.ray_physics.stage_plan`'s,
queried from the card by :func:`device_plan`.

Each 256-ray tile takes a window ``[win, win + W)`` of cells from its
active rays, tries the second tier ``W2`` when the first does not hold
them, and reads the whole table past that (the exact full-width path);
the tables' reads stay inside the window.  The window never changes a
result: K3's outputs equal K2's.  Its rule is :mod:`.ray_physics`'
``tile_windows``, and :mod:`msgwam_tpu_torch.diagnostics` mirrors it.

K4 writes y' over dens/r/m **in place** after the first stage: the first
stage reads the caller's state and writes new arrays, which the second
and third stages then update in place, and likewise the wind: the
caller's state is never modified.

Under ray sharding (``axis_name``, a ProcessGroup: each rank holds a
block of the rays) the wind cannot move before the flux is summed over the
ranks, so K4 takes its flux tail instead: it deposits and writes the
rank's flux as K2/K3 do and leaves the wind alone; a stage is then one
launch, one ``all_reduce`` of the ``(2, n_cell - 1)`` flux
(:mod:`.collective`) and the wind's stage update in torch
(:func:`.ray_physics.wind_stage`, the order of operations of the JAX
package's XLA glue, ``rhs_pallas_windowed.py:492-508``).  Without
``axis_name`` K4's arguments and launches are those of one rank.

Like K2, both take float32 only: a float64 state raises ``TypeError``
(the JAX kernels cast it to float32 and back).  Both are differentiable,
sharded or not: their backwards run the composable path (:mod:`.adjoint`),
and a sharded K4 step's backward runs the sharded one, which makes the
step's three flux all-reduces again and up to three more for the
replicated wind's cotangent (:mod:`.collective`).
For CPU tensors each entry point runs its plain twin
(:func:`rhs_fused_windowed_reference`,
:func:`rk3_step_fused_windowed_reference`); ``LAUNCHES`` counts kernel
launches per entry point, and ``"rk3_step_fused_windowed_flux"`` those of
K4's launches that took the flux tail.  While a profiler records, each
launch (or its twin) is a span ``msgwam.launch.k3``/``k4`` and adds its
tiles' window tiers to the kernel's counts (:mod:`..utils.profiling`).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..state import MeanState, State
from ..utils import profiling
from . import adjoint, collective, ray_physics, rhs_cuda
from .rhs_cuda import window_for  # noqa: F401  (the windowed kernels' window)

LAUNCHES = {"rhs_fused_windowed": 0, "rk3_step_fused_windowed": 0,
            "rk3_step_fused_windowed_flux": 0}

# K4's tails (csrc/rhs_windowed.cu kTailNone, kTailWind, kTailFlux)
TAIL_NONE, TAIL_WIND, TAIL_FLUX = 0, 1, 2


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch(inp: rhs_cuda.Inputs, u, v, fields=None, outs=None, q=None, wind=None,
           stage=None, tiers: bool = False, work=None, flux_out: bool = False,
           counts=None):
    """One launch on checked inputs: returns ``(outs, flux, tiers)``.

    K3 (``stage is None``): ``outs`` are the three tendencies, new arrays
    unless given; ``tiers`` asks for one byte per tile (1 first window, 2
    second tier, 0 full width).  K4 (``stage = (c, b, first)``): ``outs``
    receive y' (they may be the dens, r and m of ``fields`` themselves),
    ``q`` holds the three RK3 registers, and with a prognostic wind
    ``wind = (u_out, v_out, qu, qv)`` receives the wind after the stage
    (``u_out``, ``v_out`` may be ``u``, ``v``); without a prognostic wind
    the flux is not returned (``None``).  ``flux_out`` takes K4's flux
    tail: the flux written and returned, ``wind`` unused and the wind left
    alone.  ``fields`` default to ``inp.fields``.  ``counts``, a
    :func:`..utils.profiling.tier_counter` buffer or ``None``, receives
    the launch's tile windows by tier."""
    dt, bvf, kappa, f0, ff0 = inp.scalars
    c_pad, w1, w2 = inp.window
    bg = inp.bg
    fields = inp.fields if fields is None else fields
    n = fields[0].shape[0]
    device = fields[0].device
    n_tab = bg.centers.shape[0]
    work = work or rhs_cuda.scratch(n, n_tab, device)
    if outs is None:
        outs = tuple(torch.empty_like(fields[0]) for _ in range(3))
    tier_t = (torch.empty(-(-n // ray_physics.TILE), dtype=torch.int8,
                          device=device) if tiers else None)
    staged = stage is not None
    cc, bc, first = stage if staged else (0.0, 0.0, False)
    q = q if staged else (None,) * 3
    tail = (TAIL_FLUX if flux_out else TAIL_WIND if inp.prognostic
            else TAIL_NONE) if staged else TAIL_NONE
    wind = wind if tail == TAIL_WIND else (None,) * 4
    cnt = rhs_cuda.counters(device)
    with profiling.span("msgwam.launch.k4" if staged else "msgwam.launch.k3"):
        err = _build.library().msgwam_rhs_windowed(
            bg.centers.data_ptr(), bg.faces.data_ptr(), u.data_ptr(),
            v.data_ptr(), bg.rhobar.data_ptr(), bg.pressure_gradient.data_ptr(),
            n_tab, c_pad, w1, w2, dt, bvf, kappa, f0, ff0,
            *(f.data_ptr() for f in fields), inp.active.data_ptr(), n,
            *(o.data_ptr() for o in outs), *(_ptr(x) for x in q),
            *(_ptr(x) for x in wind), work.flux.data_ptr(),
            work.partials.data_ptr(), work.ranges.data_ptr(),
            cnt.buf.data_ptr(), cnt.parity, _ptr(tier_t), _ptr(counts),
            work.plan.blocks, work.plan.reducers, int(inp.online),
            int(inp.faithful), int(staged), tail, cc, bc, int(bool(first)),
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(err, "msgwam_rhs_windowed")
    cnt.launched()
    LAUNCHES["rk3_step_fused_windowed" if staged else "rhs_fused_windowed"] += 1
    if tail == TAIL_FLUX:
        LAUNCHES["rk3_step_fused_windowed_flux"] += 1
    return outs, (None if staged and tail == TAIL_NONE else work.flux), tier_t


def rhs_fused_windowed(dt, state, statics, bg, cfg):
    """Adaptive-window fused-RHS entry point (K3), a drop-in for
    :func:`msgwam_tpu_torch.ops.rhs_cuda.rhs_fused`: returns
    ``(tendencies, pm_interior)``, with K2's backward
    (:func:`.rhs_cuda.fused_plain`)."""
    rhs_cuda.check_inputs(state, statics, bg, "rhs_fused_windowed")

    def kernel(dt, state, statics, bg):
        if state.rays.r.device.type == "cpu":
            return rhs_fused_windowed_reference(dt, state, statics, bg, cfg)
        outs, flux, _ = launch(
            rhs_cuda.inputs(dt, state, statics, bg, cfg), *state.mean,
            counts=profiling.tier_counter(state.rays.r.device, "K3"))
        return dict(zip(("dens", "r", "m"), outs)), flux

    return adjoint.kernel_call(kernel, functools.partial(rhs_cuda.fused_plain, cfg=cfg),
                               dt, state, statics, bg)


def rhs_fused_windowed_reference(dt, state, statics, bg, cfg):
    """Plain PyTorch twin of K3, in the state's own dtype; a span and
    K3's tier counts while a profiler records, as the kernel's."""
    params, scalars, tables = rhs_cuda.prepare_inputs(dt, state, statics, bg, cfg)
    fields = rhs_cuda.ray_fields(state, statics)
    with profiling.span("msgwam.launch.k3"):
        tend, flux, tiers = ray_physics.fused(
            params, scalars, tables, fields, statics.active,
            cfg.saturate_online, cfg.faithful_saturation,
            window_for(cfg, bg.centers.shape[0]),
            ray_physics.stage_plan(fields[0].shape[0], bg.centers.shape[0] - 1))
        profiling.add_tiers(profiling.tier_counter(fields[0].device, "K3"), tiers)
    return tend, flux


def stage_reference(inp: rhs_cuda.Inputs, fields, q, u, v, quv, stage, plan=None,
                    group=None, counts=None):
    """The twin of one K4 launch, in the inputs' dtype: the shear tables
    from ``u``, ``v``, the per-ray stage (K3's twin and the RK3 update),
    the flux summed by ``plan`` (default: the H100's), and with a
    prognostic wind the wind's stage update (:func:`ray_physics.
    wind_stage`), from the flux summed over ``group``'s ranks when a
    ``group`` is given (the flux tail and its all-reduce).  Returns ``(ys,
    q, flux, (u, v, qu, qv))``, the flux as the wind took it.  The tiles'
    window tiers are added to ``counts`` (a :func:`..utils.profiling.
    tier_counter` buffer, or ``None``)."""
    dt, bvf, kappa, f0, ff0 = inp.scalars
    cc, bc, first = stage
    bg = inp.bg
    dtype = fields[0].dtype
    centers = bg.centers.to(dtype)
    dz = centers[1] - centers[0]
    params = torch.stack([centers[0], dz, bg.faces[1].to(dtype)])
    tables = ((u[1:] - u[:-1]) / dz, (v[1:] - v[:-1]) / dz, bg.rhobar.to(dtype))
    n = fields[0].shape[0]
    plan = plan or ray_physics.stage_plan(n, centers.shape[0] - 1)
    tend, flux, tiers = ray_physics.fused(params, (dt, bvf, kappa, f0), tables,
                                          fields, inp.active, inp.online,
                                          inp.faithful, inp.window, plan)
    profiling.add_tiers(counts, tiers)
    q = q if q is not None else (None,) * 3
    out = [ray_physics.rk3_stage(tend[f], y, qq, dt, cc, bc, first)
           for f, y, qq in zip(("dens", "r", "m"),
                               (fields[0], fields[1], fields[5]), q)]
    qu, qv = quv if quv is not None else (None, None)
    if inp.prognostic:
        if group is not None:
            flux = collective.all_reduce_flux(flux, group)
        dzf = bg.faces[1] - bg.faces[0]
        u, v, qu, qv = ray_physics.wind_stage(
            flux, u, v, qu, qv, bg.pressure_gradient, bg.rhobar, dzf, ff0, dt,
            cc, bc, first)
    return (tuple(o[0] for o in out), tuple(o[1] for o in out), flux,
            (u, v, qu, qv))


def _rk3_step_reference(dt, state, statics, bg, cfg, plan=None, group=None):
    inp = rhs_cuda.inputs(dt, state, statics, bg, cfg)
    fields = list(inp.fields)
    counts = profiling.tier_counter(fields[0].device, "K4")
    u, v = state.mean
    q = quv = None
    with profiling.span("msgwam.step.stages"):
        for stage in ray_physics.RK3_STAGES:
            with profiling.span("msgwam.launch.k4"):
                ys, q, _, (u, v, qu, qv) = stage_reference(
                    inp, fields, q, u, v, quv, stage, plan, group, counts)
            quv = (qu, qv)
            fields[0], fields[1], fields[5] = ys
    rays = state.rays._replace(dens=fields[0], r=fields[1], m=fields[5])
    return State(rays, MeanState(u, v))


def _rk3_step_kernel(dt, state, statics, bg, cfg, group=None):
    """Three K4 launches: the first stage reads the caller's state and
    writes new arrays, the next two update those in place.  With a
    ``group`` and a prognostic wind each launch takes the flux tail and is
    followed by the flux's all-reduce and the wind's stage update."""
    with profiling.span("msgwam.step.prepare"):
        inp = rhs_cuda.inputs(dt, state, statics, bg, cfg)
        sharded = group is not None and inp.prognostic
        fields = list(inp.fields)
        n = fields[0].shape[0]
        device = fields[0].device
        n_tab = bg.centers.shape[0]
        work = rhs_cuda.scratch(n, n_tab, device)
        ys = tuple(torch.empty_like(fields[0]) for _ in range(3))
        q = tuple(torch.empty_like(fields[0]) for _ in range(3))
        u, v = state.mean
        wind = qu = qv = None
        if inp.prognostic and not sharded:
            wind = tuple(torch.empty((4, n_tab), dtype=torch.float32,
                                     device=device).unbind(0))
        if sharded:
            dzf = bg.faces[1] - bg.faces[0]
        counts = profiling.tier_counter(device, "K4")
    with profiling.span("msgwam.step.stages"):
        for stage in ray_physics.RK3_STAGES:
            _, flux, _ = launch(inp, u, v, fields, ys, q, wind, stage,
                                work=work, flux_out=sharded, counts=counts)
            fields[0], fields[1], fields[5] = ys
            if sharded:
                flux = collective.all_reduce_flux(flux, group)
                u, v, qu, qv = ray_physics.wind_stage(
                    flux, u, v, qu, qv, bg.pressure_gradient, bg.rhobar, dzf,
                    inp.scalars[4], inp.scalars[0], *stage)
            elif wind is not None:
                u, v = wind[0], wind[1]
        rays = state.rays._replace(dens=ys[0], r=ys[1], m=ys[2])
        return State(rays, MeanState(u, v))


def rk3_step_fused_windowed(dt, state, statics, bg, cfg, axis_name=None):
    """One Williamson RK3 step with the stage arithmetic and the wind's
    update fused into the windowed kernel (K4): three launches per step,
    the new state returned and the caller's left as it was.
    ``hprop=False``, float32.  Differentiable: the backward differentiates
    the generic RK3 step on the composable RHS (:func:`_rk3_step_plain`),
    as the JAX package's ``_rk3_step_fused_bwd`` does.

    ``axis_name``, the ProcessGroup of the ranks that share the rays:
    each stage's flux is summed over them between K4 (in its flux tail)
    and the wind's update, as the JAX package's ``psum`` under
    ``shard_map`` is; the backward differentiates the generic step with
    the same ``axis_name``, as ``_rk3_step_fused_bwd`` does."""
    with profiling.span("msgwam.step.prepare"):
        rhs_cuda.check_inputs(state, statics, bg, "rk3_step_fused_windowed")
        kernel = (_rk3_step_kernel if state.rays.r.device.type == "cuda"
                  else _rk3_step_reference)
        if axis_name is not None:
            collective.check_group(axis_name)
    return adjoint.kernel_call(
        functools.partial(kernel, cfg=cfg, group=axis_name),
        functools.partial(_rk3_step_plain, cfg=cfg, axis_name=axis_name),
        dt, state, statics, bg)


def _rk3_step_plain(dt, state, statics, bg, cfg, axis_name=None):
    from ..models.integrate import williamson_rk3
    from ..models.rhs import rhs

    xla_cfg = adjoint.plain_config(cfg)
    return williamson_rk3(lambda s: rhs(dt, s, statics, bg, xla_cfg, axis_name),
                          state, dt)


def rk3_step_fused_windowed_reference(dt, state, statics, bg, cfg, plan=None):
    """Plain PyTorch twin of :func:`rk3_step_fused_windowed`, on any
    device, in the state's own dtype; ``plan`` the flux's block plan
    (default: the H100's)."""
    return _rk3_step_reference(dt, state, statics, bg, cfg, plan)
