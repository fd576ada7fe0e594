"""Time integration: the counterpart of :mod:`msgwam_tpu.models.integrate`.

Williamson low-storage RK3 with the reference's stage arithmetic
(including the full ``dt`` passed to every stage's RHS), the step
function with *offline* saturation and culling, and :func:`simulate`, a
Python loop over steps with history decimation, relaunch, transient winds
and the height sort.  PyTorch runs eagerly, so the loop is the JAX
package's ``lax.scan`` written out.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..config import ModelConfig, RunConfig
from ..ops import collective
from ..ops.projection import required_span
from ..ops.ray_physics import third
from ..ops.saturation import saturate_direct
from ..state import Background, RayStatics, State, torch_dtype, tree_axpy, tree_map
from ..utils import profiling
from . import sources as _sources
from .rhs import ray_side, rhs as rhs_default


def validate_inputs(state: State, statics: RayStatics, bg: Background,
                    cfg: ModelConfig, axis_name=None) -> None:
    """Host-side checks run once per :func:`simulate`: the state and
    background dtype must match ``cfg.dtype``, and the ``xla`` scatter's
    ``max_span`` must cover the widest active ray (the scatter would
    otherwise drop part of its deposit).  The span check reads one value
    from the device; under ray sharding (``axis_name``) the widest ray of
    every rank, so that the ranks raise together or not at all."""
    n = state.rays.dens.shape[0]
    if (cfg.dtype == "float32" and cfg.projection_backend == "mxu"
            and cfg.rhs_backend != "pallas" and cfg.flux_accum == "native"
            and n >= 65536):
        warnings.warn(
            f"flux_accum='native' at {n} f32 rays exceeds the 1e-6 "
            f"deposit-error target; use flux_accum='compensated' or the "
            f"pallas backend for accurate fast runs",
            stacklevel=3,
        )

    want = torch_dtype(cfg.dtype)
    for name, arr in (("state.rays.dens", state.rays.dens),
                      ("state.mean.u", state.mean.u),
                      ("background.rhobar", bg.rhobar)):
        if arr.dtype != want:
            got = str(arr.dtype).removeprefix("torch.")
            raise TypeError(
                f"{name} has dtype {got} but cfg.dtype={cfg.dtype!r}; "
                f"build the state/background with the configured dtype or "
                f"set cfg.replace(dtype={got!r})"
            )

    if cfg.projection_backend != "xla":
        return
    dr = state.rays.dr.detach()
    dr_max = torch.where(statics.active, dr, torch.full_like(dr, -math.inf)).max()
    if axis_name is not None:
        dist.all_reduce(dr_max, op=dist.ReduceOp.MAX, group=axis_name)
    dr_max = float(dr_max)
    if dr_max > -math.inf:
        dz = float(bg.faces[1] - bg.faces[0])
        need = required_span(dr_max, dz)
        if need > cfg.max_span:
            raise ValueError(
                f"cfg.max_span={cfg.max_span} but the widest active ray "
                f"volume (dr={dr_max:g} m, dz={dz:g} m) spans {need} "
                f"cells; the xla projection backend would silently drop "
                f"part of its flux deposit.  Raise cfg.max_span to "
                f">= {need} (or use the dense 'mxu' backend, which has "
                f"no span bound)."
            )


def _scale(s):
    """Leaf-wise ``s * t``; a structural zero stays a float."""
    return lambda t: s * t


def williamson_rk3(f: Callable, y, dt):
    """3-stage Williamson low-storage RK3 over a state tree:

        q = dt f(y);             y += q/3
        q = dt f(y) − 5/9 q;     y += 15/16 q
        q = dt f(y) − 153/128 q; y += 8/15 q
    """
    q = tree_map(_scale(dt), f(y))
    # stage 1 adds q/3 by *division*, exactly like the reference
    y = tree_map(lambda qq, v: v if isinstance(qq, float) and qq == 0.0
                 else v + third(qq), q, y)
    q = tree_map(lambda t, qq: dt * t - 5.0 / 9.0 * qq, f(y), q)
    y = tree_axpy(15.0 / 16.0, q, y)
    q = tree_map(lambda t, qq: dt * t - 153.0 / 128.0 * qq, f(y), q)
    return tree_axpy(8.0 / 15.0, q, y)


def forward_euler(f: Callable, y, dt):
    """First-order forward Euler (an alternative integrator)."""
    return tree_axpy(dt, f(y), y)


def rk4(f: Callable, y, dt):
    """Classic 4th-order Runge-Kutta (an alternative integrator)."""
    k1 = f(y)
    k2 = f(tree_axpy(0.5 * dt, k1, y))
    k3 = f(tree_axpy(0.5 * dt, k2, y))
    k4 = f(tree_axpy(dt, k3, y))
    incr = tree_map(lambda a, b, c, d: a + 2.0 * b + 2.0 * c + d, k1, k2, k3, k4)
    return tree_axpy(dt / 6.0, incr, y)


INTEGRATORS = {
    "rk3": williamson_rk3,
    "rk4": rk4,
    "euler": forward_euler,
}


def rk3_step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name=None,
    rhs: Callable = rhs_default,
) -> State:
    """One integrator step of the coupled system (``cfg.integrator``
    selects rk3/rk4/euler).  The full ``dt`` goes to every stage's RHS.
    ``axis_name``: the ProcessGroup of the ranks that share the rays (ray
    sharding: one all-reduce of the flux per RHS evaluation), or ``None``.

    With the windowed pallas backend (``window_cells != 0``), RK3, the
    default RHS and ``hprop=False``, the whole step runs stage-fused in
    the kernel K4 (``ops/rhs_cuda_windowed.py``), three launches per
    step; its backward differentiates the generic RK3 step on the
    composable RHS, as the JAX package's ``_rk3_step_fused`` does."""
    if (rhs is rhs_default and cfg.rhs_backend == "pallas"
            and cfg.window_cells != 0 and cfg.integrator == "rk3"
            and not cfg.hprop):
        from ..ops import rhs_cuda_windowed

        return rhs_cuda_windowed.rk3_step_fused_windowed(
            dt, state, statics, bg, cfg, axis_name)
    integ = INTEGRATORS[cfg.integrator]
    return integ(lambda s: rhs(dt, s, statics, bg, cfg, axis_name), state, dt)


class StepAux(NamedTuple):
    """Per-step side channel: the *propagated* (pre-offline-saturation)
    density."""

    dens_prop: torch.Tensor


@profiling.spanned("msgwam.step")
def step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name=None,
    rhs: Callable = rhs_default,
):
    """One model step: RK3, then (with ``saturate_online`` off) the
    host-side offline direct saturation with finite-difference rates,
    then (with ``cfg.cull``) the cull.  Returns ``(new_state, new_statics,
    aux)``.

    This path culls only when ``cfg.cull`` is set, as the JAX package's
    scan path does; the whole-run kernels K6/K7 cull when ``cfg.cull`` or
    ``cfg.relaunch`` is set (``ops/step_cuda_stream.py``), as its
    streaming kernel does."""
    prev = state
    if axis_name is not None:
        collective.check_group(axis_name)
    with collective.checked(axis_name):
        state = rk3_step(dt, state, statics, bg, cfg, axis_name, rhs)
    aux = StepAux(dens_prop=state.rays.dens)

    if not cfg.saturate_online:
        with profiling.span("msgwam.step.saturate"):
            rays, prev_rays = state.rays, prev.rays
            # the rays' read of the replicated background (ray sharding)
            _, ray_bg = ray_side(None, bg, axis_name)
            # Reference quirk 2: the height rate is divided by 1, not dt
            r_div = 1.0 if cfg.faithful_offline_rates else dt
            dens = saturate_direct(
                dt,
                rays.dens,
                prev_rays.r,
                (rays.r - prev_rays.r) / r_div,
                prev_rays.dr,
                (rays.dr - prev_rays.dr) / dt,
                rays.k,
                rays.l,
                prev_rays.m,
                (rays.m - prev_rays.m) / dt,
                statics.dkk,
                statics.dll,
                statics.rr_mm_area,
                ray_bg.centers,
                ray_bg.rhobar,
                cfg.bvf,
                cfg.kappa,
                cfg.phi0,
                faithful=cfg.faithful_saturation,
                active=statics.active,
                interp_backend=cfg.interp_backend,
            )
            state = state._replace(rays=rays._replace(dens=dens))

    if cfg.cull:
        with profiling.span("msgwam.step.cull"):
            state, statics = _sources.cull(state, statics, bg, cfg)
    return state, statics, aux


def _gather(tree, idx):
    return tree_map(lambda x: x[idx], tree)


def _checkpoint(fn, key, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``, which runs it again
    in the backward instead of keeping what it saved.  ``key``, a
    ``torch.Generator`` that ``fn`` draws from (or ``None``), is rewound to
    where it stood at the first run for every later one and put back
    after, so a replay draws the templates the first run drew: the JAX
    package's explicit keys replay by themselves."""
    if key is not None:
        start, inner, ran = key.get_state(), fn, []

        def fn(*a):
            if not ran:
                ran.append(True)
                return inner(*a)
            now = key.get_state()
            key.set_state(start)
            try:
                return inner(*a)
            finally:
                key.set_state(now)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


@profiling.spanned("msgwam.simulate")
def simulate(
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    observe: Optional[Callable] = None,
    source=None,
    relaunch_every: int = 1,
    axis_name=None,
    rhs: Callable = rhs_default,
    wind_fn: Optional[Callable] = None,
    t0: float = 0.0,
    include_t0: bool = False,
    source_key=None,
    validate: bool = True,
    sort_every: int = 0,
    remat=False,
):
    """Run ``run.n_steps`` steps, recording an observation every
    ``run.save_every`` steps.

    ``observe(state, statics, aux) -> tree`` selects what is stacked into
    the history (default: the full state, the activity mask and the
    propagated density).  ``include_t0`` prepends the initial state as
    frame 0.  Returns ``(final_state, final_statics, history)``; every
    history leaf has leading axis ``n_steps // save_every`` (+1 with
    ``include_t0``).

    With ``cfg.relaunch``, ``source`` refills the inactive slots after each
    step whose index is a multiple of ``relaunch_every``.  It is a fixed
    ``(RayState, RayStatics)`` template, or a callable ``source(key)`` that
    draws a fresh template; ``source_key`` (a ``torch.Generator``) is then
    required and passed to it at every step, even when ``relaunch_every >
    1``, as the JAX package splits its key every step.

    ``wind_fn(t) -> (u, v)`` overwrites the mean wind at the start of step
    ``i``, ``t = t0 + i * dt`` in the background's dtype; a scalar return
    is broadcast to the whole column.

    ``sort_every=N`` sorts the rays by height (inactive slots last) every
    N steps with a stable sort.  A slot permutation is carried, so history
    frames, relaunch templates and the final state all stay in the
    caller's slot order; only the order of floating-point sums changes.

    Gradients follow ``requires_grad`` on the inputs: the loop records
    what autograd needs when an input needs a gradient, and nothing when
    none does.  ``remat=True`` runs each block of ``save_every`` steps
    under ``torch.utils.checkpoint`` (its steps run again in the backward
    instead of being kept), and ``remat="full"`` each step inside the
    block as well, as ``jax.checkpoint`` does in the JAX package; the
    forward and the gradient are the same.  Only the last step's aux
    leaves a block.

    ``axis_name`` is the ProcessGroup of the ranks that share the rays
    (ray sharding, :mod:`msgwam_tpu_torch.parallel.sharding`): the state
    and statics are this rank's block of the rays and the replicated wind,
    and every RHS evaluation sums its flux over the ranks.  The sort, the
    cull and the relaunch stay local to each rank, as inside the JAX
    package's ``shard_map``.  A sharded run is differentiable as an
    unsharded one is, when every rank computes the same loss from whole
    (:func:`~msgwam_tpu_torch.parallel.sharding.gather_state`) or
    replicated outputs: each RHS evaluation that a gradient passes makes
    one more all-reduce in the backward (the replicated wind's and
    background's cotangent, :mod:`msgwam_tpu_torch.ops.collective`), and
    a step replayed by ``remat`` or rerun by a kernel's backward makes its
    flux all-reduces again.
    """
    if remat not in (False, True, "full"):
        raise ValueError(f"remat must be False, True or 'full', got {remat!r}")
    keyed_source = callable(source)
    if axis_name is not None:
        collective.check_group(axis_name)
    if keyed_source and source_key is None:
        raise ValueError("a callable source requires source_key")

    if observe is None:
        observe = lambda s, st, aux: (s, st.active, aux.dens_prop)
    if run.n_steps % run.save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    if validate:
        with profiling.span("msgwam.simulate.validate"):
            validate_inputs(state, statics, bg, cfg, axis_name)

    use_sort = sort_every > 0
    slot = (torch.arange(state.rays.r.shape[0], device=state.rays.r.device)
            if use_sort else None)
    key = source_key if keyed_source and cfg.relaunch else None

    def unsorted(st, stat, aux, slot):
        if not use_sort:
            return st, stat, aux
        inv = torch.argsort(slot)
        return (st._replace(rays=_gather(st.rays, inv)), _gather(stat, inv),
                _gather(aux, inv))

    t_dtype = bg.centers.dtype

    def advance(i, state, statics, slot):
        """Step ``i``: the sort, the prescribed wind, the step and the
        relaunch."""
        if use_sort and i % sort_every == 0:
            with profiling.span("msgwam.simulate.sort"):
                order = torch.argsort(
                    torch.where(statics.active, state.rays.r,
                                torch.full_like(state.rays.r, math.inf)),
                    stable=True)
                state = state._replace(rays=_gather(state.rays, order))
                statics = _gather(statics, order)
                slot = slot[order]
        if wind_fn is not None:
            with profiling.span("msgwam.simulate.wind"):
                t = t0 + torch.tensor(float(i), dtype=t_dtype) * run.dt
                u, v = wind_fn(t)
                mean = state.mean
                state = state._replace(mean=mean._replace(
                    u=_broadcast(u, mean.u), v=_broadcast(v, mean.v)))
        state, statics, aux = step(run.dt, state, statics, bg, cfg, axis_name,
                                   rhs)
        if cfg.relaunch and source is not None:
            with profiling.span("msgwam.simulate.relaunch"):
                template = source(source_key) if keyed_source else source
                if use_sort:
                    template = _gather(template, slot)
                if relaunch_every <= 1 or i % relaunch_every == 0:
                    state, statics = _sources.relaunch(state, statics, template)
        return state, statics, slot, aux

    def block(b, state, statics, slot):
        """The ``save_every`` steps of block ``b``; the last step's aux."""
        for i in range(b * run.save_every, (b + 1) * run.save_every):
            if remat == "full":
                state, statics, slot, aux = _checkpoint(advance, key, i, state,
                                                        statics, slot)
            else:
                state, statics, slot, aux = advance(i, state, statics, slot)
        return state, statics, slot, aux

    frames = []
    if include_t0:
        with profiling.span("msgwam.simulate.history"):
            frames.append(observe(state, statics,
                                  StepAux(dens_prop=state.rays.dens)))
    with collective.checked(axis_name):
        for b in range(run.n_steps // run.save_every):
            if remat:
                state, statics, slot, aux = _checkpoint(block, key, b, state,
                                                        statics, slot)
            else:
                state, statics, slot, aux = block(b, state, statics, slot)
            with profiling.span("msgwam.simulate.history"):
                frames.append(observe(*unsorted(state, statics, aux, slot)))
    with profiling.span("msgwam.simulate.history"):
        if use_sort:
            state, statics, _ = unsorted(state, statics, (), slot)
        if include_t0 and len(frames) > 1:
            # frame 0 takes the history's dtypes, as in the JAX package
            frames[0] = tree_map(lambda h0, h: h0.to(h.dtype), frames[0],
                                 frames[1])
        history = tree_map(lambda *xs: torch.stack(xs), *frames)
    return state, statics, history


def _broadcast(w, like):
    """A ``wind_fn`` return as a column like ``like``: scalars broadcast."""
    w = torch.as_tensor(w, device=like.device)
    return torch.broadcast_to(w, like.shape).to(like.dtype)
