"""K6 and K7: whole runs with the lifecycle, a prescribed wind, the launch
sort and ensembles, on the persistent cooperative Hopper kernel of K5.

Replaces ``msgwam_tpu/ops/step_pallas_stream.py`` (``_kernel``, entry
points ``_streamkernel_call``, ``simulate_streaming``,
``_simulate_streaming_ensemble_impl`` and ``simulate_streaming_ensemble``).
The CUDA source is ``csrc/step_resident.cu``, instantiated with
``kStream = true``: per step, the prescribed wind's row, K5's three
stages, and after the third stage the cull (domain exit, ``|m| > m_max``,
non-finite state) and the relaunch of inactive slots from a template, the
mask updated in place; K7 partitions the blocks among ensemble members.
The scan path (``models/integrate.py``) culls only when ``cfg.cull``;
this kernel culls when ``cfg.cull or cfg.relaunch``, as the JAX package's
streaming kernel does (``step_pallas_stream.py:1052``).

On the host, between launches, as in the JAX package: the per-step wind
table (:func:`_wind_table`), keyed templates drawn once per launch, and
the launch sort, a stable ``torch.sort`` of the heights (inactive slots
last) and one gather of all per-ray arrays stacked, with the slot ids
riding along, so that history frames and the final state come back in the
caller's slot order.  K7 orders each member's tiles as K5 orders its own
(:func:`member_tile_order`), from the same launch length and ray count
on, and puts the state back in the caller's slots after every launch.

Not ported, and why:

* ``TILE_ROWS``/``_auto_tile_rows``, the DMA double-buffering, the
  semaphores and the padding to three or more tiles
  (``step_pallas_stream.py:167-232, 1104-1110``): the TPU's fast-memory
  pipeline.  The port's tile is the kernels' 256-ray tile, nothing is
  padded, and ``tile_rows`` is accepted and changes nothing.
* ``_ablate``, a profiling switch of the TPU kernel.
* A backward for K6: :func:`simulate_streaming` is forward only, as the
  JAX package's streaming path is, and raises when an input needs a
  gradient (``simulate`` differentiates the lifecycle).  K7's
  ``custom_vjp`` is ported: :func:`simulate_streaming_ensemble`'s backward
  differentiates ``simulate`` member by member (:mod:`.adjoint`).
* ``LAUNCH_SORT_MIN = 500_000``, measured on a TPU v5e.  On the H100 the
  sort does not pay: over the configs[3] day at 1e6 rays the sorted runs
  took 0.0786 and 0.0795 s against 0.0734 and 0.0741 s unsorted, 7-8% more
  (``chip_smoke.py`` phase [11], NVIDIA H100 80GB HBM3 at 700 W), so
  ``launch_sort=None`` means off.

Float32 only (a float64 state raises ``TypeError``), ``hprop=False``
(else ``ValueError``), the lifecycle with online saturation only.  For CPU
tensors each launch runs the plain twin :func:`step_stream_reference`;
``LAUNCHES`` counts kernel launches, K6's (one member) and K7's apart.
While a profiler records, :func:`simulate_streaming` is a span
``msgwam.whole_run`` with its phases, each launch (or twin) a span
``msgwam.launch.k6`` or ``k7``, K7's ordering and restore spans
``msgwam.whole_run.sort`` and ``.frame``, and the launches add their tile
windows' tiers and their tiles' placement to K6's or K7's counts, and K7
its ordered launches (:mod:`..utils.profiling`).
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from ..state import MeanState, State, tree_map
from ..utils import profiling
from . import adjoint, rhs_cuda, step_cuda
from .step_cuda import Lifecycle

LAUNCHES = {"K6": 0, "K7": 0}


def lifecycle_for(bg, cfg, src=None) -> Lifecycle:
    """The cull bounds in float32, as the kernel compares them, and the
    relaunch template ``(dens, r, m, active)``."""
    f32 = lambda x: float(torch.tensor(float(x), dtype=torch.float32))
    return Lifecycle(f32(cfg.m_max), f32(bg.faces[0]), f32(bg.faces[-1]), src)


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch(ops, dens, r, m, uv, act, n_steps: int, life: Lifecycle = None,
           wind=None, n_members: int = 1, tiers=None):
    """One launch of ``n_steps`` steps of K6 (K7 with ``n_members > 1``):
    ``dens``, ``r``, ``m`` (``n_members * n_per`` rays, member-major), the
    ``(n_members, 2, n_tab)`` wind ``uv`` and the byte mask ``act`` are
    updated in place.  ``wind`` is ``(n_steps, 2 or 2 n_members, n_tab)``.
    ``tiers``, a :func:`..utils.profiling.tier_counter` buffer or ``None``,
    receives the launch's tile windows by tier.  Returns ``(dens, r, m, uv,
    dens_prop, act)``."""
    lib = _build.library()
    n = dens.shape[0]
    n_per = n // n_members
    device = dens.device
    relaunch = life is not None and life.src is not None
    with torch.cuda.device(device):
        with profiling.span("msgwam.whole_run.scratch"):
            plan = step_cuda.device_plan(n_per, n_members, ops, True)
            qd, qr, qm = (torch.empty_like(dens) for _ in range(3))
            r_prev = m_prev = dens_prop = None
            if not ops.online:
                r_prev, m_prev = torch.empty_like(dens), torch.empty_like(dens)
            if not ops.online or relaunch:
                dens_prop = torch.empty_like(dens)
            work = step_cuda.scratch(plan, n, n_members, ops.n_tab - 1, device)
        src = life.src if relaunch else (None,) * 4
        with profiling.span(_launch_span(n_members)):
            err = lib.msgwam_step_stream(
                *ops.scalars, ops.n_tab, ops.c_pad, ops.w1, ops.w2,
                *(x.data_ptr() for x in ops.frozen), act.data_ptr(), n_per,
                n_members, dens.data_ptr(), r.data_ptr(), m.data_ptr(),
                qd.data_ptr(), qr.data_ptr(), qm.data_ptr(),
                _ptr(r_prev), _ptr(m_prev), _ptr(dens_prop),
                uv.data_ptr(), ops.rhobar.data_ptr(), ops.pg.data_ptr(),
                ops.inv_rho.data_ptr(), *(x.data_ptr() for x in work),
                plan.blocks_per_member, n_steps, int(ops.online),
                int(ops.prognostic), int(ops.faithful), int(life is not None),
                *((life.m_max, life.face_lo, life.face_hi) if life
                  else (0.0,) * 3),
                *(_ptr(x) for x in src), _ptr(wind),
                0 if wind is None else wind.shape[1], _ptr(tiers),
                torch.cuda.current_stream(device).cuda_stream,
            )
            _build.check(err, "msgwam_step_stream")
    kernel = "K7" if n_members > 1 else "K6"
    step_cuda.count_placement(kernel, plan, n_steps, n_members)
    LAUNCHES[kernel] += 1
    if dens_prop is None:
        dens_prop = dens.clone()
    return dens, r, m, uv, dens_prop, act


def step_stream_reference(ops, dens, r, m, uv, act, n_steps: int,
                          life: Lifecycle = None, wind=None,
                          n_members: int = 1, tiers=None):
    """Plain PyTorch twin of one launch of K6/K7, with :func:`launch`'s
    arguments: each member runs K5's twin
    (:func:`msgwam_tpu_torch.ops.step_cuda.step_resident_reference`) with
    the mask, the lifecycle and its rows of the wind table.  Returns new
    ``(dens, r, m, uv, dens_prop, act)`` and modifies nothing."""
    n_per = dens.shape[0] // n_members
    outs = []
    for e in range(n_members):
        sl = slice(e * n_per, (e + 1) * n_per)
        cut = lambda x: x[sl]
        ops_e = ops._replace(frozen=tuple(map(cut, ops.frozen)),
                             active=ops.active[sl])
        life_e = life
        if life is not None and life.src is not None:
            life_e = life._replace(src=tuple(map(cut, life.src)))
        wind_e = None
        if wind is not None:
            wind_e = wind if wind.shape[1] == 2 else wind[:, 2 * e:2 * e + 2]
        outs.append(step_cuda.step_resident_reference(
            ops_e, dens[sl], r[sl], m[sl], uv[e], n_steps, act=act[sl].bool(),
            life=life_e, wind=wind_e, tiers=tiers))
    d, rr, mm, w, prop, a = (list(x) for x in zip(*outs))
    return (torch.cat(d), torch.cat(rr), torch.cat(mm), torch.stack(w),
            torch.cat(prop), torch.cat(a).to(act.dtype))


def _launch_span(n_members: int) -> str:
    return "msgwam.launch.k7" if n_members > 1 else "msgwam.launch.k6"


def _launcher(device, n_members: int):
    """The launch of K6 (K7 with ``n_members > 1``) on ``device``, or for
    CPU tensors its twin in the launch's span; either adds to the
    kernel's tier and placement counts while a profiler records."""
    kernel = "K7" if n_members > 1 else "K6"
    tiers = profiling.tier_counter(device, kernel)
    if device.type == "cuda":
        return functools.partial(launch, tiers=tiers)

    def twin(ops, dens, r, m, uv, act, n_steps, *args, **kwargs):
        with profiling.span(_launch_span(n_members)):
            out = step_stream_reference(ops, dens, r, m, uv, act, n_steps, *args,
                                        tiers=tiers, **kwargs)
        plan = step_cuda.mirror_plan(dens.shape[0] // n_members, n_members, ops)
        step_cuda.count_placement(kernel, plan, n_steps, n_members)
        return out

    return twin


def _wind_table(wind_fn, t0, ci: int, S: int, dt, n_tab: int, device):
    """The ``(S, 2, n_tab)`` float32 wind rows of launch ``ci``: ``wind_fn``
    at ``t = t0 + (ci S + j) dt`` in float32, as the scan path evaluates it
    at the start of each step; scalar returns are broadcast.  One call of
    ``wind_fn`` vectorised over the launch's times by ``torch.func.vmap``,
    as the JAX package ``jax.vmap``s it."""
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=device)
    ts = f32(t0) + torch.arange(ci * S, ci * S + S, dtype=torch.float32,
                                device=device) * f32(dt)

    def rows(t):
        return torch.stack([
            torch.broadcast_to(torch.as_tensor(w, device=device), (n_tab,))
            .to(torch.float32) for w in wind_fn(t)])

    return torch.func.vmap(rows)(ts).contiguous()


def _check_relaunch_template(src_rays, src_statics, rays, statics):
    """The kernel keeps every ray's frozen fields for the whole run and
    refills only dens, r, m and the mask; a template that changes a frozen
    field raises and names it."""
    for fname, a, b in (
        ("k", src_rays.k, rays.k),
        ("l", src_rays.l, rays.l),
        ("dr", src_rays.dr, rays.dr),
        ("dm", src_rays.dm, rays.dm),
        ("phi", src_rays.phi, rays.phi),
        ("dkk", src_statics.dkk, statics.dkk),
        ("dll", src_statics.dll, statics.dll),
        ("rr_mm_area", src_statics.rr_mm_area, statics.rr_mm_area),
    ):
        if not torch.equal(a.to(torch.float32).reshape(b.shape),
                           b.to(torch.float32)):
            raise ValueError(
                "in-kernel relaunch keeps the per-ray frozen fields "
                f"resident for the whole run, but the template's {fname!r} "
                "differs from the running state's; use simulate() for "
                "templates that change a ray's frozen properties")


def _template(src, like):
    """The relaunch slabs ``(dens, r, m, active)`` of a template, flat and
    on the state's device."""
    rays, statics = src
    f = lambda x: x.reshape(-1).to(like.device).contiguous()
    return (f(rays.dens.to(torch.float32)), f(rays.r.to(torch.float32)),
            f(rays.m.to(torch.float32)), f(statics.active))


def _guards(state, cfg, run, name: str):
    """The lifecycle flags ``(cull, relaunch)`` after the checks of every
    whole-run entry point."""
    step_cuda.check_run(state, cfg, run, name)
    do_cull = bool(cfg.cull or cfg.relaunch)
    if do_cull and not cfg.saturate_online:
        raise ValueError(
            "in-kernel culling/relaunch requires saturate_online=True; "
            "use simulate() for the offline-saturation lifecycle path")
    return do_cull, bool(cfg.relaunch)


def _sort(slabs, act, r, slot):
    """The launch sort: one stable sort of the heights with inactive slots
    last, and one gather of every per-ray slab stacked (the int32 slot ids
    ride along as float32 bits, the mask as 0/1)."""
    key = torch.where(act.bool(), r, torch.full_like(r, math.inf))
    order = torch.sort(key, stable=True).indices
    stacked = torch.stack([*slabs, act.to(torch.float32),
                           slot.view(torch.float32)])[:, order]
    return (tuple(stacked[:-2]), stacked[-2].to(act.dtype),
            stacked[-1].contiguous().view(torch.int32))


def _unsort(slot, slabs):
    """Per-ray slabs back in the caller's slot order."""
    inv = torch.argsort(slot)
    return tuple(x[inv] for x in slabs)


@profiling.spanned("msgwam.whole_run")
def simulate_streaming(state, statics, bg, cfg, run, include_t0: bool = False,
                       tile_rows: int = 0, source=None, wind_fn=None,
                       t0: float = 0.0, launch_sort=None, observe=None,
                       return_final_perm: bool = False, source_key=None):
    """Whole runs of K6: ``run.n_steps // save_every`` launches of
    ``save_every`` steps each, with the contract and history framing of
    :func:`msgwam_tpu_torch.simulate_resident`.

    With ``cfg.cull or cfg.relaunch`` the lifecycle runs in the kernel after
    every step (online saturation only); each history frame's ``active`` is
    the mask after its launch, and ``dens_prop`` the density before the
    last step's relaunch.  ``source`` is a fixed ``(RayState, RayStatics)``
    template or a callable ``source(key)`` drawing one; with a callable,
    ``source_key`` (a ``torch.Generator``) is passed to it once per launch,
    so at ``save_every=1`` the draws follow the scan path's.  A template
    may change only dens, r, m and the mask: a frozen field that differs
    raises ``ValueError`` naming it.

    ``wind_fn(t) -> (u, v)`` prescribes the wind at the start of every step
    (``t = t0 + i dt`` in float32); with ``prognostic_mean`` the wind then
    evolves through the step's stages.

    ``launch_sort=True`` sorts the rays by height before every launch
    (``None``, the default, is off: module docstring).  History frames and the
    final state come back in the caller's slot order; with
    ``return_final_perm`` the slot permutation of the last launch is
    appended to the return (``perm[i]`` is the slot at internal position
    ``i``; ``arange(n)`` without the sort).  ``tile_rows`` changes nothing
    (the TPU's streamed tile height).  Forward only, as the JAX package's
    streaming path is: ``simulate`` differentiates the lifecycle."""
    del tile_rows
    with profiling.span("msgwam.whole_run.prepare"):
        do_cull, do_relaunch = _guards(state, cfg, run, "simulate_streaming")
        if do_relaunch and source is None:
            raise ValueError("cfg.relaunch requires a source template")
        keyed_source = callable(source)
        if keyed_source and source_key is None:
            raise ValueError("a callable source requires source_key")
        _build.forward_only("simulate_streaming", "simulate()", state, statics,
                            bg)
        rhs_cuda.check_inputs(state, statics, bg, "simulate_streaming",
                              step_cuda.MAX_PAD)
        from ..models.integrate import StepAux

        rays, mean = state.rays, state.mean
        n = rays.r.shape[0]
        device = rays.r.device
        cfg = rhs_cuda.apply_champion(cfg, n)
        ops = step_cuda.operands(state, statics, bg, cfg, run.dt)
        chunk = _launcher(device, 1)
        use_sort = bool(launch_sort)
        S = run.save_every
        n_tab = bg.centers.shape[0]

        bounds = lifecycle_for(bg, cfg) if do_cull else None
        fixed_src = None
        if do_relaunch and not keyed_source:
            _check_relaunch_template(*source, rays, statics)
            fixed_src = _template(source, rays.r)

        statics0 = statics
        frozen, active = ops.frozen, statics.active
        dens, r, m = rays.dens.clone(), rays.r.clone(), rays.m.clone()
        uv = torch.stack([mean.u, mean.v])[None].contiguous()
        act = statics.active.to(torch.uint8)      # the kernel's byte mask
        slot = torch.arange(n, dtype=torch.int32, device=device)

    def to_state(dens, r, m, uv):
        return State(rays._replace(dens=dens, r=r, m=m),
                     MeanState(uv[0, 0].clone(), uv[0, 1].clone()))

    frames = []
    if include_t0:
        with profiling.span("msgwam.whole_run.frame"):
            frames.append((state, statics0.active, rays.dens) if observe is None
                          else observe(state, statics0,
                                       StepAux(dens_prop=rays.dens)))
    with torch.no_grad():
        for ci in range(run.n_steps // S):
            src = fixed_src
            if use_sort:
                with profiling.span("msgwam.whole_run.sort"):
                    slabs = (dens, r, m, *frozen)
                    if src:
                        slabs += (*src[:3], src[3].to(torch.float32))
                    slabs, act, slot = _sort(slabs, act, r, slot)
                    dens, r, m = slabs[:3]
                    frozen = slabs[3:11]
                    if src:
                        src = fixed_src = (*slabs[11:14], slabs[14].bool())
                    active = act.bool()
            if keyed_source:
                with profiling.span("msgwam.whole_run.template"):
                    t_rays, t_statics = source(source_key)
                    _check_relaunch_template(t_rays, t_statics, rays, statics0)
                    src = _template((t_rays, t_statics), rays.r)
                    if use_sort:
                        src = tuple(x[slot.long()] for x in src)
            life = bounds._replace(src=src if do_relaunch else None) \
                if do_cull else None
            wind = None
            if wind_fn is not None:
                with profiling.span("msgwam.whole_run.wind_table"):
                    wind = _wind_table(wind_fn, t0, ci, S, run.dt, n_tab, device)
            ops_c = ops._replace(frozen=tuple(x.contiguous() for x in frozen),
                                 active=active.contiguous())
            dens, r, m, uv, prop, act = chunk(
                ops_c, dens.contiguous(), r.contiguous(), m.contiguous(), uv,
                act.contiguous(), S, life, wind)
            with profiling.span("msgwam.whole_run.frame"):
                frame = (dens, r, m, prop, act)
                if use_sort:
                    frame = _unsort(slot, frame)
                fd, fr, fm, fp, fa = (x.clone() for x in frame)
                fstate = to_state(fd, fr, fm, uv)
                fact = fa.bool() if do_cull else statics0.active
                frames.append((fstate, fact, fp) if observe is None
                              else observe(fstate, statics0._replace(active=fact),
                                           StepAux(dens_prop=fp)))
    with profiling.span("msgwam.whole_run.history"):
        final = (dens, r, m, act)
        if use_sort:
            final = _unsort(slot, final)
        fd, fr, fm, fa = (x.clone() for x in final)
        final = to_state(fd, fr, fm, uv)
        statics = statics0._replace(active=fa.bool()) if do_cull else statics0
        history = tree_map(lambda *xs: torch.stack(xs), *frames)
    out = (final, statics, history)
    if return_final_perm:
        out += (slot.long() if use_sort else torch.arange(n, device=device),)
    return out


def _flat(tree):
    """Leading-member leaves ``(E, n)`` to flat ``(E n,)`` contiguous."""
    return tree_map(lambda x: x.reshape(-1).contiguous(), tree)


def simulate_streaming_ensemble(states, statics, bg, cfg, run,
                                tile_rows: int = 0, sources=None,
                                wind_fn=None, t0: float = 0.0):
    """A whole ensemble in one launch of K7 per ``save_every`` window.

    ``states``/``statics`` carry a leading member axis on every leaf (the
    :func:`msgwam_tpu_torch.parallel.stack_ensemble` layout); the members
    share ``bg`` and ``cfg``.  Each member's rays are their own tiles and
    blocks in the kernel, with their own wind, tables and flux.  ``wind_fn``
    is one function of time shared by the members or a sequence of one
    per member.  With ``cfg.relaunch``, ``sources`` is a stacked ``(RayState,
    RayStatics)`` template pair; a callable source raises, as in the JAX
    package.  Float32, ``hprop=False``, online saturation.  Launches of at
    least ``step_cuda.ORDER_MIN_STEPS`` steps and ``ORDER_MIN_RAYS`` rays in
    all run on each member's tiles in K5's order (:func:`_ensemble_kernel`).

    Returns ``(final_states, statics, mean_history)``: the final states with
    the member axis back, and the mean wind after every launch as a
    :class:`MeanState` of ``(n_chunks, E, n_cell)``.

    Differentiable in the states, the statics and the background: the
    backward differentiates :func:`msgwam_tpu_torch.simulate` on the
    composable path member by member, each with its own ``sources`` row
    and its own ``wind_fn`` (:func:`_ensemble_plain`), as the JAX
    package's ``simulate_streaming_ensemble`` does; the statics come back
    as they went in there.  ``sources`` and ``wind_fn`` are constants."""
    del tile_rows
    if not cfg.saturate_online:
        raise ValueError(
            "simulate_streaming_ensemble requires saturate_online=True")
    do_cull, do_relaunch = _guards(states, cfg, run,
                                   "simulate_streaming_ensemble")
    if do_relaunch and sources is None:
        raise ValueError(
            "cfg.relaunch requires stacked per-member source templates "
            "(sources=(RayState, RayStatics) with a leading ensemble axis)")
    if callable(sources):
        raise ValueError(
            "keyed (callable) sources are supported by the single-member "
            "simulate_streaming only; run members separately, or draw the "
            "stacked templates before the call")
    rays, mean = states.rays, states.mean
    E, n = rays.r.shape
    per_member_wind = isinstance(wind_fn, (list, tuple))
    if per_member_wind and len(wind_fn) != E:
        raise ValueError(
            f"per-member wind_fn sequence has {len(wind_fn)} entries "
            f"for {E} ensemble members")
    return adjoint.kernel_call(
        functools.partial(_ensemble_kernel, cfg=cfg, run=run, sources=sources,
                          wind_fn=wind_fn, t0=t0, do_cull=do_cull,
                          do_relaunch=do_relaunch),
        functools.partial(_ensemble_plain, cfg=cfg, run=run, sources=sources,
                          wind_fn=wind_fn, t0=t0),
        states, statics, bg)


def _ensemble_plain(states, statics, bg, cfg, run, sources, wind_fn, t0):
    """What K7's backward differentiates: ``simulate`` on the composable
    path, member by member; the statics are returned as they came."""
    from ..models.integrate import simulate

    xla_cfg = adjoint.plain_config(cfg, window_cells=0)
    finals, means = [], []
    for e in range(states.rays.r.shape[0]):
        member = lambda tree: tree_map(lambda x: x[e], tree)
        final, _, hist = simulate(
            member(states), member(statics), bg, xla_cfg, run,
            source=None if sources is None else member(sources),
            wind_fn=wind_fn[e] if isinstance(wind_fn, (list, tuple)) else wind_fn,
            t0=t0, validate=False)
        finals.append(final)
        means.append(hist[0].mean)
    stack = lambda *xs: torch.stack(xs, dim=0)
    mean_hist = tree_map(lambda *xs: torch.stack(xs, dim=1), *means)
    return tree_map(stack, *finals), statics, mean_hist


def member_tile_order(ops, r, m, active, n_members: int):
    """K7's tile order: :func:`step_cuda.tile_order` within each member's
    slot range ``[e n, (e + 1) n)`` of the flat member-major ``r``, ``m``
    and ``active``, as flat slot indices, so that K7's blocks still find
    each member's rays in its own range."""
    n = r.shape[0] // n_members
    order = step_cuda.tile_order(ops, r.view(n_members, n), m.view(n_members, n),
                                 active.view(n_members, n))
    offset = torch.arange(0, n_members * n, n, device=r.device)
    return (order + offset[:, None]).reshape(-1)


def _ensemble_kernel(states, statics, bg, cfg, run, sources, wind_fn, t0,
                     do_cull, do_relaunch):
    """The K7 launches of :func:`simulate_streaming_ensemble`.  From
    ``step_cuda.ORDER_MIN_STEPS`` steps and ``ORDER_MIN_RAYS`` rays in all,
    each launch runs on :func:`member_tile_order`'s slots, gathered from
    the caller-order state the last launch left, and one ``index_copy_``
    puts ``(dens, r, m, active)`` back in the caller's slots after it, as
    K5's launch loop does."""
    rays, mean = states.rays, states.mean
    E, n = rays.r.shape
    per_member_wind = isinstance(wind_fn, (list, tuple))
    flat_rays, flat_statics = _flat(rays), _flat(statics)
    flat_state = State(flat_rays, MeanState(mean.u[0], mean.v[0]))
    rhs_cuda.check_inputs(flat_state, flat_statics, bg,
                          "simulate_streaming_ensemble", step_cuda.MAX_PAD)
    cfg = rhs_cuda.apply_champion(cfg, E * n)
    ops = step_cuda.operands(flat_state, flat_statics, bg, cfg, run.dt)
    device = flat_rays.r.device
    chunk = _launcher(device, E)
    src = None
    if do_relaunch:
        _check_relaunch_template(*sources, rays, statics)
        src = _template(sources, flat_rays.r)
    life = lifecycle_for(bg, cfg, src) if do_cull else None
    S = run.save_every
    n_tab = bg.centers.shape[0]
    ordered = (S >= step_cuda.ORDER_MIN_STEPS
               and E * n >= step_cuda.ORDER_MIN_RAYS)
    if ordered:
        frozen = torch.stack(ops.frozen)
        if src:
            template = torch.stack([*src[:3], src[3].to(torch.float32)])

    dens, r, m = (x.clone() for x in (flat_rays.dens, flat_rays.r, flat_rays.m))
    uv = torch.stack([mean.u, mean.v], dim=1).contiguous()     # (E, 2, n_tab)
    act = flat_statics.active.to(torch.uint8)
    history = []
    with torch.no_grad():
        for ci in range(run.n_steps // S):
            wind = None
            if per_member_wind:
                wind = torch.cat([_wind_table(f, t0, ci, S, run.dt, n_tab, device)
                                  for f in wind_fn], dim=1).contiguous()
            elif wind_fn is not None:
                wind = _wind_table(wind_fn, t0, ci, S, run.dt, n_tab, device)
            tile_ops, tile_life, work = ops, life, (dens, r, m, act)
            if ordered:
                with profiling.span("msgwam.whole_run.sort"):
                    order = member_tile_order(ops, r, m, act.bool(), E)
                    slabs = torch.stack([dens, r, m, act.to(torch.float32)]
                                        ).index_select(1, order)
                    work = (*slabs[:3], slabs[3].to(torch.uint8))
                    tile_ops = ops._replace(
                        frozen=tuple(frozen.index_select(1, order)))
                    if src:
                        t = template.index_select(1, order)
                        tile_life = life._replace(src=(*t[:3], t[3].bool()))
            dens, r, m, uv, _, act = chunk(tile_ops, *work[:3], uv, work[3], S,
                                           tile_life, wind, n_members=E)
            profiling.add_order("K7", ordered)
            with profiling.span("msgwam.whole_run.frame"):
                if ordered:       # back to the caller's slots
                    out = torch.stack([dens, r, m, act.to(torch.float32)])
                    out = torch.empty_like(out).index_copy_(1, order, out)
                    dens, r, m, act = (*out[:3], out[3].to(torch.uint8))
                history.append(uv.clone())
    member = lambda x: x.reshape(E, n)
    final = State(rays._replace(dens=member(dens), r=member(r), m=member(m)),
                  MeanState(uv[:, 0].clone(), uv[:, 1].clone()))
    if do_cull:
        statics = statics._replace(active=member(act.bool()))
    huv = torch.stack(history)                                 # (chunks, E, 2, n_tab)
    return final, statics, MeanState(huv[:, :, 0], huv[:, :, 1])
