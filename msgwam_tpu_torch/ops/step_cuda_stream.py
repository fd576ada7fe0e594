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

The entry points check their route and hand it as data to K5's launch loop
(:func:`msgwam_tpu_torch.ops.step_cuda.whole_run`): the cull bounds, a
fixed template or keyed ones drawn each launch, each launch's rows of the
run's wind table (:func:`_winds`), and K6's launch sort or K7's tile
order.  None of it waits on the card: the bounds come from the grid's host
copy (:func:`..step_cuda.host_list`), the wind table is built once a run
with no host-to-device copy, and a fixed template's check reads one
device flag vector; so each launch queues behind the one still running.

Not ported, and why:

* ``TILE_ROWS``/``_auto_tile_rows``, the DMA double-buffering, the
  semaphores and the padding to three or more tiles
  (``step_pallas_stream.py:167-232, 1104-1110``): the TPU's fast-memory
  pipeline.  The port's tile is the kernels' 256 rays; ``tile_rows`` does
  nothing.
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
Spans and counts as K5's loop keeps them (``msgwam.launch.k6``/``k7``),
and the wind tables built and the launches that read one
(``profiling.counts()["wind"]``).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..state import tree_map
from ..utils import profiling
from . import adjoint, step_cuda
from .step_cuda import Lifecycle

LAUNCHES = {"K6": 0, "K7": 0}
# The most a run's wind table may hold at once, in bytes: a longer run's is
# built in chunks of whole launches, each one vmap of ``wind_fn``.
WIND_TABLE_BYTES = 64 << 20


def lifecycle_for(bg, cfg, src=None) -> Lifecycle:
    """The cull bounds in float32, as the kernel compares them, and the
    relaunch template ``(dens, r, m, active)``; the faces from their host
    copy (:func:`..step_cuda.host_list`)."""
    f32 = lambda x: float(torch.tensor(float(x), dtype=torch.float32))
    faces = step_cuda.host_list(bg.faces)
    return Lifecycle(f32(cfg.m_max), f32(faces[0]), f32(faces[-1]), src)


def step_stream_reference(ops, dens, r, m, uv, act, n_steps: int,
                          life: Lifecycle = None, wind=None,
                          n_members: int = 1, tiers=None):
    """Plain PyTorch twin of one launch of K5-K7, with
    :func:`..step_cuda.launch`'s arguments: each member runs K5's twin
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
        life_e = life if life is None or life.src is None else \
            life._replace(src=tuple(map(cut, life.src)))
        wind_e = (wind if wind is None or wind.shape[1] == 2
                  else wind[:, 2 * e:2 * e + 2])
        outs.append(step_cuda.step_resident_reference(
            ops_e, dens[sl], r[sl], m[sl], uv[e], n_steps, act=act[sl].bool(),
            life=life_e, wind=wind_e, tiers=tiers))
    d, rr, mm, w, prop, a = (list(x) for x in zip(*outs))
    return (torch.cat(d), torch.cat(rr), torch.cat(mm), torch.stack(w),
            torch.cat(prop), torch.cat(a).to(act.dtype))


def _wind_table(wind_fn, t0, ci: int, S: int, dt, n_tab: int, device,
                n_launches: int = 1):
    """The ``(n_launches S, 2, n_tab)`` float32 wind rows of launches
    ``ci`` .. ``ci + n_launches - 1``: ``wind_fn`` at ``t = t0 + (ci S + j)
    dt`` in float32, as the scan path evaluates it at the start of each
    step; scalar returns are broadcast.  One call of ``wind_fn`` vectorised
    over the times by ``torch.func.vmap``, as the JAX package ``jax.vmap``s
    it; the float32 scalars are made on ``device`` (``torch.full``, no
    host-to-device copy), so the host does not wait on the card here, and
    launch ``ci``'s rows are the same whatever ``n_launches`` is."""
    f32 = lambda x: torch.full((), float(x), dtype=torch.float32, device=device)
    ts = f32(t0) + torch.arange(ci * S, (ci + n_launches) * S,
                                dtype=torch.float32, device=device) * f32(dt)

    def row(w):
        if isinstance(w, (int, float)):        # made on the card, not copied
            w = torch.full((), w, dtype=torch.float32, device=device)
        return torch.broadcast_to(torch.as_tensor(w, device=device),
                                  (n_tab,)).to(torch.float32)

    def rows(t):
        return torch.stack([row(w) for w in wind_fn(t)])

    return torch.func.vmap(rows)(ts).contiguous()


def _check_relaunch_template(src_rays, src_statics, rays, statics):
    """The kernel keeps every ray's frozen fields for the whole run and
    refills only dens, r, m and the mask; a template that changes a frozen
    field raises and names the first that does.  The eight fields are
    compared where they lie, as ``torch.equal`` compares them (a NaN
    differs), and their flags read in one copy to the host."""
    names, differs = [], []
    for src, own, fields in ((src_rays, rays, ("k", "l", "dr", "dm", "phi")),
                             (src_statics, statics, ("dkk", "dll", "rr_mm_area"))):
        for fname in fields:
            a, b = (getattr(x, fname).to(torch.float32) for x in (src, own))
            names.append(fname)
            differs.append(torch.ne(a.reshape(b.shape), b).any())
    flags = torch.stack(differs).tolist()
    if any(flags):
        raise ValueError(
            "in-kernel relaunch keeps the per-ray frozen fields "
            f"resident for the whole run, but the template's "
            f"{names[flags.index(True)]!r} differs from the running state's; "
            "use simulate() for templates that change a ray's frozen "
            "properties")


def _template(src, like):
    """The relaunch rows ``(dens, r, m, active)`` of a template: float32
    ``(4, n)``, flat, on the state's device."""
    rays, statics = src
    return torch.stack([x.reshape(-1).to(like.device, torch.float32)
                        for x in (rays.dens, rays.r, rays.m, statics.active)])


def _winds(wind_fn, t0, run, bg, like, kernel: str):
    """Launch ``ci``'s wind table as a function of ``ci``: ``wind_fn``'s
    rows, or for a sequence of one function per member theirs side by side
    (``(S, 2 E, n_tab)``); ``None`` without a wind.  The run's table is
    built at its first launch, ``[ci S, (ci + 1) S)`` of it a launch: one
    vmap of each function over all the run's steps, or, where that would
    pass ``WIND_TABLE_BYTES``, over as many whole launches as fit, built
    when the first of them runs.  Each call counts a launch, and each
    build a table, to ``kernel``'s ``profiling.counts()["wind"]``."""
    if wind_fn is None:
        return None
    fns = wind_fn if isinstance(wind_fn, (list, tuple)) else [wind_fn]
    n_tab = bg.centers.shape[0]
    S, n_launches = run.save_every, run.n_steps // run.save_every
    per_chunk = max(1, WIND_TABLE_BYTES // (S * 2 * len(fns) * n_tab * 4))
    chunk = [None, None]          # the built chunk's first launch, its table

    def table(ci):
        c0 = ci - ci % per_chunk
        new = chunk[0] != c0
        if new:
            rows = [_wind_table(f, t0, c0, S, run.dt, n_tab, like.device,
                                min(per_chunk, n_launches - c0)) for f in fns]
            chunk[:] = c0, rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
        profiling.add_wind(kernel, new)
        return chunk[1][(ci - c0) * S:(ci - c0 + 1) * S]

    return table


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
    do_cull, do_relaunch = _guards(state, cfg, run, "simulate_streaming")
    if do_relaunch and source is None:
        raise ValueError("cfg.relaunch requires a source template")
    keyed_source = callable(source)
    if keyed_source and source_key is None:
        raise ValueError("a callable source requires source_key")
    _build.forward_only("simulate_streaming", "simulate()", state, statics, bg)
    rays = state.rays
    template = draw = None
    if keyed_source:
        def draw():
            t_rays, t_statics = source(source_key)
            _check_relaunch_template(t_rays, t_statics, rays, statics)
            return _template((t_rays, t_statics), rays.r)
    elif do_relaunch:
        _check_relaunch_template(*source, rays, statics)
        template = _template(source, rays.r)
    return step_cuda.whole_run(
        state, statics, bg, cfg, run, "simulate_streaming", stream=True,
        order="heights" if launch_sort else None,
        life=lifecycle_for(bg, cfg) if do_cull else None, relaunch=do_relaunch,
        template=template, draw=draw,
        wind=_winds(wind_fn, t0, run, bg, rays.r, "K6"),
        observe=observe, include_t0=include_t0,
        return_final_perm=return_final_perm)


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
    all run on each member's tiles in K5's order (:func:`..step_cuda.
    tile_order`).

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
    rays = states.rays
    E = rays.r.shape[0]
    if isinstance(wind_fn, (list, tuple)) and len(wind_fn) != E:
        raise ValueError(
            f"per-member wind_fn sequence has {len(wind_fn)} entries "
            f"for {E} ensemble members")
    template = None
    if do_relaunch:
        _check_relaunch_template(*sources, rays, statics)
        template = _template(sources, rays.r)
    return adjoint.kernel_call(
        functools.partial(
            step_cuda.whole_run, cfg=cfg, run=run,
            name="simulate_streaming_ensemble", stream=True, members=True,
            order="tiles", life=lifecycle_for(bg, cfg) if do_cull else None,
            relaunch=do_relaunch, template=template,
            wind=_winds(wind_fn, t0, run, bg, rays.r,
                        step_cuda.kernel_name(True, E)),
            observe=lambda state, statics, aux: state.mean),
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
