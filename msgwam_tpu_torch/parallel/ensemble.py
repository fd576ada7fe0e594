"""Ensemble fan-out: many independent simulations (stochastic-source
members, parameter sweeps) with a leading ``ensemble`` axis on every leaf.

The counterpart of :mod:`msgwam_tpu.parallel.ensemble`.  ``backend="mega"``
runs the whole ensemble in one launch of the kernel K7 per ``save_every``
window (:func:`msgwam_tpu_torch.ops.step_cuda_stream.
simulate_streaming_ensemble`); ``backend="scan"`` runs the members one
after another through :func:`msgwam_tpu_torch.simulate`.  The JAX package
vmaps its scan over the members or maps it (``sequential``); torch has no
vmap of this Python loop, so the port always runs the members in turn and
``sequential`` changes nothing.

With a ``mesh`` (a ``DeviceMesh`` with an ``"ensemble"`` dimension,
:func:`msgwam_tpu_torch.parallel.make_mesh`) the members are split over
its ranks, each rank taking a contiguous block (JAX's ``P("ensemble")``),
and the member count must divide the ranks.  Each rank runs its own
members, in turn (``scan``) or as one launch a window (``mega``: K7, K6
with one member a rank); members never communicate, so the only
collective of a forward is the gather of every output, member-leading, to
every rank.  Both routes are differentiable on a mesh when every rank
computes the same loss from the gathered outputs: the backward gathers the
members' cotangents into the whole inputs' (one ``all_gather`` a leaf that
needs a gradient) and sums the background's over the ranks (one
all-reduce).  A parameter that reaches the members only through
``wind_fn`` gets its own rank's members' share.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ModelConfig, RunConfig
from ..models.integrate import simulate
from ..state import Background, RayStatics, State, tree_map

ENSEMBLE_AXIS = "ensemble"


def stack_ensemble(members):
    """Stack a list of ``(state, statics)`` members into trees with a
    leading ensemble axis."""
    states = [m[0] for m in members]
    statics = [m[1] for m in members]
    stack = lambda *xs: torch.stack(xs)
    return tree_map(stack, *states), tree_map(stack, *statics)


def _on_mesh(mesh, axis: str, run_local: Callable, states, statics, sources,
             wind_fn, bg):
    """``run_local(states, statics, sources, wind_fn, bg)`` on this rank's
    block of members, its outputs gathered member-leading to every rank.
    Differentiable: the members' split and the outputs' gather carry their
    conjugate backwards, and the replicated background, which only this
    rank's members read here, sums its cotangent over the ranks."""
    from ..ops import collective
    from .distributed import P, local_block, local_device, mesh_position
    from .sharding import gather_state

    n_members = states.rays.r.shape[0]
    i, k = mesh_position(mesh, axis)
    if n_members % k:
        raise ValueError(f"{n_members} ensemble members do not divide over "
                         f"the {k} ranks of mesh dimension {axis!r}")
    device = local_device()
    local = lambda tree: tree_map(
        lambda x: local_block(mesh, P(axis), x.to(device)), tree)
    if isinstance(wind_fn, (list, tuple)):
        wind_fn = wind_fn[i * n_members // k:(i + 1) * n_members // k]
    bg = Background(*collective.replicated(
        mesh.get_group(axis), *(x.to(device) for x in bg)))
    out = run_local(local(states), local(statics),
                    None if sources is None else local(sources), wind_fn, bg)
    return gather_state(mesh, out, tree_map(lambda _: P(axis), out))


def ensemble_simulate(
    states: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    mesh=None,
    observe: Optional[Callable] = None,
    axis: str = ENSEMBLE_AXIS,
    sequential: bool = False,
    backend: str = "scan",
    sources=None,
    wind_fn=None,
    t0: float = 0.0,
):
    """Run a batch of simulations (leading ensemble axis on every leaf of
    ``states``/``statics``), split over the ``axis`` ranks of ``mesh`` if
    given.

    ``backend="mega"`` routes the batch (each rank's members) through
    :func:`msgwam_tpu_torch.ops.step_cuda_stream.simulate_streaming_ensemble`
    (K7): online saturation, float32, the lifecycle per member with stacked
    ``sources`` templates, a shared or per-member ``wind_fn``.  It rejects
    ``observe`` and ``sequential`` and returns ``(final, statics,
    mean_history)`` with ``mean_history`` member-leading, ``(E, n_chunks,
    n_cell)``, as the scan backend's default observation.

    ``backend="scan"`` runs each member through ``simulate`` with
    ``observe`` (default: the mean wind) and stacks the results; members
    run one after another whatever ``sequential`` says.

    With ``mesh`` every rank returns the whole ensemble's outputs."""
    if backend == "mega":
        from ..ops.step_cuda_stream import simulate_streaming_ensemble

        if observe is not None:
            raise ValueError(
                "backend='mega' returns the per-member mean history "
                "directly and does not support an observe callback; "
                "post-process its mean_history or use backend='scan'")
        if sequential:
            raise ValueError(
                "backend='mega' batches all local members into one kernel "
                "launch; sequential=True is a scan-backend option")

        def run_mega(states, statics, sources, wind_fn, bg):
            fin, st, mh = simulate_streaming_ensemble(
                states, statics, bg, cfg, run, sources=sources,
                wind_fn=wind_fn, t0=t0)
            return fin, st, tree_map(lambda x: x.transpose(0, 1), mh)

        if mesh is None:
            return run_mega(states, statics, sources, wind_fn, bg)
        return _on_mesh(mesh, axis, run_mega, states, statics, sources,
                        wind_fn, bg)
    if backend != "scan":
        raise ValueError(f"unknown ensemble backend {backend!r}")
    fn = build_ensemble_fn(cfg, run, mesh=mesh, observe=observe, axis=axis,
                           sequential=sequential,
                           with_source=sources is not None, wind_fn=wind_fn,
                           t0=t0)
    if sources is None:
        return fn(states, statics, bg)
    return fn(states, statics, sources, bg)


def _default_observe(s, st, aux):
    return s.mean


def build_ensemble_fn(
    cfg: ModelConfig,
    run: RunConfig,
    mesh=None,
    observe: Optional[Callable] = None,
    axis: str = ENSEMBLE_AXIS,
    sequential: bool = False,
    with_source: bool = False,
    wind_fn: Optional[Callable] = None,
    t0: float = 0.0,
) -> Callable:
    """The ensemble runner ``f(states, statics[, sources], bg) -> (final,
    statics, history)``: each member through ``simulate`` in turn, the
    results stacked member-leading; with ``mesh``, each rank's members, the
    results gathered to every rank.  ``with_source=True`` adds a stacked
    per-member relaunch template argument.  Nothing is compiled, so nothing
    is cached; ``sequential`` changes nothing."""
    del sequential
    obs = observe or _default_observe
    pick = lambda tree, e: tree_map(lambda x: x[e], tree)

    def run_members(states, statics, sources, wind_fn, bg):
        outs = []
        for e in range(states.rays.r.shape[0]):
            source = pick(sources, e) if with_source else None
            outs.append(simulate(pick(states, e), pick(statics, e), bg, cfg,
                                 run, observe=obs, source=source,
                                 wind_fn=wind_fn, t0=t0))
        return tree_map(lambda *xs: torch.stack(xs), *outs)

    def runner(states, statics, *rest):
        *src, bg = rest
        sources = src[0] if with_source else None
        if mesh is None:
            return run_members(states, statics, sources, wind_fn, bg)
        return _on_mesh(mesh, axis, run_members, states, statics, sources,
                        wind_fn, bg)

    return runner
