"""Ray-axis sharding over the ranks of a mesh: the counterpart of
:mod:`msgwam_tpu.parallel.sharding`.

Rays are independent except at one point: the flux's reduction onto the
shared vertical grid inside the RHS.  Each rank holds a contiguous block
of ``capacity / world`` ray slots (rank i the rows ``[i n / k, (i + 1) n /
k)``, JAX's ``P("rays")`` layout), deposits its own flux, and one
``torch.distributed.all_reduce`` of the ``(2, n_cell - 1)`` interior flux
per RHS evaluation (three per RK3 step) gives every rank the whole
profile, after which each computes the same wind update: the wind, the
background and the config are replicated.  The kernel routes shard alike:
K1 and K2 run on the rank's rays with the all-reduce after them, K4 takes
its flux tail (:mod:`msgwam_tpu_torch.ops.rhs_cuda_windowed`).

JAX runs one program over the mesh and returns global arrays; here each
rank runs this module's functions on its own block and gets its own block
back: :func:`gather_state` assembles whole arrays on every rank.  The sums
over ranks take another order than one rank's sum, so a sharded run
matches an unsharded one to roundoff, not bitwise.  A callable (keyed)
source is refused, as in the JAX package.

Gradients follow ``requires_grad``, as ``jax.grad`` runs through
``shard_map``, provided every rank computes the same loss from whole
(gathered) or replicated outputs.  The backward of :func:`shard_state`'s
split gathers the blocks' cotangents into the whole array's (one
``all_gather`` a leaf that needs a gradient), so a replicated parameter
upstream of the state gets its whole gradient on every rank; the backward
of :func:`gather_state` keeps this rank's block of a cotangent that is the
same on every rank; the RHS adds one all-reduce an evaluation for the
replicated wind's and background's cotangent
(:mod:`msgwam_tpu_torch.ops.collective`).  Bool and integer leaves carry
no gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import ModelConfig, RunConfig
from ..models.integrate import simulate, step
from ..state import Background, MeanState, RayState, RayStatics, State, tree_map
from .distributed import (P, all_gather, global_mesh, initialize, local_block,
                          local_device, mesh_position)

RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None, axis: str = RAY_AXIS):
    """A 1-D mesh named ``axis`` over every rank of the world, after
    :func:`~msgwam_tpu_torch.parallel.distributed.initialize` where no
    process group exists yet.  ``n_devices`` must be the world's size: a
    rank cannot leave the world's collectives."""
    initialize()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}) in a world of {world} ranks: the mesh "
            f"spans every rank; start {n_devices} ranks (torchrun "
            f"--nproc_per_node {n_devices}) or pass n_devices=None")
    return global_mesh((world,), (axis,))


def ray_sharding_specs(axis: str = RAY_AXIS):
    """Partition specs for ``(State, RayStatics)``: ray fields split along
    ``axis``, mean-flow fields replicated."""
    ray = P(axis)
    rep = P()
    state_spec = State(
        RayState(*([ray] * len(RayState._fields))),
        MeanState(rep, rep),
    )
    statics_spec = RayStatics(ray, ray, ray, ray)
    return state_spec, statics_spec


def _place(mesh, spec_tree, tree):
    # to the device first: the split's backward then runs on the device's
    # autograd thread, in order with the run's other collectives
    device = local_device()
    return tree_map(lambda s, x: local_block(mesh, s, x.to(device)),
                    spec_tree, tree)


def shard_state(mesh, state: State, statics: RayStatics, axis: str = RAY_AXIS):
    """This rank's ``(state, statics)`` from the whole ones (the same on
    every rank): its block of every ray field, the wind whole, on its
    device."""
    n = state.rays.dens.shape[0]
    k = mesh_position(mesh, axis)[1]
    if n % k:
        raise ValueError(
            f"ray capacity {n} is not divisible by the mesh size {k}; "
            f"pad with msgwam_tpu_torch.pad_rays to a multiple first")
    state_spec, statics_spec = ray_sharding_specs(axis)
    return _place(mesh, state_spec, state), _place(mesh, statics_spec, statics)


def sharded_step_fn(mesh, bg: Background, cfg: ModelConfig, dt: float,
                    axis: str = RAY_AXIS) -> Callable:
    """One model step sharded over the ray axis: ``f(state, statics) ->
    (state, statics)`` on this rank's block (:func:`shard_state`'s)."""
    mesh.get_group(axis)    # the mesh has the dimension

    def f(state, statics):
        # the group looked up a call, so that a kept runner keeps no group
        # alive past the world's end (distributed.shutdown)
        state, statics, _ = step(dt, state, statics, bg, cfg,
                                 axis_name=mesh.get_group(axis))
        return state, statics

    return f


def sharded_simulate(mesh, state: State, statics: RayStatics, bg: Background,
                     cfg: ModelConfig, run: RunConfig,
                     observe: Optional[Callable] = None, observe_spec=None,
                     source=None, axis: str = RAY_AXIS):
    """:func:`msgwam_tpu_torch.simulate` sharded over the ray axis, from
    the whole state (and relaunch ``source`` template) on every rank:
    returns this rank's ``(final, statics, history)``.  ``observe``
    defaults to the (replicated) wind per saved step; a custom
    ``observe`` needs a matching ``observe_spec`` tree of :class:`P` for
    its output, which :func:`gather_state` reads."""
    fn = build_sharded_simulate_fn(mesh, cfg, run, observe=observe,
                                   observe_spec=observe_spec, axis=axis)
    state, statics = shard_state(mesh, state, statics, axis)
    if source is None:
        return fn(state, statics, bg)
    if callable(source):
        raise ValueError(
            "a callable (keyed) source is not supported on the sharded "
            "path, as in the JAX package: draw the template first")
    state_spec, statics_spec = ray_sharding_specs(axis)
    return fn(state, statics, bg, (_place(mesh, state_spec.rays, source[0]),
                                   _place(mesh, statics_spec, source[1])))


def _default_observe(s, st, aux):
    return s.mean


def full_history_observe(s, st, aux):
    """``observe`` matching :func:`simulate`'s default history tuple
    ``(state, active, dens_prop)``: with :func:`full_history_observe_spec`
    it gives the unsharded driver's history structure from a sharded
    run."""
    return (s, st.active, aux.dens_prop)


def full_history_observe_spec(axis: str = RAY_AXIS):
    """The specs of :func:`full_history_observe`: history frames carry a
    leading time axis, so per-ray buffers are ``(n_frames, capacity)``
    split on axis 1; the wind is replicated."""
    ray = P(None, axis)
    state_spec = State(
        RayState(*([ray] * len(RayState._fields))),
        MeanState(P(), P()),
    )
    return (state_spec, ray, ray)


def build_sharded_simulate_fn(mesh, cfg: ModelConfig, run: RunConfig,
                              observe: Optional[Callable] = None,
                              observe_spec=None,
                              axis: str = RAY_AXIS) -> Callable:
    """The sharded runner ``f(state, statics, bg[, source]) -> (final,
    statics, history)`` on this rank's blocks, each RHS's flux summed over
    the mesh dimension ``axis``; ``f.out_specs`` are the specs of its
    outputs, for :func:`gather_state`.  Nothing is compiled, so nothing is
    cached."""
    state_spec, statics_spec = ray_sharding_specs(axis)
    if observe is None:
        observe = _default_observe
        observe_spec = MeanState(P(), P())
    elif observe_spec is None:
        raise ValueError("custom observe requires observe_spec")
    mesh.get_group(axis)    # the mesh has the dimension
    device = local_device()

    def run_sharded(state, statics, bg, source=None):
        # the group looked up a call, as in sharded_step_fn
        bg = tree_map(lambda x: x.to(device), bg)
        return simulate(state, statics, bg, cfg, run, observe=observe,
                        source=source, axis_name=mesh.get_group(axis))

    run_sharded.out_specs = (state_spec, statics_spec, observe_spec)
    return run_sharded


def _default_spec(tree, axis: str):
    if isinstance(tree, State):
        return ray_sharding_specs(axis)[0]
    if isinstance(tree, RayStatics):
        return ray_sharding_specs(axis)[1]
    if isinstance(tree, RayState):
        return ray_sharding_specs(axis)[0].rays
    if isinstance(tree, MeanState):
        return MeanState(P(), P())
    raise ValueError("gather_state: pass the spec of this tree (for a "
                     "history: the runner's out_specs)")


class _Gather(torch.autograd.Function):
    """The gather of the ranks' blocks into the whole array; backward,
    this rank's block of the whole array's cotangent, which is the same
    on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def _gather(mesh, spec: P, x: torch.Tensor) -> torch.Tensor:
    split = spec.split()
    if split is None:
        return x
    d, name = split
    group = mesh.get_group(name)
    if x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, d, group)
    return all_gather(x, d, group)


def gather_state(mesh, tree, spec=None, axis: str = RAY_AXIS):
    """The whole arrays of a sharded tree, on every rank: each split leaf
    gathered from the ranks in their order along its split dimension
    (axis 1 for history frames), replicated leaves as they are.  ``spec``
    defaults to the layout of a ``State``, ``RayState``, ``RayStatics`` or
    ``MeanState`` (the wind history of the default ``observe``); a history
    of :func:`full_history_observe` takes :func:`full_history_observe_spec`,
    other trees their runner's ``out_specs``."""
    if spec is None:
        spec = _default_spec(tree, axis)
    return tree_map(lambda s, x: _gather(mesh, s, x), spec, tree)
