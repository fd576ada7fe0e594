"""The collectives of ray sharding and their conjugates in the backward.

The one collective of a forward is the sum of the interior flux over the
ranks that hold the rays, once per RHS evaluation (three per RK3 step):
the counterpart of the JAX package's ``jax.lax.psum(pm_interior,
axis_name)`` (``msgwam_tpu/models/rhs.py``,
``msgwam_tpu/ops/rhs_pallas_windowed.py``).  Under ``shard_map`` JAX names
the mesh axis; here ``axis_name`` is the ``torch.distributed``
ProcessGroup of the mesh's ray dimension (``mesh.get_group("rays")``,
:mod:`msgwam_tpu_torch.parallel.sharding`), each rank holding a contiguous
block of the rays and the wind replicated.

Gradients.  Each rank runs its own autograd graph, and every rank computes
the same loss from whole (gathered) or replicated tensors.  Two conjugate
operators put the sums over ranks where JAX's transpose puts them, as the
paired operators of Megatron's tensor parallelism do:

- :func:`all_reduce_flux` (g) sums the flux over the ranks; its backward
  is the identity, since the flux's cotangent comes from the replicated
  wind and is already the same on every rank.
- :func:`replicated` (f) is the identity on the replicated tensors a
  rank's rays read (the wind, the background); its backward sums their
  cotangent over the ranks, since each rank holds only its own rays' part.
  The mean-flow side reads the same tensors unwrapped: its cotangent is
  already whole.

:mod:`msgwam_tpu_torch.parallel.distributed` adds the split of a whole
array into blocks and :mod:`msgwam_tpu_torch.parallel.sharding` the
gather of blocks, each the other's conjugate.  ``ALL_REDUCES`` counts the
flux's all-reduces (a forward's, and those of a forward run again in a
backward: a checkpoint's replay, a kernel's plain rerun);
``BACKWARD_ALL_REDUCES`` counts f's: one for each ray-side read of the
replicated tensors that the loss depends on (an RHS evaluation, the
offline saturation's read of the background), none in a world of 1.  The
sum ``validate_inputs`` takes of the widest ray (``models/integrate.py``)
is neither: it runs outside autograd.

A whole run (``simulate``, a ``step``) checks its group once at its entry
and runs its body under :func:`checked`, inside which the calls it makes
skip the check.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

ALL_REDUCES = 0
BACKWARD_ALL_REDUCES = 0
_CHECKED = False     # inside checked(): the run's entry made the checks


def _sum_flux(flux: torch.Tensor, group) -> torch.Tensor:
    global ALL_REDUCES
    dist.all_reduce(flux, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    return flux


class _SumFlux(torch.autograd.Function):
    """g: the sum over the ranks forward, the identity backward."""

    @staticmethod
    def forward(ctx, flux, group):
        return _sum_flux(flux.clone(memory_format=torch.contiguous_format),
                         group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_flux(flux: torch.Tensor, group) -> torch.Tensor:
    """The ``(2, n_flux)`` flux summed over ``group``'s ranks, returned: in
    place when ``flux`` is contiguous and no gradient is recorded (a copy
    otherwise).  Its backward passes the cotangent through unchanged."""
    if torch.is_grad_enabled() and flux.requires_grad:
        return _SumFlux.apply(flux, group)
    return _sum_flux(flux.contiguous(), group)


class _Replicated(torch.autograd.Function):
    """f: the identity forward, the cotangents summed over the ranks
    backward, all of one dtype in one all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        global BACKWARD_ALL_REDUCES
        out = list(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
            BACKWARD_ALL_REDUCES += 1
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return (None, *out)


def replicated(group, *xs):
    """``xs``, replicated tensors that a rank's rays read, with f's
    backward: their cotangent summed over ``group``'s ranks.  Without a
    gradient recorded, for tensors that need none, or in a group of one
    rank, ``xs`` as they are: a sum over one rank would only regroup the
    cotangent's sum, and without it a world of 1 differentiates bitwise
    as an unsharded run does."""
    need = [i for i, x in enumerate(xs)
            if isinstance(x, torch.Tensor) and x.requires_grad]
    if not (torch.is_grad_enabled() and need) or dist.get_world_size(group) == 1:
        return xs
    out = list(xs)
    for i, y in zip(need, _Replicated.apply(group, *(xs[i] for i in need))):
        out[i] = y
    return tuple(out)


def check_group(axis_name) -> None:
    """Raise unless ``axis_name`` is a ProcessGroup: JAX names a mesh
    axis, the port takes the group of the mesh dimension.  Inside
    :func:`checked` the run's entry made this check, and this returns at
    once."""
    if _CHECKED:
        return
    if not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError(
            f"axis_name must be the ProcessGroup of the ranks that share the "
            f"rays (mesh.get_group('rays')), not {axis_name!r}")


@contextlib.contextmanager
def checked(axis_name):
    """The body of a sharded run whose entry called :func:`check_group`:
    the checks of the calls inside it are skipped.  Nothing happens
    without ``axis_name`` or inside another such body."""
    global _CHECKED
    if axis_name is None or _CHECKED:
        yield
        return
    _CHECKED = True
    try:
        yield
    finally:
        _CHECKED = False
