"""The one collective of ray sharding: the sum of the interior flux over
the ranks that hold the rays, once per RHS evaluation (three per RK3
step).

The counterpart of the JAX package's ``jax.lax.psum(pm_interior,
axis_name)`` (``msgwam_tpu/models/rhs.py``,
``msgwam_tpu/ops/rhs_pallas_windowed.py``).  Under ``shard_map`` JAX names
the mesh axis; here ``axis_name`` is the ``torch.distributed``
ProcessGroup of the mesh's ray dimension (``mesh.get_group("rays")``,
:mod:`msgwam_tpu_torch.parallel.sharding`), each rank holding a contiguous
block of the rays and the wind replicated.  ``ALL_REDUCES`` counts the
calls.

The sharded routes are forward only: :func:`forward_only` refuses an input
that needs a gradient.  A whole run (``simulate``, a ``step``) makes that
check once at its entry and runs under :func:`checked`, inside which the
RHS evaluations skip it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .._build import _tensors

ALL_REDUCES = 0
_CHECKED = False     # inside checked(): the run's entry made the checks


def all_reduce_flux(flux: torch.Tensor, group) -> torch.Tensor:
    """The ``(2, n_flux)`` flux summed over ``group``'s ranks: in place
    when ``flux`` is contiguous (a copy otherwise), and returned."""
    global ALL_REDUCES
    flux = flux.contiguous()
    dist.all_reduce(flux, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    return flux


def check_group(axis_name) -> None:
    """Raise unless ``axis_name`` is a ProcessGroup: JAX names a mesh
    axis, the port takes the group of the mesh dimension."""
    if not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError(
            f"axis_name must be the ProcessGroup of the ranks that share the "
            f"rays (mesh.get_group('rays')), not {axis_name!r}")


def forward_only(name: str, axis_name, *trees) -> None:
    """The checks of a sharded call: ``axis_name`` a ProcessGroup
    (:func:`check_group`), and no input that needs a gradient: the
    all-reduce has no backward here, and no JAX test differentiates a
    sharded run.  Inside :func:`checked` the run's entry made these
    checks, and this returns at once."""
    if _CHECKED:
        return
    check_group(axis_name)
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(trees)):
        raise NotImplementedError(
            f"{name} with axis_name (ray sharding) is forward only; run it "
            f"under torch.no_grad(), or use the unsharded route "
            f"(axis_name=None) for gradients")


@contextlib.contextmanager
def checked(axis_name):
    """The body of a sharded run whose entry called :func:`forward_only`:
    under ``torch.no_grad()``, with the checks of the calls inside it
    skipped.  Nothing happens without ``axis_name`` or inside another
    such body."""
    global _CHECKED
    if axis_name is None or _CHECKED:
        yield
        return
    _CHECKED = True
    try:
        with torch.no_grad():
            yield
    finally:
        _CHECKED = False
