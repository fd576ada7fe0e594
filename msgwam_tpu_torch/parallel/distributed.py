"""Process groups, meshes and the placement of host arrays: the
counterpart of :mod:`msgwam_tpu.parallel.distributed`.

JAX runs one controller over every device of a mesh.  PyTorch runs one
process per rank (SPMD), started by ``torchrun`` or spawned, each with its
own device; a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the world, and the process group of one of its dimensions is what the
port's ``axis_name`` arguments take.

:func:`initialize` sets up the default process group once per process:
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), from an explicit ``init_method``
(``file://`` or ``tcp://localhost:<port>``) with ``world_size`` and
``rank``, or, with neither, as a world of 1 inside this process.  Each
rank's device is ``cuda:LOCAL_RANK`` unless the caller names another one
(``device="cpu"``).  The backend is NCCL on the card and gloo on the CPU
unless the caller names it; it is never switched behind the caller's
back.  NCCL takes one rank per card: two ranks on one card raise, naming
gloo, whose ``all_reduce`` takes CUDA tensors (and whose ``all_gather``
:func:`all_gather` runs through the host).

Only ensemble members should be split across hosts (members never
communicate), so a 2-D ``('ensemble', 'rays')`` mesh puts ``ensemble``
first, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import socket
import traceback
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..state import tree_map

_DEVICE: Optional[torch.device] = None
_MESHES = weakref.WeakSet()     # :func:`global_mesh`'s, for :func:`shutdown`


class P:
    """A partition spec, the counterpart of ``jax.sharding.PartitionSpec``:
    for each leading dimension of a leaf, the mesh dimension it is split
    over, or ``None``; ``P()`` is replicated.  A leaf, not a tuple, so that
    a tree of specs maps like the state tree it describes."""

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def split(self):
        """``(dim, mesh dimension name)`` of the split, or ``None``."""
        for d, name in enumerate(self.dims):
            if name is not None:
                return d, name
        return None

    def __eq__(self, other):
        return isinstance(other, P) and self.dims == other.dims

    def __repr__(self):
        return f"P{self.dims!r}"


def check_one_rank_per_card(devices: Sequence[str]) -> None:
    """Raise when two ranks of an NCCL world name one card (``devices``:
    each rank's ``host/index``): NCCL refuses that, and gloo is the
    backend that runs two ranks on one card."""
    seen = {}
    for rank, dev in enumerate(devices):
        if dev in seen:
            raise RuntimeError(
                f"NCCL takes one rank per card, and ranks {seen[dev]} and "
                f"{rank} are both on {dev}: start one rank per card, or pass "
                f"backend='gloo' to run several ranks on one card")
        seen[dev] = rank


def _rank_device(device, local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a rank runs on cuda:LOCAL_RANK unless the "
                "caller names another device; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> torch.device:
    """Set up this process's rank and return its device; a no-op (that
    returns the device) when the default process group exists.

    Without arguments: ``torchrun``'s environment where it is set, else a
    world of 1 in this process (an in-memory store, no socket).  The
    default ``backend`` is ``"nccl"`` for a CUDA device and ``"gloo"``
    otherwise."""
    global _DEVICE
    if dist.is_initialized():
        return local_device()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank or 0))
    device = _rank_device(device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend runs on the card, not on {device}")
    if init_method is None and world_size in (None, 1):
        store, rank, world_size = dist.HashStore(), 0, 1
    else:
        store, rank, world_size = next(dist.rendezvous(
            init_method or "env://", -1 if rank is None else rank,
            -1 if world_size is None else world_size))
    if backend == "nccl":
        store.set(f"msgwam_device/{rank}",
                  f"{socket.gethostname()}/cuda:{device.index}")
        check_one_rank_per_card([
            store.get(f"msgwam_device/{r}").decode() for r in range(world_size)])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    _DEVICE = device
    return device


def shutdown(barrier: bool = True) -> None:
    """End the world of this process, so that no thread of its process
    groups outlives it: a barrier on the default group (no rank closes its
    connections while a peer still uses them; ``barrier=False`` on an
    error, where a peer may never reach it), then the groups of the
    meshes that :func:`global_mesh` made are let go and every process group
    is destroyed, the meshes' groups before the default one
    (``destroy_process_group`` takes them in the reverse order of their
    creation).  With no other reference left, each group's destructor joins
    its worker threads here.  A no-op without a process group.

    Why: a gloo worker thread drops its last finished collective (and the
    tensors it holds, whose Python objects it must release under the
    interpreter lock) some time after the caller has gone on.  A mesh keeps
    its groups, and so those threads, alive; if the interpreter is already
    finalizing when such a thread asks for the lock, Python ends the thread
    and C++ aborts the process (``terminate called without an active
    exception``, exit -6), after the rank's work is done.  So every world
    the port starts ends here (through :func:`world`, or here directly in
    a rank's own process), and a caller holds no group of a mesh
    (``mesh.get_group``) past this call.  The JAX package has no
    counterpart, since JAX shuts its own distributed runtime down, so
    :mod:`msgwam_tpu_torch.parallel` does not export it: its callers are
    the port's entry points, scripts and tests."""
    global _DEVICE
    if not dist.is_initialized():
        return
    if barrier and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    elif barrier:
        dist.barrier()
    for mesh in list(_MESHES):
        # DeviceMesh holds its dimensions' groups by name in this registry
        getattr(mesh, "_pg_registry", {}).clear()
    _MESHES.clear()
    dist.destroy_process_group()
    _DEVICE = None


@contextlib.contextmanager
def world(**kwargs):
    """:func:`initialize` (``kwargs``) for the span of a ``with`` block,
    which gets this rank's device, ended by :func:`shutdown` if it was made
    here (a world that existed before is left to its maker): with the
    barrier after the block, without it when the block raised.  On that
    path the finished frames of the traceback let their locals go first,
    so that a group one of them held is destroyed with the rest.  Private
    to the port's callers, as :func:`shutdown`."""
    created = not dist.is_initialized()
    device = initialize(**kwargs)
    try:
        yield device
    except BaseException as e:
        if created:
            traceback.clear_frames(e.__traceback__)
            shutdown(barrier=False)
        raise
    if created:
        shutdown()


def local_device() -> torch.device:
    """This rank's device (:func:`initialize`'s; for a process group set
    up elsewhere, the current card under NCCL and the CPU otherwise)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    if _DEVICE is not None:
        return _DEVICE
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axes: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` over the whole world; ``ensemble`` (if present)
    should be the first, outermost dimension, so that it maps across
    hosts."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(local_device().type, tuple(axes),
                            mesh_dim_names=tuple(names))
    _MESHES.add(mesh)
    return mesh


def mesh_position(mesh, name: str) -> tuple:
    """``(this rank's index, the number of ranks)`` along the mesh
    dimension ``name``."""
    return (mesh.get_local_rank(name),
            dist.get_world_size(mesh.get_group(name)))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks ``x`` of ``group``'s ranks joined in rank order along
    ``dim``, on every rank, on ``x``'s device and in its dtype (bool
    through bytes).  Under gloo, whose ``all_gather`` takes CPU tensors
    only (its ``all_reduce`` takes CUDA tensors too), through the host.
    Outside autograd."""
    y = x.detach()
    if y.dtype == torch.bool:
        y = y.to(torch.uint8)
    if dist.get_backend(group) == "gloo":
        y = y.cpu()
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim).to(x.device, x.dtype)


class _Split(torch.autograd.Function):
    """The split of a whole array, the same on every rank, into this
    rank's block; backward, the blocks' cotangents gathered into the
    whole array's (each rank's block in its place: their sum over the
    ranks)."""

    @staticmethod
    def forward(ctx, x, dim, lo, size, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, lo, size)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.dim, ctx.group), None, None, None, None


def local_block(mesh, spec: P, x):
    """This rank's block of ``x`` (a tensor or a NumPy array) under
    ``spec``: rank i of the mesh dimension holds the rows ``[i n / k,
    (i + 1) n / k)`` of the split dimension, the layout of JAX's
    ``P(axis)``; the whole of ``x`` when ``spec`` is replicated.  A tensor
    that needs a gradient gets the split's backward: the whole array's
    cotangent, gathered from every rank's block (one ``all_gather``)."""
    split = spec.split()
    if split is None:
        return x
    d, name = split
    i, k = mesh_position(mesh, name)
    n = x.shape[d]
    if n % k:
        raise ValueError(f"dimension {d} of length {n} does not divide over "
                         f"the {k} ranks of mesh dimension {name!r}")
    if (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled()):
        return _Split.apply(x, d, i * n // k, n // k, mesh.get_group(name))
    index = (slice(None),) * d + (slice(i * n // k, (i + 1) * n // k),)
    return x[index]


def make_global_sharded(mesh, spec_tree, host_tree):
    """This rank's part of identical host (NumPy) arrays on every rank:
    split leaves as :func:`local_block` cuts them, replicated ones whole,
    each on this rank's device in the host array's dtype.  The counterpart
    of the JAX package's ``make_array_from_callback`` recipe, which
    materializes each process's addressable shards."""
    device = local_device()

    def one(spec, host):
        block = local_block(mesh, spec, np.asarray(host))
        return torch.from_numpy(np.ascontiguousarray(block)).to(device)

    return tree_map(one, spec_tree, host_tree)
