"""K1: the ray→grid flux deposit as a hand-written Hopper kernel.

Replaces ``msgwam_tpu/ops/projection_pallas.py`` (``_kernel``, entry
points ``_project_pallas`` and ``project_pallas``), reached through
``projection_backend="pallas"``.  The CUDA source is
``csrc/projection.cu``, with the span rule, the tile and sum types and the
arrival counters it shares with K2-K7 in ``csrc/deposit.cuh``.

Arithmetic of the Pallas kernel: cell indices from the *division*
``r / dz`` truncated toward zero and clamped to ``n_cells - 1`` after the
out-of-domain test; faces rebuilt as ``g0 + c·dz``; weight
``|min(face_hi, r_up) − max(face_lo, r_low)| / dz · phase_vol``; at most
two value rows; no flux in the top cell.

What bounds it on the H100: it reads 21 B per ray (five f32 fields and a
mask byte) and writes ``(2, n_cells)``; at 1e6 rays that is ~6.3 µs of
memory time at 3.35 TB/s.  One launch over a persistent grid whose blocks
are all resident (the plan, :func:`device_plan`, mirrored by
:func:`.ray_physics.project_plan`), with shared memory sized to the grid.
Each thread loads its next ray while it deposits the current one.  A tile
whose rays span at most 4 cells is deposited by each warp into float64
sums of its own, without block barriers (up to 256 cells; a cell's lanes
summed by a butterfly or in lane order, a fixed order either way); a tile
of longer rays, or any tile past 256 cells, by a walk over the tile's rays
sorted into bins by their first cell, a cell reading only the bins that
can reach it.  The blocks publish their sums for the cells they
touched, and fixed reducer blocks add them in block order in the kernel's
tail, with the arrival counters of the per-stage kernels
(:func:`.rhs_cuda.counters`).  The TPU kernel summed in plain float32
across its sequential grid; here every sum past the products is float64,
without float atomics, and bitwise repeatable.

:func:`project_pallas` launches the kernel for CUDA tensors and runs the
plain twin :func:`project_pallas_reference` for CPU tensors; ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ray_physics
from .rhs_cuda import Scratch, counters, scratch_for

LAUNCHES = 0

MAX_CELLS = 1024     # csrc/deposit.cuh kMaxCells


def _check_args(values, r_low, r_up, phase_vol, valid, grid, accum):
    if accum != "native":
        raise ValueError(
            f"the pallas projection backend only supports accum='native', "
            f"got {accum!r}; use projection_backend='mxu' for wide "
            f"accumulation"
        )
    if values.dim() != 2 or values.shape[0] > 2:
        raise ValueError("project_pallas supports at most 2 value rows")
    n = values.shape[1]
    for name, x in (("values", values), ("r_low", r_low), ("r_up", r_up),
                    ("phase_vol", phase_vol), ("grid", grid)):
        if x.dtype != torch.float32:
            raise TypeError(f"project_pallas: {name} must be float32, "
                            f"got {x.dtype}")
        if x.device != values.device:
            raise ValueError(f"project_pallas: {name} is on {x.device}, "
                             f"values on {values.device}")
        if not x.is_contiguous():
            raise ValueError(f"project_pallas: {name} must be contiguous")
    for name, x in (("r_low", r_low), ("r_up", r_up), ("phase_vol", phase_vol)):
        if x.shape != (n,):
            raise ValueError(f"project_pallas: {name} has shape "
                             f"{tuple(x.shape)}, expected ({n},)")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)
                              or valid.device != values.device
                              or not valid.is_contiguous()):
        raise ValueError("project_pallas: valid must be a contiguous bool "
                         f"tensor of shape ({n},) on {values.device}")
    n_cells = grid.shape[0] - 1
    if grid.dim() != 1 or not 1 <= n_cells <= MAX_CELLS:
        raise ValueError(f"project_pallas: grid must be 1-D with 2 to "
                         f"{MAX_CELLS + 1} points")


def project_pallas(values, r_low, r_up, phase_vol, valid, grid, max_span=None,
                   accum: str = "native"):
    """Drop-in for :func:`msgwam_tpu_torch.ops.projection.project`
    (float32, at most 2 value rows; ``max_span`` is accepted and ignored).
    Returns ``(nvar, n_cells)`` float32.  Forward only, as the JAX
    package's ``project_pallas`` is."""
    _build.forward_only("project_pallas", "projection_backend='mxu'",
                        values, r_low, r_up, phase_vol, grid)
    values = torch.atleast_2d(values)
    _check_args(values, r_low, r_up, phase_vol, valid, grid, accum)
    if values.device.type == "cpu":
        return project_pallas_reference(values, r_low, r_up, phase_vol, valid,
                                        grid)
    if values.device.type != "cuda":
        raise ValueError(f"project_pallas: unsupported device {values.device}")

    return launch(values, r_low, r_up, phase_vol, valid, grid)


def device_plan(n: int, n_cells: int, device) -> ray_physics.StagePlan:
    """The kernel's plan on ``device`` (the card's own SM count)."""
    index = torch.device(device).index
    return _device_plan(n, n_cells, torch.cuda.current_device()
                        if index is None else index)


@functools.lru_cache(maxsize=64)
def _device_plan(n, n_cells, index) -> ray_physics.StagePlan:
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        _build.check(_build.library().msgwam_project_plan(
            n, n_cells, ctypes.addressof(out)), "msgwam_project_plan")
    return ray_physics.StagePlan(out[0], out[1])


def scratch(n: int, n_cells: int, device) -> Scratch:
    """The scratch of one call of ``n`` rays on ``n_cells`` cells, for the
    card's plan (:func:`.rhs_cuda.scratch_for`)."""
    return scratch_for(device_plan(n, n_cells, device), n_cells, device)


def launch(values, r_low, r_up, phase_vol, valid, grid, work: Scratch = None):
    """One launch of the kernel on inputs that :func:`project_pallas` has
    checked (no checks here); ``work`` (from :func:`scratch`) holds the
    result, which the next launch with it overwrites."""
    global LAUNCHES
    nvar, n = values.shape
    n_cells = grid.shape[0] - 1
    if n == 0:
        return torch.zeros((nvar, n_cells), dtype=values.dtype,
                           device=values.device)
    work = work or scratch(n, n_cells, values.device)
    cnt = counters(values.device)
    err = _build.library().msgwam_project(
        values[0].data_ptr(), values[1].data_ptr() if nvar == 2 else None,
        r_low.data_ptr(), r_up.data_ptr(), phase_vol.data_ptr(),
        None if valid is None else valid.data_ptr(), grid.data_ptr(),
        n, n_cells, work.flux.data_ptr(), work.partials.data_ptr(),
        work.ranges.data_ptr(), cnt.buf.data_ptr(), cnt.parity,
        work.plan.blocks, work.plan.reducers,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(err, "msgwam_project")
    cnt.launched()
    LAUNCHES += 1
    return work.flux[:nvar]


def project_pallas_reference(values, r_low, r_up, phase_vol, valid, grid,
                             plan: ray_physics.StagePlan = None):
    """Plain PyTorch twin of the K1 kernel, in the inputs' own dtype
    (float32 for the kernel's arithmetic, float64 for an oracle): the same
    index, face and weight arithmetic (the values scaled by
    ``phase_vol / dz`` first, then each overlap times a value), a dense
    ``(n, n_cells)`` overlap matrix, and the products summed in float64 by
    the kernel's block plan (``plan``, by default the H100's:
    :func:`.ray_physics.project_plan`) and its reducers' order."""
    values = torch.atleast_2d(values)
    nvar, n = values.shape
    n_cells = grid.shape[0] - 1
    nzmax = n_cells - 1
    g0 = grid[0]
    dz = grid[1] - grid[0]
    nlow = (r_low / dz).to(torch.int64)             # truncation toward zero
    nup = (r_up / dz + 1.0).to(torch.int64)
    ood = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    live = ~ood if valid is None else (valid & ~ood)
    nlow = torch.clamp(nlow, 0, nzmax)
    nup = torch.clamp(nup, 0, nzmax)
    c = torch.arange(n_cells, device=values.device)
    cf = c.to(values.dtype)
    face_lo = g0 + cf * dz
    face_hi = g0 + (cf + 1.0) * dz
    in_span = (c >= nlow[:, None]) & (c < nup[:, None]) & live[:, None]
    ov = torch.abs(torch.minimum(face_hi, r_up[:, None])
                   - torch.maximum(face_lo, r_low[:, None]))
    ov = torch.where(in_span, ov, torch.zeros_like(ov))
    # the kernel reads no value of a dead ray
    scaled = torch.where(live, values * (phase_vol / dz), 0.0)
    prod = torch.cat([ov * scaled[v][:, None] for v in range(nvar)], dim=1)
    plan = plan or ray_physics.project_plan(max(n, 1), n_cells)
    return ray_physics.sum_by_plan(prod, plan, ray_physics.reduce_group(
        plan.blocks)).to(values.dtype).view(nvar, n_cells)
