"""K1: the ray→grid flux deposit as a hand-written Hopper kernel.

Replaces ``msgwam_tpu/ops/projection_pallas.py`` (``_kernel``, entry
points ``_project_pallas`` and ``project_pallas``), reached through
``projection_backend="pallas"``.  The CUDA source is
``csrc/projection.cu`` with the deposit shared with K2 in
``csrc/deposit.cuh``.

Arithmetic of the Pallas kernel: cell indices from the *division*
``r / dz`` truncated toward zero and clamped to ``n_cells - 1`` after the
out-of-domain test; faces rebuilt as ``g0 + c·dz``; weight
``|min(face_hi, r_up) − max(face_lo, r_low)| / dz · phase_vol``; at most
two value rows.

What bounds it on the H100: it reads 21 B per ray (five f32 fields and a
mask byte) and writes ``(2, n_cells)``; at 1e6 rays that is ~6 µs of
memory time at 3.35 TB/s.  One ray per thread, coalesced reads; each cell a
256-ray tile touches is walked by up to 32 lanes and combined by a fixed
shuffle tree into float64 block sums in shared memory; a second pass adds
at most 1056 float64 block partials.  The TPU kernel summed in plain
float32 across its sequential grid; here the cross-block sum is float64
and bitwise reproducible.

:func:`project_pallas` launches the kernel for CUDA tensors and runs the
plain twin :func:`project_pallas_reference` for CPU tensors; ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .projection import _reduce_partials, block_partials

LAUNCHES = 0

THREADS = 256        # csrc/deposit.cuh kThreads: rays per tile
MAX_BLOCKS = 132 * 8  # csrc/deposit.cuh kMaxBlocks
MAX_CELLS = 1024     # csrc/deposit.cuh kMaxCells


def n_blocks_for(n: int) -> int:
    """Blocks of the deposit kernels for ``n`` rays: one 256-ray tile per
    block up to 1056 blocks, which then loop over tiles.  A function of
    ``n`` alone, so the summation order is fixed."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


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
    Returns ``(nvar, n_cells)`` float32."""
    values = torch.atleast_2d(values)
    _check_args(values, r_low, r_up, phase_vol, valid, grid, accum)
    if values.device.type == "cpu":
        return project_pallas_reference(values, r_low, r_up, phase_vol, valid,
                                        grid)
    if values.device.type != "cuda":
        raise ValueError(f"project_pallas: unsupported device {values.device}")

    return launch(values, r_low, r_up, phase_vol, valid, grid)


def launch(values, r_low, r_up, phase_vol, valid, grid):
    """One launch of the kernel on inputs that :func:`project_pallas` has
    checked (no checks here)."""
    global LAUNCHES
    nvar, n = values.shape
    n_cells = grid.shape[0] - 1
    v1 = values[1] if nvar == 2 else torch.zeros_like(values[0])
    nb = n_blocks_for(n)
    out = torch.empty((2, n_cells), dtype=torch.float32, device=values.device)
    partials = torch.empty((nb, 2, n_cells), dtype=torch.float64,
                           device=values.device)
    err = _build.library().msgwam_project(
        values[0].data_ptr(), v1.data_ptr(), r_low.data_ptr(),
        r_up.data_ptr(), phase_vol.data_ptr(),
        None if valid is None else valid.data_ptr(), grid.data_ptr(),
        n, n_cells, out.data_ptr(), partials.data_ptr(), nb,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(err, "msgwam_project")
    LAUNCHES += 1
    return out[:nvar]


def project_pallas_reference(values, r_low, r_up, phase_vol, valid, grid):
    """Plain PyTorch twin of the K1 kernel, in the inputs' own dtype (float32
    for the kernel's arithmetic, float64 for an oracle): the same index,
    face and weight arithmetic, a dense ``(n, n_cells)`` weight matrix,
    block partials and a float64 combination."""
    values = torch.atleast_2d(values)
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
    w = torch.where(in_span, ov / dz, torch.zeros_like(ov)) * phase_vol[:, None]
    return _reduce_partials(block_partials(values, w), "f64", values.dtype)
