"""The least time the card could take for a kernel's work, counted from
the inputs: the larger of its bytes over the HBM bandwidth and its float32
operations over the float32 rate outside the tensor cores.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3 at 3.35 TB/s, 67
TFLOP/s float32 without tensor cores), which assume the full 700 W power
limit; the result line carries the card's own limit beside every share.

Bytes: each input read once and each output written once, per ray a
launch (K4 81 B: dens, r, m, their three RK3 registers in and out and the
frozen fields in; K5-K7 57 B: the state in and out and the frozen fields
in, once for the whole launch).  Operations per ray, counted from the
per-ray physics: the windowed right-hand side of one stage without the
deposit (dispersion and deposit inputs 44, window bounds 8, three lookups
30, tendencies with online saturation 38), the three RK3 field updates,
and the deposit per covered cell (span test, overlap, two products, two
float64 conversions and sums).  Covered cells come from the rays' own
extents (:func:`covered_cells`), never from a kernel's tiles or windows.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
RHS_OPS = 120
RK3_OPS = 12
DEPOSIT_CELL_OPS = 11
K4_BYTES_PER_RAY = 81
WHOLE_RUN_BYTES_PER_RAY = 57


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds the card needs at least for ``n_bytes`` and ``n_ops``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def covered_cells(r, dr, active, dz: float, n_centers: int) -> float:
    """Mean deposit cells per active ray: the reference's index rule on
    the cell centers (``r / dz`` truncated from origin 0, both ends clamped
    to ``n_centers - 2``)."""
    nzmax = n_centers - 2
    lo = torch.clamp(torch.trunc((r - 0.5 * dr) / dz), 0, nzmax)
    up = torch.clamp(torch.trunc((r + 0.5 * dr) / dz + 1.0), 0, nzmax)
    act = active.to(lo.dtype)
    return float(((up - lo) * act).sum() / act.sum().clamp(min=1))


def step_ops(n: int, cells: float, deposit: bool = True) -> float:
    """Operations of one whole RK3 step of ``n`` rays."""
    return 3 * n * (RHS_OPS + RK3_OPS + (DEPOSIT_CELL_OPS * cells if deposit else 0))


def whole_run_step_s(n: int, cells: float, steps_per_launch: int,
                     deposit: bool) -> float:
    """K5-K7's bound for one step, its launch's bytes shared by the
    launch's steps; ``deposit`` is false where the wind is imposed (no
    flux is needed)."""
    return bound_s(WHOLE_RUN_BYTES_PER_RAY * n / steps_per_launch,
                   step_ops(n, cells, deposit))


def k4_launch_s(n: int, cells: float) -> float:
    """K4's bound for one launch (one RK3 stage with its update)."""
    return bound_s(K4_BYTES_PER_RAY * n,
                   n * (RHS_OPS + RK3_OPS + DEPOSIT_CELL_OPS * cells))
