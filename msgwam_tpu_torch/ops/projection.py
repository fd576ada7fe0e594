"""Ray→grid projection of the pseudo-momentum flux: the counterpart of
:mod:`msgwam_tpu.ops.projection`.

The reference semantics are kept exactly: cell indices from the origin-0
ratio ``r/dz`` truncated toward zero, both clamped to ``nzmax = len(grid)
- 2`` (so the top cell never receives flux), an out-of-domain mask, and
the *absolute value* of the overlap ``|min(grid[c+1], r_up) − max(grid[c],
r_low)|/dz``.

Backends (``cfg.projection_backend``):

* ``"xla"``    — :func:`project`, an ``index_add_`` scatter over at most
  ``max_span`` cells per ray;
* ``"mxu"``    — :func:`project_dense`, a dense ``(n, n_cell)`` weight
  matrix and one matmul, with ``native``/``compensated``/``f64``
  accumulation of per-block partials;
* ``"pallas"`` — the hand-written CUDA deposit kernel,
  :func:`msgwam_tpu_torch.ops.projection_cuda.project_pallas`.
"""

from __future__ import annotations

import math

import torch


def _cell_spans(r_low, r_up, dz, n_points):
    """Reference index arithmetic: ``(nlow, nup, in_domain)`` with indices
    clamped to ``[0, nzmax]``."""
    nzmax = n_points - 2
    nlow = (r_low / dz).to(torch.int64)  # truncates toward zero
    nup = (r_up / dz + 1.0).to(torch.int64)
    out_of_domain = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    nlow = torch.clamp(nlow, 0, nzmax)
    nup = torch.clamp(nup, 0, nzmax)
    return nlow, nup, ~out_of_domain


def projection_weights(r_low, r_up, valid, grid, max_span: int):
    """Sparse overlap weights ``(cells, weights, live)``, each
    ``(n, max_span)``; a ray overlapping more than ``max_span`` cells is
    truncated (choose ``max_span >= ceil(max dr / dz) + 1``)."""
    n_points = grid.shape[0]
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)

    j = torch.arange(max_span, dtype=torch.int64, device=r_low.device)
    cells = nlow[:, None] + j[None, :]                      # (n, S)
    live = ok[:, None] & (cells < nup[:, None])
    cells = torch.clamp(cells, 0, n_points - 2)
    zmin = torch.maximum(grid[cells], r_low[:, None])
    zmax = torch.minimum(grid[cells + 1], r_up[:, None])
    weights = torch.where(live, torch.abs(zmax - zmin) / dz,
                          torch.zeros_like(zmax))
    return cells, weights, live


# Ray-axis block length of the wide accumulation modes: partial deposits
# are summed per block at working precision, then combined in float64 or
# with Kahan compensation.
ACCUM_BLOCK = 8192


def _kahan_sum(parts):
    """Compensated summation over the leading axis, at working precision."""
    s = torch.zeros_like(parts[0])
    c = torch.zeros_like(parts[0])
    for x in parts:
        y = x - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def _reduce_partials(parts, accum: str, out_dtype):
    """Combine ``(nb, nvar, C)`` per-block partial deposits: ``"native"``
    sums at working precision, ``"f64"`` in float64, ``"compensated"`` with
    Kahan compensation."""
    if accum == "native":
        return parts.sum(dim=0)
    if accum == "f64":
        return parts.to(torch.float64).sum(dim=0).to(out_dtype)
    if accum == "compensated":
        return _kahan_sum(parts)
    raise ValueError(
        f"unknown flux accumulation mode {accum!r}; "
        "available: 'native', 'f64', 'compensated'"
    )


def block_partials(values, w, block: int = ACCUM_BLOCK):
    """``(nb, nvar, C)`` partial deposits ``values[:, blk] @ w[blk]`` over
    consecutive ray blocks of length ``block`` (the last one may be
    short)."""
    nvar, n = values.shape
    nb = n // block
    parts = []
    if nb:
        vb = values[:, : nb * block].reshape(nvar, nb, block).transpose(0, 1)
        wb = w[: nb * block].reshape(nb, block, w.shape[1])
        parts.append(torch.bmm(vb, wb))                     # (nb, nvar, C)
    if n - nb * block or not nb:
        parts.append((values[:, nb * block:] @ w[nb * block:])[None])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def project(values, r_low, r_up, phase_vol, valid, grid, max_span: int,
            accum: str = "native"):
    """Deposit per-ray ``values`` ``(nvar, n)`` onto the ``G-1`` cells of
    the uniform ``grid`` ``(G,)``: an ``index_add_`` scatter.  ``accum``
    is ``"native"`` or ``"f64"`` (the whole scatter in float64).

    Returns ``(nvar, G-1)``."""
    values = torch.atleast_2d(values)
    n_points = grid.shape[0]
    n_cells = n_points - 1
    cells, weights, live = projection_weights(r_low, r_up, valid, grid, max_span)
    w = weights * phase_vol[:, None]                        # (n, S)
    # dead slots go to a dump segment so they never touch real cells
    seg = torch.where(live, cells, n_cells).reshape(-1)     # (n*S,)
    contrib = (values[:, :, None] * w[None, :, :]).reshape(values.shape[0], -1)
    if accum == "f64":
        contrib = contrib.to(torch.float64)
    elif accum != "native":
        raise ValueError(
            f"the 'xla' (scatter) backend supports accum 'native' or 'f64', "
            f"got {accum!r}; 'compensated' needs the blockwise 'mxu' backend"
        )
    out = torch.zeros((values.shape[0], n_cells + 1), dtype=contrib.dtype,
                      device=contrib.device)
    out.index_add_(1, seg, contrib)
    return out[:, :n_cells].to(values.dtype)


def _dense_weights(r_low, r_up, phase_vol, valid, grid):
    """The dense ``(n, n_cells)`` overlap-weight matrix ``w`` such that the
    deposit is ``values @ w``."""
    n_points = grid.shape[0]
    n_cells = n_points - 1
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)
    c = torch.arange(n_cells, dtype=torch.int64, device=r_low.device)
    in_span = (c[None, :] >= nlow[:, None]) & (c[None, :] < nup[:, None])
    zmin = torch.maximum(grid[:-1][None, :], r_low[:, None])
    zmax = torch.minimum(grid[1:][None, :], r_up[:, None])
    w = torch.abs(zmax - zmin) / dz
    return torch.where(in_span & ok[:, None], w, torch.zeros_like(w)) \
        * phase_vol[:, None]


def project_dense(values, r_low, r_up, phase_vol, valid, grid, max_span=None,
                  accum: str = "native"):
    """The ``mxu`` backend: the deposit as a dense weight-matrix product.
    Same semantics as :func:`project`, without a span bound (``max_span``
    is accepted and ignored).  ``"native"`` is one ``(nvar, n) @ (n, C)``
    product; ``"f64"``/``"compensated"`` combine :data:`ACCUM_BLOCK`-ray
    block partials in float64 / with Kahan compensation."""
    values = torch.atleast_2d(values)
    w = _dense_weights(r_low, r_up, phase_vol, valid, grid)
    if accum == "native":
        return values @ w
    return _reduce_partials(block_partials(values, w), accum, values.dtype)


PROJECT_BACKENDS = {"xla": project, "mxu": project_dense}


def project_backend(name: str):
    if name == "pallas":
        from .projection_cuda import project_pallas

        return project_pallas
    try:
        return PROJECT_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown projection backend {name!r}; available: "
            f"{sorted(PROJECT_BACKENDS) + ['pallas']}"
        ) from None


def required_span(dr_max: float, dz: float) -> int:
    """Host-side helper: the ``max_span`` needed so no ray volume of extent
    up to ``dr_max`` is truncated."""
    return int(math.ceil(dr_max / dz)) + 1
