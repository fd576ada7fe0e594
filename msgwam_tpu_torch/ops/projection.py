"""Ray→grid projection of the pseudo-momentum flux: the counterpart of
:mod:`msgwam_tpu.ops.projection`.

The reference semantics are kept exactly: cell indices from the origin-0
ratio ``r/dz`` truncated toward zero, both clamped to ``nzmax = len(grid)
- 2`` (so the top cell never receives flux), an out-of-domain mask, and
the *absolute value* of the overlap ``|min(grid[c+1], r_up) − max(grid[c],
r_low)|/dz``, differentiated with the JAX package's ``abs'(0) = 1``
(:func:`abs1`): the overlap is 0 in the cell above a ray edge that sits
on a grid face, where torch's ``abs`` would pass no gradient.

Backends (``cfg.projection_backend``):

* ``"xla"``    — :func:`project`, an ``index_add_`` scatter over at most
  ``max_span`` cells per ray;
* ``"mxu"``    — :func:`project_dense`, a dense ``(n, n_cell)`` weight
  matrix and one matmul, with ``native``/``compensated``/``f64``
  accumulation of per-block partials;
* ``"pallas"`` — the hand-written CUDA deposit kernel,
  :func:`msgwam_tpu_torch.ops.projection_cuda.project_pallas`.

:func:`project_interfaces` and :func:`project_reference_variant` are the
reference's other projection variants, for diagnostics.
"""

from __future__ import annotations

import math

import torch

from .dispersion import cg_r


def abs1(x):
    """``|x|`` whose derivative at 0 is 1, as JAX's ``abs`` has it (torch's
    ``abs`` has 0); the value differs from ``torch.abs`` only in the sign
    of a zero."""
    return torch.where(x >= 0, x, -x)


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
    weights = torch.where(live, abs1(zmax - zmin) / dz,
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
    w = abs1(zmax - zmin) / dz
    return torch.where(in_span & ok[:, None], w, torch.zeros_like(w)) \
        * phase_vol[:, None]


class _DenseDeposit(torch.autograd.Function):
    """``values @ _dense_weights(...)`` with the analytic backward of
    ``msgwam_tpu.ops.projection._dense_deposit_bwd``: only the inputs are
    saved and the ``(n, n_cells)`` weights are rebuilt in the backward.
    Its tie conventions are JAX's: ``abs'(0) = 1``, and a ``maximum`` or
    ``minimum`` tie splits the gradient 0.5/0.5.  ``valid`` gets none."""

    @staticmethod
    def forward(ctx, values, r_low, r_up, phase_vol, valid, grid):
        ctx.save_for_backward(values, r_low, r_up, phase_vol, valid, grid)
        return values @ _dense_weights(r_low, r_up, phase_vol, valid, grid)

    @staticmethod
    def backward(ctx, ct):
        values, r_low, r_up, phase_vol, valid, grid = ctx.saved_tensors
        n_points = grid.shape[0]
        n_cells = n_points - 1
        dz = grid[1] - grid[0]
        nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
        ok = in_domain if valid is None else (valid & in_domain)
        c = torch.arange(n_cells, dtype=torch.int64, device=r_low.device)
        mask = ((c[None, :] >= nlow[:, None]) & (c[None, :] < nup[:, None])
                & ok[:, None])
        gl = grid[:-1][None, :]
        gu = grid[1:][None, :]
        rl = r_low[:, None]
        ru = r_up[:, None]
        d = torch.minimum(gu, ru) - torch.maximum(gl, rl)
        zero = torch.zeros_like(d)
        w_raw = abs1(d) / dz                                # before phase_vol
        w = torch.where(mask, w_raw, zero) * phase_vol[:, None]

        ct_values = ct @ w.T                                # (nvar, n)
        ctm = torch.where(mask, values.T @ ct, zero)        # (n, n_cells)
        ct_pv = (ctm * w_raw).sum(dim=1)
        s = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)      # abs'(0) = 1
        g_d = ctm * s * (phase_vol[:, None] / dz)           # dL/d d
        sel_rl = torch.where(rl > gl, 1.0,
                             torch.where(rl == gl, 0.5, 0.0)).to(d.dtype)
        sel_ru = torch.where(ru < gu, 1.0,
                             torch.where(ru == gu, 0.5, 0.0)).to(d.dtype)
        ct_rl = (g_d * -sel_rl).sum(dim=1)
        ct_ru = (g_d * sel_ru).sum(dim=1)
        # the grid: zmin reaches grid[c] where the max took the face, zmax
        # grid[c + 1] where the min did; dz = grid[1] - grid[0] adds the
        # 1/dz factor's term
        g_gl = (g_d * -(1.0 - sel_rl)).sum(dim=0)
        g_gu = (g_d * (1.0 - sel_ru)).sum(dim=0)
        ct_dz = -(ctm * w_raw * phase_vol[:, None]).sum() / dz
        ct_grid = torch.zeros_like(grid)
        ct_grid[:-1] += g_gl
        ct_grid[1:] += g_gu
        ct_grid[0] -= ct_dz
        ct_grid[1] += ct_dz
        return ct_values, ct_rl, ct_ru, ct_pv, None, ct_grid


def project_dense(values, r_low, r_up, phase_vol, valid, grid, max_span=None,
                  accum: str = "native"):
    """The ``mxu`` backend: the deposit as a dense weight-matrix product.
    Same semantics as :func:`project`, without a span bound (``max_span``
    is accepted and ignored).  ``"native"`` is one ``(nvar, n) @ (n, C)``
    product (:class:`_DenseDeposit`, whose backward rebuilds the weights);
    ``"f64"``/``"compensated"`` combine :data:`ACCUM_BLOCK`-ray block
    partials in float64 / with Kahan compensation."""
    values = torch.atleast_2d(values)
    if accum == "native":
        return _DenseDeposit.apply(values, r_low, r_up, phase_vol, valid, grid)
    w = _dense_weights(r_low, r_up, phase_vol, valid, grid)
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


def project_interfaces(values, r_low, r_up, phase_vol, valid, grid):
    """Interface-flux projection (reference vars 3-4,
    ``lib/libprop.py:199-219``): each interior face ``nb`` accumulates the
    full ``value * phase_vol`` of every ray strictly straddling it
    (``nlow < nb < nup``).  A dense ``(n, G)`` mask and one matmul
    (diagnostics only).  Returns ``(nvar, G)``."""
    values = torch.atleast_2d(values)
    n_points = grid.shape[0]
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)
    nb = torch.arange(n_points, dtype=torch.int64, device=r_low.device)
    straddle = ((nlow[:, None] < nb[None, :]) & (nup[:, None] > nb[None, :])
                & ok[:, None] & (nb[None, :] >= 1)
                & (nb[None, :] < n_points - 1))             # (n, G)
    w = straddle.to(values.dtype) * phase_vol[:, None]
    return values @ w                                       # (nvar, G)


def project_reference_variant(dens, lam, phi, rr_low, rr_up, kk, ll, mm_low,
                              mm_up, dkk, dll, dmm, grid, bvf, var: int = 0,
                              max_span: int = 4, valid=None):
    """The reference ``wave_projection`` entry point
    (``lib/libprop.py:92-221``), all five variants:

    * var=0 — pseudo-momentum fluxes (u,v) at cell centers → ``(2, G-1)``
    * var=1 — vertical wave-action flux at cell centers → ``(G-1,)``
    * var=2 — wave action at cell centers → ``(G-1,)``
    * var=3 — wave-action flux at interfaces → ``(G,)``
    * var=4 — pseudo-momentum fluxes at interfaces → ``(2, G)``

    Like the reference, cg_r is evaluated at ray centers and the
    phase-space volume is ``|dkk·dll·dmm|``."""
    phase_vol = torch.abs(dkk * dll * dmm)
    cgr = cg_r(kk, ll, 0.5 * (mm_low + mm_up), phi, bvf)
    if var == 0:
        vals = torch.stack([cgr * kk * dens, cgr * ll * dens])
        return project(vals, rr_low, rr_up, phase_vol, valid, grid, max_span)
    if var == 1:
        return project(cgr * dens, rr_low, rr_up, phase_vol, valid, grid,
                       max_span)[0]
    if var == 2:
        return project(dens, rr_low, rr_up, phase_vol, valid, grid,
                       max_span)[0]
    if var == 3:
        return project_interfaces(cgr * dens, rr_low, rr_up, phase_vol, valid,
                                  grid)[0]
    if var == 4:
        vals = torch.stack([cgr * kk * dens, cgr * ll * dens])
        return project_interfaces(vals, rr_low, rr_up, phase_vol, valid, grid)
    raise ValueError(f"unknown projection variant {var}")


def required_span(dr_max: float, dz: float) -> int:
    """Host-side helper: the ``max_span`` needed so no ray volume of extent
    up to ``dr_max`` is truncated."""
    return int(math.ceil(dr_max / dz)) + 1
