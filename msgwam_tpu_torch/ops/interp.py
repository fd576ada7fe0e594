"""Linear interpolation of grid profiles onto ray heights: the counterpart
of :mod:`msgwam_tpu.ops.interp`.

* :func:`interp` — ``np.interp`` on any sorted grid (``searchsorted``);
  :func:`uniform_interp` — on a uniform grid given by origin and step.
* :func:`grid_interp` — ``np.interp`` on a uniform, materialised grid,
  with the same index arithmetic and the same inner-loop expression as the
  JAX package, so that float64 results agree to the last ulps.
* :func:`basis_matrix` / :func:`basis_interp` — the dense hat-basis form
  (the ``mxu`` backend), with the JAX package's residual-free backward.
"""

from __future__ import annotations

import torch


def interp(x, xp, fp):
    """``np.interp`` semantics for a sorted 1-D ``xp``: linear inside,
    clamped to ``fp[0]`` / ``fp[-1]`` outside.  General (non-uniform)
    grid."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    x0 = xp[i]
    f0 = fp[i]
    # numpy's compiled inner-loop arithmetic: slope*(x - x0) + f0, clamped
    inner = (fp[i + 1] - f0) / (xp[i + 1] - x0) * (x - x0) + f0
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], inner))


def uniform_interp(x, x0, dx, fp):
    """``np.interp`` on a uniform grid ``xp[j] = x0 + j*dx``: index
    arithmetic instead of a search, with numpy's inner-loop expression."""
    n = fp.shape[0]
    t = (x - x0) / dx
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    xi = x0 + i.to(x.dtype) * dx
    f0 = fp[i]
    inner = (fp[i + 1] - f0) / dx * (x - xi) + f0
    return torch.where(x <= x0, fp[0],
                       torch.where(x >= x0 + (n - 1) * dx, fp[-1], inner))


def basis_matrix(x, x0, dx, n: int):
    """Dense hat basis ``B[i, j] = hat_j(clip(x_i))`` on the uniform grid
    ``xp[j] = x0 + j*dx``, so that ``B @ fp`` is clamped linear
    interpolation of any table ``fp`` on that grid."""
    xc = torch.clamp(x, x0, x0 + (n - 1) * dx)
    j = torch.arange(n, dtype=x.dtype, device=x.device)
    t = (xc[:, None] - x0) / dx - j[None, :]
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


class _BasisInterp(torch.autograd.Function):
    """``basis_matrix(x) @ tables`` with the backward of
    ``msgwam_tpu.ops.interp._basis_interp_bwd``: only the inputs are saved
    and the basis is rebuilt in the backward, never the ``(n_query,
    n_table)`` matrix.  The kink conventions are the ones that function
    implements: the hat's derivative is ``-sgn(t)`` on ``|t| < 1`` with
    ``sgn(0) = +1``, ``-0.5 sgn(t)`` at ``|t| = 1`` and 0 beyond, and the
    clip passes a factor 1 inside, 0.5 on a bound and 0 outside."""

    @staticmethod
    def forward(ctx, x, x0, dx, tables):
        ctx.save_for_backward(x, x0, dx, tables)
        return basis_matrix(x, x0, dx, tables.shape[0]) @ tables

    @staticmethod
    def backward(ctx, ct):
        x, x0, dx, tables = ctx.saved_tensors
        n = tables.shape[0]
        hi = x0 + (n - 1) * dx
        xc = torch.clamp(x, x0, hi)
        j = torch.arange(n, dtype=x.dtype, device=x.device)
        t = (xc[:, None] - x0) / dx - j[None, :]
        ct_tables = None
        if ctx.needs_input_grad[3]:
            ct_tables = torch.clamp(1.0 - torch.abs(t), min=0.0).T @ ct
        sgn = torch.where(t >= 0, 1.0, -1.0).to(t.dtype)
        at = torch.abs(t)
        d_hat = torch.where(at < 1.0, -sgn,
                            torch.where(at == 1.0, -0.5 * sgn,
                                        torch.zeros_like(t)))
        ct_u = (ct * (d_hat @ tables)).sum(dim=1)       # d out / d u, per query
        clip = torch.where((x > x0) & (x < hi), 1.0,
                           torch.where((x == x0) | (x == hi), 0.5, 0.0))
        ct_u = ct_u * clip.to(ct_u.dtype)
        ct_x = ct_u / dx
        ct_x0 = -ct_u.sum() / dx
        ct_dx = -(ct_u * (xc - x0)).sum() / (dx * dx)
        return ct_x, ct_x0, ct_dx, ct_tables


def basis_interp(x, x0, dx, tables):
    """Interpolate one ``(n_table,)`` or stacked ``(n_table, k)`` tables at
    the query points ``x`` through :func:`basis_matrix` and one matmul.
    ``x0`` and ``dx`` are taken in ``x``'s dtype, as the JAX package does;
    gradients reach ``x``, ``x0``, ``dx`` and ``tables``
    (:class:`_BasisInterp`)."""
    squeeze = tables.dim() == 1
    if squeeze:
        tables = tables[:, None]
    x0 = torch.as_tensor(x0, dtype=x.dtype, device=x.device)
    dx = torch.as_tensor(dx, dtype=x.dtype, device=x.device)
    out = _BasisInterp.apply(x, x0, dx, tables)
    return out[:, 0] if squeeze else out


def grid_interp(x, xp, fp):
    """``np.interp`` on a *uniform, explicitly materialised* grid ``xp``:
    closed-form indices, but the interpolation arithmetic uses the actual
    ``xp[i]`` values and per-interval widths."""
    n = fp.shape[0]
    x0 = xp[0]
    dx = xp[1] - xp[0]
    i = torch.clamp(torch.floor((x - x0) / dx).to(torch.int64), 0, n - 2)
    xi = xp[i]
    # if rounding put x below xp[i], step back one interval (searchsorted)
    i = torch.where(x < xi, torch.clamp(i - 1, min=0), i)
    xi = xp[i]
    f0 = fp[i]
    f1 = fp[i + 1]
    inner = (f1 - f0) / (xp[i + 1] - xi) * (x - xi) + f0
    return torch.where(x <= x0, fp[0], torch.where(x >= xp[-1], fp[-1], inner))
