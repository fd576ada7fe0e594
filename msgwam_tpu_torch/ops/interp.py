"""Linear interpolation of grid profiles onto ray heights: the counterpart
of :mod:`msgwam_tpu.ops.interp`.

* :func:`grid_interp` — ``np.interp`` on a uniform, materialised grid,
  with the same index arithmetic and the same inner-loop expression as the
  JAX package, so that float64 results agree to the last ulps.
* :func:`basis_matrix` / :func:`basis_interp` — the dense hat-basis form
  (the ``mxu`` backend), forward only in this port.
"""

from __future__ import annotations

import torch


def basis_matrix(x, x0, dx, n: int):
    """Dense hat basis ``B[i, j] = hat_j(clip(x_i))`` on the uniform grid
    ``xp[j] = x0 + j*dx``, so that ``B @ fp`` is clamped linear
    interpolation of any table ``fp`` on that grid."""
    xc = torch.clamp(x, x0, x0 + (n - 1) * dx)
    j = torch.arange(n, dtype=x.dtype, device=x.device)
    t = (xc[:, None] - x0) / dx - j[None, :]
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def basis_interp(x, x0, dx, tables):
    """Interpolate one ``(n_table,)`` or stacked ``(n_table, k)`` tables at
    the query points ``x`` through :func:`basis_matrix` and one matmul.
    ``x0`` and ``dx`` are taken in ``x``'s dtype, as the JAX package does."""
    squeeze = tables.dim() == 1
    if squeeze:
        tables = tables[:, None]
    x0 = torch.as_tensor(x0, dtype=x.dtype, device=x.device)
    dx = torch.as_tensor(dx, dtype=x.dtype, device=x.device)
    out = basis_matrix(x, x0, dx, tables.shape[0]) @ tables
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
