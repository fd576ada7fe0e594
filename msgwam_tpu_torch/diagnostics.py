"""Diagnostics of the port: the counterpart of :mod:`msgwam_tpu.diagnostics`.

This slice ports only the window mirror of the windowed kernels K3-K5
(``msgwam_tpu/diagnostics.py:206-338``): which tiles of the current ray
layout a kernel would run in its first window, its second tier or at full
width.  It mirrors **the port's** kernels, whose tile is 256 rays (the
TPU's was 8192) and whose rule is :mod:`.ops.ray_physics`' own, so the
mirror and the kernels' twins share one implementation.  A tile of no
active ray never falls back.  The rest of the JAX module (wave-action
histories, the reference window diagnostics, ``internal_ray_layout``)
is ROADMAP queue 1, item 7.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import ray_physics, rhs_cuda


class WindowFallbackStats(NamedTuple):
    """Window coherence of a ray layout for the windowed kernels."""

    n_blocks: torch.Tensor       # tiles, all-inactive ones included
    n_fallback: torch.Tensor     # tiles whose span outgrows window_cells
    fallback_rate: torch.Tensor  # n_fallback / n_blocks
    # with a window_cells2 tier: tiles that outgrow both windows and read
    # at full width (equal to the above when the tier is off)
    full_rate: torch.Tensor


def block_window_bounds(dt, state, statics, bg, cfg,
                        tile_rays: int = ray_physics.TILE):
    """Per-tile touched-cell bounds ``(lo_b, hi_b, c_pad)`` of consecutive
    ``tile_rays``-ray tiles, as floats, by the kernels' arithmetic: the
    lookups at r and at ``r + cg_r dt`` and the deposit span.  An
    all-inactive tile gives ``lo_b = 1e9 > hi_b = -1e9``.  ``tile_rays``
    defaults to the kernels' tile; 1024 gives the JAX mirror's
    ``block_rows=8``."""
    params, (dt, bvf, _, _), tables = rhs_cuda.prepare_inputs(
        dt, state, statics, bg, cfg)
    n_tab = tables[2].shape[0]
    rt = ray_physics.ray_terms(rhs_cuda.ray_fields(state, statics),
                               statics.active,
                               ray_physics.geometry(params, n_tab), dt, bvf)
    lo, hi = ray_physics.window_bounds(rt, statics.active)
    return (*ray_physics.tile_bounds(lo, hi, tile_rays),
            rhs_cuda.c_pad_for(n_tab))


def window_fallback_stats(dt, state, statics, bg, cfg,
                          tile_rays: int = ray_physics.TILE
                          ) -> WindowFallbackStats:
    """How many tiles of the windowed kernels would leave their first
    window (``n_fallback``) and how many would read at full width, for the
    current ray layout.  The kernels stay exact either way; this makes a
    decohered layout visible at no cost to the kernels."""
    lo_b, hi_b, c_pad = block_window_bounds(dt, state, statics, bg, cfg,
                                            tile_rays)
    tier, _, _ = ray_physics.tile_windows(
        lo_b, hi_b, c_pad, *rhs_cuda.resolve_window_cells(cfg, c_pad))
    n_blocks = torch.tensor(tier.numel())
    n_fallback = (tier != 1).sum()
    return WindowFallbackStats(n_blocks, n_fallback, n_fallback / n_blocks,
                               (tier == 0).sum() / n_blocks)
