"""Diagnostics of the port: the counterpart of :mod:`msgwam_tpu.diagnostics`.

Ported: the window mirror of the windowed kernels K3-K6
(``msgwam_tpu/diagnostics.py:206-338``): which tiles of the current ray
layout a kernel would run in its first window, its second tier or at full
width.  It mirrors **the port's** kernels, whose tile is 256 rays (the
TPU's was 8192) and whose rule is :mod:`.ops.ray_physics`' own, so the
mirror and the kernels' twins share one implementation.  A tile of no
active ray never falls back.  :func:`stage_partials`: the flux partials
each block of the per-stage kernels K2-K4 publishes under their block plan
(:func:`msgwam_tpu_torch.ops.ray_physics.stage_plan`, the plan the kernels
and their twins take).  And :func:`internal_ray_layout`, the layout the
launch-sorted K6 saw.  The rest of the JAX module (wave-action histories,
the reference window diagnostics) is ROADMAP queue 1, item 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import ray_physics, rhs_cuda
from .state import State, tree_map


def internal_ray_layout(state, statics, perm):
    """Per-ray state and statics in the launch-sorted layout that K6's
    last launch ran over.

    ``perm`` is the final slot permutation of
    ``simulate_streaming(..., return_final_perm=True)``: ``perm[i]`` is the
    caller's slot at internal position ``i``.  The port pads to no tile
    multiple, so ``perm`` has one entry per ray; ids past the ray count
    (a longer ``perm``) take the last slot's fields and an inactive mask,
    as the JAX package pads.  Applied to the returned slot-ordered state it
    rebuilds what the kernel saw, so :func:`window_fallback_stats` measures
    that layout.  Returns ``(state, statics)`` of ``perm``'s length."""
    n = state.rays.r.shape[0]
    idx = torch.clamp(perm.long(), max=n - 1)
    pad = perm >= n

    def gather(x):
        return x[idx]

    rays = tree_map(gather, state.rays)
    statics_i = tree_map(gather, statics)
    active = statics_i.active & ~pad
    return State(rays, state.mean), statics_i._replace(active=active)


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


class StagePartials(NamedTuple):
    """The flux partials of one launch of K2-K4."""

    plan: ray_physics.StagePlan
    lo: torch.Tensor        # (blocks,) first cell the block's tiles touch
    hi: torch.Tensor        # (blocks,) one past the last; lo = hi = 0: none
    entries: torch.Tensor   # partials published: 2 * sum(hi - lo)


def stage_partials(dt, state, statics, bg, cfg,
                   sms: int = ray_physics.H100_SMS) -> StagePartials:
    """Which flux partials the blocks of K2-K4 would publish for the
    current ray layout on a card of ``sms`` SMs: block ``b`` of the plan
    owns tiles ``b, b + blocks, ...`` and publishes the cells its live rays'
    deposit spans touch, which the kernel's reducers then read; the other
    entries are exact zeros that they skip."""
    params, (dt, bvf, _, _), tables = rhs_cuda.prepare_inputs(
        dt, state, statics, bg, cfg)
    n_tab = tables[2].shape[0]
    n = state.rays.r.shape[0]
    rt = ray_physics.ray_terms(rhs_cuda.ray_fields(state, statics),
                               statics.active,
                               ray_physics.geometry(params, n_tab), dt, bvf)
    plan = ray_physics.stage_plan(n, n_tab - 1, sms)
    big = 1 << 30
    lo = torch.where(rt.live, rt.nlow, big)
    hi = torch.where(rt.live, rt.nup, -1)
    pad = -n % ray_physics.TILE
    lo = torch.nn.functional.pad(lo, (0, pad), value=big)
    hi = torch.nn.functional.pad(hi, (0, pad), value=-1)
    lo = lo.view(-1, ray_physics.TILE).amin(dim=1)
    hi = hi.view(-1, ray_physics.TILE).amax(dim=1)
    owner = ray_physics.tile_blocks(n, plan).to(lo.device)
    b_lo = torch.full((plan.blocks,), big, dtype=torch.int64, device=lo.device)
    b_hi = torch.full((plan.blocks,), -1, dtype=torch.int64, device=lo.device)
    b_lo = b_lo.scatter_reduce(0, owner, lo, "amin")
    b_hi = b_hi.scatter_reduce(0, owner, hi, "amax")
    empty = b_hi <= b_lo
    b_lo = torch.where(empty, 0, b_lo)
    b_hi = torch.where(empty, 0, b_hi)
    return StagePartials(plan, b_lo, b_hi, 2 * (b_hi - b_lo).sum())
