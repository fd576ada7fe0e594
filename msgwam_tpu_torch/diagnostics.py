"""Diagnostics of the port: the counterpart of :mod:`msgwam_tpu.diagnostics`.

The reference driver's conservation diagnostics (``raytracer.py:194-240``):
:func:`wave_action_history` (wave action, its flux and the flux's
tendency over a stacked history), :func:`reference_window_diagnostics`
(the same frame for frame with the driver's window arithmetic and index
quirk 3) and :func:`pseudo_momentum_flux`.  The JAX package ``vmap``s over
the frames; the port loops over them, one frame's deposits at a time
through ``project_backend(cfg.projection_backend)``, so the dense ``mxu``
weight is never stacked over frames, and ``"pallas"`` is two K1 calls a
frame.

The window mirror of the windowed kernels K3-K6
(``msgwam_tpu/diagnostics.py:206-338``): which tiles of the current ray
layout a kernel would run in its first window, its second tier or at full
width.  It mirrors **the port's** kernels, whose tile is 256 rays (the
TPU's was 8192) and whose rule is :mod:`.ops.ray_physics`' own, so the
mirror and the kernels' twins share one implementation.  A tile of no
active ray never falls back.  :func:`stage_partials`: the flux partials
each block of the per-stage kernels K2-K4 publishes under their block plan
(:func:`msgwam_tpu_torch.ops.ray_physics.stage_plan`, the plan the kernels
and their twins take).  And :func:`internal_ray_layout`, the layout the
launch-sorted K6 saw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig
from .ops import ray_physics, rhs_cuda
from .ops.dispersion import cg_r
from .ops.projection import project_backend
from .state import Background, State, tree_map


class WaveActionDiagnostics(NamedTuple):
    wave_action: torch.Tensor  # (n_t, n_face - 1)  on the face grid cells
    flux: torch.Tensor         # (n_t, n_cell - 1)  on the center-grid cells
    tendency: torch.Tensor     # (n_t, n_cell)      -d(flux)/dz, zero-padded


def _project_frame(dens, phi, r, dr, k, l, m, dm, dkk, dll, active,
                   grid, bvf, max_span, with_flux: bool, backend: str = "xla"):
    phase_vol = torch.abs(dkk * dll * dm)
    vals = cg_r(k, l, m, phi, bvf) * dens if with_flux else dens
    return project_backend(backend)(
        vals, r - 0.5 * dr, r + 0.5 * dr, phase_vol, active, grid, max_span
    )[0]


def _frame(history_rays, history_active, i: int, statics, bg: Background,
           cfg: ModelConfig):
    """Frame ``i``'s wave action on the face grid and its wave-action flux
    on the center grid."""
    rays = tree_map(lambda x: x[i], history_rays)
    args = (rays.dens, rays.phi, rays.r, rays.dr, rays.k, rays.l, rays.m,
            rays.dm, statics.dkk, statics.dll, history_active[i])
    kw = dict(bvf=cfg.bvf, max_span=cfg.max_span,
              backend=cfg.projection_backend)
    return (_project_frame(*args, bg.faces, with_flux=False, **kw),
            _project_frame(*args, bg.centers, with_flux=True, **kw))


def _tendency(flux, bg: Background):
    """-d(flux)/dz on the interior, zero at both profile edges."""
    dz = bg.faces[1] - bg.faces[0]
    interior = -(flux[:, 1:] - flux[:, :-1]) / dz
    pad = torch.zeros((flux.shape[0], 1), dtype=flux.dtype, device=flux.device)
    return torch.cat([pad, interior, pad], dim=1)


def wave_action_history(history_rays, history_active, statics,
                        bg: Background, cfg: ModelConfig
                        ) -> WaveActionDiagnostics:
    """The reference's conservation diagnostics over a stacked history
    (leading time axis on every ray field), one frame at a time:

    * wave action (var=2) projected onto the *face* grid
      (``raytracer.py:210-223``),
    * wave-action flux (var=1) onto the *center* grid
      (``raytracer.py:225-231``),
    * tendency = -Δflux/Δz, zero at the profile edges
      (``raytracer.py:234-237``).
    """
    wa, flux = zip(*(_frame(history_rays, history_active, i, statics, bg, cfg)
                     for i in range(history_rays.dens.shape[0])))
    flux = torch.stack(flux)
    return WaveActionDiagnostics(torch.stack(wa), flux, _tendency(flux, bg))


def reference_window_diagnostics(history_rays, history_active, statics,
                                 bg: Background, cfg: ModelConfig
                                 ) -> WaveActionDiagnostics:
    """Frame-for-frame reproduction of the reference driver's diagnostics
    block (``raytracer.py:194-240``), including its window arithmetic and
    index quirks.  Expects a *full-rate* history that includes the initial
    condition as frame 0 (``simulate(..., save_every=1, include_t0=True)``:
    ``n_frames = n_steps + 1``).

    With ``nproj1 = n_frames - 4`` (``raytracer.py:198``):

    * ``wave_action`` has ``nproj1`` rows; rows ``0 .. nproj1-3`` are var=2
      projections of those frames onto the face grid; row ``nproj1-2`` is
      never filled (stays zero, ``raytracer.py:210-212``); row ``nproj1-1``
      is built from frame ``nproj1-1`` except ``rr_up``, which quirk 3
      reads from frame 0 (``raytracer.py:221``).
      ``cfg.faithful_diag_index=False`` corrects the index (the zero row
      is kept either way).
    * ``flux`` has ``nproj1 - 1`` rows; rows ``0 .. nproj1-3`` are var=1
      projections onto the center grid; the last row stays zero.
    * ``tendency`` is ``-Δflux/Δz`` zero-padded at both profile edges.
    """
    n_frames = history_rays.dens.shape[0]
    nproj1 = n_frames - 4
    if nproj1 < 3:
        raise ValueError(
            f"reference window needs n_frames >= 7, got {n_frames}")

    wa, flux = zip(*(_frame(history_rays, history_active, i, statics, bg, cfg)
                     for i in range(nproj1 - 2)))

    # the quirked last wave-action row (raytracer.py:219-223)
    last = tree_map(lambda x: x[nproj1 - 1], history_rays)
    src = tree_map(lambda x: x[0], history_rays) if cfg.faithful_diag_index \
        else last
    wa_last = project_backend(cfg.projection_backend)(
        last.dens, last.r - 0.5 * last.dr, src.r + 0.5 * src.dr,
        torch.abs(statics.dkk * statics.dll * last.dm),
        history_active[nproj1 - 1], bg.faces, cfg.max_span)[0]

    wa = torch.stack([*wa, torch.zeros_like(wa[0]), wa_last])
    flux = torch.stack([*flux, torch.zeros_like(flux[0])])
    return WaveActionDiagnostics(wa, flux, _tendency(flux, bg))


def pseudo_momentum_flux(rays, statics, bg: Background, cfg: ModelConfig):
    """Pseudo-momentum flux profile (u, v components) on the center grid:
    the wave→mean-flow observable (``lib/libprop.py:96,146-163``)."""
    phase_vol = torch.abs(statics.dkk * statics.dll * rays.dm)
    cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
    vals = torch.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens])
    return project_backend(cfg.projection_backend)(
        vals, rays.r - 0.5 * rays.dr, rays.r + 0.5 * rays.dr,
        phase_vol, statics.active, bg.centers, cfg.max_span)


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
