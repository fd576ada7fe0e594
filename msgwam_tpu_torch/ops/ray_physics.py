"""Plain PyTorch twin of ``csrc/ray_physics.cuh``: the per-ray physics of
the ``hprop=False`` right-hand side and the per-tile height window, shared
by the twins of the kernels K2 (:mod:`.rhs_cuda`), K3/K4
(:mod:`.rhs_cuda_windowed`) and K5 (:mod:`.step_cuda`), and by the window
mirror :mod:`msgwam_tpu_torch.diagnostics`.

Each function computes what its CUDA namesake computes, in the same order
of operations, in the dtype of its inputs (float32 to hold a kernel to it,
float64 for an oracle).  The deposit is a dense ``(n, n_cells)`` weight
matrix with float64-combined block partials; for the per-stage kernels
K2-K4 and the deposit kernel K1 they are summed by those kernels' block
plan and order (:func:`stage_plan`, :func:`project_plan`,
:func:`sum_by_plan`), and :func:`wind_stage` is K4's update of the wind.

The window rule (``msgwam_tpu/ops/rhs_pallas_windowed.py:124-147``): the
rays of a tile of :data:`TILE` rays touch cells ``[lo, hi)``; the window
starts at ``lo`` rounded down to a multiple of 8, clipped to
``[0, c_pad - W]``, and the tile takes the first of ``W``, ``W2`` and the
full width that holds ``hi``.  A lookup reads only inside its tile's
window, which changes no result for an active ray.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..constants import ROT_EARTH
from .projection import _reduce_partials, block_partials

TILE = 256           # csrc/deposit.cuh kThreads: rays per tile
EMPTY_LO = 1e9       # an inactive ray's window bounds
EMPTY_HI = -1e9

# Williamson RK3 coefficients (c, b, first) of the three stages
RK3_STAGES = ((0.0, 0.0, True), (5.0 / 9.0, 15.0 / 16.0, False),
              (153.0 / 128.0, 8.0 / 15.0, False))


class Geometry(NamedTuple):
    g0c: torch.Tensor      # first cell center
    dz: torch.Tensor
    g0f: torch.Tensor      # first interior face
    idz: torch.Tensor
    hi_c: torch.Tensor     # last center
    hi_f: torch.Tensor     # last interior face
    n_tab: int             # centers (rho's table)
    n_flux: int            # interior faces (the shears' table) = deposit cells
    nzmax: int


def geometry(params, n_tab: int) -> Geometry:
    """``params`` is ``(g0c, dz, g0f)``, as the kernels read it."""
    g0c, dz, g0f = params[0], params[1], params[2]
    return Geometry(g0c, dz, g0f, 1.0 / dz, g0c + (n_tab - 1.0) * dz,
                    g0f + (n_tab - 2.0) * dz, n_tab, n_tab - 1, n_tab - 2)


class RayTerms(NamedTuple):
    """What each ray contributes before the winds are known."""

    kh2: torch.Tensor
    ik2: torch.Tensor
    cgr: torch.Tensor
    r_lo: torch.Tensor
    r_up: torch.Tensor
    fvk: torch.Tensor      # deposit values (zero unless live)
    fvl: torch.Tensor
    nlow: torch.Tensor     # clamped cell span [nlow, nup)
    nup: torch.Tensor
    live: torch.Tensor
    qf: torch.Tensor       # hat coordinate of the shear lookup at r
    qr: torch.Tensor       # ... of the rho lookup at r + cg_r dt


def ray_terms(fields, act, g: Geometry, dt, bvf) -> RayTerms:
    """``fields`` is the 11-tuple ``(dens, r, dr, k, l, m, dm, phi, dkk,
    dll, area)``."""
    dens, r, dr, k, l, m, dm, phi, dkk, dll, area = fields
    ff = 2.0 * ROT_EARTH * torch.sin(phi)
    kh2 = k * k + l * l
    k2 = kh2 + m * m
    ik2 = 1.0 / k2
    om2 = (bvf * bvf * kh2 + ff * ff * m * m) * ik2
    cgr = -m * (om2 - ff * ff) * torch.rsqrt(om2) * ik2

    # deposit inputs: indices from r * (1/dz), 1/dz folded into the values
    r_lo = r - 0.5 * dr
    r_up = r + 0.5 * dr
    nlow = (r_lo * g.idz).to(torch.int64)
    nup = (r_up * g.idz + 1.0).to(torch.int64)
    ood = ((nlow >= g.nzmax) & (nup >= g.nzmax)) | ((nlow <= 0) & (nup <= 0))
    live = act & ~ood
    pv = torch.abs(dkk * dll * dm)
    fv = cgr * dens * g.idz
    zero = torch.zeros_like(r)
    fvk = torch.where(live, fv * k * pv, zero)
    fvl = torch.where(live, fv * l * pv, zero)

    qf = (torch.clamp(r, g.g0f, g.hi_f) - g.g0f) * g.idz
    qr = (torch.clamp(r + cgr * dt, g.g0c, g.hi_c) - g.g0c) * g.idz
    return RayTerms(kh2, ik2, cgr, r_lo, r_up, fvk, fvl,
                    torch.clamp(nlow, 0, g.nzmax), torch.clamp(nup, 0, g.nzmax),
                    live, qf, qr)


class RayWindow(NamedTuple):
    """Each ray's read window ``[base, base + width)`` of tables padded
    with zeros to ``c_pad`` entries."""

    base: torch.Tensor
    width: torch.Tensor
    c_pad: int


def lookup(table, q, window: Optional[RayWindow] = None):
    """Two-point interpolation at hat coordinates ``q >= 0``, ``i`` clamped
    to ``len - 2``; with a window, the two entries read are kept inside
    it (``interp_window``)."""
    i = torch.clamp(q.to(torch.int64), max=table.shape[0] - 2)
    t = q - i.to(q.dtype)
    if window is not None:
        table = F.pad(table, (0, window.c_pad - table.shape[0]))
        i = window.base + torch.minimum(torch.clamp(i - window.base, min=0),
                                        window.width - 2)
    return table[i] * (1.0 - t) + table[i + 1] * t


def tendencies(fields, act, rt: RayTerms, du, dv, rho, dt, bvf, kappa, f0,
               online: bool, faithful: bool) -> dict:
    """dm/dt and the online saturation tendency; 0 on inactive rays."""
    dens, r, dr, k, l, m, dm, phi, dkk, dll, area = fields
    zero = torch.zeros_like(r)
    dmm = -(k * du + l * dv)
    if online:
        m_fin = m + dmm * dt
        dmm_fin = area / dr
        omh2 = (bvf * bvf * rt.kh2 + f0 * f0 * m * m) * rt.ik2
        cap = (kappa * kappa * 0.5 * rho * omh2 * torch.rsqrt(omh2) * bvf * bvf
               / (m_fin * m_fin * (omh2 - f0 * f0)))
        pvol = dkk * dll * dmm_fin
        cap_applied = cap if faithful else cap / pvol
        dst = torch.where(cap < dens * pvol, (cap_applied - dens) * (1.0 / dt),
                          zero)
    else:
        dst = zero
    return {"dens": torch.where(act, dst, zero),
            "r": torch.where(act, rt.cgr, zero),
            "m": torch.where(act, dmm, zero)}


_THREES = {}    # (dtype, device) -> the 0-d tensor 3


def third(q):
    """``q / 3`` by division on every device.  The divisor is a 0-d tensor
    on ``q``'s device, made once for each dtype and device, not the Python
    3.0: on the card torch divides by a Python scalar (or a 0-d CPU tensor)
    as a product with its reciprocal, one rounding off the kernels'
    division; on the CPU both divide."""
    key = (q.dtype, q.device)
    three = _THREES.get(key)
    if three is None:
        three = _THREES[key] = torch.full((), 3.0, dtype=q.dtype,
                                          device=q.device)
    return q / three


def rk3_stage(tend, y, q, dt, cc, bc, first: bool):
    """One Williamson RK3 stage: ``(y', q')`` with ``q' = dt f - c q`` and
    ``y' = y + b q'``; the first stage adds ``q'/3`` by division
    (:func:`third`)."""
    if first:
        q = dt * tend
        return y + third(q), q
    q = dt * tend - cc * q
    return y + bc * q, q


def window_bounds(rt: RayTerms, act):
    """Each ray's touched-cell bounds ``(lo, hi)`` as floats: the hat reads
    of both lookups and the deposit span; the empty span on inactive
    rays."""
    fq, rq = torch.floor(rt.qf), torch.floor(rt.qr)
    lo = torch.minimum(torch.minimum(fq, rq) - 1.0, rt.nlow.to(fq.dtype))
    hi = torch.maximum(torch.maximum(fq, rq) + 2.0, rt.nup.to(fq.dtype))
    return torch.where(act, lo, EMPTY_LO), torch.where(act, hi, EMPTY_HI)


def tile_bounds(lo, hi, tile: int = TILE):
    """Per-tile ``(lo, hi)`` of consecutive ``tile``-ray tiles; the last
    tile is padded with empty spans."""
    pad = -lo.shape[0] % tile
    lo = F.pad(lo, (0, pad), value=EMPTY_LO)
    hi = F.pad(hi, (0, pad), value=EMPTY_HI)
    return lo.view(-1, tile).amin(dim=1), hi.view(-1, tile).amax(dim=1)


def tile_windows(lo_b, hi_b, c_pad: int, w1: int, w2: int):
    """The window rule per tile: ``(tier, base, width)``, tier 1 for the
    first window, 2 for the second, 0 for the full width."""
    lo8 = torch.div(lo_b.to(torch.int64), 8, rounding_mode="floor") * 8
    win = torch.clamp(lo8, 0, c_pad - w1)
    ok = hi_b - win.to(hi_b.dtype) <= w1
    tier = torch.where(ok, 1, 0)
    base = torch.where(ok, win, 0)
    width = torch.where(ok, w1, c_pad)
    if w2:
        win2 = torch.clamp(lo8, 0, c_pad - w2)
        ok2 = ~ok & (hi_b - win2.to(hi_b.dtype) <= w2)
        tier = torch.where(ok2, 2, tier)
        base = torch.where(ok2, win2, base)
        width = torch.where(ok2, w2, width)
    return tier, base, width


def ray_window(lo, hi, c_pad: int, w1: int, w2: int):
    """``(tiers, RayWindow)``: the tiles' windows, spread to their rays."""
    tier, base, width = tile_windows(*tile_bounds(lo, hi), c_pad, w1, w2)
    tile_of = torch.arange(lo.shape[0], device=lo.device) // TILE
    return tier, RayWindow(base[tile_of], width[tile_of], c_pad)


class StagePlan(NamedTuple):
    """The block plan of the per-stage kernels K2-K4
    (``csrc/rhs_windowed.cu:msgwam_rhs_plan``) and of the deposit kernel K1
    (``csrc/projection.cu:msgwam_project_plan``)."""

    blocks: int      # block b owns tiles b, b + blocks, ...
    reducers: int    # the last blocks to arrive, which sum the flux


STAGE_BLOCKS_PER_SM = 4    # kStageBlocksPerSm
MAX_REDUCERS = 256         # kMaxReducers, kProjReducers
H100_SMS = 132             # an H100 SXM's SMs
PROJ_BLOCKS_PER_SM = 4     # csrc/projection.cu kProjBlocksPerSm


def stage_plan(n: int, n_flux: int, sms: int = H100_SMS) -> StagePlan:
    """The plan of K2-K4 for ``n`` rays on a card of ``sms`` SMs: one block
    per 256-ray tile up to 4 per SM, and one reducer per wind cell
    (``n_flux + 1``), at most 256 and at most the blocks.  The kernels, their twins
    (:func:`deposit`) and :mod:`msgwam_tpu_torch.diagnostics` take the plan
    from here."""
    blocks = min(-(-n // TILE), STAGE_BLOCKS_PER_SM * sms)
    return StagePlan(blocks, min(blocks, n_flux + 1, MAX_REDUCERS))


def project_plan(n: int, n_cells: int, sms: int = H100_SMS) -> StagePlan:
    """The plan of K1 for ``n`` rays on ``n_cells`` cells on a card of
    ``sms`` SMs: one block per 256-ray tile up to 4 per SM, and one
    reducer per cell, at most 256 and at most the blocks."""
    blocks = min(-(-n // TILE), PROJ_BLOCKS_PER_SM * sms)
    return StagePlan(blocks, min(blocks, n_cells, MAX_REDUCERS))


def tile_blocks(n: int, plan: StagePlan) -> torch.Tensor:
    """The block of each 256-ray tile under ``plan``."""
    return torch.arange(-(-n // TILE)) % plan.blocks


GROUP = 64    # threads that sum one flux entry in a reducer


def reduce_group(blocks: int) -> int:
    """K1's threads per flux entry in a reducer: the blocks rounded up to a
    power of two, at most 64 (``csrc/projection.cu:reduce_group``); K2-K4
    always take :data:`GROUP`."""
    g = 1
    while g < blocks and g < GROUP:
        g *= 2
    return g


def sum_blocks(parts: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """The kernels' sum of ``(blocks, entries)`` float64 block partials,
    per entry, as a reducer adds them with a group of ``group`` threads
    (a power of two up to 64): thread ``t`` adds blocks ``t, t + group,
    ...`` in order, then a butterfly over the group's lanes (xor
    ``group/2 .. 1``); a group of 64 is two warps, each combining its 32
    thread sums by xor 16, 8, 4, 2, 1, and the two warp sums are added.  A
    block that did not touch a cell adds an exact zero there."""
    nb = parts.shape[0]
    parts = F.pad(parts, (0, 0, 0, -nb % group)).view(-1, group, parts.shape[1])
    lanes = parts[0]
    for k in range(1, parts.shape[0]):
        lanes = lanes + parts[k]
    width = min(group, 32)
    lanes = lanes.view(group // width, width, -1)
    idx = torch.arange(width, device=parts.device)
    off = width // 2
    while off:
        lanes = lanes + lanes[:, idx ^ off]
        off //= 2
    return lanes[0, 0] + lanes[1, 0] if group == 64 else lanes[0, 0]


def sum_by_plan(prod: torch.Tensor, plan: StagePlan,
                group: int = GROUP) -> torch.Tensor:
    """The kernels' sum of per-ray products ``(n, entries)`` under
    ``plan``: in float64 per 256-ray tile, per block of the plan (block
    ``b`` holds tiles ``b, b + blocks, ...``) in tile order, and the blocks
    as :func:`sum_blocks` with ``group``.  Returns ``(entries,)``
    float64."""
    n = prod.shape[0]
    prod = F.pad(prod.to(torch.float64), (0, 0, 0, -n % TILE))
    tiles = prod.view(-1, TILE, prod.shape[1]).sum(dim=1)
    per_block = torch.zeros((plan.blocks, tiles.shape[1]), dtype=torch.float64,
                            device=tiles.device)
    per_block.index_add_(0, tile_blocks(n, plan).to(tiles.device), tiles)
    return sum_blocks(per_block, group)


def deposit(rt: RayTerms, g: Geometry, plan: Optional[StagePlan] = None):
    """The ``(2, n_flux)`` flux from a dense overlap-weight matrix.

    Without ``plan`` (K5's twin): block partials of 8192 rays and a
    float64 combination.  With the per-stage kernels' ``plan``: each
    ray's products ``overlap * value`` in the input dtype, summed in
    float64 by the plan (:func:`sum_by_plan`)."""
    dtype = rt.r_lo.dtype
    c = torch.arange(g.n_flux, device=rt.r_lo.device)
    cf = c.to(dtype)
    face_lo = g.g0c + cf * g.dz
    face_hi = g.g0c + (cf + 1.0) * g.dz
    in_span = (c >= rt.nlow[:, None]) & (c < rt.nup[:, None])
    w = torch.abs(torch.minimum(face_hi, rt.r_up[:, None])
                  - torch.maximum(face_lo, rt.r_lo[:, None]))
    w = torch.where(in_span, w, torch.zeros_like(w))
    if plan is None:
        return _reduce_partials(block_partials(torch.stack([rt.fvk, rt.fvl]), w),
                                "f64", dtype)
    prod = torch.cat([w * rt.fvk[:, None], w * rt.fvl[:, None]], dim=1)
    return sum_by_plan(prod, plan).to(dtype).view(2, g.n_flux)


def wind_stage(flux, u, v, qu, qv, pg, rhobar, dzf, ff0, dt, cc, bc,
               first: bool):
    """The wind's RK3 stage update from a stage's ``(2, n_flux)`` flux, in
    the order of operations of K4's last reducer: the flux padded by copy
    at both ends, its divergence over ``dzf``, Coriolis ``ff0``, the
    pressure gradient over ρ̄, then the q/y update.  Both components at
    once, ``(2, n_cell)``: the sharded K4 step runs this after each
    stage's all-reduce, 14-16 torch operations.  Returns ``(u, v, qu,
    qv)``."""
    padded = torch.cat([flux[:, :1], flux, flux[:, -1:]], dim=1)
    grad = (padded[:, 1:] - padded[:, :-1]) / dzf
    # ff0 * (-u) is -ff0 * u to the bit: a product's rounding is symmetric
    tend = ff0 * torch.stack([v, -u]) - (pg + grad) / rhobar
    q = None if first else torch.stack([qu, qv])
    uv, q = rk3_stage(tend, torch.stack([u, v]), q, dt, cc, bc, first)
    return uv[0], uv[1], q[0], q[1]


def fused(params, scalars, tables, fields, act, online: bool, faithful: bool,
          window=None, plan: Optional[StagePlan] = None):
    """The fused RHS of one evaluation: ``(tendencies, flux, tiers)``.

    ``scalars`` is ``(dt, bvf, kappa, f0)``, ``tables`` ``(du_dz, dv_dz,
    rhobar)``.  ``window`` is ``None`` for the full width (K2, ``tiers``
    is then ``None``) or ``(c_pad, w1, w2)`` for the per-tile window of
    K3-K5.  ``plan``: the per-stage kernels' block plan for the flux's sum
    (:func:`deposit`)."""
    dt, bvf, kappa, f0 = scalars
    du_dz, dv_dz, rhobar = tables
    g = geometry(params, rhobar.shape[0])
    rt = ray_terms(fields, act, g, dt, bvf)
    tiers = win = None
    if window is not None:
        lo, hi = window_bounds(rt, act)
        tiers, win = ray_window(lo, hi, *window)
    du = lookup(du_dz, rt.qf, win)
    dv = lookup(dv_dz, rt.qf, win)
    rho = lookup(rhobar, rt.qr, win) if online else None
    tend = tendencies(fields, act, rt, du, dv, rho, dt, bvf, kappa, f0,
                      online, faithful)
    return tend, deposit(rt, g, plan), tiers
