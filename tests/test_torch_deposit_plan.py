"""The block plan, the sum order and the binned walk of the deposit kernel
K1 (``csrc/projection.cu``), checked on the CPU: the plan mirror against
the kernel's constants and written-out cases, the twin's plan-order sum
against a direct float64 sum, and the kernel's placement of a tile's rays
into bins, step by step as the kernel computes it, against a stable sort by
first cell."""

import re

import numpy as np
import pytest
import torch

from msgwam_tpu_torch import _build
from msgwam_tpu_torch.ops import projection_cuda, ray_physics

torch.set_num_threads(1)


def _source_constant(name):
    text = (_build.SRC_DIR / "projection.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_project_plan_constants_are_the_kernels():
    assert ray_physics.PROJ_BLOCKS_PER_SM == _source_constant("kProjBlocksPerSm")
    assert ray_physics.MAX_REDUCERS == _source_constant("kProjReducers")
    assert projection_cuda.MAX_CELLS == 1024


@pytest.mark.parametrize("n, n_cells, sms, want", [
    (1, 99, 132, (1, 1)),
    (256, 99, 132, (1, 1)),
    (257, 99, 132, (2, 2)),
    (100_000, 99, 132, (391, 99)),
    (135_168, 99, 132, (528, 99)),
    (1_000_000, 99, 132, (528, 99)),
    (1_000_000, 99, 114, (456, 99)),
    (1_000_000, 256, 132, (528, 256)),
    (1_000_000, 1024, 132, (528, 256)),
    (100_000, 1024, 132, (391, 256)),
    (10_000, 24, 2, (8, 8)),
    (3000, 1, 132, (12, 1)),
])
def test_project_plan(n, n_cells, sms, want):
    """One block per 256-ray tile up to 4 per SM; one reducer per cell, at
    most 256 and at most the blocks."""
    assert tuple(ray_physics.project_plan(n, n_cells, sms)) == want


@pytest.mark.parametrize("n, n_cells, sms", [(3000, 99, 132), (70_000, 99, 132),
                                             (70_000, 99, 2), (20_000, 300, 1)])
def test_twin_plan_sum_against_a_direct_float64_sum(n, n_cells, sms):
    """In float64 the twin's deposit, summed tile by tile and block by block
    in the kernel's order, is a direct float64 sum of the same products to
    1e-12 relative to its maximum, with one tile per block and with many."""
    rng = np.random.default_rng(n + n_cells)
    grid = torch.linspace(0.0, 100e3, n_cells + 1, dtype=torch.float64)
    r = torch.tensor(rng.uniform(-5e3, 105e3, n))
    dr = torch.tensor(rng.uniform(100.0, 3e3, n))
    vals = torch.tensor(rng.normal(size=(2, n)))
    pv = torch.tensor(np.abs(rng.normal(1.0, 0.2, n)))
    valid = torch.tensor(rng.random(n) > 0.1)
    r_low, r_up = r - 0.5 * dr, r + 0.5 * dr
    plan = ray_physics.project_plan(n, n_cells, sms)
    got = projection_cuda.project_pallas_reference(vals, r_low, r_up, pv, valid,
                                                   grid, plan)
    dz = grid[1] - grid[0]
    nzmax = n_cells - 1
    nlow = (r_low / dz).to(torch.int64)
    nup = (r_up / dz + 1.0).to(torch.int64)
    ood = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    nlow, nup = nlow.clamp(0, nzmax), nup.clamp(0, nzmax)
    c = torch.arange(n_cells)
    w = torch.abs(torch.minimum(grid[1:], r_up[:, None])
                  - torch.maximum(grid[:-1], r_low[:, None]))
    span = (c >= nlow[:, None]) & (c < nup[:, None]) & (valid & ~ood)[:, None]
    w = torch.where(span, w, 0.0) * (pv / dz)[:, None]
    want = vals @ w
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def _reducer_order(parts, group):
    """A K1 reducer's order for one entry, written out: thread t of a group
    of ``group`` threads adds blocks t, t + group, ... in order; a group of
    up to 32 combines its thread sums by xor group/2 .. 1, a group of 64
    each of its two warps by xor 16 .. 1 and then warp 0's sum plus warp
    1's."""
    nb, ne = parts.shape
    out = []
    for e in range(ne):
        threads = [0.0] * group
        for b in range(nb):
            threads[b % group] += float(parts[b, e])
        warps = []
        for w in range(max(group // 32, 1)):
            lanes = threads[32 * w:32 * w + min(group, 32)]
            off = len(lanes) // 2
            while off:
                lanes = [lanes[l] + lanes[l ^ off] for l in range(len(lanes))]
                off //= 2
            warps.append(lanes[0])
        out.append(warps[0] + warps[1] if group == 64 else warps[0])
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 16, 33, 64, 65, 391, 1056])
def test_reducer_group_and_order(nb):
    """K1's reducers take groups of the blocks rounded up to a power of
    two, at most 64, and sum_blocks is their order to the bit."""
    group = ray_physics.reduce_group(nb)
    assert group == min(64, 1 << (nb - 1).bit_length())
    rng = np.random.default_rng(nb)
    parts = torch.tensor(rng.lognormal(0.0, 3.0, (nb, 5))
                         * rng.choice([-1.0, 1.0], (nb, 5)))
    assert torch.equal(ray_physics.sum_blocks(parts, group),
                       _reducer_order(parts, group))


def _kernel_bin_positions(nlow, nup, live):
    """Each live ray's position in a 256-ray tile placed by its first cell,
    computed as ``walk_binned`` does: per warp, the lanes of each key
    (``__match_any_sync``) and the lower ones among them, the leader writing
    the warp's count; per bin, the counts of the earlier warps in place of
    the count and the bin's total; an exclusive scan of the totals over the
    bins (each thread a run of bins, a warp scan, the warp totals).  Returns
    the positions (-1 for a dead ray) and the bins' starts."""
    tile = nlow.shape[0]
    warps = tile // 32
    cmin = int(nlow[live].min())
    width = int(nup[live].max()) - cmin
    key = np.where(live, nlow - cmin, -1)
    cnt = np.zeros((warps, width), np.int64)
    rank = np.zeros(tile, np.int64)
    for w in range(warps):
        for lane in range(32):
            i = 32 * w + lane
            peers = [l for l in range(32) if key[32 * w + l] == key[i]]
            rank[i] = sum(l < lane for l in peers)
            if live[i] and rank[i] == 0:
                cnt[w, key[i]] = len(peers)
    kb = -(-width // tile)
    start = np.zeros(width + 1, np.int64)
    totals = np.zeros(tile, np.int64)
    for t in range(tile):
        for b in range(t * kb, min(t * kb + kb, width)):
            run = 0
            for w in range(warps):
                cnt[w, b], run = run, run + cnt[w, b]
            start[b] = run
            totals[t] += run
    incl = np.cumsum(totals.reshape(warps, 32), axis=1)      # the warp scans
    wsum = incl[:, -1]
    for t in range(tile):
        w, lane = divmod(t, 32)
        pos = incl[w, lane] - totals[t] + wsum[:w].sum()
        for b in range(t * kb, min(t * kb + kb, width)):
            start[b], pos = pos, pos + start[b]
        if t == tile - 1:
            start[width] = pos
    out = np.full(tile, -1)
    for i in np.flatnonzero(live):
        out[i] = start[key[i]] + cnt[i // 32, key[i]] + rank[i]
    return out, start, cmin


def _tile(kind, rng):
    tile = 256
    live = rng.random(tile) > 0.2
    nlow = rng.integers(0, 79, tile)
    span = rng.integers(1, 6, tile)
    if kind == "one_bin":
        nlow[:] = 7
    elif kind == "distinct":
        nlow = rng.permutation(1000)[:tile]
    elif kind == "dead_warp":
        live[64:96] = False
    elif kind == "one_live":
        live[:] = False
        live[137] = True
    elif kind == "wide_grid":
        nlow = rng.integers(0, 1018, tile)
    return nlow, nlow + span, live


@pytest.mark.parametrize("kind", ["random", "one_bin", "distinct", "dead_warp",
                                  "one_live", "wide_grid"])
def test_binned_placement_is_a_stable_sort_by_first_cell(kind):
    """The kernel's placement of a tile's live rays is their order sorted by
    (first cell, ray index), whatever warps and lanes the rays sit in, and
    a cell's run of bins c - maxspan + 1 .. c holds every ray that covers
    it."""
    rng = np.random.default_rng(len(kind))
    nlow, nup, live = _tile(kind, rng)
    pos, start, cmin = _kernel_bin_positions(nlow, nup, live)
    order = sorted(np.flatnonzero(live), key=lambda i: (nlow[i], i))
    assert [int(np.flatnonzero(pos == p)[0]) for p in range(len(order))] == order
    assert start[-1] == live.sum()
    maxspan = int((nup - nlow)[live].max())
    placed = np.argsort(np.where(live, pos, 1 << 30))[:live.sum()]
    for c in range(cmin, int(nup[live].max())):
        rc = c - cmin
        run = placed[start[max(rc - maxspan + 1, 0)]:start[rc + 1]]
        got = sorted(i for i in run if nup[i] > c)
        assert got == sorted(np.flatnonzero(live & (nlow <= c) & (nup > c)))
