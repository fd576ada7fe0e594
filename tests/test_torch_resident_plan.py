"""The block plan of the whole-run kernel (K5-K7, csrc/step_resident.cu):
its Python mirror ``step_cuda.resident_plan`` for an H100, the on-chip
capacity it states, and (on a card) the kernel on both sides of that
capacity and with 8 members against its plain twin."""

import math

import pytest
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.ops import step_cuda, step_cuda_stream
from msgwam_tpu_torch.parallel import stack_ensemble
from msgwam_tpu_torch.state import tree_map

TOL = 3e-5
CAPACITY_TILES = 132 * 4 * 8        # 4 blocks per SM, 1 + 7 tiles each online

# (n_per, n_members, kwargs) -> (blocks per member, tile blocks, tiles per
# block, shared-memory slots, dynamic shared bytes, tiles on chip, tiles)
CASES = {
    "1e5": ((100_000, 1, {}), (528, 391, 1, 0, 8192, 391, 391)),
    "1e5_no_prognostic": ((100_000, 1, {"prognostic": False}),
                          (391, 391, 1, 0, 8192, 391, 391)),
    "1e6": ((1_000_000, 1, {}), (528, 528, 8, 7, 44800, 3907, 3907)),
    "1e6_offline": ((1_000_000, 1, {"online": False}),
                    (528, 528, 8, 5, 42240, 3168, 3907)),
    "configs4": ((125_000, 8, {}), (66, 66, 8, 7, 44800, 489, 489)),
    "above_capacity": ((2_000_000, 1, {}), (528, 528, 15, 7, 44800, 4224, 7813)),
    "c_pad_256": ((1_000_000, 1, {"c_pad": 256, "n_flux": 199}),
                  (528, 528, 8, 6, 38400, 3696, 3907)),
    "one_tile": ((200, 1, {}), (199, 1, 1, 0, 8192, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_plan_cases(case):
    (n_per, n_members, kw), want = CASES[case]
    plan = step_cuda.resident_plan(n_per, n_members, **kw)
    assert tuple(plan) == want
    assert plan.on_chip_share == plan.on_chip_tiles / plan.tiles


def test_on_chip_capacity_is_the_stated_one():
    """The capacity in the kernel's note: 4,224 tiles, 1,081,344 rays, and
    one ray more spills a tile to device memory."""
    n = CAPACITY_TILES * step_cuda.TILE
    assert n == 1_081_344
    assert step_cuda.resident_plan(n).on_chip_share == 1.0
    over = step_cuda.resident_plan(n + 1)
    assert over.on_chip_tiles == CAPACITY_TILES < over.tiles


def test_shared_memory_budget_of_an_h100():
    """Four blocks per SM fit: static plus dynamic plus the reserved
    kilobyte, four times, is at most the SM's 228 KB."""
    for c_pad in (128, 256):
        for online in (True, False):
            plan = step_cuda.resident_plan(10_000_000, c_pad=c_pad,
                                           n_flux=c_pad - 1, online=online)
            per_block = (step_cuda.fixed_smem(c_pad) + plan.smem_bytes
                         + step_cuda.H100["reserved"])
            assert 4 * per_block <= step_cuda.H100["smem_per_sm"]
            assert 4 * (per_block + step_cuda.slot_bytes(online)) \
                > step_cuda.H100["smem_per_sm"]      # one more slot would not


@pytest.mark.parametrize("n_per,n_members", [
    (1, 1), (255, 1), (257, 3), (33_000, 2), (400_000, 5), (3_000_000, 1),
    (1_000, 600)])
def test_resident_plan_invariants(n_per, n_members):
    for prognostic in (True, False):
        p = step_cuda.resident_plan(n_per, n_members, prognostic=prognostic)
        per_member = 4 * 132 // n_members
        assert p.tiles == math.ceil(n_per / 256)
        assert 1 <= p.tile_blocks <= p.tiles
        assert p.tile_blocks == max(1, min(p.tiles, per_member))
        assert p.tile_blocks <= p.blocks_per_member <= max(1, per_member)
        if not prognostic:
            assert p.blocks_per_member == p.tile_blocks
        assert p.blocks_per_member - p.tile_blocks <= 2 * 99
        assert p.tiles_per_block * p.tile_blocks >= p.tiles
        assert 0 <= p.smem_slots <= max(0, p.tiles_per_block - 1)
        assert p.on_chip_tiles <= p.tiles
        if p.smem_slots == p.tiles_per_block - 1:
            assert p.on_chip_tiles == p.tiles


def test_resident_plan_rejects_a_table_too_wide():
    with pytest.raises(ValueError, match="c_pad"):
        step_cuda.resident_plan(1000, c_pad=4096)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _bench(n, device):
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True, dtype="float32",
                                           rhs_backend="pallas", window_cells=-1)
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float32), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                             dtype=torch.float32, device=device)
    rays, statics = mtt.gaussian_spectrum_source(
        cfg, bg, n, dtype=torch.float32, device=device, z_launch=2000.0,
        dz_launch=500.0, amplitude_alpha=0.003)
    state = mtt.State(rays, mtt.MeanState(uu.to(device), torch.zeros_like(uu).to(device)))
    return cfg, bg, state, statics


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_000, 1_200_000, 10_000_000])
def test_k5_on_both_sides_of_the_capacity_on_gpu(cuda_device, n):
    cfg, bg, state, statics = _bench(n, cuda_device)
    ops = step_cuda.operands(state, statics, bg, cfg, 120.0)
    plan = step_cuda.device_plan(n, 1, ops, False)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert plan == step_cuda.resident_plan(n, 1, ops.c_pad, ops.n_tab - 1,
                                           ops.online, ops.prognostic, sms=sms)
    assert (plan.on_chip_share == 1.0) == (n <= 1_081_344)
    init = [state.rays.dens, state.rays.r, state.rays.m,
            torch.stack([state.mean.u, state.mean.v])]
    act = statics.active.to(torch.uint8)
    got = step_cuda.launch(ops, *[x.clone() for x in init], act, 3)
    again = step_cuda.launch(ops, *[x.clone() for x in init], act, 3)
    want = step_cuda.step_resident_reference(ops, *init, 3)
    for w, g in zip((*want[:3], want[3][0]), (*got[:3], got[3][0])):
        assert _rel(w, g) < TOL
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_k7_eight_members_on_gpu(cuda_device):
    cfg, bg, state, statics = _bench(125_000, cuda_device)
    members = [(state._replace(rays=state.rays._replace(
        dens=state.rays.dens * (1.0 + 0.1 * e))), statics) for e in range(8)]
    states, stats = stack_ensemble(members)
    flat = lambda tree: tree_map(torch.flatten, tree)
    fstate = mtt.State(flat(states.rays), mtt.MeanState(states.mean.u[0],
                                                        states.mean.v[0]))
    fstat = flat(stats)
    ops = step_cuda.operands(fstate, fstat, bg, cfg, 120.0)
    uv = torch.stack([states.mean.u, states.mean.v], dim=1).contiguous()
    act = fstat.active.to(torch.uint8)
    base = (fstate.rays.dens, fstate.rays.r, fstate.rays.m)
    got = step_cuda.launch(ops, *[x.clone() for x in (*base, uv)],
                           act.clone(), 3, n_members=8, stream=True)
    want = step_cuda_stream.step_stream_reference(ops, *base, uv, act, 3,
                                                  n_members=8)
    for w, g in zip((*want[:3], want[3][:, 0]), (*got[:3], got[3][:, 0])):
        assert _rel(w, g) < TOL
