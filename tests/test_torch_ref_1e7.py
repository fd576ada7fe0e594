"""The reference column at 1e7 ray volumes (``portbench/configs/ref_1e7.json``)
on the CPU: K5's block plan there, the placement counts of K5-K7 (tiles on
chip, streamed, windows in the device-memory scratch) from the twins
against the mirror plan, the bound that counts the streamed rays' bytes
(``portbench/roofline_stream.py``) and its readers, and the port's whole
run on the configuration's physics against the benchmark's float64
reference."""

import functools
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import msgwam_tpu_torch as prog
from msgwam_tpu_torch.ops import rhs_cuda, step_cuda
from msgwam_tpu_torch.utils import profiling
from portbench import check, manifest, roofline, roofline_stream, spans, traffic
from portbench.trace import Event, Window

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"
N_1E7 = 10_000_000
SEED = 2**31 + 21


def _conf(name, n_ray):
    return dict(json.loads((CONFIGS / f"{name}.json").read_text()), n_ray=n_ray)


def _one_sm(monkeypatch):
    """The mirror plan of a card with one SM (4 tile blocks of 1 + 7 tiles
    on chip), so that a population the CPU runs streams tiles."""
    monkeypatch.setattr(step_cuda, "resident_plan",
                        functools.partial(step_cuda.resident_plan, sms=1))


# ---------------------------------------------------------------------------
# the plan at 1e7
# ---------------------------------------------------------------------------

def test_k5_plan_at_1e7():
    """528 tile blocks of at most 74 tiles, 7 shared-memory slots: 4,224 of
    39,063 tiles on chip (89.19% streamed), and a 10-row window scratch
    holding 5,271 tile windows a stage."""
    plan = step_cuda.resident_plan(N_1E7)
    assert tuple(plan) == (528, 528, 74, 7, 44800, 4224, 39063)
    assert 1 - plan.on_chip_share == pytest.approx(0.8919, abs=5e-5)
    assert plan.scratch_windows == 5271
    work = step_cuda.scratch(plan, N_1E7, 1, 99, "meta")
    assert work[-1].shape == (plan.tiles_per_block - step_cuda.WIN_SHARED, 528) \
        == (10, 528)
    assert work[3].shape == (8, N_1E7)


@pytest.mark.parametrize("n,want", [(1_000_000, 0), (8_650_000, 0),
                                    (8_700_000, 193), (17_000_000, 32_615)])
def test_scratch_windows_count_each_block_past_its_64th_tile(n, want):
    plan = step_cuda.resident_plan(n)
    by_block = sum(max(0, -(-(plan.tiles - r) // plan.tile_blocks)
                       - step_cuda.WIN_SHARED) for r in range(plan.tile_blocks))
    assert plan.scratch_windows == by_block == want


# ---------------------------------------------------------------------------
# the placement counts
# ---------------------------------------------------------------------------

def test_placement_counts_of_k5s_twin_follow_the_mirror_plan(monkeypatch):
    """Two one-step launches of 70,000 rays on a one-SM plan: 274 tiles, 32
    on chip, 18 windows past a block's 64th; each times 2 steps and 3
    stages.  Nothing is counted without a profiler, and ``reset_counts``
    zeroes the counts."""
    _one_sm(monkeypatch)
    n = 70_000
    s = traffic.setup(_conf("ref_1e7", n), SEED, torch.device("cpu"))
    run = prog.RunConfig(dt=120.0, n_steps=2, save_every=1)
    day = lambda: prog.simulate_resident(s.state0, s.statics0, s.bg, s.cfg, run)
    ops = step_cuda.operands(s.state0, s.statics0, s.bg, s.cfg, 120.0)
    plan = step_cuda.mirror_plan(n, 1, ops)
    assert (plan.tiles, plan.on_chip_tiles, plan.scratch_windows) == (274, 32, 18)
    profiling.reset_counts()
    day()
    assert profiling.counts()["placement"]["K5"] == dict.fromkeys(
        profiling.PLACES, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        day()
    got = profiling.counts()["placement"]
    assert got["K5"] == {"on_chip": 6 * 32, "streamed": 6 * 242,
                         "win_scratch": 6 * 18}
    assert got["K6"] == got["K7"] == dict.fromkeys(profiling.PLACES, 0)
    profiling.reset_counts()
    assert all(v == dict.fromkeys(profiling.PLACES, 0)
               for v in profiling.counts()["placement"].values())


@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_placement_counts_of_the_stream_twins(kernel):
    """K6 (the tidal column's lifecycle) and K7 (eight members) count as K5
    does, from the mirror plan of each launch's members."""
    name, n = ("tidal_1e5", 600) if kernel == "K6" else ("ens8_125k", 8 * 300)
    s = traffic.setup(_conf(name, n), SEED, torch.device("cpu"))
    run = prog.RunConfig(dt=120.0, n_steps=2, save_every=1)
    members = max(1, s.members)
    n_tab = s.bg.centers.shape[0]
    plan = step_cuda.resident_plan(n // members, members, rhs_cuda.c_pad_for(n_tab),
                                   n_tab - 1, s.cfg.saturate_online,
                                   s.cfg.prognostic_mean)
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        if s.members:
            prog.parallel.ensemble_simulate(s.state0, s.statics0, s.bg, s.cfg, run,
                                            backend="mega")
        else:
            prog.simulate_resident(s.state0, s.statics0, s.bg, s.cfg, run,
                                   source=s.source, wind_fn=s.wind_fn)
    stages = 3 * 2 * members
    got = profiling.counts()["placement"]
    assert got[kernel] == {"on_chip": stages * plan.on_chip_tiles,
                           "streamed": stages * (plan.tiles - plan.on_chip_tiles),
                           "win_scratch": stages * plan.scratch_windows}
    assert got[kernel]["on_chip"] > 0
    assert got["K5"] == dict.fromkeys(profiling.PLACES, 0)
    profiling.reset_counts()


# ---------------------------------------------------------------------------
# the bound with streamed bytes, and its readers
# ---------------------------------------------------------------------------

def test_capacity_from_the_data_sheet():
    assert roofline_stream.ON_CHIP_BYTES == 65_421_312
    assert roofline_stream.CAPACITY_RAYS == 1_168_238
    # the least a streamed ray moves in a step: state in and out and the
    # frozen terms in, each stage; q in at stages 2-3, out at stages 1-2
    stages = [(12 + 12 + 32) + (12 if s > 1 else 0) + (12 if s < 3 else 0)
              for s in (1, 2, 3)]
    assert stages == [68, 80, 68]
    assert roofline_stream.STREAM_STEP_BYTES == sum(stages) == 216


@pytest.mark.parametrize("n,cells,steps", [
    (100_000, 2.0, 72), (1_000_000, 5.5, 72), (1_000_000, 2.0, 10),
    (roofline_stream.CAPACITY_RAYS, 2.0, 72)])
@pytest.mark.parametrize("deposit", [True, False])
def test_stream_bound_is_the_whole_run_bound_on_chip(n, cells, steps, deposit):
    assert roofline_stream.whole_run_step_s(n, cells, steps, deposit) == \
        roofline.whole_run_step_s(n, cells, steps, deposit)


def test_stream_bound_at_1e7_by_hand():
    """57 B a ray a launch of 72 steps and 216 B a step for each of the
    8,831,762 rays past the capacity: 1.9156 GB a step, 0.572 ms at 3.35
    TB/s, against 0.069 ms of operations at 2 covered cells."""
    n_bytes = 57 * N_1E7 / 72 + 216 * (N_1E7 - 1_168_238)
    assert roofline_stream.step_bytes(N_1E7, 72) == pytest.approx(n_bytes)
    want = n_bytes / 3.35e12
    assert want == pytest.approx(0.5718e-3, rel=1e-3)
    assert 3 * N_1E7 * 154 / 67e12 == pytest.approx(0.069e-3, rel=1e-2)
    assert roofline_stream.whole_run_step_s(N_1E7, 2.0, 72, True) == \
        pytest.approx(want)


K5 = "void msgwam::step_resident_kernel<false, 128>(msgwam::ResidentArgs)"
K7 = "void msgwam::step_resident_kernel<true, 128>(msgwam::ResidentArgs)"
READERS = ("k5_roofline.stream", "step_mfu.stream", "stream_share.day")


def _ctx(events, wall_s, steps, kind="whole_run", slots=N_1E7, cells=2.0):
    return SimpleNamespace(
        driver=SimpleNamespace(kind=kind, lifecycle=False, save_every=72),
        trace=Window(events, [], wall_s, 0), trace_steps=steps, slots=slots,
        cells=cells, setup=SimpleNamespace(conf={"model": {"prognostic_mean": True}},
                                           members=0))


@pytest.mark.parametrize("name", READERS)
def test_stream_readers_find_nothing_without_a_trace(name, monkeypatch):
    monkeypatch.setattr(spans, "program_counts", lambda: None)
    ctx = _ctx([], 1.0, 72)
    ctx.trace = None
    assert manifest.reader(name)(ctx) is None


def test_stream_readers_on_a_window_by_hand(monkeypatch):
    """144 traced steps: K5 in 0.2 s of device time beside K7 and a copy,
    which it does not count, in a 0.25 s window; the placement of a
    program that counts it, and ``None`` from one that does not."""
    evs = [Event(K5, 0, 120_000), Event("Memcpy DtoH", 120_000, 121_000),
           Event(K5, 125_000, 205_000), Event(K7, 206_000, 207_000)]
    ctx = _ctx(evs, 0.25, 144)
    bound = 144 * roofline_stream.whole_run_step_s(N_1E7, 2.0, 72, True)
    k5 = manifest.reader("k5_roofline.stream")(ctx)
    assert k5 == pytest.approx(100 * bound / 0.2)
    mfu = manifest.reader("step_mfu.stream")(ctx)
    assert mfu == pytest.approx(100 * bound / 0.25)
    assert 0 < mfu < k5 < 100
    # no K5 in the window, or a step loop's window: nothing to read
    assert manifest.reader("k5_roofline.stream")(_ctx(evs[3:], 0.25, 144)) is None
    assert manifest.reader("step_mfu.stream")(
        _ctx(evs, 0.25, 144, kind="stepwise")) is None
    counts = {"placement": {"K5": {"on_chip": 4224, "streamed": 34839,
                                   "win_scratch": 5271},
                            "K6": dict.fromkeys(profiling.PLACES, 0),
                            "K7": dict.fromkeys(profiling.PLACES, 0)}}
    monkeypatch.setattr(spans, "program_counts", lambda: counts)
    share = manifest.reader("stream_share.day")(ctx)
    assert share == pytest.approx(100 * 34839 / 39063)
    assert round(share, 2) == 89.19
    for got in ({"K5": {"full": 1, "first": 2, "second": 0}}, None):
        monkeypatch.setattr(spans, "program_counts", lambda: got)
        assert manifest.reader("stream_share.day")(ctx) is None
    zero = {"placement": {k: dict.fromkeys(profiling.PLACES, 0)
                          for k in ("K5", "K6", "K7")}}
    monkeypatch.setattr(spans, "program_counts", lambda: zero)
    assert manifest.reader("stream_share.day")(ctx) is None


# ---------------------------------------------------------------------------
# the whole run on ref_1e7's physics against the float64 reference
# ---------------------------------------------------------------------------

STEPS = 6


def _item(s):
    return traffic.Item(0, STEPS, (s.state0.rays.dens, s.state0.rays.r,
                                   s.state0.rays.m, s.statics0.active),
                        (s.u0, s.v0), None, None)


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def test_k5_twin_in_float64_follows_the_reference():
    """K5's plain twin, in float64 from the configuration's float32 inputs,
    against the benchmark's reference at the reference tests' tolerances:
    the rays to float64 round-off, the wind's change to 1e-6 of itself."""
    s = traffic.setup(_conf("ref_1e7", 600), SEED, torch.device("cpu"))
    d = lambda x: x.to(torch.float64)
    rays = s.state0.rays._replace(**{f: d(getattr(s.state0.rays, f))
                                     for f in s.state0.rays._fields})
    statics = s.statics0._replace(dkk=d(s.statics0.dkk), dll=d(s.statics0.dll),
                                  rr_mm_area=d(s.statics0.rr_mm_area))
    bg = prog.Background(*(d(x) for x in s.bg))
    state = prog.State(rays, prog.MeanState(d(s.u0), d(s.v0)))
    ops = step_cuda.operands(state, statics, bg, s.cfg, 120.0)
    dens, r, m, uv, _ = step_cuda.step_resident_reference(
        ops, rays.dens, rays.r, rays.m, torch.stack([d(s.u0), d(s.v0)]), STEPS)
    want, want_u, _ = check.run_item(_item(s), s, torch.float64)
    for f, got in (("dens", dens), ("r", r), ("m", m)):
        assert _rel(got, getattr(want, f)) < 1e-10, f
    du = want_u - d(s.u0)
    assert float((uv[0] - want_u).abs().max() / du.abs().max()) < 1e-6
    gaps = check.gaps(_item(s), s, ((dens, r, m, s.statics0.active), uv[0]),
                      (want, want_u))
    assert gaps["flux_gap"] < 1e-8 and gaps["rays_off"] == 0.0


def test_ordered_whole_run_in_float32_follows_the_reference(monkeypatch):
    """``simulate_resident`` (K5's twin on the CPU) in float32, its tiles
    ordered before each launch as at 1e7, against the float64 reference
    from the same inputs: every ray within the check's 1e-3, the flux and
    the wind's change within float32 round-off of a few steps."""
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", 1)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", 1)
    s = traffic.setup(_conf("ref_1e7", 600), SEED, torch.device("cpu"))
    run = prog.RunConfig(dt=120.0, n_steps=STEPS, save_every=STEPS // 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        final, st, _ = prog.simulate_resident(s.state0, s.statics0, s.bg, s.cfg,
                                              run)
    assert sum(e.name == "msgwam.whole_run.sort" for e in prof.events()) == 2
    want, want_u, _ = check.run_item(_item(s), s, torch.float64)
    for f in ("r", "m"):
        assert _rel(getattr(final.rays, f), getattr(want, f)) < 3e-5, f
    gaps = check.gaps(_item(s), s, ((final.rays.dens, final.rays.r,
                                     final.rays.m, st.active), final.mean.u),
                      (want, want_u))
    assert gaps["rays_off"] == 0.0
    assert gaps["flux_gap"] < 1e-5 and gaps["wind_gap"] < 1e-5
    profiling.reset_counts()
