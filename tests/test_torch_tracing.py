"""The port's spans and window-tier counts (``utils/profiling.py``) on the
CPU: off without a profiler, and under ``torch.profiler`` the spans of the
whole run (K5's twin), of Path A's step (K4's twin) and of Path C's
``simulate``, and the twins' tier counts against the window mirror of
``diagnostics``."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.diagnostics import window_fallback_stats
from msgwam_tpu_torch.ops import ray_physics, rhs_cuda, rhs_cuda_windowed, step_cuda
from msgwam_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 512


def _setup(n=N, tile_spans=None, **cfg_kw):
    """The bench population on the CPU in float32; ``tile_spans`` gives each
    256-ray tile a band of heights of its own width in km, cycling."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32", "rhs_backend": "pallas",
        **cfg_kw})
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float32), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                             dtype=torch.float32, device="cpu")
    rays, statics = mtt.gaussian_spectrum_source(cfg, bg, n, dtype=torch.float32)
    if tile_spans is not None:
        g = torch.Generator().manual_seed(0)
        tiles = -(-n // ray_physics.TILE)
        width = torch.tensor(tile_spans, dtype=torch.float64).repeat(tiles)[:tiles] * 1e3
        lo = 2e3 + torch.rand(tiles, generator=g, dtype=torch.float64) * (93e3 - width)
        per_ray = lambda x: x.repeat_interleave(ray_physics.TILE)[:n]
        r = per_ray(lo) + torch.rand(n, generator=g, dtype=torch.float64) * per_ray(width)
        rays = rays._replace(r=r.to(torch.float32))
    state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))
    return cfg, bg, state, statics


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("msgwam.")]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_off_without_a_profiler():
    """No profiler: one shared null context, no buffer, and a twin day
    counts nothing."""
    assert profiling.span("msgwam.a") is profiling.span("msgwam.b")
    assert profiling.tier_counter("cpu", "K5") is None
    profiling.reset_counts()
    cfg, bg, state, statics = _setup()
    mtt.simulate_resident(state, statics, bg, cfg,
                          mtt.RunConfig(dt=120.0, n_steps=4, save_every=2))
    got = profiling.counts()
    assert all(got[k] == {"full": 0, "first": 0, "second": 0}
               for k in profiling.KERNELS)


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7"])
def test_whole_run_spans_nest_every_launch(kernel):
    """A twin day of n launches: n launch spans, nested in one
    ``msgwam.whole_run`` with its prepare, frames and history (K6: a wind
    table a launch), and every tile window of every stage counted.  K7 is
    an ensemble day of two members through ``parallel.ensemble_simulate``
    (``backend="mega"``)."""
    kw = {}
    if kernel == "K6":
        kw = dict(cull=True, relaunch=True, m_max=2 * 3.141592653589793 / 300.0)
    cfg, bg, state, statics = _setup(**kw)
    run = mtt.RunConfig(dt=120.0, n_steps=6, save_every=2)
    extra = {}
    if kernel == "K6":
        u0 = state.mean.u
        extra = dict(source=(state.rays, statics),
                     wind_fn=lambda t: (u0 * torch.cos(t / 43200.0),
                                        torch.zeros_like(u0)))
    members = 2 if kernel == "K7" else 1
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if kernel == "K7":
            mtt.parallel.ensemble_simulate(
                *mtt.parallel.stack_ensemble([(state, statics)] * members), bg,
                cfg, run, backend="mega")
        else:
            mtt.simulate_resident(state, statics, bg, cfg, run, **extra)
    spans = _spans(prof)
    names = Counter(e.name for e in spans)
    assert names[f"msgwam.launch.{kernel.lower()}"] == 3
    assert names["msgwam.whole_run"] == names["msgwam.whole_run.prepare"] == 1
    assert names["msgwam.whole_run.frame"] == 3
    assert names["msgwam.whole_run.history"] == 1
    assert names["msgwam.whole_run.wind_table"] == (3 if kernel == "K6" else 0)
    outer = next(e for e in spans if e.name == "msgwam.whole_run")
    assert all(_inside(e, outer) for e in spans)
    assert sum(profiling.counts()[kernel].values()) == \
        6 * 3 * members * (N // ray_physics.TILE)


def test_k5_orders_its_tiles_in_a_sort_span_a_launch(monkeypatch):
    """K5's run: one ``msgwam.whole_run.sort`` a launch, before the launch
    inside the whole run, while a profiler records; without a session no
    range is made at all; launches of fewer steps than ``ORDER_MIN_STEPS``
    or fewer rays than ``ORDER_MIN_RAYS`` are not ordered."""
    cfg, bg, state, statics = _setup()
    run = mtt.RunConfig(dt=120.0, n_steps=6, save_every=2)
    for steps, rays in ((3, N), (2, N + 1)):
        monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", steps)
        monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", rays)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            mtt.simulate_resident(state, statics, bg, cfg, run)
        names = Counter(e.name for e in _spans(prof))
        assert names["msgwam.whole_run.sort"] == 0
        assert names["msgwam.launch.k5"] == 3
    monkeypatch.setattr(step_cuda, "ORDER_MIN_STEPS", 2)
    monkeypatch.setattr(step_cuda, "ORDER_MIN_RAYS", N)
    made = []

    def counted(name):
        made.append(name)
        return record_function(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    mtt.simulate_resident(state, statics, bg, cfg, run)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mtt.simulate_resident(state, statics, bg, cfg, run)
    assert Counter(made)["msgwam.whole_run.sort"] == 3
    spans = sorted(_spans(prof), key=lambda e: e.time_range.start)
    sorts = [e for e in spans if e.name == "msgwam.whole_run.sort"]
    launches = [e for e in spans if e.name == "msgwam.launch.k5"]
    outer = next(e for e in spans if e.name == "msgwam.whole_run")
    assert len(sorts) == len(launches) == 3
    for s_, l_ in zip(sorts, launches):
        assert _inside(s_, outer) and s_.time_range.end <= l_.time_range.start


def test_path_a_step_spans_three_k4_launches():
    cfg, bg, state, statics = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mtt.step(120.0, state, statics, bg, cfg)
    spans = _spans(prof)
    names = Counter(e.name for e in spans)
    assert names["msgwam.launch.k4"] == 3 and names["msgwam.step"] == 1
    assert names["msgwam.step.stages"] == 1
    outer = next(e for e in spans if e.name == "msgwam.step")
    assert all(_inside(e, outer) for e in spans)
    stages = next(e for e in spans if e.name == "msgwam.step.stages")
    assert all(_inside(e, stages) for e in spans
               if e.name == "msgwam.launch.k4")


def test_path_c_simulate_spans_its_lifecycle():
    """``simulate`` with a relaunch template and a wind: the wind, the
    cull and the relaunch each step, inside ``msgwam.simulate``."""
    cfg, bg, state, statics = _setup(cull=True, relaunch=True,
                                     m_max=2 * 3.141592653589793 / 300.0)
    run = mtt.RunConfig(dt=120.0, n_steps=2, save_every=1)
    u0 = state.mean.u

    def wind_fn(t):
        return u0 * torch.cos(t / 43200.0), torch.zeros_like(u0)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mtt.simulate(state, statics, bg, cfg, run, source=(state.rays, statics),
                     wind_fn=wind_fn)
    names = Counter(e.name for e in _spans(prof))
    for phase in ("msgwam.simulate.wind", "msgwam.step.cull",
                  "msgwam.simulate.relaunch", "msgwam.step"):
        assert names[phase] == 2, (phase, names)
    assert names["msgwam.simulate"] == 1
    assert names["msgwam.launch.k4"] == 6


@pytest.mark.parametrize("tile_spans", [None, (5.0, 30.0, 90.0)],
                         ids=["launch", "mixed"])
def test_k4_twin_tiers_equal_the_window_mirror(tile_spans):
    """One K4 stage's twin counts what ``window_fallback_stats`` mirrors
    for the same state: every tile once, the fallbacks and the full-width
    tiles among them."""
    cfg, bg, state, statics = _setup(n=2048, tile_spans=tile_spans,
                                     window_cells=16, window_cells2=48)
    inp = rhs_cuda.inputs(120.0, state, statics, bg, cfg)
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        buf = profiling.tier_counter("cpu", "K4")
        rhs_cuda_windowed.stage_reference(inp, list(inp.fields), None,
                                          *state.mean, None,
                                          ray_physics.RK3_STAGES[0],
                                          counts=buf)
    got = profiling.counts()["K4"]
    want = window_fallback_stats(120.0, state, statics, bg, cfg)
    n = int(want.n_blocks)
    assert sum(got.values()) == n
    assert got["full"] + got["second"] == int(want.n_fallback)
    assert got["full"] == round(float(want.full_rate) * n)
    if tile_spans is not None:
        assert all(got.values()), got


def test_reset_counts_zeroes_them():
    cfg, bg, state, statics = _setup()
    with profile(activities=[ProfilerActivity.CPU]):
        mtt.step(120.0, state, statics, bg, cfg)
    assert sum(profiling.counts()["K4"].values()) > 0
    profiling.reset_counts()
    got = profiling.counts()
    assert all(sum(got[k].values()) == 0 for k in profiling.KERNELS)
    assert set(got["launches"]) == {"projection_cuda", "rhs_cuda",
                                    "rhs_cuda_windowed", "step_cuda",
                                    "step_cuda_stream"}
