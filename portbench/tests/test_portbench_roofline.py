"""The bounds are counted from shapes, and the trace readers from the
records they are given."""

from types import SimpleNamespace

import pytest
import torch

from portbench import manifest, roofline, trace
from portbench.trace import Event, Window


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_counts_from_shapes():
    n = 1_000_000
    assert roofline.step_ops(n, 2.0) == 3 * n * (120 + 12 + 22)
    assert roofline.step_ops(n, 2.0, deposit=False) == 3 * n * 132
    # K4: 81 B a ray dominate at every cell count the column allows
    assert roofline.k4_launch_s(n, 2.0) == pytest.approx(81 * n / 3.35e12)
    # K5: the operations of a step dominate the launch's bytes
    k5 = roofline.whole_run_step_s(n, 2.0, 72, deposit=True)
    assert k5 == pytest.approx(3 * n * 154 / 67e12)


def test_covered_cells_by_the_reference_rule():
    # dz = 1000 m on 100 centers: cells trunc(lo/dz) up to, not
    # including, trunc(up/dz + 1); the inactive ray is left out
    r = torch.tensor([2100.0, 2600.0, 2900.0, 99_900.0], dtype=torch.float64)
    dr = torch.full_like(r, 500.0)
    act = torch.tensor([True, True, True, False])
    assert roofline.covered_cells(r, dr, act, 1000.0, 100) == pytest.approx(
        (2 + 1 + 2) / 3)


def ev(name, a, b):
    return Event(name, float(a), float(b))


def test_busy_gaps_and_kernel_gaps():
    evs = [ev("step_resident_kernel<false>", 0, 100), ev("copy", 90, 120),
           ev("step_resident_kernel<false>", 150, 250), ev("x", 300, 310)]
    assert trace.busy_s(evs) == pytest.approx(230e-6)
    assert trace.gaps(evs) == [(120.0, 150.0), (250.0, 300.0)]
    assert trace.kernel_gaps_s(evs, "step_resident_kernel") == pytest.approx([50e-6])
    assert trace.kernel_time_s(evs, "step_resident_kernel") == pytest.approx(200e-6)
    top = trace.top_ops(evs)
    assert top[0][0] == "step_resident_kernel<false>"
    w = Window(evs, [ev("portbench.request", 0, 400), ev("aten::copy_", 110, 160)],
               400e-6, 0)
    assert trace.top_gaps(w) == [["portbench.request", pytest.approx(50e-6)],
                                 ["aten::copy_", pytest.approx(30e-6)]]


def ctx_for(kind, lifecycle, events, wall_s, steps, slots=1_000_000, cells=2.0,
            members=0):
    driver = SimpleNamespace(kind=kind, lifecycle=lifecycle, save_every=72,
                             steps=1)
    conf = {"model": {"prognostic_mean": not lifecycle}}
    return SimpleNamespace(driver=driver, trace=Window(events, [], wall_s, 0),
                           trace_steps=steps, slots=slots, cells=cells,
                           setup=SimpleNamespace(conf=conf, members=members))


def test_roofline_readers_read_the_kernels_time():
    # 72 steps of K5 at 1e6 rays in 72 * 0.1 ms: the bound's share
    bound = roofline.whole_run_step_s(1_000_000, 2.0, 72, True)
    ctx = ctx_for("whole_run", False, [ev("step_resident_kernel<false, 128>",
                                          0, 7200)], 7.5e-3, 72)
    k5 = manifest.reader("k5_roofline")(ctx)
    assert k5 == pytest.approx(100 * bound / 1e-4)
    assert manifest.reader("k6_roofline")(ctx) is None
    assert manifest.reader("k4_roofline")(ctx) is None
    mfu = manifest.reader("step_mfu")(ctx)
    assert 0 < mfu < k5
    idle = manifest.reader("idle_share")(ctx)
    assert idle == pytest.approx(100 * (1 - 7.2e-3 / 7.5e-3))


def test_k4_reader_and_ops_per_step():
    evs = [ev("void stage_kernel<2, 128>", 100 * i, 100 * i + 50) for i in range(6)]
    evs.append(ev("Memcpy DtoH", 700, 705))
    ctx = ctx_for("stepwise", False, evs, 1e-3, 2)
    k4 = manifest.reader("k4_roofline")(ctx)
    assert k4 == pytest.approx(100 * roofline.k4_launch_s(1_000_000, 2.0) / 50e-6)
    assert manifest.reader("device_ops_per_step.step")(ctx) == pytest.approx(3.5)
    assert manifest.reader("k5_roofline")(ctx) is None


def test_readers_find_nothing_without_a_trace():
    ctx = ctx_for("whole_run", False, [], 1.0, 72)
    for name in ("idle_share", "k5_roofline", "k6_roofline", "k4_roofline",
                 "step_mfu", "host_gap_ms.day", "device_ops_per_step.step"):
        assert manifest.reader(name)(ctx) is None


@pytest.mark.parametrize("slots,cells,steps_per_launch", [
    (1_000_000, 2.0, 72), (1_000_000, 5.5, 72), (200_000, 3.0, 10)])
def test_k7_reader_reads_the_stream_kernel(slots, cells, steps_per_launch):
    # 144 traced steps of K7 in 20 ms of its device time, beside K5's
    # instantiation and a copy, which it does not count
    k7 = "void msgwam::step_resident_kernel<true, 128>(msgwam::ResidentArgs)"
    k5 = "void msgwam::step_resident_kernel<false, 128>(msgwam::ResidentArgs)"
    evs = [ev(k7, 0, 12_000), ev("Memcpy DtoH", 12_000, 12_100),
           ev(k7, 12_200, 20_200), ev(k5, 20_300, 29_000)]
    ctx = ctx_for("whole_run", False, evs, 40e-3, 144, slots=slots,
                  cells=cells, members=8)
    ctx.driver.save_every = steps_per_launch
    bound = 144 * max(57 * slots / steps_per_launch / 3.35e12,
                      3 * slots * (120 + 12 + 11 * cells) / 67e12)
    assert manifest.reader("k7_roofline")(ctx) == pytest.approx(
        100 * bound / 20e-3)
    # nothing to read without members, or without K7 in the window
    ctx.setup.members = 0
    assert manifest.reader("k7_roofline")(ctx) is None
    ctx = ctx_for("whole_run", False, evs[3:], 40e-3, 144, members=8)
    assert manifest.reader("k7_roofline")(ctx) is None
    ctx = ctx_for("whole_run", False, [], 1.0, 72, members=8)
    assert manifest.reader("k7_roofline")(ctx) is None
