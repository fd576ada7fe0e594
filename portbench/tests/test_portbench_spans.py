"""The readers of the program's spans and counters on synthetic windows:
nested spans count once, launch spans are taken out, a device gap counts
for the part of it that a span covers, and a window without the program's
spans or counts reads ``None``."""

from types import SimpleNamespace

import pytest

from portbench import manifest, spans
from portbench.trace import Event, Window

READERS = ("program_idle_share", "loop_host_ms.day", "glue_host_ms.step",
           "fallback_share.day", "fallback_share.step")
ZERO = {"full": 0, "first": 0, "second": 0}


def _ctx(host, device=(), wall_s=1e-3, steps=1):
    return SimpleNamespace(trace=Window(list(device), list(host), wall_s, 0),
                           trace_steps=steps)


def _read(name, ctx):
    return manifest.reader(name)(ctx)


def test_nested_spans_count_once():
    host = [Event("msgwam.simulate", 0.0, 100.0), Event("msgwam.step", 10.0, 90.0),
            Event("msgwam.step.prepare", 20.0, 30.0),
            Event("msgwam.step", 95.0, 100.0)]
    assert spans.length(spans.covered(host, spans.named("msgwam.simulate",
                                                        "msgwam.step"))) == 100.0
    # 100 us of host time in two steps: 0.05 ms a step
    assert _read("glue_host_ms.step", _ctx(host, steps=2)) == pytest.approx(0.05)
    assert spans.phase_share(host) == pytest.approx(0.1)


def test_launch_spans_are_taken_out():
    host = [Event("msgwam.whole_run", 0.0, 1000.0),
            Event("msgwam.launch.k5", 100.0, 300.0),
            Event("msgwam.launch.k5", 500.0, 700.0),
            Event("msgwam.whole_run.frame", 300.0, 400.0),
            Event("aten::empty", 350.0, 360.0)]
    # 1000 us less 400 us of launches, over two launches
    assert _read("loop_host_ms.day", _ctx(host)) == pytest.approx(0.3)
    assert spans.self_us(host, ("msgwam.whole_run",)) == 600.0
    assert spans.phase_share(host) == pytest.approx(0.5)
    step = [Event("msgwam.step", 0.0, 100.0), Event("msgwam.launch.k4", 10.0, 40.0),
            Event("msgwam.launch.k4", 30.0, 60.0)]
    assert _read("glue_host_ms.step", _ctx(step)) == pytest.approx(0.05)


def test_a_gap_half_inside_a_span_counts_half():
    device = [Event("stage_kernel", 0.0, 100.0), Event("stage_kernel", 300.0, 400.0)]
    host = [Event("msgwam.step", 150.0, 250.0), Event("msgwam.step.cull", 160.0, 200.0),
            Event("portbench.request", 0.0, 400.0)]
    # the 200 us gap, half of it in the program's span, of a 1 ms window
    assert _read("program_idle_share", _ctx(host, device)) == pytest.approx(10.0)


def test_fallback_shares_read_the_kernels_counts(monkeypatch):
    counts = {k: dict(ZERO) for k in ("K3", "K4", "K5", "K6", "K7")}
    counts["K4"] = {"full": 1, "first": 6, "second": 3}
    counts["K5"] = {"full": 2, "first": 2, "second": 0}
    counts["K6"] = {"full": 0, "first": 4, "second": 0}
    monkeypatch.setattr(spans, "program_counts", lambda: counts)
    ctx = _ctx([])
    assert _read("fallback_share.step", ctx) == pytest.approx(40.0)
    assert _read("fallback_share.day", ctx) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_none(name, monkeypatch):
    """No program span (the harness's own and the device's only), no count
    or a program that keeps none: ``None``."""
    monkeypatch.setattr(spans, "program_counts", lambda: None)
    device = [Event("stage_kernel", 0.0, 100.0), Event("stage_kernel", 300.0, 400.0)]
    host = [Event("portbench.request", 0.0, 400.0), Event("aten::empty", 5.0, 9.0)]
    assert _read(name, _ctx(host, device)) is None
    assert _read(name, SimpleNamespace(trace=None, trace_steps=0)) is None
    zero = {k: dict(ZERO) for k in ("K3", "K4", "K5", "K6", "K7")}
    monkeypatch.setattr(spans, "program_counts", lambda: zero)
    assert _read(name, _ctx(host, device)) is None
