"""The rate and the tail use every step and the whole window."""

import pytest

from portbench import run, stats


def test_rate_is_all_steps_over_all_time():
    assert stats.rate(1_000_000, 7200, 0.9) == pytest.approx(8e9)
    with pytest.raises(ValueError):
        stats.rate(1, 1, 0.0)


def test_percentile_nearest_rank_over_all_values():
    vals = list(range(1, 101))                 # 1 .. 100
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    # one stall among many steps moves the 95th percentile only if it is
    # more than one in twenty
    assert stats.percentile([1.0] * 19 + [50.0], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [50.0] * 2, 95) == 50.0


class FakeDriver:
    """Requests whose host-clock durations, and the caller's checks of
    them, are scripted."""

    def __init__(self, durations, clock, checks=None):
        self.durations, self.clock, self.calls = list(durations), clock, []
        self.checks = list(checks or [0.0] * len(self.durations))

    def verify(self, ans):
        self.clock.now += self.checks[len(self.calls) - 1]
        return ans

    def request(self, i):
        self.calls.append(i)
        self.clock.now += self.durations[len(self.calls) - 1]
        from portbench.traffic import Answer

        return Answer(host=None, items=[i] if i % 2 else [])


class Clock:
    now = 100.0

    def __call__(self):
        return self.now


def test_serve_counts_every_request_and_the_whole_window(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    d = FakeDriver([0.3, 0.2, 0.9, 0.4, 0.1], clock)
    durations, hosts, items, window = run.serve(d, seconds=1.0)
    # the request that crosses the deadline is the last, and it counts
    assert d.calls == [0, 1, 2]
    assert durations == pytest.approx([0.3, 0.2, 0.9])
    assert window == pytest.approx(1.4)
    assert items == [1]
    assert stats.rate(10, len(durations) * 720, window) == pytest.approx(
        10 * 3 * 720 / 1.4)


def test_serve_leaves_the_callers_checks_out_of_the_window(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    d = FakeDriver([0.3, 0.2, 0.9, 0.4], clock, checks=[0.5, 0.5, 0.5, 0.5])
    durations, _, _, window = run.serve(d, seconds=1.0)
    # the checks take as long as the requests, and neither the deadline
    # nor the window counts them
    assert d.calls == [0, 1, 2]
    assert window == pytest.approx(1.4)
    assert clock.now == pytest.approx(100.0 + 1.4 + 1.5)
