"""The traced window: a fixed number of requests under ``torch.profiler``,
and what the per-layer readers take from it.

CUPTI drops the first records of a profiler session once other CUDA
contexts have come and gone on the card; a lead of short sleep kernels
takes those drops, and the sleeps are left out of every count.  The
harness's own spans (``portbench.request``, ``portbench.host_read``) are
``record_function`` ranges around its calls into the program.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

LEAD_KERNELS = 64
SLEEP_NAME = "spin_kernel"
SPAN = "portbench."
TOP = 10


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Window(NamedTuple):
    """One traced window: the device events (sleeps left out, in order of
    start), the host events, its wall seconds, and the sleeps lost."""

    device: list
    host: list
    wall_s: float
    sleeps_lost: int


def profiled(fn) -> Window:
    """Run ``fn()`` once under the profiler, behind ``LEAD_KERNELS`` sleep
    kernels; the wall time is that of ``fn`` to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    device, host, sleeps = [], [], 0
    for e in prof.events():
        ev = Event(e.name, e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN):
            # a span of the harness, on the host's and the device's rows
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(ev)
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if SLEEP_NAME in e.name:
                sleeps += 1
            else:
                device.append(ev)
        else:
            host.append(ev)
    device.sort(key=lambda e: e.start_us)
    return Window(device, host, wall, LEAD_KERNELS + 1 - sleeps)


def busy_s(events) -> float:
    """Seconds in which at least one device operation ran."""
    total, end = 0.0, -float("inf")
    for e in events:
        if e.end_us <= end:
            continue
        total += e.end_us - max(e.start_us, end)
        end = e.end_us
    return total * 1e-6


def gaps(events):
    """``(start_us, end_us)`` of every idle interval between consecutive
    device operations."""
    out, end = [], None
    for e in events:
        if end is not None and e.start_us > end:
            out.append((end, e.start_us))
        end = e.end_us if end is None else max(end, e.end_us)
    return out


def kernel_time_s(events, name: str) -> float:
    """Seconds of the device operations whose name holds ``name``."""
    return sum(e.end_us - e.start_us for e in events if name in e.name) * 1e-6


def kernel_gaps_s(events, name: str) -> list:
    """Seconds between each operation named ``name`` and the next one."""
    ks = [e for e in events if name in e.name]
    return [(b.start_us - a.end_us) * 1e-6 for a, b in zip(ks, ks[1:])]


def top_ops(events) -> list:
    """The ``TOP`` device operations by total time: ``[name, seconds]``."""
    tot = {}
    for e in events:
        tot[e.name] = tot.get(e.name, 0.0) + (e.end_us - e.start_us) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_at(host, t_us: float) -> str:
    """The innermost host event running at ``t_us`` (the shortest that
    contains it), or ``idle host``."""
    best = None
    for h in host:
        if h.start_us <= t_us <= h.end_us and (
                best is None or h.end_us - h.start_us < best.end_us - best.start_us):
            best = h
    return best.name if best is not None else "idle host"


def top_gaps(window: Window) -> list:
    """The ``TOP`` longest idle gaps, each named by what the host was
    doing at its middle: ``[name, seconds]``."""
    gs = sorted(gaps(window.device), key=lambda g: g[0] - g[1])[:TOP]
    return [[_host_at(window.host, 0.5 * (a + b)), (b - a) * 1e-6] for a, b in gs]
