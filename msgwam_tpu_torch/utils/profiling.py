"""Profiling hooks of the port: ``torch.profiler`` trace capture, the
program's spans, and the window-tier counts of the windowed kernels.

Everything here is off unless a ``torch.profiler`` session records:
:func:`span` then returns one shared null context, :func:`tier_counter`
``None``, and the kernels count nothing.  Under a session (:func:`trace`,
or any ``torch.profiler.profile``):

* :func:`span` is a ``record_function`` range, on the profiler's clock
  beside the device's rows.  The program's spans are named ``msgwam.*``:
  the entries ``msgwam.step``, ``msgwam.simulate`` and ``msgwam.whole_run``,
  their phases ``msgwam.<entry>.<phase>``, and the host side of each kernel
  launch, ``msgwam.launch.k3`` .. ``msgwam.launch.k7``.
* K3-K7 count how many of their 256-ray tile windows took the first
  window, the second tier or the full width (thread 0 of a block, into
  the block's row of ``TIER_SLOTS`` with integer ``atomicAdd``: K3-K5 one
  per tile window as it reads it, K6/K7 once per launch from a count in
  shared memory; the saturation's window is not counted), into one
  ``int64[TIER_SLOTS, 4]`` buffer per kernel and device (full, first,
  second, unused); the CPU twins add the same counts to its first row.
  :func:`counts` sums them, the only read of the device here: call it
  after the profiled window.
* K5-K7 count where their tiles' state lives, from each launch's block
  plan (host integers, no device work): tile-stages whose state stays on
  chip (registers or shared memory), tile-stages whose state is streamed
  through device memory, and tile windows kept in the device-memory window
  scratch (a block's tiles past its first ``kWinShared``), each times the
  launch's steps, its three stages and its members.
* K5 and K7 count their launches, and those whose tiles they ordered
  first (``step_cuda.tile_order``; host integers, no device work).
* K6 and K7 count the wind tables their runs build and the launches that
  read one (``step_cuda_stream._winds``; host integers, no device work).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional

import torch
from torch.profiler import record_function

KERNELS = ("K3", "K4", "K5", "K6", "K7")
TIERS = ("full", "first", "second")   # a tile's tier: 0, 1, 2
TIER_SLOTS = 1024    # csrc/ray_physics.cuh kTierSlots: rows of a buffer
WHOLE_RUN = ("K5", "K6", "K7")
PLACES = ("on_chip", "streamed", "win_scratch")
ORDERING = ("K5", "K7")
WINDED = ("K6", "K7")

_NULL = contextlib.nullcontext()
# (kernel, device) -> the int64[TIER_SLOTS, 4] window-tier counts
_TIER_COUNTS = {}
# kernel -> {place: tile-stages (windows for "win_scratch")}, host integers
_PLACEMENT = {k: dict.fromkeys(PLACES, 0) for k in WHOLE_RUN}
# kernel -> [launches with ordered tiles, launches], host integers
_ORDERED = {k: [0, 0] for k in ORDERING}
# kernel -> [wind tables built, launches that read one], host integers
_WIND = {k: [0, 0] for k in WINDED}


def recording() -> bool:
    """Whether a ``torch.profiler`` session records on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler session
    records, else one shared ``contextlib.nullcontext()``."""
    return record_function(name) if recording() else _NULL


def spanned(name: str):
    """A decorator: the function's every call in :func:`span` ``name``
    (with no session, a plain call: no context is entered)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def tier_counter(device, kernel: str) -> Optional[torch.Tensor]:
    """The ``int64[TIER_SLOTS, 4]`` window-tier counts of ``kernel`` (one
    of :data:`KERNELS`) on ``device`` while a profiler session records
    (made, zeroed, at its first use and kept after), else ``None``."""
    if not recording():
        return None
    key = (kernel, torch.device(device))
    buf = _TIER_COUNTS.get(key)
    if buf is None:
        buf = _TIER_COUNTS[key] = torch.zeros((TIER_SLOTS, 4),
                                              dtype=torch.int64, device=device)
    return buf


def add_tiers(buf: Optional[torch.Tensor], tiers: torch.Tensor) -> None:
    """Add one launch's tile tiers (0 full width, 1 first window, 2 second)
    to ``buf``, a :func:`tier_counter` buffer or ``None``: the twins'
    count."""
    if buf is not None:
        buf[0, :3] += torch.bincount(tiers.reshape(-1), minlength=3)


def add_placement(kernel: str, on_chip: int, streamed: int,
                  win_scratch: int) -> None:
    """Add one launch's tile-stages on chip and streamed and its tile
    windows in the device-memory scratch to ``kernel``'s counts (one of
    :data:`WHOLE_RUN`) while a profiler session records; else nothing."""
    if recording():
        got = _PLACEMENT[kernel]
        for place, n in zip(PLACES, (on_chip, streamed, win_scratch)):
            got[place] += int(n)


def add_order(kernel: str, ordered: bool) -> None:
    """Count one launch of ``kernel`` (one of :data:`ORDERING`), and
    whether its tiles were ordered, while a profiler session records; else
    nothing."""
    if recording():
        got = _ORDERED[kernel]
        got[0] += int(ordered)
        got[1] += 1


def add_wind(kernel: str, built: bool) -> None:
    """Count one launch of ``kernel`` (one of :data:`WINDED`) that reads a
    wind table, and whether its table was built for it, while a profiler
    session records; else nothing."""
    if recording():
        got = _WIND[kernel]
        got[0] += int(built)
        got[1] += 1


def counts() -> dict:
    """``{"K3".."K7": {"full": n, "first": n, "second": n}}``, summed over
    devices, each kernel module's ``LAUNCHES`` under ``"launches"``,
    K5-K7's tile placement under ``"placement"``: ``{"K5".."K7":
    {"on_chip": n, "streamed": n, "win_scratch": n}}``, and K5's and K7's
    ordered launches under ``"ordered"``: ``{"K5": [ordered, launches],
    "K7": [...]}``, and K6's and K7's wind tables under ``"wind"``:
    ``{"K6": [tables built, launches that read one], "K7": [...]}``.
    Reads the device: call it after the profiled window."""
    from ..ops import (projection_cuda, rhs_cuda, rhs_cuda_windowed, step_cuda,
                       step_cuda_stream)

    out = {k: dict.fromkeys(TIERS, 0) for k in KERNELS}
    for (kernel, _), buf in _TIER_COUNTS.items():
        for tier, n in zip(TIERS, buf[:, :3].sum(0).tolist()):
            out[kernel][tier] += n
    out["launches"] = {
        m.__name__.rsplit(".", 1)[1]:
            dict(m.LAUNCHES) if isinstance(m.LAUNCHES, dict) else m.LAUNCHES
        for m in (projection_cuda, rhs_cuda, rhs_cuda_windowed, step_cuda,
                  step_cuda_stream)}
    out["placement"] = {k: dict(v) for k, v in _PLACEMENT.items()}
    out["ordered"] = {k: list(v) for k, v in _ORDERED.items()}
    out["wind"] = {k: list(v) for k, v in _WIND.items()}
    return out


def reset_counts() -> None:
    """Zero every window-tier, placement, order and wind count (the
    buffers stay)."""
    for buf in _TIER_COUNTS.values():
        buf.zero_()
    for got in _PLACEMENT.values():
        got.update(dict.fromkeys(PLACES, 0))
    for got in (*_ORDERED.values(), *_WIND.values()):
        got[:] = [0, 0]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (host, and the card where there
    is one) around a block and write it to ``log_dir/trace.json`` in the
    Chrome trace format; a no-op without ``log_dir``.  Yields the profiler
    (``None`` without ``log_dir``).  The program's spans and window-tier
    counts are on inside the block."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
