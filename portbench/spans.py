"""The program's own spans and counters in a traced window.

The port opens ``record_function`` ranges named ``msgwam.*`` while a
profiler records (``msgwam_tpu_torch/utils/profiling.py``): the entries
``msgwam.step``, ``msgwam.simulate`` and ``msgwam.whole_run``, their phases,
and the host side of each kernel launch, ``msgwam.launch.k*``.  They reach
the readers as host events of ``trace.Window``.  Times here are those of
the union of a set of spans, so nested or repeated spans count once, and a
span's self time is its union less the part its children cover.  The
window-tier counts come from the program's ``profiling.counts()``, read
after the window; a program without spans or counts gives ``None``
everywhere.
"""

from __future__ import annotations

PREFIX = "msgwam."
LAUNCH = "msgwam.launch."
ENTRIES = ("msgwam.step", "msgwam.simulate", "msgwam.whole_run")


def program(window) -> list:
    """The window's host events that are spans of the program."""
    return [e for e in window.host if e.name.startswith(PREFIX)]


def union(intervals) -> list:
    """``(start, end)`` pairs merged into disjoint ones, in order."""
    out = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals) -> float:
    """The summed length of disjoint intervals."""
    return sum(b - a for a, b in intervals)


def intersect(xs, ys) -> list:
    """The overlap of two lists of disjoint, ordered intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def covered(events, match) -> list:
    """The union of the events whose name ``match`` accepts."""
    return union((e.start_us, e.end_us) for e in events if match(e.name))


def named(*names):
    """A ``match`` for :func:`covered`: the names given."""
    return lambda name: name in names


def launches(events) -> int:
    """How many launch spans there are."""
    return sum(1 for e in events if e.name.startswith(LAUNCH))


def self_us(events, entries) -> float:
    """Host time inside the union of the spans named ``entries``, less the
    part the launch spans cover."""
    outer = covered(events, named(*entries))
    inner = covered(events, lambda n: n.startswith(LAUNCH))
    return length(outer) - length(intersect(outer, inner))


def phase_share(events) -> float:
    """The share of the entry spans' host time that their phases and the
    launch spans cover, or ``None`` without entry spans."""
    outer = covered(events, named(*ENTRIES))
    if not outer:
        return None
    inner = covered(events, lambda n: n.startswith(PREFIX) and n not in ENTRIES)
    return length(intersect(outer, inner)) / length(outer)


def program_counts():
    """The program's window-tier counts, or ``None`` where it keeps
    none."""
    from msgwam_tpu_torch.utils import profiling

    counts = getattr(profiling, "counts", None)
    return counts() if counts is not None else None


def fallback_share(counts, kernels) -> float:
    """The share, in %, of ``kernels``' tile windows that left the first
    window (the second tier or the full width), or ``None`` where none was
    counted."""
    if not counts:
        return None
    first = sum(counts[k]["first"] for k in kernels)
    left = sum(counts[k]["full"] + counts[k]["second"] for k in kernels)
    return 100.0 * left / (first + left) if first + left else None
