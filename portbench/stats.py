"""The arithmetic of the host-clock metrics: the rate and the tail."""

from __future__ import annotations

import math


def rate(slots: int, steps: int, window_s: float) -> float:
    """Ray-steps per second: every slot of the population times every step
    completed in the window, over the window's whole wall time."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return slots * steps / window_s


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` by the nearest rank: the
    smallest value with at least ``q`` percent of the values at or below
    it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]

