"""Arithmetic of a measured window of back-to-back solves.

A window is the list of its solves, each ``(start s, end s, iterations,
recurrence rel, pool index)`` with times from the window's start: one
caller sends each solve when the previous one has ended on the device,
so the window runs from 0 to the end of its last solve.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

Solve = Tuple[float, float, int, float, int]


def window_s(solves: Sequence[Solve]) -> float:
    """The window's length: to the end of its last solve."""
    return solves[-1][1] if solves else 0.0


def solve_ms(solves: Sequence[Solve]) -> float:
    """Milliseconds of window per completed solve."""
    return 1e3 * window_s(solves) / len(solves)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least q% of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def solve_ms_p95(solves: Sequence[Solve]) -> float:
    """95th percentile of the solves' wall times, in ms."""
    return percentile([1e3 * (e - s) for s, e, *_ in solves], 95.0)


def gdof_s(solves: Sequence[Solve], ndofs: int) -> float:
    """Upstream's throughput (src/cgpoisson_problem.cpp:232-243) over the
    whole window: iterations x dofs summed over its solves, over its
    seconds, in 1e9 per second."""
    return sum(s[2] for s in solves) * ndofs / window_s(solves) / 1e9
