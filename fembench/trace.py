"""Reduction of a profiled stretch of solves to what the per-layer
metrics read.

The profiler's raw events (``torch.profiler``'s kineto results, without
the slower tree that ``events()`` builds) are split into the device's
kernels and copies and the host thread's operations.  The benchmark's
own ranges (``record_function``) mark each solve and each call of a
program entry it wraps; a kernel belongs to a range when the host call
that launched it lies inside one.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SOLVE_RANGE = "fembench.solve"
NAME_CHARS = 120     # a kernel's name as the breakdown shows it


def _kind(e) -> str:
    """What a raw event is: "kernel", "copy" (a device memcpy or memset),
    "device_range" (a range's device-side copy), "range" (a host
    ``record_function``), "launch" (a runtime call that launches a
    kernel) or "host" (any other host operation).  From the device type,
    the annotation flag and the name, which every PyTorch 2.x gives."""
    from torch.autograd import DeviceType
    name = e.name()
    if e.device_type() != DeviceType.CPU:
        if e.is_user_annotation():
            return "device_range"
        return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
    if e.is_user_annotation():
        return "range"
    if name.startswith("cu") and "Launch" in name:
        return "launch"
    return "host"


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals: the time a device
    was busy, from its kernels' and copies' intervals (summing the
    profiler's per-op device times instead counts each kernel under its
    op and again under its own name)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Ev:
    __slots__ = ("name", "kind", "start", "end", "corr", "linked", "thread")

    def __init__(self, e) -> None:
        self.name = e.name()
        self.kind = _kind(e)
        self.start = e.start_ns() * 1e-3
        self.end = self.start + e.duration_ns() * 1e-3
        self.corr = e.correlation_id()
        self.linked = e.linked_correlation_id()
        self.thread = e.start_thread_id()


def _inside(t: float, spans: Sequence[Tuple[float, float]],
            starts: Sequence[float]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def reduce(raw_events, ranges: Sequence[str] = ()) -> Optional[dict]:
    """What the per-layer metrics read from one profiled stretch, or None
    when it holds no solve range.  Times in seconds:

    - ``window_s``: from the first solve range's start to the last's end;
      ``busy_s``: the union of the device's kernels and copies in it;
    - ``kernels``: the device kernels (not copies) in it;
    - ``ranges``: for each name in ``ranges``, its ``calls``, the host
      seconds inside them (``host_s``), and the kernels launched inside
      them and their device seconds (``kernels``, ``device_s``);
    - ``device_ops``: the ten device operations that took most time, by
      name; ``idle_gaps``: the device's idle time inside the window by
      the innermost host operation running when each gap began, the ten
      largest."""
    events = [_Ev(e) for e in raw_events]
    solves = [e for e in events if e.kind == "range" and e.name == SOLVE_RANGE]
    if not solves:
        return None
    main = solves[0].thread
    w0 = min(e.start for e in solves)
    w1 = max(e.end for e in solves)
    dev = [e for e in events if e.kind in ("kernel", "copy")
           and e.end > w0 and e.start < w1]
    host = [e for e in events
            if e.kind in ("range", "launch", "host") and e.thread == main]
    kernels = [e for e in dev if e.kind == "kernel"]
    busy = merged((max(e.start, w0), min(e.end, w1)) for e in dev)

    # the host time each kernel was launched at: its runtime call, by the
    # correlation both carry (the profiler may file runtime calls under
    # another thread id than the operations'); else the start of the
    # operation it is linked to
    launch = {e.corr: e.start for e in events if e.kind == "launch"}
    op_start = {e.corr: e.start for e in host if e.kind in ("range", "host")}

    def launched_at(k: _Ev) -> Optional[float]:
        t = launch.get(k.corr)
        return t if t is not None else op_start.get(k.linked)

    out_ranges: Dict[str, dict] = {}
    for name in ranges:
        spans = sorted((e.start, e.end) for e in host
                       if e.kind == "range" and e.name == name)
        starts = [s for s, _ in spans]
        mine = [k for k in kernels
                if (t := launched_at(k)) is not None
                and _inside(t, spans, starts)]
        out_ranges[name] = dict(
            calls=len(spans), host_s=sum(e - s for s, e in spans) * 1e-6,
            kernels=len(mine),
            device_s=busy_us((k.start, k.end) for k in mine) * 1e-6)

    by_op: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_op[e.name] += (min(e.end, w1) - max(e.start, w0)) * 1e-6
    gaps = []
    edge = w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s - edge))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1 - edge))
    by_host = _gaps_by_host(gaps, host)

    def top(d: Dict[str, float]) -> List[list]:
        """The ten largest, names cut to NAME_CHARS."""
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(window_s=(w1 - w0) * 1e-6,
                busy_s=sum(e - s for s, e in busy) * 1e-6,
                kernels=len([k for k in kernels if w0 <= k.start < w1]),
                ranges=out_ranges, device_ops=top(by_op),
                idle_gaps=top(by_host))


def _gaps_by_host(gaps: List[Tuple[float, float]],
                  host: List[_Ev]) -> Dict[str, float]:
    """Seconds of idle device by the innermost host operation running at
    each gap's start (host operations of one thread nest)."""
    evs = sorted(host, key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[_Ev] = []
    j = 0
    for t, length in sorted(gaps):
        while j < len(evs) and evs[j].start <= t:
            while stack and stack[-1].end <= evs[j].start:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[stack[-1].name if stack else "(no host operation)"] += length * 1e-6
    return out
