"""Scoped timers and the ZZZ timing table (counterpart of tpufem/timing.py),
and the spans and counters of the solve path.

Equivalent of ``dolfinx::common::Timer`` + ``dolfinx::list_timings``
(reference: src/main.cpp:130,145,208,226).  Stage names keep the
reference's ``ZZZ`` prefix so timing tables compare line for line.  The
registry and the table are tpufem's; PyTorch launches CUDA work
asynchronously, so a timer given a CUDA ``device`` synchronises it
before the clock stops, where tpufem calls ``jax.block_until_ready``.

Spans (``span``) and counters (``count``) mark the layer boundaries of
a solve (``solve``, ``cg.*``, ``gmg.*``, ``certify.pass``); they are
the port's own and have no counterpart in tpufem.  ``enable_spans``
turns both on or off, off by default.  Off, a span is one boolean test
that returns a shared null context.  On, each span is kept in memory
(``SPANS``, apart from ``REGISTRY``) on ``time.perf_counter_ns``, and
under an active ``torch.profiler`` it also enters
``record_function(name)``, so the kineto trace holds the program's
spans beside the device's kernels.  On or off, a span launches nothing
on the device and never synchronises.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

import torch


class TimingRegistry:
    """Accumulates (count, total seconds) per timer name."""

    def __init__(self) -> None:
        self._data: "collections.OrderedDict[str, List[float]]" = \
            collections.OrderedDict()

    def add(self, name: str, elapsed: float) -> None:
        rec = self._data.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += elapsed

    def rows(self) -> List[Tuple[str, int, float]]:
        return [(k, int(v[0]), v[1]) for k, v in self._data.items()]

    def get(self, name: str) -> float:
        return self._data.get(name, [0, 0.0])[1]

    def reset(self) -> None:
        self._data.clear()

    def table(self, ranks: int = 1) -> str:
        """Render the timing table (the ``list_timings`` analogue,
        reference main.cpp:226 reduces min/avg/max over MPI ranks).

        tpufem's table (tpufem/timing.py:39-58): for ``ranks`` > 1 the
        reduced columns, each holding this process's time, as tpufem's
        do (its shards run in lockstep; nothing is reduced across
        processes in either package)."""
        name_w = max([len("Summary")] + [len(k) for k, _, _ in self.rows()]) + 2
        if ranks > 1:
            lines = [f"{'Summary':<{name_w}}{'reps':>6}  {'wall min':>12}"
                     f"  {'wall avg':>12}  {'wall max':>12}"]
            for name, reps, tot in self.rows():
                avg = tot / max(reps, 1)
                lines.append(f"{name:<{name_w}}{reps:>6}  {avg:>12.6f}"
                             f"  {avg:>12.6f}  {avg:>12.6f}")
            lines.append(f"(reduced over {ranks} shards; SPMD lockstep — "
                         "one program, identical per-shard times)")
            return "\n".join(lines)
        lines = [
            f"{'Summary':<{name_w}}{'reps':>6}  {'wall avg':>12}  {'wall tot':>12}",
        ]
        has_solve = False
        for name, reps, tot in self.rows():
            avg = tot / max(reps, 1)
            lines.append(f"{name:<{name_w}}{reps:>6}  {avg:>12.6f}  {tot:>12.6f}")
            has_solve = has_solve or name == "ZZZ Solve"
        if has_solve:
            # the kernel build is a stage of its own ("ZZZ Build kernels")
            lines.append("(ZZZ Solve includes preconditioner setup — see "
                         "'ZZZ PC setup')")
        return "\n".join(lines)


REGISTRY = TimingRegistry()


class Timer:
    """``with Timer("ZZZ Solve", device=dev): ...``; stop() synchronises
    a CUDA ``device`` so queued device work is included."""

    def __init__(self, name: str, device: Optional[torch.device] = None,
                 registry: Optional[TimingRegistry] = None) -> None:
        self.name = name
        self.device = device
        self.registry = registry if registry is not None else REGISTRY
        self.elapsed = 0.0
        self._t0 = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        self.registry.add(self.name, self.elapsed)
        return self.elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def list_timings(registry: Optional[TimingRegistry] = None,
                 ranks: int = 1) -> str:
    s = (registry or REGISTRY).table(ranks=ranks)
    print(s, flush=True)
    return s


# ---------------------------------------------------------------------------
# Spans and counters of the solve path
# ---------------------------------------------------------------------------


class SpanRecorder:
    """The spans and counters recorded while spans are on.

    A record is ``[name, solve id, parent record's index (-1: none),
    start ns, end ns]``.  A ``solve`` span opened while no span is open
    starts a new solve id; every other span takes the current one, so a
    correction solve inside a ``certify.pass`` keeps the id of the solve
    it certifies."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.records: List[list] = []
        self.counters: Dict[str, int] = {}
        self.solve_id = 0
        self._open: List[int] = []

    def open(self, name: str) -> int:
        if name == "solve" and not self._open:
            self.solve_id += 1
        i = len(self.records)
        self.records.append([name, self.solve_id,
                             self._open[-1] if self._open else -1,
                             time.perf_counter_ns(), 0])
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        self.records[i][4] = time.perf_counter_ns()
        self._open.pop()

    def summary(self) -> dict:
        """``{"spans": {name: {"calls", "host_s", "self_s"}},
        "counters": {name: n}}`` over the closed spans; a span's self
        time is its own less the part of it its child spans cover."""
        dur = [r[4] - r[3] if r[4] else 0 for r in self.records]
        own = list(dur)
        for r, d in zip(self.records, dur):
            if r[4] and r[2] >= 0:
                own[r[2]] -= d
        spans: Dict[str, dict] = {}
        for r, d, o in zip(self.records, dur, own):
            if not r[4]:
                continue
            s = spans.setdefault(r[0], dict(calls=0, host_s=0.0,
                                            self_s=0.0))
            s["calls"] += 1
            s["host_s"] += d * 1e-9
            s["self_s"] += o * 1e-9
        return dict(spans=spans, counters=dict(self.counters))

    def table(self) -> str:
        """The summary as a table, spans in the order first opened."""
        summ = self.summary()
        rows = summ["spans"]
        name_w = max([len("span")] + [len(k) for k in rows]) + 2
        lines = [f"{'span':<{name_w}}{'calls':>8}  {'host s':>12}"
                 f"  {'self s':>12}"]
        for name, r in rows.items():
            lines.append(f"{name:<{name_w}}{r['calls']:>8}  "
                         f"{r['host_s']:>12.6f}  {r['self_s']:>12.6f}")
        for name, n in summ["counters"].items():
            lines.append(f"counter {name}: {n}")
        return "\n".join(lines)


SPANS = SpanRecorder()
_SPANS_ON = False
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "index", "rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self.rf = None

    def __enter__(self) -> "_Span":
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.index = SPANS.open(self.name)
        return self

    def __exit__(self, *exc: Any) -> None:
        SPANS.close(self.index)
        if self.rf is not None:
            self.rf.__exit__(*exc)


def enable_spans(on: bool = True) -> bool:
    """Turn the spans and counters on or off; returns the previous
    state."""
    global _SPANS_ON
    was, _SPANS_ON = _SPANS_ON, bool(on)
    return was


def span(name: str):
    """``with span("cg.apply"): ...``: a span of the solve path, kept in
    ``SPANS`` while spans are on; off, a shared null context."""
    if not _SPANS_ON:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    if _SPANS_ON:
        SPANS.counters[name] = SPANS.counters.get(name, 0) + n
