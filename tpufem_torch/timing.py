"""Scoped timers and the ZZZ timing table (counterpart of tpufem/timing.py).

Equivalent of ``dolfinx::common::Timer`` + ``dolfinx::list_timings``
(reference: src/main.cpp:130,145,208,226).  Stage names keep the
reference's ``ZZZ`` prefix so timing tables compare line for line.  The
registry and the table are tpufem's; PyTorch launches CUDA work
asynchronously, so a timer given a CUDA ``device`` synchronises it
before the clock stops, where tpufem calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import collections
import time
from typing import Any, List, Optional, Tuple

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
