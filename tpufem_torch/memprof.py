"""Memory profiler: background RSS/VSIZE sampler (counterpart of
tpufem/memprof.py).

Equivalent of the reference's rank-0 daemon thread reading
``/proc/self/stat`` every 100 ms and logging ``VSIZE=..., RSS=...``
under a ``[MEM]`` pattern (reference: src/mem.cpp:18-38, started/joined
around solve() at src/main.cpp:104-107,236-240).  tpufem reads the two
sizes through psutil, which on Linux reads ``/proc/self/statm`` (pages,
times the page size); the port reads that file itself and needs no
package.  ``start()`` takes the first sample in the caller's thread, so
a host whose ``/proc`` cannot be read fails there, not in the sampler.
``device_memory_stats`` gives the device's allocator figures under
tpufem's (JAX's) keys.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple

import torch

logger = logging.getLogger("tpufem_torch")

STATM = "/proc/self/statm"
_GB = 1.0 / (1 << 30)


def read_statm(path: str = STATM) -> Tuple[int, int]:
    """(VSIZE, RSS) of this process in bytes: the first two fields of
    ``statm`` (total program size and resident set, in pages)."""
    with open(path) as f:
        size, resident = f.read().split()[:2]
    page = os.sysconf("SC_PAGE_SIZE")
    return int(size) * page, int(resident) * page


class MemoryProfiler:
    """``with MemoryProfiler(): ...`` or ``start()`` / ``stop()``: logs
    ``[MEM] VSIZE = %.3f GB, RSS = %.3f GB`` every ``interval_s``."""

    def __init__(self, interval_s: float = 0.1, path: str = STATM) -> None:
        self.interval = interval_s
        self.path = path
        self._quit = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> None:
        vms, rss = read_statm(self.path)
        logger.info("[MEM] VSIZE = %.3f GB, RSS = %.3f GB",
                    vms * _GB, rss * _GB)

    def _run(self) -> None:
        while not self._quit.wait(self.interval):
            self._sample()

    def start(self) -> "MemoryProfiler":
        self._sample()
        self._quit.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpufem_torch-memprof")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._quit.set()
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MemoryProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def device_memory_stats(device: torch.device) -> dict:
    """The allocator's figures for ``device`` under the keys tpufem's
    callers read from ``jax.Device.memory_stats()`` (tpufem/memprof.py:
    47-54): ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``
    and ``bytes_limit``.  The CPU reports none, as JAX's CPU backend
    does: ``{}``."""
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device)
                               .total_memory)}
