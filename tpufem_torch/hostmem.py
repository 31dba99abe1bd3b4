"""Host-memory tuning (the port's copy of tpufem/hostmem.py's
``tune_allocator``).

glibc serves every allocation above its dynamic mmap threshold (at most
32 MiB) with a fresh mapping that is unmapped on free and faulted anew
on the next allocation, and the setup phases allocate many such numpy
temporaries.  ``tune_allocator()`` raises the mmap threshold and
disables trim (glibc ``mallopt``), so numpy's large setup temporaries
are SERVED FROM THE HEAP POOL and reused across setup phases instead of
being munmapped on free and re-faulted on the next allocation.
Idempotent, no-op on non-glibc.

Measured on the H100 host (``scripts/hostmem_probe.py``): the tuning
takes 2-5 s (8-14%) off the spoke P1 500k CLI run and moves the cube
500k runs by less than their spread.  tpufem's other two tools are not
ported: its background heap ``prefault`` moved no run beyond that of
the tuning alone, and its ``warm_vm`` (a detached process that touches
4-12 GiB, for a TPU VM whose never-touched pages faulted at 16-160
MB/s) none beyond the prefault: on this host a first touch runs within
1.33x of a re-touch.
"""

from __future__ import annotations

import ctypes
import logging

logger = logging.getLogger("tpufem_torch")

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_tuned = False


def tune_allocator() -> bool:
    """Raise glibc's mmap threshold (1 GiB) and disable heap trim so
    large numpy temporaries are pooled and reused.  Idempotent."""
    global _tuned
    if _tuned:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30) == 1)
    except Exception:  # pragma: no cover - non-glibc platforms
        ok = False
    _tuned = ok
    if not ok:  # pragma: no cover
        logger.debug("mallopt tuning unavailable; large numpy "
                     "temporaries will be re-faulted per allocation")
    return ok
