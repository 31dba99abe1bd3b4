"""Logging with the reference's per-rank pattern (the port's copy of
tpufem/logutil.py).

Equivalent of the spdlog setup at reference src/main.cpp:260-267:
pattern ``[timestamp] [RANK: n] [level] message``, INFO enabled on
rank/host 0 only.
"""

from __future__ import annotations

import logging


def init_logging(rank: int = 0, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("tpufem_torch")
    if logger.handlers:
        return logger
    handler = logging.StreamHandler()
    fmt = f"[%(asctime)s] [RANK: {rank}] [%(levelname)s] %(message)s"
    handler.setFormatter(logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    # reference enables info level on rank 0 only (src/main.cpp:266-267)
    logger.setLevel(level if rank == 0 else logging.WARNING)
    return logger


def int64_to_human(n: int) -> str:
    """Human-readable count, e.g. ``" (1.5 million)"``.

    Equivalent of int64_to_human (reference: src/main.cpp:31-50).
    """
    names = ["", "thousand", "million", "billion", "trillion"]
    r = float(n)
    i = 0
    while r > 1000.0:
        r /= 1000.0
        i += 1
    if i >= len(names):
        raise RuntimeError("number too big")
    if i == 0:
        return ""
    return f" ({r:.3g} {names[i]})"
