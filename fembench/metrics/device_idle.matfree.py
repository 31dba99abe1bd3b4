"""device_idle.matfree: ``device_idle`` read in a cell of the matrix-free
throughput test, which reports ``gdof_s`` and not ``solve_ms``; the
same reading (fembench/metrics/device_idle.py)."""

from fembench import harness

read = harness.load_module("metrics", "device_idle").read
