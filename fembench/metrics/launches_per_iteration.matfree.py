"""launches_per_iteration.matfree: ``launches_per_iteration`` read in a cell of the matrix-free
throughput test, which reports ``gdof_s`` and not ``solve_ms``; the
same reading (fembench/metrics/launches_per_iteration.py)."""

from fembench import harness

read = harness.load_module("metrics", "launches_per_iteration").read
