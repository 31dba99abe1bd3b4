"""solve_ms_p95 (ms, host clock): the 95th percentile of the wall times
of all the window's solves, each ended by a device synchronisation."""

from fembench import window


def read(record):
    solves = record["solves"]
    return window.solve_ms_p95(solves) if solves else None
