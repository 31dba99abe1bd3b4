"""solve_tail_ms (ms, host clock, la.cg): the 95th percentile of the
solves' wall times, as ``solve_ms_p95``, read in the traced run of a
cell whose device idles most of the window: a tail that the host paces."""

from fembench import window


def read(record):
    solves = record["solves"]
    return window.solve_ms_p95(solves) if solves else None
