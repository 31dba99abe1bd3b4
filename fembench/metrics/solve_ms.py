"""solve_ms (ms, host clock): the window's milliseconds over the solves
it completed."""

from fembench import window


def read(record):
    solves = record["solves"]
    return window.solve_ms(solves) if solves else None
