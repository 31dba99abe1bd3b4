"""gdof_s (Gdof/s, host clock): upstream's throughput
(src/cgpoisson_problem.cpp:232-243), iterations x dofs over the solve's
seconds, taken over the whole window: the sum over its solves of
iterations x dofs, over its seconds, / 1e9."""

from fembench import window


def read(record):
    solves = record["solves"]
    return window.gdof_s(solves, record["ndofs"]) if solves else None
