"""Shared pieces of the benchmark's tests: a cell of BENCHMARK.json cut to
a lattice that a CPU test holds."""

import torch

from fembench import harness

SMALL_DOFS = 20000     # a 24 x 24 x 32 lattice, 16,875 dofs
CPU = torch.device("cpu")
_cell = harness.cell      # kept: tests replace harness.cell by small_cell


def small_cell(workload: str, **mix) -> dict:
    c = _cell(harness.load_spec(), workload)
    c["mix"] = dict(c["mix"], ndofs=SMALL_DOFS, trace_solves=2, **mix)
    return c


def need_cuda():
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
