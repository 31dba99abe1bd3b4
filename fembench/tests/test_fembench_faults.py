"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``harness.run_cell``, past the
harness's look for a chip) on the CPU at a small lattice, with one fault
planted in the port: a solve that returns its state unchanged, an answer
altered where it is produced, half of the rows left out of the
operator's product, and (the GMG cell) a V-cycle weakened to its fine
level's smoothing, whose solves still reach the configured rtol.  One
process, one card: there is no exchange between chips to leave out."""

import time

import pytest
import torch

from fembench import harness
from fembench.tests.helpers import CPU, small_cell

CELLS = ("cgpoisson_p1_cube.10m", "poisson_p1_cube_gmg.10m")
SEED = 2**31 + 77


def run(workload):
    c = small_cell(workload)
    rec = harness.run_cell(c, SEED, 0.0, False, CPU, time.perf_counter())
    return harness.correct(rec), {ch["name"]: ch["value"]
                                  for ch in rec["checks"]}


def wrap_solvers(monkeypatch, change):
    """Both problems' CG, with ``change(x)`` applied to its answer."""
    from tpufem_torch.problems import cgpoisson, poisson
    for mod, name in ((poisson, "cg_solve"), (cgpoisson, "cg_solve_fused")):
        inner = getattr(mod, name)

        def broken(*args, _inner=inner, **kwargs):
            x, it, rel = _inner(*args, **kwargs)
            return change(x), it, rel

        monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    ok, checks = run(workload)
    assert ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged(monkeypatch, workload):
    wrap_solvers(monkeypatch, torch.zeros_like)
    ok, checks = run(workload)
    assert not ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_it_is_produced(monkeypatch, workload):
    def alter(x):
        x = x.clone()
        i = x.numel() // 2 + 17
        x[i] += x.abs().max()
        return x
    wrap_solvers(monkeypatch, alter)
    ok, checks = run(workload)
    assert not ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_rows_left_out(monkeypatch, workload):
    from tpufem_torch.fem.dia_op import DiaOperator
    inner = DiaOperator.apply

    def half(self, x, *args, **kwargs):
        y = inner(self, x, *args, **kwargs)
        if y.numel() == x.numel() and y.dim() == 1:
            y = y.clone()
            y[y.numel() // 2:] = 0.0
        return y

    monkeypatch.setattr(DiaOperator, "apply", half)
    ok, checks = run(workload)
    assert not ok, checks


def test_weakened_vcycle_is_caught_by_its_iterations(monkeypatch):
    """The V-cycle without its coarse correction: CG still converges to
    the configured rtol and to a small true residual, in more iterations
    than the limit allows."""
    from tpufem_torch.la.gmg import GMG
    inner = GMG.vcycle

    def weak(self, r, i=0):
        if i > 0:
            return inner(self, r, i)
        x, _ = self._smooth0[0](r)
        return self._smooth[0](x, r)

    monkeypatch.setattr(GMG, "vcycle", weak)
    ok, checks = run("poisson_p1_cube_gmg.10m")
    assert not ok, checks
    assert checks["rel"] <= 1e-8 and checks["true_rel"] <= 1e-4, checks
    assert checks["its"] > 32, checks
