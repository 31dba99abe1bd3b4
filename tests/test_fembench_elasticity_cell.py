"""The benchmark's elasticity cell, ``elasticity_p1_cube.10m``, run on the
CPU at a small lattice (``fembench/tests/helpers.small_cell``: 16x16x24,
21,675 dofs, two smoothed GMG levels): a sound run, traced, is correct
and its readings are there; a run with a fault planted in the port is
not correct (the answer x = 0, one of its three components zeroed, a
V-cycle weakened to its fine level's smoothing); and the control of
``correct``, the plain reference in the program's place, fails in TF32
and passes in float32 (bar ``its``, which measures the program's
preconditioner: the reference has none).

At this lattice the float32 reference needs about 500 steps, so the
control's budget is cut to 1,000 here (the cell's 6,000 are for 10M
dofs); the TF32 reference diverges within it."""

import time

import pytest
import torch

from fembench import control, harness
from fembench.tests.helpers import CPU, small_cell

CELL = "elasticity_p1_cube.10m"
SEED = 2**31 + 4242

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def guard_new_modules(monkeypatch):
    """This suite's conftest imports JAX before any test, which the
    harness's guard refuses; here it refuses the modules of JAX or tpufem
    that a run loads, those already loaded set aside."""
    before = set(harness.forbidden_modules())

    def guard(when):
        found = sorted(set(harness.forbidden_modules()) - before)
        if found:
            raise harness.RunError(f"{when}: a run loaded " + ", ".join(found))

    monkeypatch.setattr(harness, "guard", guard)


def run(workload=CELL, traced=False, seed=SEED):
    c = small_cell(workload)
    rec = harness.run_cell(c, seed, 0.0, traced, CPU, time.perf_counter())
    return rec, {ch["name"]: ch["value"] for ch in rec["checks"]}


def test_a_traced_run_is_correct_and_reads_its_metrics():
    rec, checks = run(traced=True)
    assert rec["lattice"] == (16, 16, 24) and rec["ndofs"] == 21_675
    spec = harness.load_spec()
    out = harness.result(spec, CELL, rec, True, CPU)
    assert out["correct"], out["checks"]
    # the CPU has no kernels to read and the process phases are main()'s
    assert {"build_s", "pc_setup_s", "vcycle_ms", "cg_iterations",
            "solve_tail_ms", "device_idle"} <= set(out["metrics"])
    assert set(harness.result(spec, CELL, rec, False, CPU)["metrics"]) == {
        "setup_s", "solve_ms"}
    assert checks["lattice_off"] == 0.0 and checks["rel"] <= 1e-8
    # the program's own spans are ranges of the traced stretch alone
    ranges = rec["trace"]["ranges"]
    its = rec["trace_iterations"]
    assert ranges["fembench.vcycle"]["calls"] == its
    assert ranges["cg.apply"]["calls"] == its
    assert ranges["gmg.smooth.L0"]["calls"] == 2 * its
    assert rec["timed"]["ranges"]["fembench.vcycle"]["calls"] == its
    from tpufem_torch import timing
    assert timing.span("solve") is timing.span("cg.apply")  # spans off


def _wrap_cg(monkeypatch, change):
    """The elasticity solver's CG (``problems.poisson.cg_solve``), with
    ``change(x)`` applied to its planar answer."""
    from tpufem_torch.problems import poisson
    inner = poisson.cg_solve

    def broken(*args, **kwargs):
        x, it, rel = inner(*args, **kwargs)
        return change(x), it, rel

    monkeypatch.setattr(poisson, "cg_solve", broken)


def _zero_component(x):
    x = x.clone()
    n = x.numel() // 3
    x[n:2 * n] = 0.0          # component 1 of every vertex, planar
    return x


@pytest.mark.parametrize("change", [torch.zeros_like, _zero_component],
                         ids=["x_zero", "one_component_zero"])
def test_a_wrong_answer_is_not_correct(monkeypatch, change):
    _wrap_cg(monkeypatch, change)
    rec, checks = run()
    assert not harness.correct(rec), checks
    assert checks["true_rel"] > 0.1, checks


def test_weakened_vcycle_is_not_correct(monkeypatch):
    """The V-cycle without its coarse correction: CG runs to its cap
    of 100 iterations, past the limit on ``its``."""
    from tpufem_torch.la.gmg import GMG
    inner = GMG.vcycle

    def weak(self, r, i=0):
        if i > 0:
            return inner(self, r, i)
        x, _ = self._smooth0[0](r)
        return self._smooth[0](x, r)

    monkeypatch.setattr(GMG, "vcycle", weak)
    rec, checks = run()
    assert not harness.correct(rec), checks
    assert checks["its"] > harness.cell(harness.load_spec(), CELL)[
        "config"]["limits"]["its"], checks


@pytest.mark.parametrize("subject, correct", [
    ("tf32", False), ("float32", True), ("program", True)])
def test_control_on_a_small_lattice(monkeypatch, subject, correct):
    def cell(spec, workload):
        c = small_cell(workload)
        c["config"] = dict(c["config"],
                           control=dict(c["config"]["control"], max_it=1000))
        return c

    monkeypatch.setattr(harness, "cell", cell)
    (r,) = control.readings(CELL, [SEED], subject, CPU)
    if subject == "program":
        assert r["correct"] is correct, r
        return
    judged = all(v <= r["limits"][k] for k, v in r["checks"].items()
                 if k != "its")
    assert judged is correct, r
    assert r["checks"]["its"] > 3 * r["limits"]["its"], r
