"""``python -m tpufem_torch --num_shards N`` on the CPU against tpufem's
CLI: tpufem's two sharded goldens (tests/test_golden.py) and its sharded
CLI cases (tests/test_cli.py), float64, to its iteration counts and
norms (tpufem's values pinned by ``scripts/sharded_reference.py --cli``),
the routes (slabs, the row-sharded path where the cube is too small for
a sharded multigrid chain, GMG for ``-pc_type amg`` on the cube), and
the summary and scope."""

import logging

import numpy as np
import pytest
import torch

from tpufem_torch import cli
from tpufem_torch.problems import cgpoisson, sharded

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_timed_solve(monkeypatch):
    """The timing loops cut to the one solve (the values are the same)."""
    monkeypatch.setattr(sharded, "TIMING_REPS", 0)
    monkeypatch.setattr(cgpoisson, "TIMING_PASSES", 1)
    monkeypatch.setattr(cgpoisson, "TIMING_REPS", 1)


def run(args: str):
    return cli.main(args.split() + ["--dtype", "float64", "--device", "cpu"])


# tpufem's CLI, float64 (iterations, norm); the goldens are
# tests/test_golden.py's, the others python scripts/sharded_reference.py
# --cli
TPUFEM = {
    "poisson100k-8shard": ("--problem_type poisson --ndofs 100000 "
                           "--scaling_type strong --num_shards 8 "
                           "-ksp_rtol 1e-8", 11, 68.43884037046897),
    "elasticity10k-4shard": ("--problem_type elasticity --ndofs 10000 "
                             "--scaling_type weak --num_shards 4",
                             20, 4.3635484081745004e-05),
    "elasticity4000-8": ("--problem_type elasticity --ndofs 4000 "
                         "--num_shards 8", 21, 3.587320067138036e-05),
    "order2-15000-8": ("--problem_type poisson --ndofs 15000 --order 2 "
                       "--num_shards 8", 11, 68.57320785948252),
    "spoke4000-2": ("--problem_type poisson --mesh_type unstructured "
                    "--ndofs 4000 --num_shards 2 -ksp_max_it 40",
                    40, 498.86361738374296),
    "rowshard-small-cube": ("--ndofs 3000 --num_shards 2 --scaling_type "
                            "strong -amg_coarse_eq_limit 5000",
                            1, 11.197928170959246),
    "pc-amg-on-slabs": ("--ndofs 15000 --num_shards 4 -pc_type amg "
                        "-ksp_rtol 1e-8", 9, 49.90673388309939),
}


@pytest.mark.parametrize("name", list(TPUFEM))
def test_matches_tpufem_cli(name, caplog):
    args, it, norm = TPUFEM[name]
    with caplog.at_level(logging.INFO, logger="tpufem_torch"):
        res = run(args)
    assert res.iterations == it
    assert abs(res.norm - norm) <= 1e-9 * norm
    assert np.isfinite(res.x.numpy()).all()
    log = caplog.text
    assert ("too small for a sharded multigrid chain" in log) == \
        (name == "rowshard-small-cube")
    assert ("'-pc_type amg' runs the slabs' geometric multigrid" in log) == \
        (name == "pc-amg-on-slabs")


def test_strong_scaling_8_shards_equals_serial(capsys):
    """tpufem's test_cli case: 8 shards and 1 solve the same 32^3 system
    (tpufem's 8-shard run: 9 iterations, 40.29408478836899)."""
    args = ("--problem_type poisson --ndofs 35937 --scaling_type strong "
            "-ksp_rtol 1e-8")
    r8 = run(args + " --num_shards 8")
    out = capsys.readouterr().out
    assert "Num shards:      8" in out
    assert "Average degrees of freedom per shard:   4492" in out
    r1 = run(args + " --num_shards 1")
    assert r8.iterations == r1.iterations == 9
    assert abs(r8.norm - r1.norm) <= 1e-8 * r1.norm
    assert abs(r8.norm - 40.29408478836899) <= 1e-9 * r8.norm


def test_cgpoisson_sharded_matches_serial():
    """tpufem's 8-shard cgpoisson: 100 iterations, 40.294084167271535;
    the serial run's norm to 1e-5 (tpufem's own bound)."""
    args = "--problem_type cgpoisson --ndofs 35937 --scaling_type strong"
    r8 = run(args + " --num_shards 8")
    r1 = run(args + " --num_shards 1")
    assert r8.iterations == 100 and abs(r8.iterations - r1.iterations) <= 1
    assert abs(r8.norm - 40.294084167271535) <= 1e-9 * r8.norm
    assert abs(r8.norm - r1.norm) <= 1e-5 * r1.norm
    assert r8.problem.solver_function.gdofs > 0


def test_weak_scaling_iterations_flat():
    """tpufem's weak-scaling case (its 8-shard run: 9, 72.96320383106908)."""
    args = "--problem_type poisson --ndofs 15000 --scaling_type weak " \
        "-ksp_rtol 1e-8"
    r1 = run(args + " --num_shards 1")
    r8 = run(args + " --num_shards 8")
    assert abs(r8.iterations - r1.iterations) <= 2
    assert r8.iterations == 9
    assert abs(r8.norm - 72.96320383106908) <= 1e-9 * r8.norm


@pytest.mark.parametrize("flag,item", [("--output /tmp/x", "M17"),
                                       ("--memory_profiling", "M17")])
def test_scope_keeps_only_m17(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        run(f"--ndofs 1000 --num_shards 2 {flag}")


def test_dryrun_multichip_twin(capsys):
    """tpufem_torch.entry.dryrun_multichip, the twin of
    __graft_entry__.dryrun_multichip: its four sharded paths at 8 shards
    against one, each converged and within its tolerance (it asserts)."""
    from tpufem_torch.entry import dryrun_multichip
    dryrun_multichip(8, "cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip[")]
    assert [ln.split("[")[1].split("]")[0] for ln in lines] == [
        "poisson cg+gmg", "elasticity cg+gmg", "poisson P2 cg+gmg",
        "rowshard amg"]
    assert all(" 8 shards, " in ln for ln in lines)
