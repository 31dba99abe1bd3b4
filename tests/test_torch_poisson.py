"""The port's Poisson slice end to end on the CPU: against tpufem at a
small lattice, the float64 goldens of tests/test_golden.py, the float32
certified-residual contract, the jax-free import, and the refusals (no
CUDA fallback, unported options)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.config import Config, SolverOptions
from tpufem.fem.dirichlet import DirichletBC as TpuBC
from tpufem.mesh import BoxTetMesh
from tpufem.problems import poisson as tpu_poisson

from tpufem_torch import cli
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.problems import poisson

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_matches_tpufem():
    """RHS, iteration count and solution of the whole float64 slice
    (two smoothed GMG levels + the dense coarse solve)."""
    mesh = BoxTetMesh(16, 16, 32)

    def cfg():
        return Config(dtype="float64", solver=SolverOptions(ksp_rtol=1e-8))

    ref = tpu_poisson.problem(mesh, 1, cfg())
    x_ref, it_ref = ref.solver_function(ref.u, ref.b)
    prob = poisson.problem(mesh, 1, cfg(), CPU)
    x, it = prob.solver_function(prob.u, prob.b)
    b_ref = np.asarray(ref.b)
    assert (np.linalg.norm(prob.b.numpy() - b_ref)
            <= 1e-13 * np.linalg.norm(b_ref))
    assert it == it_ref
    n, n_ref = np.linalg.norm(x.numpy()), np.linalg.norm(np.asarray(x_ref))
    assert abs(n - n_ref) <= 1e-10 * n_ref
    assert prob.solver_function.true_rel <= 1e-8


@pytest.mark.parametrize("ndofs,gold_it,gold_norm", [
    ("15000", 9, 26.535020301876788),
    ("50000", 10, 48.94285576880367),
], ids=["poisson15k", "poisson50k"])
def test_golden(ndofs, gold_it, gold_norm):
    res = cli.main(["--problem_type", "poisson", "--ndofs", ndofs,
                    "--scaling_type", "weak", "--num_shards", "1",
                    "--dtype", "float64", "-ksp_rtol", "1e-8",
                    "--device", "cpu"])
    assert res.iterations == gold_it
    assert abs(res.norm - gold_norm) < 1e-9 * abs(gold_norm)
    assert res.problem.rhs_op is None  # float64 assembles b on the host


def test_float32_certified_contract():
    res = cli.main(["--ndofs", "15000", "--dtype", "float32",
                    "-ksp_rtol", "1e-8", "--device", "cpu"])
    assert res.true_rel is not None and res.true_rel <= 1e-8
    assert res.problem.b.dtype == torch.float32
    assert 0 < res.iterations < 20
    assert abs(res.norm - 26.535020301876788) < 1e-5 * 26.535020301876788
    # the device RHS's mass operator is kept on the problem
    mass, A = res.problem.rhs_op, res.problem.solver_function.A
    assert mass.fields.dtype == torch.float32
    assert mass.grid_dims == A.grid_dims and not mass.bc_mask.any()


def test_profile_solve_on_cpu():
    from tpufem_torch import profile_solve
    out = profile_solve.main(["--solves", "2", "--",
                              "--ndofs", "3000", "--dtype", "float32",
                              "--device", "cpu"])
    assert out["iterations"] > 0 and len(out["solves"]) == 2
    assert out["wall_s"] > 0.0
    # no device on the CPU: nothing launched, nothing busy
    assert out["device_kernels"] == out["launch_calls"] == 0
    assert out["busy_s"] == 0.0
    # busy time is the union of the device intervals
    assert profile_solve.busy_us([(5, 6), (0, 2), (1, 3), (1.5, 2.5)]) == 4


def _spans(reps, launches, name="perm_apply_cube_kernel<float, 20>", t=0.0):
    """A profile's device spans: per call an L2 flush (100 us) and
    ``launches`` launches of ``name``, 30 us each, back to back."""
    out = []
    for _ in range(reps):
        out.append(("void at::native::reduce_kernel<512, 1>", t, t + 100.0))
        t += 100.0
        for _ in range(launches):
            out.append((f"void (anonymous namespace)::{name}(...)", t,
                        t + 30.0))
            t += 30.0
    return out


@pytest.mark.parametrize("reps,launches", [(20, 1), (3, 2)])
def test_kernel_device_ms_counts_the_kernels_own_spans(reps, launches):
    """Per call: the kernel's own spans only (not the flush's), reps x
    launches of them."""
    from tpufem_torch.profile_solve import kernel_device_ms
    spans = _spans(reps, launches)
    assert kernel_device_ms(spans, "perm_apply_cube_kernel", reps,
                            launches) == pytest.approx(0.030 * launches)


def test_kernel_device_ms_refuses_a_missing_or_extra_span():
    from tpufem_torch.profile_solve import kernel_device_ms
    spans = _spans(20, 1)
    with pytest.raises(ValueError, match="19 spans"):
        kernel_device_ms(spans[:-1], "perm_apply_cube_kernel", 20)
    with pytest.raises(ValueError, match="expected 40"):
        kernel_device_ms(spans, "perm_apply_cube_kernel", 20, launches=2)
    with pytest.raises(ValueError, match="0 spans"):
        kernel_device_ms(spans, "dense_gemv_bf16", 20)


def test_kernel_device_ms_overlapping_spans_count_once():
    """Two launches of a call that overlap (other streams) count as the
    union of their intervals; both kernels of a two-kernel call match."""
    from tpufem_torch.profile_solve import kernel_device_ms
    spans = [("dense_gemv_bf16_kernel", 0.0, 50.0),
             ("dense_gemv_bf16_combine", 40.0, 60.0),
             ("dense_gemv_bf16_kernel", 100.0, 150.0),
             ("dense_gemv_bf16_combine", 150.0, 152.0),
             ("reduce_kernel", 55.0, 100.0)]
    assert kernel_device_ms(spans, "dense_gemv_bf16", 2,
                            launches=2) == pytest.approx(0.056)


def test_import_and_solve_leave_jax_out():
    code = ("import sys\n"
            "from tpufem_torch.cli import main\n"
            "res = main(['--ndofs', '3000', '--dtype', 'float64',"
            " '--device', 'cpu'])\n"
            "assert res.iterations > 0\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_LOADED False" in out.stdout


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--ndofs", "3000", "--device", "cuda"])


@pytest.mark.parametrize("argv,raises", [
    # ported since: the matrix-free cgpoisson on the spoke mesh (singular,
    # undeflated: its 100 steps, uncertified)
    (["--problem_type", "cgpoisson", "--mesh_type", "unstructured"],
     "matrix-free"),
    # P2/P3 elasticity is ported; its -pc_type amg fails in tpufem too
    (["--problem_type", "elasticity", "--order", "2", "-pc_type", "amg"],
     "tpufem has no such path"),
    # ported since: tpufem's SA-AMG and the spoke mesh run
    (["--problem_type", "elasticity", "-pc_type", "amg", "-amg_brick", "off"],
     None),
    (["--mesh_type", "unstructured"], None),
    (["--order", "2", "-pc_type", "amg"], None),
    # ported since: the slab-sharded path (certifying nothing, as tpufem's)
    (["--num_shards", "2"], "sharded"),
    (["-pc_type", "amg", "-amg_brick", "off"], None),
], ids=["cgpoisson_unstructured", "elasticity_order2", "elasticity_amg",
        "unstructured", "order2", "shards", "amg"])
def test_unported_options_raise(argv, raises):
    """What is not ported raises naming its ROADMAP item (or, where tpufem
    has no such path either, saying so); what has been ported since runs
    a small certified solve (the sharded path, as tpufem's, certifies
    nothing)."""
    argv = ["--ndofs", "3000", "--device", "cpu"] + argv
    if raises == "sharded":
        res = cli.main(argv + ["--dtype", "float64"])
        assert 0 < res.iterations < 100 and res.true_rel is None
        assert type(res.problem.solver_function.sh).__name__ == \
            "ShardedCubeSolver"
        return
    if raises == "matrix-free":
        res = cli.main(argv + ["--dtype", "float64"])
        assert res.iterations == 100 and res.true_rel is None
        assert type(res.problem.solver_function.op).__name__ == \
            "MatFreePoissonOp"
        return
    if raises is not None:
        with pytest.raises(NotImplementedError, match=raises):
            cli.main(argv)
        return
    res = cli.main(argv + ["--dtype", "float64"])
    assert 0 < res.iterations < 100 and res.true_rel <= 1e-8


@pytest.mark.parametrize("given", [True, False], ids=["path", "default"])
def test_log_view_writes_a_trace_of_the_solve(given, tmp_path, monkeypatch,
                                              capsys, caplog):
    """-log_view is read (no "Option left"), traces the solve into the
    given directory, or ./tpufem-trace without a value (tpufem's rule)."""
    monkeypatch.chdir(tmp_path)
    where = str(tmp_path / "trace") if given else "./tpufem-trace"
    argv = ["--ndofs", "3000", "--dtype", "float64", "--device", "cpu",
            "-log_view"] + ([where] if given else [])
    res = cli.main(argv)
    assert res.iterations > 0
    assert f"-log_view: profiler trace written to {where}" in \
        capsys.readouterr().out
    traces = os.listdir(where)
    assert traces and os.path.getsize(os.path.join(where, traces[0])) > 0
    assert "Option left" not in caplog.text


def test_log_view_trace_names_the_solve_path(tmp_path, capsys):
    """-log_view turns the solve path's spans on while it profiles: the
    trace holds the CG steps and V-cycle levels, the run prints their
    table, and the spans are off again after it."""
    import json

    from tpufem_torch import timing
    where = str(tmp_path / "trace")
    res = cli.main(["--ndofs", "3000", "--dtype", "float64", "--device",
                    "cpu", "-log_view", where])
    with open(os.path.join(where, "solve.trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"solve", "cg.step", "cg.apply", "cg.precond", "cg.readback",
            "gmg.smooth.L0", "gmg.coarse"} <= names
    out = capsys.readouterr().out
    assert f"counter cg.readbacks: {res.iterations + 2}" in out
    assert timing.span("cg.step") is timing.span("solve")


def test_dirichlet_set_and_zero_match_tpufem():
    mask = np.zeros(20, dtype=bool)
    mask[[0, 3, 7]] = True
    dofs = np.flatnonzero(mask)
    x = np.arange(20.0)
    bc = DirichletBC(scalar_dofs=dofs, value=2.0, ndofs_scalar=20)
    ref = TpuBC(scalar_dofs=dofs, value=2.0, ndofs_scalar=20)
    assert np.array_equal(bc.mask(), ref.mask())
    assert np.array_equal(bc.set(torch.from_numpy(x), 3.0).numpy(),
                          np.asarray(ref.set(jnp.asarray(x), 3.0)))
    assert np.array_equal(bc.zero(torch.from_numpy(x)).numpy(),
                          np.asarray(ref.zero(jnp.asarray(x))))
