"""The harness's own arithmetic and plumbing on the CPU: the window's
statistics, the trace reduction's union, the apply bound, the import
guard, and finding a configuration, a mix and a metric added as files."""

import json
import math
import pathlib
import shutil
import subprocess
import sys
import time
import types

import pytest

from fembench import harness, peaks, trace, window
from fembench.reference import p1_cube

ROOT = pathlib.Path(__file__).resolve().parents[2]


def steady(n=200, ms=50.0, its=100):
    """n back-to-back solves of ``ms`` each."""
    return [(i * ms / 1e3, (i + 1) * ms / 1e3, its, 1e-3, i % 8)
            for i in range(n)]


def stalled(solves, every, extra_ms):
    """The same solves with every ``every``-th one ``extra_ms`` longer,
    the later ones shifted."""
    out, shift = [], 0.0
    for i, (s, e, it, rel, k) in enumerate(solves):
        s2 = s + shift
        if i % every == 0:
            shift += extra_ms / 1e3
        out.append((s2, e + shift, it, rel, k))
    return out


def test_window_arithmetic_of_a_steady_window():
    w = steady()
    assert window.window_s(w) == pytest.approx(10.0)
    assert window.solve_ms(w) == pytest.approx(50.0)
    assert window.solve_ms_p95(w) == pytest.approx(50.0)
    # 200 solves x 100 iterations x 1e7 dofs over 10 s
    assert window.gdof_s(w, 10_000_000) == pytest.approx(20.0)


def test_a_stall_moves_every_window_metric():
    w = steady()
    s = stalled(w, every=10, extra_ms=25.0)   # 10% of solves 50% longer
    assert window.solve_ms(s) == pytest.approx(52.5)
    assert window.solve_ms_p95(s) == pytest.approx(75.0)
    assert window.gdof_s(s, 10_000_000) == pytest.approx(20.0 * 50 / 52.5)
    # a stall between solves, the host's own, moves the rate and the mean
    gap = [(a + (0.5 if i >= 100 else 0.0), b + (0.5 if i >= 100 else 0.0),
            it, r, k) for i, (a, b, it, r, k) in enumerate(w)]
    assert window.solve_ms(gap) == pytest.approx(52.5)
    assert window.gdof_s(gap, 10_000_000) < 20.0


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert window.percentile(v, 95) == 95
    assert window.percentile([3.0], 95) == 3.0
    assert window.percentile([1, 2], 50) == 1


def test_busy_us_is_the_union():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.busy_us([]) == 0
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_apply_bound_counts_x_and_y_once():
    dims = (208, 208, 224)
    n = 209 * 209 * 225
    assert n == 9_828_225
    nbytes, flops = p1_cube.apply_work(dims, 4)
    assert nbytes == 2 * 4 * n and flops == 2 * p1_cube.nnz(dims)
    b = peaks.bound_s(nbytes, flops)
    assert b == pytest.approx(nbytes / 3.35e12)     # bandwidth bound
    assert b == pytest.approx(23.47e-6, rel=1e-3)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)


def test_apply_roofline_reads_the_apply_range():
    mod = harness.load_module("metrics", "apply_roofline")
    rec = dict(ndofs=9_828_225, lattice=(208, 208, 224), itemsize=4,
               problem_type="cgpoisson", trace=dict(ranges={"fembench.apply": dict(
                   calls=100, host_s=0.1, kernels=100,
                   device_s=100 * 0.1128e-3)}))
    assert mod.read(rec) == pytest.approx(100 * 23.47e-6 / 0.1128e-3,
                                          rel=1e-3)
    # the work is the problem type's reference's: twice the bytes in f64
    assert mod.read(dict(rec, itemsize=8)) == pytest.approx(
        2 * mod.read(rec), rel=1e-9)
    rec["trace"]["ranges"]["fembench.apply"]["calls"] = 0
    assert mod.read(rec) is None
    assert mod.read(dict(rec, trace=None)) is None


def test_device_idle_and_launches_read_the_trace():
    idle = harness.load_module("metrics", "device_idle")
    lpi = harness.load_module("metrics", "launches_per_iteration")
    rec = dict(trace=dict(window_s=2.0, busy_s=0.5, kernels=900),
               trace_iterations=45, timed=dict(wall_s=1.25, ranges={}))
    # idle over the unprofiled wall of the same solves, not the traced one
    assert idle.read(rec) == pytest.approx(60.0)
    assert lpi.read(rec) == pytest.approx(20.0)
    assert idle.read(dict(rec, trace=None)) is None
    assert idle.read(dict(rec, timed=None)) is None
    # the throughput cells' names read the same
    for name, base in (("device_idle.matfree", idle),
                       ("launches_per_iteration.matfree", lpi)):
        assert harness.load_module("metrics", name).read(rec) == \
            base.read(rec)


def test_vcycle_ms_reads_the_unprofiled_stretch():
    vc = harness.load_module("metrics", "vcycle_ms")
    rec = dict(timed=dict(wall_s=1.0, ranges={"fembench.vcycle": dict(
        calls=144, host_s=1.152)}),
        trace=dict(ranges={"fembench.vcycle": dict(calls=144, host_s=9.9)}))
    assert vc.read(rec) == pytest.approx(8.0)
    assert vc.read(dict(rec, timed=dict(wall_s=1.0, ranges={}))) is None


def test_host_timer_counts_calls_and_seconds():
    t = harness.HostTimer()
    for _ in range(3):
        with t("a"):
            pass
    assert t.ranges["a"]["calls"] == 3 and t.ranges["a"]["host_s"] >= 0.0
    assert "b" not in t.ranges


def test_setup_phases_are_read_by_their_metrics():
    rec = dict(setup_phases={"import": 3.5, "cuda": 1.25, "harness": 0.0,
                             "program": 2.0})
    assert harness.load_module("metrics", "import_s").read(rec) == 3.5
    assert harness.load_module("metrics", "cuda_init_s").read(rec) == 1.25
    assert harness.load_module("metrics", "import_s").read(
        dict(setup_phases={})) is None


def test_import_guard_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "tpufem",
             "tpufem.cli", "tpufem_torch", "tpufem_torch.cli", "jaxtyping",
             "tpufemx", "numpy"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "tpufem",
        "tpufem.cli"]


def test_import_guard_raises_on_a_loaded_forbidden_module(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    harness.guard("clean")
    monkeypatch.setitem(sys.modules, "tpufem_torch.fake", types.ModuleType("x"))
    harness.guard("the port passes")
    monkeypatch.setitem(sys.modules, "tpufem.fake", types.ModuleType("x"))
    with pytest.raises(harness.RunError, match="tpufem.fake"):
        harness.guard("after the window")


def test_the_port_and_the_harness_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from fembench import harness, port, control\n"
            "import fembench.problems.poisson, fembench.problems.cgpoisson\n"
            "import tpufem_torch.cli, tpufem_torch.problems.poisson\n"
            "import tpufem_torch.problems.cgpoisson\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_finds_a_cell_mix_and_metric_added_as_files(tmp_path,
                                                             monkeypatch):
    bench = tmp_path / "fembench"
    for d in ("configs", "mixes", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "new_config.json").write_text(
        json.dumps({"problem_type": "cgpoisson", "args": []}))
    (bench / "mixes" / "new_mix.v2.json").write_text(
        json.dumps({"name": "new_mix.v2", "ndofs": 1000}))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(record):\n    return record['setup_s'] * 2\n")
    spec = dict(configs=[dict(name="new_config",
                              file="fembench/configs/new_config.json")],
                workloads=[dict(name="new_config.new_mix", config="new_config",
                                traffic="new_mix.v2", chips=1)],
                end_to_end=[dict(name="new_metric", unit="s",
                                 workloads=["new_config.new_mix"]),
                            dict(name="other", unit="s",
                                 workloads=["elsewhere"])],
                per_layer=[])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", bench)
    c = harness.cell(harness.load_spec(), "new_config.new_mix")
    assert c["config"]["problem_type"] == "cgpoisson"
    assert c["mix"]["ndofs"] == 1000
    ms = harness.metrics_for(spec, "new_config.new_mix", traced=False)
    assert [m["name"] for m in ms] == ["new_metric"]
    assert harness.load_module("metrics", "new_metric").read(
        dict(setup_s=1.5)) == 3.0
    with pytest.raises(harness.RunError):
        harness.cell(spec, "missing")


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for w in spec["workloads"]:
        c = harness.cell(spec, w["name"])
        ptype = c["config"]["problem_type"]
        assert callable(harness.load_module("problems", ptype).build)
        assert callable(harness.load_module("reference", ptype).check)


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    """Without a card the run exits non-zero with no result line; so does
    it, card or none, in a directory holding only BENCHMARK.json and
    fembench/."""
    import torch
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fembench", tmp_path / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    where_all = [tmp_path] if torch.cuda.is_available() else [ROOT, tmp_path]
    for where in where_all:
        out = subprocess.run(
            [sys.executable, "fembench/run.py", "--workload",
             "cgpoisson_p1_cube.10m", "--seed", str(2**31 + 7), "--seconds",
             "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=where)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_rhs_pool_is_the_seeds_and_zero_on_dirichlet_planes():
    import torch
    dims = (4, 3, 2)
    a = p1_cube.rhs_pool(2**31 + 5, 3, dims, torch.float32,
                         torch.device("cpu"))
    b = p1_cube.rhs_pool(2**31 + 5, 3, dims, torch.float32,
                         torch.device("cpu"))
    c = p1_cube.rhs_pool(2**31 + 6, 3, dims, torch.float32,
                         torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = a.view(3, 3, 4, 5)
    assert not g[..., 0].any() and not g[..., 4].any()
    assert bool((g[..., 1:4] != 0).all())
    assert math.isclose(float(a.std()), 1.0, rel_tol=0.5)


TOY_PROBLEM = """
import torch


class Toy:
    ranges = []

    def __init__(self, n, device):
        self.dtype, self.lattice, self.ndofs = torch.float32, (n, 1, 1), n
        self.d = torch.arange(1, n + 1, dtype=torch.float32, device=device)

    def solve(self, rhs):
        return rhs / self.d, 1, 0.0

    def registry(self):
        return {"ZZZ Toy": 0.5}


def build(config, mix, device):
    return Toy(int(mix["ndofs"]) * config["dofs_per_node"], device)
"""

TOY_REFERENCE = """
import torch


def rhs_pool(seed, count, mix, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((count, int(mix["ndofs"]) * 3), generator=g,
                       dtype=dtype, device=device)


def apply_work(record):
    return 2 * record["itemsize"] * record["ndofs"], record["ndofs"]


def check(record, pool, sample, config, mix, device):
    d = torch.arange(1, pool.shape[1] + 1, dtype=torch.float64)
    err = max(float((s["x"].double() * d - pool[s["pool"]].double())
                    .abs().max()) for s in sample)
    return [dict(name="residual", value=err, limit=1e-5)]
"""


def test_a_new_problem_type_is_its_pair_of_files(tmp_path, monkeypatch):
    """A configuration of a problem type that no cell has yet, with three
    dofs a node and no lattice, runs through ``run_cell`` from its own
    ``problems/`` and ``reference/`` files: the pool, the check and the
    apply's work are the type's, and no file of the harness changes."""
    import torch
    bench = tmp_path / "fembench"
    for d in ("problems", "reference", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "problems" / "toy.py").write_text(TOY_PROBLEM)
    (bench / "reference" / "toy.py").write_text(TOY_REFERENCE)
    shutil.copy(ROOT / "fembench" / "metrics" / "apply_roofline.py",
                bench / "metrics" / "apply_roofline.py")
    monkeypatch.setattr(harness, "HERE", bench)
    c = dict(workload=dict(name="toy.mix"),
             config=dict(problem_type="toy", dofs_per_node=3),
             mix=dict(name="mix", loop="closed", callers=1, ndofs=50, pool=4,
                      warm_solves=1, sample=3, trace_solves=2))
    rec = harness.run_cell(c, 2**31 + 9, 0.0, False, torch.device("cpu"),
                           time.perf_counter())
    assert rec["ndofs"] == 150 and rec["itemsize"] == 4
    assert rec["registry"] == {"ZZZ Toy": 0.5}
    assert [ch["name"] for ch in rec["checks"]] == ["residual"]
    assert harness.correct(rec), rec["checks"]
    rec["trace"] = dict(ranges={"fembench.apply": dict(
        calls=10, host_s=1.0, kernels=10, device_s=10 * 1200 / 3.35e12)})
    assert harness.load_module("metrics", "apply_roofline").read(rec) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("workload, expect", [
    ("poisson_p1_cube_gmg.10m", {"build_s", "pc_setup_s", "vcycle_ms",
                                 "cg_iterations", "solve_tail_ms"}),
    ("cgpoisson_p1_cube.10m", {"build_s"})])
def test_a_traced_run_on_the_cpu(monkeypatch, workload, expect):
    """A ``--trace 1`` run at a small lattice on the CPU: the timed and
    the profiled stretch both run, the host-clock and program readings
    are there, and the numbers compared come last in the result."""
    import torch
    from fembench.tests.helpers import small_cell
    cpu = torch.device("cpu")
    rec = harness.run_cell(small_cell(workload), 2**31 + 11, 0.0, True, cpu,
                           time.perf_counter())
    assert rec["timed"]["wall_s"] > 0 and rec["trace"]["window_s"] > 0
    out = harness.result(harness.load_spec(), workload, rec, True, cpu)
    assert out["correct"], out["checks"]
    assert expect <= set(out["metrics"]), out["metrics"]
    assert list(out)[-1] == "checks"
    if "vcycle_ms" in expect:
        calls = rec["timed"]["ranges"]["fembench.vcycle"]["calls"]
        assert calls == rec["trace"]["ranges"]["fembench.vcycle"]["calls"]
