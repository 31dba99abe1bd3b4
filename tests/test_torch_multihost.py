"""Multi-process runs over torch.distributed (tpufem_torch/parallel/
multihost.py and the process-group form of parallel/comm.py): two
processes over gloo, each holding 2 of 4 shards, against one process
holding all 4 (the exchanges, the per-host slab build and its solve, the
row-sharded solve, the CLI), each worker built only for its own shards;
the environment rules; and NCCL's one rank a GPU."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpufem_torch import cli
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.parallel import multihost
from tpufem_torch.parallel.slab import ShardedCubeSolver
from tpufem_torch.problems import sharded

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "TPUFEM_NUM_PROCESSES", "TPUFEM_PROCESS_ID")
SLAB_KW = dict(problem="poisson", dtype=torch.float64, rtol=1e-8, maxit=60,
               gather_limit=500)
CLI_ARGS = ["--ndofs", "2000", "--num_shards", "4", "--dtype", "float64",
            "-ksp_rtol", "1e-8", "--device", "cpu"]

_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, os.getcwd())
    from tpufem_torch.parallel import multihost
    rank, world = multihost.init_from_env(torch.device("cpu"))
    from tpufem_torch import cli
    from tpufem_torch.mesh.structured import BoxTetMesh
    from tpufem_torch.parallel.comm import ShardComm
    from tpufem_torch.parallel.gmap import build_general_maps
    from tpufem_torch.parallel.slab import ShardedCubeSolver
    from tpufem_torch.problems import sharded
    sharded.TIMING_REPS = 0
    CPU = torch.device("cpu")
    out = {"rank": rank, "world": world}
    comm = ShardComm(4, CPU)
    out["local"] = comm.local.tolist()
    # the exchanges: a global buffer [4, 3], this process's rows of it
    g = np.arange(12, dtype=np.float64).reshape(4, 3) + 1.0
    t = torch.from_numpy(g[comm.local])
    perms = {"down": [(1, 0), (2, 1), (3, 2)], "up": [(0, 1), (1, 2), (2, 3)],
             "ring": [(0, 3), (3, 2), (2, 1), (1, 0)], "cross": [(0, 2), (3, 1)]}
    out["ppermute"] = {k: comm.ppermute(t, p).tolist() for k, p in perms.items()}
    out["psum"] = comm.psum(t).tolist()
    out["all_gather"] = comm.all_gather(t).tolist()
    # general maps: the complete graph (every pair, several rounds)
    gm = build_general_maps([np.arange(16)] * 4, np.arange(16) % 4)
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, gm.nlocal))[comm.local])
    out["fwd"] = gm.fwd(y, comm).tolist()
    out["rev_add"] = gm.rev_add(y, comm).tolist()
    # the per-host slab build, each process building its own shards only
    calls = []
    orig = multihost.make_sharded_rows
    def counting(comm, shape, dtype, builder):
        def wrapped(s):
            calls.append(s)
            return builder(s)
        return orig(comm, shape, dtype, wrapped)
    multihost.make_sharded_rows = counting
    kw = json.loads(sys.argv[1])
    kw["dtype"], kw["device"] = torch.float64, CPU
    sh = ShardedCubeSolver.build_per_host(BoxTetMesh(8, 8, 16), 4, **kw)
    out["built"] = sorted(set(calls))
    x, it, rel, _ = sh.run_timed(0)
    out["slab"] = [it, rel, sh.norm(x)]
    res = cli.main(json.loads(sys.argv[2]))
    out["cli"] = [res.iterations, res.norm]
    res = cli.main(["--problem_type", "poisson", "--mesh_type",
                    "unstructured", "--ndofs", "1500", "--num_shards", "4",
                    "--dtype", "float64", "--device", "cpu"])
    out["rowshard"] = [res.iterations, res.norm]
    json.dump(out, open(os.environ["OUT"], "w"))
""")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_without_environment_touches_no_runtime(clean_env):
    import torch.distributed as dist
    assert multihost.init_from_env(torch.device("cpu")) == (0, 1)
    assert not dist.is_initialized()
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.init_from_env(torch.device("cpu"))


def test_nccl_takes_one_rank_a_gpu(clean_env):
    """A rank whose LOCAL_RANK names no GPU of its own raises by name,
    before any process group exists (never gloo instead)."""
    import torch.distributed as dist
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29999", RANK="1",
                     WORLD_SIZE="2",
                     LOCAL_RANK=str(torch.cuda.device_count())).items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL runs one rank a GPU"):
        multihost.init_from_env(torch.device("cuda"))
    assert not dist.is_initialized()


def test_one_process_builds_every_shard():
    from tpufem_torch.parallel.comm import ShardComm
    calls = []

    def builder(s):
        calls.append(s)
        return np.full(3, float(s))

    comm = ShardComm(4, torch.device("cpu"))
    rows = multihost.make_sharded_rows(comm, (3,), np.float64, builder)
    assert calls == [0, 1, 2, 3] and rows[:, 0].tolist() == [0, 1, 2, 3]
    assert [comm.rank_of(s) for s in range(4)] == [0, 0, 0, 0]
    assert comm.local.tolist() == [0, 1, 2, 3]


def test_two_processes_match_one(tmp_path, clean_env):
    """2 processes x 2 shards over gloo against this process's 4 shards:
    the same exchanges, iterations and norms."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    kw = dict(SLAB_KW, dtype=None)
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE="2", OUT=str(tmp_path / f"{r}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), json.dumps(kw),
             json.dumps(CLI_ARGS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    res = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(2)]

    # the one-process run
    g = np.arange(12, dtype=np.float64).reshape(4, 3) + 1.0
    perms = {"down": [(1, 0), (2, 1), (3, 2)], "up": [(0, 1), (1, 2), (2, 3)],
             "ring": [(0, 3), (3, 2), (2, 1), (1, 0)],
             "cross": [(0, 2), (3, 1)]}
    from tpufem_torch.parallel.comm import ShardComm
    from tpufem_torch.parallel.gmap import build_general_maps
    comm = ShardComm(4, torch.device("cpu"))
    gm = build_general_maps([np.arange(16)] * 4, np.arange(16) % 4)
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, gm.nlocal)))
    fwd, rev = gm.fwd(y, comm).numpy(), gm.rev_add(y, comm).numpy()
    sh = ShardedCubeSolver.build(BoxTetMesh(8, 8, 16), 4,
                                 device=torch.device("cpu"), **SLAB_KW)
    x, it, rel, _ = sh.run_timed(0)
    orig = sharded.TIMING_REPS
    sharded.TIMING_REPS = 0
    try:
        one_cli = cli.main(CLI_ARGS)
        one_row = cli.main(["--problem_type", "poisson", "--mesh_type",
                            "unstructured", "--ndofs", "1500",
                            "--num_shards", "4", "--dtype", "float64",
                            "--device", "cpu"])
    finally:
        sharded.TIMING_REPS = orig

    for r, out in enumerate(res):
        rows = [2 * r, 2 * r + 1]
        assert out["world"] == 2 and out["local"] == rows
        for k, p in perms.items():
            want = comm.ppermute(torch.from_numpy(g), p).numpy()[rows]
            assert np.array_equal(np.asarray(out["ppermute"][k]), want), k
        assert np.array_equal(out["psum"], g.sum(0))
        assert np.array_equal(out["all_gather"], g)
        assert np.array_equal(np.asarray(out["fwd"]), fwd[rows])
        assert np.array_equal(np.asarray(out["rev_add"]), rev[rows])
        assert out["built"] == rows
        s_it, s_rel, s_norm = out["slab"]
        assert s_it == it and s_rel < 1e-8
        assert abs(s_norm - sh.norm(x)) <= 1e-12 * s_norm
        assert out["cli"][0] == one_cli.iterations
        assert abs(out["cli"][1] - one_cli.norm) <= 1e-12 * one_cli.norm
        assert out["rowshard"][0] == one_row.iterations
        assert abs(out["rowshard"][1] - one_row.norm) <= \
            1e-12 * one_row.norm
