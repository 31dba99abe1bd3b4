"""tpufem's own ``--output`` files of CLI runs on the CPU (JAX,
its 8-device virtual mesh), the values tests/test_torch_xdmf.py pins:
iterations, the number of vertices and cells, the norm of
``/function/values``, its entries at a few fixed places (flattened) and
the SHA-256 of ``/mesh/topology`` and ``/mesh/geometry``, printed as
Python literals.

    python scripts/xdmf_reference.py [--case NAME ...]

Cases (CASES): elasticity P1 (node-interleaved vectors), the slab path (``--ndofs 3000 --num_shards 2``) and the
row-sharded spoke (``--mesh_type unstructured --ndofs 3000 --num_shards
2 -ksp_max_it 40``), float64.  tpufem's host-memory warm-up
(tpufem/hostmem.py: ``prefault`` and, on the spoke, a detached process
touching 4 GiB) is switched off: it moves no value."""

import argparse
import hashlib
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

SAMPLES = 11  # entries of the flattened values, evenly spaced

CASES = {
    "elasticity": "--problem_type elasticity --ndofs 3000 --num_shards 1 "
    "--dtype float64",
    "slab": "--ndofs 3000 --num_shards 2 --dtype float64",
    "rowshard-spoke": "--mesh_type unstructured --ndofs 3000 --num_shards 2 "
    "--dtype float64 -ksp_max_it 40",
}


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--case", nargs="*")
    args = p.parse_args()
    import tpufem.hostmem as hostmem
    from tpufem.cli import parse_args, solve
    from tpufem.io import read_xdmf
    hostmem.prefault = lambda *a, **k: None
    hostmem.warm_vm = lambda *a, **k: None
    for name in args.case or list(CASES):
        with tempfile.TemporaryDirectory() as out:
            cfg = parse_args(CASES[name].split() + ["--output", out])
            it, _ = solve(cfg)
            f = read_xdmf(os.path.join(out, f"solution-{cfg.num_shards}.xdmf"))
        v = f["values"].reshape(-1)
        idx = np.linspace(0, v.shape[0] - 1, SAMPLES).astype(np.int64)
        print(f"RESULT {name!r}: ({it}, {f['geometry'].shape[0]}, "
              f"{f['topology'].shape[0]}, {float(np.linalg.norm(v))!r}, "
              f"{[float(x) for x in v[idx]]!r}, "
              f"{digest(f['topology'])!r}, {digest(f['geometry'])!r}),",
              flush=True)


if __name__ == "__main__":
    main()
