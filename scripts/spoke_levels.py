#!/usr/bin/env python3
"""The port's SA-AMG level sizes of the spoke mesh's Poisson problem at
order k, with a digest of every host step that feeds the aggregation, so
that two hosts (two numpy / scipy builds) can be compared step by step.

For each ``--ndofs`` (strong scaling, float32 as the CLI runs it) it
builds the spoke mesh, the space, the Dirichlet dofs and tpufem's
BC-eliminated CSR (``fem.assemble.assemble_csr_np``), takes the window
gate's route, runs ``SAAMG.setup`` on the host (device ``cpu``: the
hierarchy is host work) and prints one JSON line: the level sizes, the
route and sha256 digests of the reference tables
(``ReferenceTet.stiffness_tensors``, which ``fem/reference.py`` builds
with ``np.linalg.solve``), the metric, the element matrices, the CSR,
the RCM permutation, and the numpy / scipy versions.

    python scripts/spoke_levels.py --order 2 --ndofs 3000 6000 12000
    # keep this host's CSR values (--save-ref), then on another host
    # count the entries that differ (--ref) and write the CSR of the
    # smallest size whose levels are not those given (SIZE=l0,l1,...):
    # whole where no reference is given, else the differing entries alone
    python scripts/spoke_levels.py --order 2 --ndofs 3000 6000 \\
        --save-ref tpufem_torch/_build/levels_ref
    python scripts/spoke_levels.py --order 2 --ndofs 3000 6000 \\
        --ref tpufem_torch/_build/levels_ref --expect 3000=17588,329 \\
        --dump chiprun_out/spoke_levels
    # feed a written CSR to the port's aggregation (and, with --tpufem,
    # to tpufem's, JAX on the CPU): the level sizes each gives (a file of
    # differing entries is applied to this host's own CSR of that size)
    python scripts/spoke_levels.py \\
        --load chiprun_out/spoke_levels/p2_6000.npz [--tpufem]

No GPU is needed: the levels come from the host's setup.  Nothing of
JAX or tpufem is imported unless ``--tpufem`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def digest(*arrays) -> str:
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def versions() -> dict:
    import numpy as np
    import scipy
    return {"numpy": np.__version__, "scipy": scipy.__version__}


def port_levels(csr, bc_mask):
    """(route, level sizes, RCM perm or None) of the port's SA-AMG setup
    on a host CSR, as problems.poisson.Solver._setup_saamg takes it, f32."""
    import torch
    from tpufem_torch.cli import parse_args
    from tpufem_torch.fem.window_op import window_gate
    from tpufem_torch.la.amg import SAAMG
    cfg, _ = parse_args(["--device", "cpu"])
    opts = cfg.solver
    gate = window_gate(csr, str(opts.get("amg_fine_window")),
                       int(opts.get("amg_window_budget_mb")), 4)
    cpu = torch.device("cpu")
    if gate is None:
        pc = SAAMG.setup(csr, 1, opts, cpu, dtype=torch.float32,
                         bc_mask=bc_mask)
        return "plain", list(pc.level_sizes), None
    perm, csr_w = gate
    pc = SAAMG.setup(csr_w, 1, opts, cpu, dtype=torch.float32,
                     bc_mask=bc_mask[perm], fine_factored=False,
                     fine_store_a=False, fine_transfer_window=True)
    return "rcm", list(pc.level_sizes), perm


def tpufem_levels(csr, bc_mask):
    """(route, level sizes) of tpufem's own setup on the same CSR, as
    scripts/saamg_reference.py --levels_only runs it (float32)."""
    import jax.numpy as jnp
    from tpufem.config import SolverOptions
    from tpufem.la.amg import SAAMG
    from tpufem.problems import poisson

    class _Mask:
        def mask(self):
            return bc_mask

    solver = SolverOptions()
    wop, csr_w, mask_w, _ = poisson._try_window(csr, _Mask(), solver,
                                                jnp.float32)
    if wop is not None:
        pc = SAAMG.setup(csr_w, bs=1, options=solver, dtype=jnp.float32,
                         bc_mask=mask_w, fine_factored=False,
                         fine_store_a=False, fine_transfer_window=True)
        return "rcm", list(pc.level_sizes)
    pc = SAAMG.setup(csr, bs=1, options=solver, dtype=jnp.float32,
                     bc_mask=bc_mask, fine_factored=False)
    return "plain", list(pc.level_sizes)


def size_row(order: int, nd: int):
    """(JSON row, CSR, bc mask) of the spoke Poisson problem at ``nd``."""
    import numpy as np
    from tpufem_torch.fem.assemble import (_poisson_stiffness_np,
                                           assemble_csr_np, metric_np)
    from tpufem_torch.fem.dirichlet import DirichletBC
    from tpufem_torch.fem.reference import ReferenceTet
    from tpufem_torch.fem.space import FunctionSpace
    from tpufem_torch.mesh.spoke import create_spoke_mesh
    from tpufem_torch.problems.common import poisson_bc_marker
    t0 = time.perf_counter()
    mesh = create_spoke_mesh(nd, True, 1, 1, verbose=False)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(poisson_bc_marker))
    coords = mesh.cell_coords()
    csr = assemble_csr_np(space, bc, "poisson")
    mask = bc.mask()
    route, levels, perm = port_levels(csr, mask)
    row = {"order": order, "ndofs_arg": nd, "ndofs": int(space.ndofs),
           "cells": int(coords.shape[0]), "route": route, "levels": levels,
           "digest": {
               "reference_tables": digest(
                   ReferenceTet(order).stiffness_tensors),
               "mesh": digest(mesh.vertices, mesh.cells()),
               "metric": digest(metric_np(coords)),
               "element_matrices": digest(
                   _poisson_stiffness_np(coords[:4096], order)),
               "csr": digest(*csr),
               "rcm_perm": None if perm is None else digest(perm)},
           **versions(), "seconds": time.perf_counter() - t0}
    return row, csr, mask


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--ndofs", type=int, nargs="*", default=[])
    p.add_argument("--expect", nargs="*", default=[], metavar="SIZE=L0,L1",
                   help="level sizes another host gave at SIZE")
    p.add_argument("--dump", metavar="DIR",
                   help="write the CSR of the smallest size whose levels "
                        "differ from --expect")
    p.add_argument("--save-ref", metavar="DIR",
                   help="write each size's CSR values to DIR")
    p.add_argument("--ref", metavar="DIR",
                   help="another host's --save-ref: count the differing "
                        "entries")
    p.add_argument("--load", metavar="NPZ",
                   help="the level sizes of a written CSR")
    p.add_argument("--tpufem", action="store_true",
                   help="with --load: tpufem's setup too (JAX, CPU)")
    a = p.parse_args()
    if a.load:
        import numpy as np
        z = np.load(a.load)
        written = json.loads(str(z["row"]))
        if "indptr" in z:
            csr = (z["indptr"], z["indices"].astype(np.int64), z["data"])
            mask = z["bc_mask"]
        else:  # the differing entries, applied to this host's CSR
            _, csr, mask = size_row(written["order"], written["ndofs_arg"])
            data = csr[2].copy()
            data[z["pos"]] = z["values"]
            csr = (csr[0], csr[1], data)
        out = {"file": a.load, "csr": digest(*csr), **versions(),
               "csr_is_the_writers": digest(*csr) == written["digest"]["csr"],
               "written_by": written}
        route, levels, _ = port_levels(csr, mask)
        out["port"] = {"route": route, "levels": levels}
        if a.tpufem:
            route, levels = tpufem_levels(csr, mask)
            out["tpufem"] = {"route": route, "levels": levels}
        print(json.dumps(out), flush=True)
        return 0
    expect = {}
    for e in a.expect:
        k, v = e.split("=")
        expect[int(k)] = [int(t) for t in v.split(",")]
    dumped = False
    import numpy as np
    for nd in a.ndofs:
        row, csr, mask = size_row(a.order, nd)
        differs = nd in expect and expect[nd] != row["levels"]
        row["differs_from_expected"] = differs if nd in expect else None
        name = f"p{a.order}_{nd}.npz"
        pos = None
        if a.ref and os.path.exists(os.path.join(a.ref, name)):
            ref = np.load(os.path.join(a.ref, name))
            same_pattern = str(ref["pattern"]) == digest(csr[0], csr[1])
            row["same_pattern_as_ref"] = same_pattern
            if same_pattern:
                pos = np.flatnonzero(csr[2] != ref["data"])
                rel = (np.abs(csr[2][pos] - ref["data"][pos])
                       / np.abs(ref["data"][pos]).clip(1e-300))
                row["entries_differing_from_ref"] = int(pos.size)
                row["largest_rel_difference"] = float(rel.max(initial=0.0))
        print(json.dumps(row), flush=True)
        if a.save_ref:
            os.makedirs(a.save_ref, exist_ok=True)
            np.savez(os.path.join(a.save_ref, name), data=csr[2],
                     pattern=digest(csr[0], csr[1]))
        if a.dump and differs and not dumped:
            os.makedirs(a.dump, exist_ok=True)
            path = os.path.join(a.dump, name)
            if pos is not None:
                np.savez_compressed(path, pos=pos, values=csr[2][pos],
                                    row=json.dumps(row))
            elif csr[2].size > 5_000_000:
                print(f"{name}: {csr[2].size} entries and no reference of "
                      "this size: not written (give --ref)", flush=True)
                continue
            else:
                np.savez_compressed(path, indptr=csr[0],
                                    indices=csr[1].astype(np.int32),
                                    data=csr[2], bc_mask=mask,
                                    row=json.dumps(row))
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)",
                  flush=True)
            dumped = True
    return 0


if __name__ == "__main__":
    sys.exit(main())
