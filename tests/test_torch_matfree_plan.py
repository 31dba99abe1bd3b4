"""The matrix-free kernel's cluster plan (fem.assemble.cluster_plan) and
its walk (fem.matfree_op.matfree_action_walk) on the CPU: the port alone
(no tpufem, no native library), the spoke mesh at 3,000 dofs (9,254
cells, weak scaling) at P1-P3 and single cells."""

import functools

import numpy as np
import pytest
import torch

from tpufem_torch.fem.assemble import SMEM_BYTES, cluster_plan, metric_np
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.matfree_op import (METRIC6, TABLE_PAIRS,
                                         TABLE_ZERO, TABLES_HEADER,
                                         MatFreePoissonOp,
                                         kernel_multiply_adds, kernel_tables,
                                         matfree_action_bound,
                                         matfree_action_walk,
                                         matfree_apply_plain, matfree_launches,
                                         tables_header)
from tpufem_torch.fem.reference import ReferenceTet
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.spoke import create_spoke_mesh
from tpufem_torch.problems.common import poisson_bc_marker

torch.set_num_threads(1)
CPU = torch.device("cpu")
ORDERS = [1, 2, 3]


@functools.lru_cache(maxsize=None)
def _space(order):
    """(cell dofs, ndofs, Dirichlet dofs, mesh) of the 3k spoke mesh at
    ``order``."""
    mesh = create_spoke_mesh(3000, False, 1, 1, verbose=False)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(poisson_bc_marker))
    return space.cell_dofs, space.ndofs_scalar, bc.flat_dofs(), mesh


@functools.lru_cache(maxsize=None)
def _plan(order):
    cd, N, bc, _ = _space(order)
    return cluster_plan(cd, N, bc)


def _locals(p, k):
    """(first local, free end, Dirichlet end, count) of cluster k."""
    return [int(v) for v in p.clusters[k]]


def _slot_local(p):
    """([C, n] the local of each slot of the cells in cluster order, [C]
    their clusters)."""
    K, n, B = p.ld.shape
    C = p.order.size
    cl = np.arange(C) // B
    return p.ld[cl, :, np.arange(C) - cl * B].astype(np.int64), cl


@pytest.mark.parametrize("order", ORDERS)
def test_plan_covers_every_slot_once(order):
    """Every slot (c, i) of every cell is summed exactly once, by the
    local whose dof it holds, and each local's dof is the slot's."""
    cd, N, _, _ = _space(order)
    p = _plan(order)
    K, n, B = p.ld.shape
    C = cd.shape[0]
    assert np.array_equal(np.sort(p.order), np.arange(C))
    loc, cl = _slot_local(p)
    cdo = cd[p.order]
    assert np.array_equal(p.gid[p.clusters[cl, 0][:, None] + loc], cdo)
    seen = np.zeros((C, n), dtype=np.int64)
    for k in range(K):
        first, _, _, nloc = _locals(p, k)
        ends = p.sum_end[first:first + nloc].astype(np.int64)
        starts = np.concatenate([[0], ends[:-1]])
        ncell = min(B, C - k * B)
        assert ends[-1] == ncell * n
        for l in range(nloc):
            idx = p.sum_idx[k, starts[l]:ends[l]].astype(np.int64)
            c, i = idx % B, idx // B
            assert np.all(np.diff(c * n + i) > 0)   # ascending (c, i)
            assert np.all(cdo[k * B + c, i] == p.gid[first + l])
            seen[k * B + c, i] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("order", ORDERS)
def test_locals_partition_the_dofs(order):
    """A dof in cells is free in one cluster, or halo in two or more, or
    Dirichlet; the halo list holds each halo dof once with one partial a
    cluster, then the dofs in no cell with none."""
    cd, N, bc, _ = _space(order)
    p = _plan(order)
    K = p.clusters.shape[0]
    where = {}
    kind = {}
    for k in range(K):
        first, free, zero, nloc = _locals(p, k)
        for l in range(nloc):
            d = int(p.gid[first + l])
            where.setdefault(d, []).append(first + l)
            kind.setdefault(d, set()).add(
                "free" if l < free else "bc" if l < zero else "halo")
    in_cells = np.unique(cd)
    assert sorted(where) == in_cells.tolist()
    bcs = set(np.asarray(bc).tolist())
    has = np.diff(p.halo_off) > 0
    nh = int(has.sum())
    assert has[:nh].all() and not has[nh:].any()
    for d, locs in where.items():
        assert len(kind[d]) == 1
        (kd,) = kind[d]
        if d in bcs:
            assert kd == "bc"
        elif len(locs) == 1:
            assert kd == "free"
        else:
            assert kd == "halo"
    halo = sorted(d for d, k in kind.items() if k == {"halo"})
    assert p.halo_dof[:nh].tolist() == halo
    for h, d in enumerate(halo):
        src = p.halo_src[p.halo_off[h]:p.halo_off[h + 1]]
        assert src.tolist() == where[d]
    unused = np.setdiff1d(np.arange(N), in_cells)
    assert p.halo_dof[len(halo):].tolist() == unused.tolist()
    assert np.all(np.diff(p.halo_off)[len(halo):] == 0)
    assert p.halo_share == p.halo_src.size / cd.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("order", ORDERS)
def test_walk_follows_the_stored_order(order, dtype):
    """The walk's y is, to the bit, the locals summed from 0 in the
    plan's stored order and the halo partials in cluster order, over the
    cell values of the tables' form, recomputed here from the tables."""
    cd, N, bc, mesh = _space(order)
    op = MatFreePoissonOp.from_arrays(metric_np(mesh.cell_coords()), cd, bc,
                                      N, order, dtype, CPU)
    p = op.cplan
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = np.random.default_rng(order).standard_normal(N).astype(npdt)
    got = matfree_action_walk(op, x)
    S = kernel_tables(order).astype(npdt)
    G = op.G.numpy().reshape(-1, 9)[p.order][:, list(METRIC6)]
    u = x[cd[p.order]]
    K, n, B = p.ld.shape
    C = cd.shape[0]
    y = np.zeros((C, n), dtype=npdt)
    for i in range(n):
        for j in range(i, n):
            a = G[:, 0] * S[0, i, j]
            for s in range(1, 6):
                a = a + G[:, s] * S[s, i, j]
            y[:, i] = y[:, i] + a * u[:, j]
            if j != i:
                y[:, j] = y[:, j] + a * u[:, i]
    want = np.zeros(N, dtype=npdt)
    partial = np.zeros(p.gid.size, dtype=npdt)
    for k in range(K):
        first, free, zero, nloc = _locals(p, k)
        prev = 0
        for l in range(nloc):
            end = int(p.sum_end[first + l])
            s = npdt(0)
            for v in p.sum_idx[k, prev:end].astype(np.int64):
                s = npdt(s + y[k * B + v % B, v // B])
            prev = end
            if l < free:
                want[p.gid[first + l]] = s
            elif l >= zero:
                partial[first + l] = s
    for h, d in enumerate(p.halo_dof):
        s = npdt(0)
        for src in p.halo_src[p.halo_off[h]:p.halo_off[h + 1]]:
            s = npdt(s + partial[src])
        want[d] = s
    assert np.array_equal(got, want)


def _single_cell(order, dtype, ndofs_extra=0, bc=(), copies=1, cells=None):
    """``copies`` copies of one tetrahedron at ``order`` on dofs 0..n-1 of
    a space of n + ``ndofs_extra`` dofs (the extra dofs are in no cell);
    the cluster plan rebuilt with ``cells`` a cluster where given."""
    n = ReferenceTet(order).ndofs
    coords = np.array([[[0.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.2, 0.9, 0.1],
                        [0.1, 0.2, 1.1]]] * copies)
    cd = np.tile(np.arange(n), (copies, 1))
    bcs = np.asarray(bc, dtype=np.int64)
    op = MatFreePoissonOp.from_arrays(metric_np(coords), cd, bcs,
                                      n + ndofs_extra, order, dtype, CPU)
    if cells is not None:
        op.cplan = cluster_plan(cd, n + ndofs_extra, bcs, cells=cells)
    return op


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", ["single_cell", "all_halo"])
def test_walk_matches_plain_on_edge_cases(case, order, dtype):
    """A single cell with three dofs in no cell (their rows 0) and a
    Dirichlet row (0); and three copies of a cell in clusters of one
    cell, so that every free dof is halo: the walk lies within
    matfree_action_bound of the plain version, with the zero rows
    exact."""
    if case == "single_cell":
        op = _single_cell(order, dtype, ndofs_extra=3, bc=(1,))
    else:
        op = _single_cell(order, dtype, bc=(0,), copies=3, cells=1)
        p = op.cplan
        assert p.clusters.shape[0] == 3
        assert all(int(c[1]) == 0 for c in p.clusters)   # no free local
        assert p.halo_dof.size == op.n - 1
        assert p.halo_src.size == 3 * (op.n - 1)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = np.random.default_rng(11).standard_normal(op.ndofs).astype(npdt)
    y = matfree_apply_plain(op, torch.from_numpy(x)).numpy()
    w = matfree_action_walk(op, x)
    bound = matfree_action_bound(op, torch.from_numpy(x)).numpy()
    assert np.all(np.abs(w - y) <= bound)
    zero = [0] if case == "all_halo" else [1, op.ndofs - 3, op.ndofs - 2,
                                           op.ndofs - 1]
    assert np.all(w[zero] == 0) and np.all(y[zero] == 0)
    assert matfree_launches(op) == 2


def test_plan_refuses_clusters_over_the_card_limits():
    """A cluster whose block would need more than the card's shared
    memory in float64 is refused by name, as are clusters whose cell
    values a 16-bit index cannot reach; the locals and the summing order
    are padded to 8 for 16-byte copies."""
    cd = np.arange(600 * 20).reshape(600, 20)
    with pytest.raises(ValueError, match=r"cluster 0 of 600 cells has "
                       r"12000 dofs: its block needs 288000 bytes"):
        cluster_plan(cd, cd.size, cells=600)
    fits = cluster_plan(cd[:484], 484 * 20, cells=484)
    assert fits.smem_bytes(8) <= SMEM_BYTES < fits.smem_bytes(8) + 480
    odd = cluster_plan(np.arange(12).reshape(3, 4), 12, cells=1)
    assert odd.max_locals == 8 and odd.sum_idx.shape == (3, 8)
    assert np.all(odd.clusters[:, 0] % 8 == 0)
    with pytest.raises(ValueError, match="16 bits"):
        cluster_plan(cd, cd.size, cells=3300)


@pytest.mark.parametrize("order", ORDERS)
def test_cell_order_keeps_clusters_compact(order):
    """The locality order gives the 3k spoke's clusters fewer (cluster,
    dof) pairs, so fewer partial sums, than clusters cut from the cells
    as built."""
    cd, N, _, _ = _space(order)
    p = _plan(order)
    cl = np.arange(cd.shape[0])[:, None] // p.cells

    def pairs(cells):
        return np.unique(cl * N + cells).size

    assert pairs(cd[p.order]) == p.clusters[:, 3].sum()
    assert pairs(cd[p.order]) < 0.8 * pairs(cd)


def test_kernel_header_holds_the_tables():
    """csrc/matfree_tables.cuh is what tables_header() writes: every
    order's kernel_tables, upper triangles, as exact float64 literals
    (regenerate with matfree_op.write_tables_header())."""
    assert TABLES_HEADER.read_text() == tables_header()
    text = tables_header()
    for order in ORDERS:
        S = kernel_tables(order)
        n = S.shape[1]
        body = text.split(f"kMatfreeTables{n}[6][{n}][{n}] = {{")[1]
        body = body.split("};")[0]
        vals = [float.fromhex(v) if v.strip() != "0" else 0.0
                for v in body.replace("{", " ").replace("}", " ").split(",")
                if v.strip()]
        got = np.array(vals).reshape(6, n, n)
        upper = np.triu(np.ones((n, n), dtype=bool))
        assert np.array_equal(got[:, upper], S[:, upper])
        assert np.all(got[:, ~upper] == 0)


def test_cpu_operator_builds_its_plan_when_read():
    """A CPU operator builds no cluster plan for its plain version; the
    first read builds it from the operator's cell and Dirichlet dofs
    (the plan a CUDA operator builds with itself) and keeps it."""
    cd, N, bc, mesh = _space(2)
    op = MatFreePoissonOp.from_arrays(metric_np(mesh.cell_coords()), cd, bc,
                                      N, 2, torch.float64, CPU)
    matfree_apply_plain(op, torch.ones(N, dtype=torch.float64))
    assert op._cplan is None
    p = op.cplan
    assert op.cplan is p
    want = _plan(2)
    for name in ("order", "clusters", "gid", "ld", "sum_idx", "sum_end",
                 "halo_dof", "halo_off", "halo_src"):
        assert np.array_equal(getattr(p, name), getattr(want, name)), name


@pytest.mark.parametrize("order", ORDERS)
def test_table_zeros_are_quadrature_rounding(order):
    """The kernel's tables set to 0 exactly the entries that quadrature
    leaves at rounding level (under TABLE_ZERO of the largest, with the
    others at least 1e-4 of it: no entry near the cut) and keep the
    others to the bit; the multiply-adds a cell count what is left."""
    K = ReferenceTet(order).stiffness_tensors
    raw = np.stack([K[a, a] if a == b else K[a, b] + K[b, a]
                    for a, b in TABLE_PAIRS])
    n = raw.shape[1]
    upper = np.triu(np.ones((n, n), dtype=bool))
    S, R = kernel_tables(order)[:, upper], raw[:, upper]
    big = np.abs(R).max()
    zero = S == 0
    assert np.all(np.abs(R[zero]) < TABLE_ZERO * big)
    assert np.array_equal(S[~zero], R[~zero])
    assert np.all(np.abs(R[~zero]) >= 1e-4 * big)
    assert kernel_multiply_adds(order) == {1: 37, 2: 277, 3: 1417}[order]
