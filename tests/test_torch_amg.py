"""The port's SA-AMG (tpufem_torch.la.amg) and its two kernels' plain
versions (fem.csr_spmv, fem.dense_gemv) against tpufem.la.amg on the
CPU: the host setup bit for bit on both aggregation routes, the whole
hierarchy, the CSR and dense products against scipy and tpufem's
``ELLMatrix`` / ``DenseMat``, and the V-cycle on tpufem's own hierarchy
(carried over by convert.saamg_from_numpy), factored and assembled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem import native as tpu_native
from tpufem.config import SolverOptions as TpuSolverOptions
from tpufem.fem.assemble import csr_to_ell as tpu_csr_to_ell
from tpufem.la import amg as tpu_amg

from tpufem_torch import convert, native
from tpufem_torch.config import SolverOptions
from tpufem_torch.fem.csr_spmv import (CsrMatrix, csr_plan, csr_spmv,
                                       csr_spmv_bound, csr_spmv_plain)
from tpufem_torch.fem.dense_gemv import (DenseMat, dense_gemv_bf16,
                                         dense_gemv_bound, dense_gemv_walk,
                                         dense_pieces, dense_smem_bytes)
from tpufem_torch.fem.dia_op import build_operator
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.la import amg
from tpufem_torch.la.nullspace import build_near_nullspace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _cube(dims, problem="poisson"):
    """(interleaved f64 CSR, scalar BC mask, near-nullspace or None) of a
    small lattice's BC-eliminated P1 operator."""
    mesh = BoxTetMesh(*dims)
    bs = 3 if problem == "elasticity" else 1
    marker = (common.elasticity_bc_marker if bs == 3
              else common.poisson_bc_marker)
    space = FunctionSpace(mesh, 1, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    A = build_operator(mesh, 1, problem, bc_dofs=bc.flat_dofs(), dtype=F64)
    nns = (build_near_nullspace(space.scalar_dof_coords()) if bs == 3
           else None)
    return A.to_scipy(), bc.mask(), nns


def _spoke_csr():
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.mesh.spoke import create_spoke_mesh
    mesh = create_spoke_mesh(3000, True, 1, 1, verbose=False)
    space = FunctionSpace(mesh, 1)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(
        common.poisson_bc_marker))
    indptr, indices, data = assemble_csr_np(space, bc, "poisson")
    return sp.csr_matrix((data, indices, indptr)), bc.mask()


def _spoke_elasticity_bsr():
    """(block CSR of the spoke mesh's elasticity operator as a scipy BSR
    matrix, its interleaved mask, near-nullspace): no Dirichlet dof, the
    rigid-body modes as the near-nullspace."""
    from tpufem_torch.fem.assemble import assemble_csr_np
    from tpufem_torch.mesh.spoke import create_spoke_mesh
    mesh = create_spoke_mesh(3000, True, 3, 1, verbose=False)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(
        common.elasticity_bc_marker))
    indptr, indices, data = assemble_csr_np(space, bc, "elasticity")
    n = 3 * (indptr.shape[0] - 1)
    return (sp.bsr_matrix((data, indices, indptr), shape=(n, n)), bc.mask(),
            build_near_nullspace(space.scalar_dof_coords()))


def _opts(cls, **kw):
    o = cls()
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _no_native(monkeypatch):
    """Both packages on their numpy fallbacks."""
    monkeypatch.setattr(tpu_native, "_get", lambda: None)
    monkeypatch.setattr(native, "_get", lambda: None)


def _same_native(monkeypatch):
    """tpufem's loader on the port's library of the same pinned source
    (tests/test_torch_vendored.py), so both packages take one aggregation
    route whichever process built tpufem's own library first: native
    where g++ builds it, numpy on both where it does not."""
    monkeypatch.setattr(tpu_native, "_get", native._get)


@pytest.fixture
def same_native(monkeypatch):
    _same_native(monkeypatch)


# -- host copies, bit for bit -------------------------------------------------
@pytest.mark.parametrize("theta", [0.0, 0.08])
@pytest.mark.parametrize("problem", ["poisson", "elasticity"])
def test_strength_graph_bitwise(problem, theta):
    A, _, _ = _cube((4, 5, 6), problem)
    bs = 3 if problem == "elasticity" else 1
    mine, ref = (amg.node_strength_graph(A, bs, theta),
                 tpu_amg.node_strength_graph(A, bs, theta))
    for k in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(mine, k), getattr(ref, k)), k


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_aggregation_and_matching_bitwise(route, monkeypatch):
    """Both routes against tpufem's on the same route.  The native pass
    is compared with tpufem's where tpufem's library loads, and with its
    pinned output (321 aggregates, a digest) too."""
    _same_native(monkeypatch)
    if route == "numpy":
        _no_native(monkeypatch)
    A, _, _ = _cube((9, 10, 11))
    S = amg.node_strength_graph(A, 1, 0.0)
    agg, nagg = amg.aggregate_nodes(S, seed=0)
    if route == "native":
        assert native.have_native()
        assert (nagg, int((agg * np.arange(agg.size)).sum() % 1000003)) \
            == (321, 228336)
    ragg, rnagg = tpu_amg.aggregate_nodes(S, seed=0)
    assert nagg == rnagg and np.array_equal(agg, ragg)
    Agg = sp.csr_matrix((np.ones(S.shape[0]), (np.arange(S.shape[0]), agg)),
                        shape=(S.shape[0], nagg))
    S2 = (Agg.T @ S @ Agg).tocsr()
    S2.setdiag(0.0)
    S2.eliminate_zeros()
    assert np.array_equal(amg.match_pairs(S2), tpu_amg.match_pairs(S2))


@pytest.mark.parametrize("problem", ["poisson", "elasticity"])
def test_prolongators_bitwise(problem, same_native):
    A, mask, nns = _cube((4, 5, 6), problem)
    bs = 3 if problem == "elasticity" else 1
    B = np.ones((A.shape[0], 1)) if nns is None else nns.T.copy()
    B = B * (~np.repeat(mask, bs))[:, None]
    S = amg.node_strength_graph(A, bs, 0.0)
    agg, nagg = tpu_amg.aggregate_nodes(S, seed=0)
    P0, Bc = amg.tentative_prolongator(agg, nagg, B, bs)
    rP0, rBc = tpu_amg.tentative_prolongator(agg, nagg, B, bs)
    assert (P0 != rP0).nnz == 0 and np.array_equal(Bc, rBc)
    for k in (0, 4, 2):
        P = amg.smooth_prolongator(A, P0, 1.3333, 7.5, filter_k=k)
        rP = tpu_amg.smooth_prolongator(A, rP0, 1.3333, 7.5, filter_k=k)
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(P, f), getattr(rP, f)), (k, f)
    m = B.shape[1]
    for got, want in zip(amg._csr_rows_padded(P0, m),
                         tpu_amg._csr_rows_padded(rP0, m)):
        assert np.array_equal(got, want)


def _tpu_level_dicts(pc, dense_dtype):
    def ell(E):
        if E is None:
            return None
        ov = ((np.asarray(E.ov_rows), np.asarray(E.ov_cols),
               np.asarray(E.ov_vals)) if E.ov_rows is not None else ())
        if hasattr(E, "blk_idx"):  # a WindowedMatrix: its windows as ELL
            nb, R, WC = E.vals.shape
            C = E.C
            w = np.arange(WC)
            cols = (np.asarray(E.blk_idx)[:, w // C] * C + w % C)
            cols = np.repeat(cols[:, None, :], R, axis=1).reshape(nb * R, WC)
            vals = np.asarray(E.vals).reshape(nb * R, WC)
            return (cols[:E.n], vals[:E.n]) + ov
        return (np.asarray(E.cols), np.asarray(E.vals)) + ov

    out = []
    for lv in pc.levels:
        d = {"dinv": np.asarray(lv.dinv), "lmax": lv.lmax}
        if isinstance(lv.A, tpu_amg.DenseMat):
            d["A"] = ("dense", np.asarray(lv.A.M).astype(dense_dtype))
        else:
            d["A"] = ell(lv.A)
        if lv.fw is not None:
            d.update(fw=np.asarray(lv.fw), fcols=np.asarray(lv.fcols),
                     omega_dinv=np.asarray(lv.omega_dinv))
        else:
            d.update(P=ell(lv.P), PT=ell(lv.PT))
        out.append(d)
    return out


def _dense(op, n):
    if op is None:
        return None
    if isinstance(op, DenseMat):
        return op.M[:, :n].double().numpy()
    return op.to_scipy().toarray()


SETUPS = {
    # (matrix, bs, options, setup flags)
    "cube_factored": ("cube", 1, dict(amg_coarse_eq_limit=50),
                      dict(fine_factored=True)),
    "elasticity_factored": ("elasticity", 3, dict(amg_coarse_eq_limit=100),
                            dict(fine_factored=True)),
    "spoke_plain": ("spoke", 1, dict(amg_coarse_eq_limit=60), {}),
    "spoke_window": ("spoke", 1, dict(amg_coarse_eq_limit=60),
                     dict(fine_store_a=False, fine_transfer_window=True)),
    "spoke_sparse_levels": ("spoke", 1, dict(amg_coarse_eq_limit=30,
                                             amg_dense_level_limit=100), {}),
    # the spoke mesh's elasticity: block CSR in, the plain route
    "spoke_elasticity_plain": ("spoke_elasticity", 3,
                               dict(amg_coarse_eq_limit=100), {}),
}


def _setup_inputs(name):
    kind, bs, opts, flags = SETUPS[name]
    if kind == "spoke":
        A, mask = _spoke_csr()
        nns = None
    elif kind == "spoke_elasticity":
        A, mask, nns = _spoke_elasticity_bsr()
    else:
        A, mask, nns = _cube((7, 8, 6), "elasticity" if bs == 3 else "poisson")
    return A, bs, mask, nns, opts, flags


def _assert_setup_matches(name):
    """The whole host hierarchy (float64) of ``SETUPS[name]`` in both
    packages: level sizes, lmax, dinv, the transfers, the level operators
    (dense and CSR) and the coarse pseudo-inverse, bit for bit."""
    A, bs, mask, nns, opts, flags = _setup_inputs(name)
    csr = (A.indptr, A.indices, A.data)
    ref = tpu_amg.SAAMG.setup(csr, bs, _opts(TpuSolverOptions, **opts),
                              dtype=jnp.float64, near_nullspace=nns,
                              bc_mask=mask, **flags)
    mine = amg.SAAMG.setup(csr, bs, _opts(SolverOptions, **opts), CPU,
                           dtype=F64, near_nullspace=nns, bc_mask=mask,
                           **flags)
    assert mine.level_sizes == ref.level_sizes and len(mine.levels) >= 1
    carried = convert.saamg_from_numpy(
        _tpu_level_dicts(ref, np.float64), np.asarray(ref.coarse_inv),
        ref.smoother_degree, ref.level_sizes, CPU)
    sizes = mine.level_sizes
    for i, (lv, rl) in enumerate(zip(mine.levels, carried.levels)):
        assert lv.lmax == rl.lmax
        assert torch.equal(lv.dinv, rl.dinv)
        assert np.array_equal(_dense(lv.A, sizes[i]), _dense(rl.A, sizes[i])) \
            if rl.A is not None else lv.A is None
        pairs = ((lv.P0, rl.P0), (lv.P0T, rl.P0T)) if lv.factored else \
            ((lv.P, rl.P), (lv.PT, rl.PT))
        for got, want in pairs:
            assert np.array_equal(got.to_scipy().toarray(),
                                  want.to_scipy().toarray())
        if lv.factored:
            assert torch.equal(lv.omega_dinv, rl.omega_dinv)
    assert torch.equal(mine.coarse_inv, carried.coarse_inv)
    assert set(mine.last_phase_s) >= {"eig", "strength", "aggregate",
                                      "tentative", "smoothP", "galerkin",
                                      "device", "total"}


@pytest.mark.parametrize("name", list(SETUPS))
def test_setup_matches_tpufem(name, same_native):
    """The whole host hierarchy, bit for bit (``_assert_setup_matches``),
    both packages on one aggregation route."""
    _assert_setup_matches(name)


def test_setup_matches_tpufem_when_tpufem_lost_its_native_build(monkeypatch):
    """tpufem's own library lost the build race of parallel test workers
    (its loader then returns None for the rest of the process, and it
    aggregates by its numpy fallback, which is equivalent to the native
    pass but not bit-identical): with its loader on the port's library,
    the spoke hierarchy is still the port's, bit for bit."""
    monkeypatch.setattr(tpu_native, "_get", lambda: None)
    _same_native(monkeypatch)
    assert tpu_native.have_native() == native.have_native()
    _assert_setup_matches("spoke_plain")


def test_planar_fine_level_is_the_interleaved_one_permuted():
    """Elasticity: the planar setup's fine rows are the interleaved
    setup's, permuted; everything below is the same."""
    A, mask, nns = _cube((4, 5, 6), "elasticity")
    csr = (A.indptr, A.indices, A.data)
    opts = _opts(SolverOptions, amg_coarse_eq_limit=100)
    kw = dict(near_nullspace=nns, bc_mask=mask, fine_factored=True)
    inter = amg.SAAMG.setup(csr, 3, opts, CPU, dtype=F64, **kw)
    planar = amg.SAAMG.setup(csr, 3, opts, CPU, dtype=F64, planar=True, **kw)
    perm = amg.interleaved_to_planar(A.shape[0])
    a, b = inter.levels[0], planar.levels[0]
    assert torch.equal(a.dinv[perm], b.dinv)
    assert torch.equal(a.omega_dinv[perm], b.omega_dinv)
    assert np.array_equal(a.P0.to_scipy().toarray()[perm],
                          b.P0.to_scipy().toarray())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.shape[0]))
    Ap = sp.csr_matrix(A[perm][:, perm])
    ya = inter.vcycle(x, fine_matvec=lambda v: torch.from_numpy(A @ v.numpy()))
    yb = planar.vcycle(x[perm],
                       fine_matvec=lambda v: torch.from_numpy(Ap @ v.numpy()))
    assert torch.allclose(ya[perm], yb, rtol=0, atol=1e-12 * ya.abs().max())


# -- the two kernels' plain versions -------------------------------------------
def _random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    M = sp.random(n, m, density=density, random_state=seed, format="csr")
    M.data = rng.standard_normal(M.nnz)
    return M


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("shape", [(700, 700, 0.02), (900, 60, 0.05),
                                   (40, 2000, 0.3)], ids=["square", "P", "PT"])
def test_csr_plain_matches_scipy_and_tpufem_ell(shape, dtype):
    """The plain version against scipy in float64 (the stated bound) and
    against tpufem's ELLMatrix.matvec in the working type (its capped-K
    ELL with the spill tail on the square case; bf16: tpufem's cast of
    the same values, f32 x rounded alike)."""
    n, m, dens = shape
    M = _random_csr(n, m, dens, 3)
    dt = getattr(torch, dtype)
    A = CsrMatrix.from_scipy(M, dt, CPU)
    P = csr_plan(M.indptr)
    assert torch.equal(A.tile_row, torch.from_numpy(P.tile_row))
    assert A.ncols == m
    assert torch.equal(A.starts, torch.from_numpy(P.starts))
    rng = np.random.default_rng(4)
    xo = torch.from_numpy(rng.standard_normal(m)).to(A.out_dtype)
    y = csr_spmv(A, xo)
    assert y.dtype == A.out_dtype and y.shape == (n,)
    xs = xo.to(torch.bfloat16).double() if dtype == "bfloat16" else xo.double()
    Ms = sp.csr_matrix((A.vals.double().numpy(), M.indices, M.indptr),
                       shape=M.shape)
    bound = csr_spmv_bound(A, xo).double().numpy()
    assert np.all(np.abs(y.double().numpy() - Ms @ xs.numpy()) <= bound)
    if dtype != "bfloat16":
        E = tpu_csr_to_ell(M.indptr, M.indices, M.data,
                           dtype=np.dtype(dtype),
                           k_cap="auto" if n == m else None)
        want = np.asarray(E.matvec(jnp.asarray(xo.numpy())))
        assert np.all(np.abs(y.numpy() - want) <= 2 * bound)


def test_csr_wrapper_refuses_what_the_kernel_does_not_take():
    A = CsrMatrix.from_scipy(_random_csr(30, 20, 0.2, 1), torch.float32, CPU)
    with pytest.raises(TypeError):
        csr_spmv(A, torch.zeros(20, dtype=torch.float64))
    with pytest.raises(ValueError):
        csr_spmv(A, torch.zeros(30))
    B = A.astype(torch.bfloat16)
    assert B.vals.dtype == torch.bfloat16 and B.indices is A.indices
    assert torch.equal(csr_spmv_plain(B, torch.ones(20)),
                       csr_spmv_plain(B, torch.ones(20)))


@pytest.mark.parametrize("n", [5, 130, 1001])
def test_dense_bf16_plain_matches_tpufem_densemat(n):
    """The bf16 level's plain product against tpufem's f32-solve
    DenseMat.matvec (bf16 M, bf16 x, f32 sums and y) within the stated
    bound, and the densified level against the CSR's values rounded
    f64 -> f32 -> bf16."""
    rng = np.random.default_rng(n)
    Md = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    S = sp.csr_matrix(Md)
    D = DenseMat.from_csr(S.indptr, S.indices, S.data, n, torch.bfloat16, CPU)
    assert D.M.shape == (n, -(-n // 8) * 8) and D.M.dtype == torch.bfloat16
    assert torch.equal(D.M[:, :n], torch.from_numpy(
        Md.astype(np.float32)).to(torch.bfloat16))
    assert not D.M[:, n:].any()
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = dense_gemv_bf16(D, x)
    assert y.dtype == torch.float32
    ref = tpu_amg.DenseMat(jnp.asarray(Md.astype(np.float32)).astype(
        jnp.bfloat16))
    want = np.asarray(ref.matvec(jnp.asarray(x.numpy())))
    assert np.all(np.abs(y.numpy() - want) <= 2 * dense_gemv_bound(D, x).numpy())
    D64 = DenseMat.from_csr(S.indptr, S.indices, S.data, n, F64, CPU)
    assert np.array_equal(D64.M.numpy(), Md)


# the persistent grid on an H100: 132 SMs x 2 blocks of 8 warps
_H100_WARPS = 132 * 2 * 8


@pytest.mark.parametrize("n", [1, 7, 8, 9512, 18840, 28377])
def test_dense_plan_covers_every_row_and_column_once(n):
    """The dense kernel's plan: equal runs of 16-byte chunks (within one)
    per warp, every column chunk of every row in exactly one piece, a
    whole row to y or a tail followed by the heads of the warps after
    it; bf16(x) within the 227 KB of shared memory up to the densify
    guard's cap (28,377 rows: 56,768 bytes)."""
    cpr = -(-n // 8)
    pieces = dense_pieces(n, _H100_WARPS)
    runs = [sum(b - a for _, a, b, _ in p) for p in pieces]
    assert sum(runs) == n * cpr and max(runs) - min(runs) <= 1
    seen = {}
    for w, p in enumerate(pieces):
        for r, a, b, where in p:
            seen.setdefault(r, []).append((w, a, b, where))
    assert sorted(seen) == list(range(n))
    for r, ps in seen.items():
        assert [a for _, a, _, _ in ps] == [0] + [b for _, _, b, _ in ps[:-1]]
        assert ps[-1][2] == cpr
        kinds = [where for _, _, _, where in ps]
        assert kinds in (["y"], ["tail"] + ["head"] * (len(ps) - 1))
    assert dense_smem_bytes(n) <= 232448
    assert dense_smem_bytes(28377) == 56768


@pytest.mark.parametrize("n,warps", [(7, 5), (333, 64), (1001, _H100_WARPS)])
def test_dense_plan_walk_gives_the_plain_product(n, warps):
    """The plan walked in plain PyTorch (whole rows, and rows split over
    several warps summed in warp order) gives the plain product within
    dense_gemv_bound."""
    rng = np.random.default_rng(n)
    S = sp.csr_matrix(rng.standard_normal((n, n)) * (rng.random((n, n)) < .3))
    D = DenseMat.from_csr(S.indptr, S.indices, S.data, n, torch.bfloat16, CPU)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    err = (dense_gemv_walk(D, x, warps) - dense_gemv_bf16(D, x)).abs()
    assert bool((err <= dense_gemv_bound(D, x)).all())


# -- the V-cycle on tpufem's hierarchy ------------------------------------------
@pytest.mark.parametrize("name", ["cube_factored", "spoke_plain",
                                  "spoke_window", "spoke_sparse_levels"])
def test_vcycle_matches_tpufem(name, same_native):
    """tpufem's float64 hierarchy carried across: the port's V-cycle
    equals tpufem's to 1e-12, factored (the fine action passed in) and
    assembled (the fine level's own CSR, or the action passed in)."""
    A, bs, mask, nns, opts, flags = _setup_inputs(name)
    csr = (A.indptr, A.indices, A.data)
    ref = tpu_amg.SAAMG.setup(csr, bs, _opts(TpuSolverOptions, **opts),
                              dtype=jnp.float64, near_nullspace=nns,
                              bc_mask=mask, **flags)
    pc = convert.saamg_from_numpy(
        _tpu_level_dicts(ref, np.float64), np.asarray(ref.coarse_inv),
        ref.smoother_degree, ref.level_sizes, CPU)
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    own = name in ("spoke_plain", "spoke_sparse_levels")
    Aj = jnp.asarray(A.toarray())
    want = np.asarray(jax.jit(lambda v: ref.vcycle(
        v, fine_matvec=None if own else (lambda u: Aj @ u)))(jnp.asarray(r)))
    At = torch.from_numpy(A.toarray())
    got = pc.vcycle(torch.from_numpy(r),
                    fine_matvec=None if own else (lambda u: At @ u)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
