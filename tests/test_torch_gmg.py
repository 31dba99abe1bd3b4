"""The port's multigrid pieces (tpufem_torch.la) against tpufem.la.gmg
and tpufem.la.chebyshev, in float64 on the CPU: h-transfers, Chebyshev
smoothers, the surrogate lmax, the coarse inverse and one V-cycle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.la import chebyshev as tpu_cheb
from tpufem.la import gmg as tpu_gmg
from tpufem.mesh import BoxTetMesh
from tpufem.problems import common as tpu_common

from tpufem_torch import convert
from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.la import chebyshev, gmg
from tpufem_torch.mesh.structured import BoxTetMesh as PortMesh
from tpufem_torch.problems import common

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
MESH16 = BoxTetMesh(16, 16, 16)


@pytest.fixture(scope="module")
def gmg16():
    """tpufem's and the port's float64 GMG on the 16^3 lattice (one
    smoothed level + the 8^3 dense coarse solve)."""
    ref = tpu_gmg.GMG.setup(MESH16, 1, "poisson",
                            tpu_common.poisson_bc_marker, dtype=jnp.float64)
    port = gmg.GMG.setup(MESH16, 1, "poisson", common.poisson_bc_marker,
                         CPU, dtype=torch.float64)
    return ref, port


@pytest.mark.parametrize("cd", [(3, 2, 4), (4, 5, 6)])
def test_h_transfers_match_tpufem_and_are_adjoint(cd):
    fd = tuple(2 * v for v in cd)
    rng = np.random.default_rng(0)
    c = rng.standard_normal((cd[2] + 1, cd[1] + 1, cd[0] + 1))
    f = rng.standard_normal((fd[2] + 1, fd[1] + 1, fd[0] + 1))
    Pc = gmg.prolong_h(torch.from_numpy(c)).numpy()
    Rf = gmg.restrict_h(torch.from_numpy(f)).numpy()
    Pc_ref = np.asarray(jax.jit(tpu_gmg.prolong_h, static_argnums=1)(
        jnp.asarray(c[..., None]), fd))[..., 0]
    Rf_ref = np.asarray(jax.jit(tpu_gmg.restrict_h, static_argnums=1)(
        jnp.asarray(f[..., None]), cd))[..., 0]
    np.testing.assert_allclose(Pc, Pc_ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(Rf, Rf_ref, rtol=0, atol=1e-14)
    assert np.isclose(np.sum(Pc * f), np.sum(c * Rf), rtol=1e-12)


def test_chebyshev_smoothers_match_tpufem(gmg16):
    ref, port = gmg16
    lv_ref, lv = ref.levels[0], port.levels[0]
    rng = np.random.default_rng(1)
    b, x = rng.standard_normal((2, lv.op.layout.ndofs))
    for degree in (2, 3):
        s_ref = tpu_cheb.chebyshev_smoother(lv_ref.op.apply, lv_ref.dinv,
                                            lv_ref.lmax, degree=degree)
        s0_ref = tpu_cheb.chebyshev_smoother_zero(lv_ref.op.apply,
                                                  lv_ref.dinv, lv_ref.lmax,
                                                  degree=degree)
        s = chebyshev.chebyshev_smoother(lv.op.apply, lv.dinv, lv.lmax,
                                         degree=degree)
        s0 = chebyshev.chebyshev_smoother_zero(lv.op.apply, lv.dinv,
                                               lv.lmax, degree=degree)
        np.testing.assert_allclose(
            s(torch.from_numpy(x), torch.from_numpy(b)).numpy(),
            np.asarray(s_ref(jnp.asarray(x), jnp.asarray(b))),
            rtol=0, atol=1e-12)
        for got, want in zip(s0(torch.from_numpy(b)),
                             s0_ref(jnp.asarray(b))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", [(16, 16, 16), (8, 10, 12), (64, 80, 96)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lmax_estimates_equal(dims, dtype):
    mesh = BoxTetMesh(*dims)
    assert (gmg.surrogate_lmax(mesh, 1, "poisson", common.poisson_bc_marker,
                               getattr(torch, dtype))
            == tpu_gmg.surrogate_lmax(mesh, 1, "poisson",
                                      tpu_common.poisson_bc_marker,
                                      getattr(jnp, dtype)))
    op = DiaOperator.build(BoxTetMesh(6, 6, 6), 1, "poisson",
                           dtype=torch.float64)
    dinv = 1.0 / op.diagonal_np()
    assert (chebyshev.power_iteration_lmax(op.apply_np, dinv, dinv.size)
            == tpu_cheb.power_iteration_lmax(op.apply_np, dinv, dinv.size))


def test_setup_matches_tpufem(gmg16):
    """Coarse inverse from to_scipy vs tpufem's assembled one; the same
    level data and hierarchy."""
    ref, port = gmg16
    assert port.dims == ref.dims
    for m in (MESH16, BoxTetMesh(64, 80, 96), BoxTetMesh(40, 40, 40),
              BoxTetMesh(50, 50, 50)):
        assert gmg.gmg_viable(m) == tpu_gmg.gmg_viable(m, 1)
    np.testing.assert_allclose(port.coarse_inv.numpy(),
                               np.asarray(ref.coarse_inv), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref.coarse_inv)).max())
    assert np.array_equal(port.coarse_bc_mask.numpy(),
                          np.asarray(ref.coarse_bc_mask))
    for lv, lv_ref in zip(port.levels, ref.levels):
        assert lv.lmax == lv_ref.lmax
        assert np.array_equal(lv.dinv.numpy(), np.asarray(lv_ref.dinv))


def test_vcycle_matches_tpufem(gmg16):
    ref, port = gmg16
    r = np.random.default_rng(2).standard_normal(MESH16.num_vertices_global)
    want = np.asarray(jax.jit(ref.vcycle)(jnp.asarray(r)))
    got = port.vcycle(torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    # the same V-cycle from tpufem's arrays carried over by convert
    lv = ref.levels[0]
    op = convert.dia_from_numpy(
        lv.op.plan, lv.op.weights, np.asarray(lv.op.bc_mask), ref.dims[0],
        CPU, zone_plan=lv.op.zone_plan,
        zones=[[np.asarray(f) for f in z] for z in lv.op.zones],
        surr_dims=lv.op.surr_dims)
    carried = convert.gmg_from_numpy(
        [op], [np.asarray(lv.dinv)], [lv.lmax], np.asarray(ref.coarse_inv),
        np.asarray(ref.coarse_bc_mask), ref.dims, CPU)
    got2 = carried.vcycle(torch.from_numpy(r)).numpy()
    assert np.linalg.norm(got2 - want) <= 1e-12 * np.linalg.norm(want)


# -- the h-transfers with their masks --------------------------------------

def _bc_mask(dims, batch):
    """The Poisson Dirichlet mask of a (Nx, Ny, Nz) lattice's vertices,
    the same for each of ``batch`` grids, flat."""
    return torch.from_numpy(np.tile(gmg.vertex_bc_mask(
        PortMesh(*dims), common.poisson_bc_marker), batch))


def _pair(cd, batch, dtype, seed=0):
    """Random fine and coarse grids of a batch, with some -0.0 entries."""
    fd = tuple(2 * v for v in cd)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, fd[2] + 1, fd[1] + 1, fd[0] + 1))
    c = rng.standard_normal((batch, cd[2] + 1, cd[1] + 1, cd[0] + 1))
    f.reshape(-1)[::7] = -0.0
    c.reshape(-1)[::5] = -0.0
    return (torch.from_numpy(f).to(dtype), torch.from_numpy(c).to(dtype))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["restrict", "prolong"])
def test_masked_transfers_are_masked_fill_around_the_slices(kind, batch,
                                                             masks):
    """prepare_h_transfers' pair on the CPU equals masked_fill o
    restrict_h o masked_fill (prolong_h likewise), bit for bit."""
    cd = (4, 5, 6)
    f, c = _pair(cd, batch, torch.float64)
    fm = _bc_mask(tuple(2 * v for v in cd), batch) if masks else None
    cm = _bc_mask(cd, batch) if masks else None
    restrict, prolong = gmg.prepare_h_transfers(
        batch, tuple(c.shape[1:]), torch.float64, CPU, fine_mask=fm,
        coarse_mask=cm)

    def fill(v, m):
        v = v.reshape(-1)
        return v if m is None else v.masked_fill(m, 0.0)

    if kind == "restrict":
        got = restrict(f.reshape(-1))
        want = fill(gmg.restrict_h(fill(f, fm).reshape(f.shape)), cm)
    else:
        got = prolong(c.reshape(-1))
        want = fill(gmg.prolong_h(fill(c, cm).reshape(c.shape)), fm)
    assert got.shape == want.shape and got.dim() == 1
    assert torch.equal(_bits(got), _bits(want))


def test_transfer_counters_on_the_cpu(gmg16):
    """A V-cycle counts its two h-transfers a smoothed level in
    gmg.transfers and no launch of the kernel; restrict_h and prolong_h
    count theirs; off, nothing is counted."""
    from tpufem_torch import timing
    _, port = gmg16
    launches = gmg.prepare_h_transfers.launches
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(
        MESH16.num_vertices_global))
    timing.SPANS.reset()
    port.vcycle(r)
    assert timing.SPANS.counters == {}
    was = timing.enable_spans(True)
    try:
        port.vcycle(r)
        f, c = _pair((3, 2, 4), 1, torch.float64)
        gmg.restrict_h(f)
        gmg.prolong_h(c)
        counters = dict(timing.SPANS.counters)
    finally:
        timing.enable_spans(was)
        timing.SPANS.reset()
    assert counters["gmg.transfers"] == 2 * len(port.levels) + 2 > 2
    assert counters.get("gmg.transfers.kernel", 0) == 0
    assert gmg.prepare_h_transfers.launches == launches


def test_transfer_refusals_on_the_cpu():
    f, c = _pair((3, 2, 4), 1, torch.float64)
    with pytest.raises(ValueError, match="odd"):
        gmg.restrict_h(f[..., :-1])
    with pytest.raises(ValueError, match="grids"):
        gmg.prolong_h(c[0, 0])
    with pytest.raises(ValueError, match="mask"):
        gmg.prepare_h_transfers(1, (5, 3, 4), torch.float64, CPU,
                                fine_mask=torch.zeros(7, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="no h-transfer kernel"):
        gmg.restrict_h(f.to("meta"))


def test_transfer_launch_struct_mirrors_the_kernel():
    """_build.TransferLaunch lays out csrc/gmg_transfer.cu's
    TransferLaunch: two mask pointers, then device, B, Z, Y, X."""
    import ctypes
    from tpufem_torch import _build
    L = _build.TransferLaunch
    assert [n for n, _ in L._fields_] == ["fine_mask", "coarse_mask",
                                          "device", "B", "Z", "Y", "X"]
    assert (L.coarse_mask.offset, L.device.offset, L.X.offset) == (8, 16, 32)
    assert ctypes.sizeof(L) == 40
