"""Structured geometric multigrid (counterpart of tpufem/la/gmg.py:
``prolong_h``/``restrict_h`` :74-116, ``prolong_p``/``restrict_p``
:118-193, ``GMG.setup`` :236-339, scalar and planar bs = 3, P1-P3,
``vcycle`` :341-404, ``gmg_viable``, ``surrogate_lmax``, ``_host_lmax``).

Nested Kuhn lattices give an exact geometric hierarchy: P1 prolongation
is linear interpolation (every fine vertex is a coarse vertex or the
midpoint of a coarse vertex pair), level operators are the re-discretized
DIA stencils with their own Dirichlet masks, the smoother is
Chebyshev/Jacobi with one lmax per order estimated on a small surrogate
lattice, and the coarsest level is solved by a dense inverse.  An order
k > 1 problem has one more level on top: the order-k operator of
``build_operator`` on the same lattice (the multi-kind DIA, one launch
of the zone kernel an apply, or the per-perm StructuredOperator on small
lattices; for elasticity the blocked StructuredOperator, one launch of
the perm_apply kernel), reached from the P1 level by the p-transfers:
point evaluation of the linear field at the P_k nodes and its adjoint.

Elasticity runs in the component-planar layout (``planar``): the level
operators are planar bs = 3 operators, the transfers (h and p) act on
the three component grids as a leading batch dimension, the level walk
counts bs * nodes dofs, and the dense coarse inverse is permuted to
planar order.  tpufem runs order-k elasticity interleaved; the planar
V-cycle computes the same values.

Unlike tpufem, the coarsest operator is the coarse
DiaOperator's ``to_scipy()`` matrix (tpufem assembles it from element
tensors; the two are equal, tests/test_dia_op.py pins it); vectors are
[Z, Y, X] grids ([3, Z, Y, X] planar) without tpufem's trailing
component axis.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpufem_torch.fem.dia_op import build_operator, np_dtype
from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.reference import _edge_interior_params
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.fem.structured_op import GridLayout
from tpufem_torch.la.chebyshev import (chebyshev_smoother,
                                       chebyshev_smoother_zero)
from tpufem_torch.mesh.structured import EDGE_TYPES, FACE_TYPES, BoxTetMesh
from tpufem_torch.timing import count, span


# ---------------------------------------------------------------------------
# Transfers (an exact adjoint pair) on the last three axes [..., Z, Y, X]:
# leading axes are a batch (the planar components, the slabs).  The h-
# transfers are shifted slices on the CPU and one launch of
# csrc/gmg_transfer.cu's kernels (the slices' bits) on the card.
# ---------------------------------------------------------------------------


def _interleave(A: torch.Tensor, B: torch.Tensor, axis: int) -> torch.Tensor:
    """[a0, b0, a1, b1, ..., an]: weave A (n+1 slices) with B (n slices)."""
    axis %= A.dim()
    n = B.shape[axis]
    pairs = torch.stack([A.narrow(axis, 0, n), B], dim=axis + 1)
    shape = list(A.shape)
    shape[axis] = 2 * n
    return torch.cat([pairs.reshape(shape), A.narrow(axis, n, 1)], dim=axis)


def _deinterleave(Fg: torch.Tensor, axis: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Inverse of _interleave: F (2n+1 slices) -> (A (n+1), B (n))."""
    axis %= Fg.dim()
    n = (Fg.shape[axis] - 1) // 2
    shape = list(Fg.shape)
    shape[axis: axis + 1] = [n, 2]
    pairs = Fg.narrow(axis, 0, 2 * n).reshape(shape)
    A = torch.cat([pairs.select(axis + 1, 0), Fg.narrow(axis, 2 * n, 1)],
                  dim=axis)
    return A, pairs.select(axis + 1, 1)


def prolong_h_plain(c: torch.Tensor) -> torch.Tensor:
    """P1 vertex-grid prolongation [..., Zc+1, Yc+1, Xc+1] -> [...,
    2Zc+1, ...]: every fine vertex is the average of coarse vertices
    floor(f/2) and ceil(f/2) (exact linear interpolation on the coarse
    Kuhn mesh).  Shifted slices, on any device."""
    Z, Y, X = c.shape[-3:]
    pat = {}
    for oz, oy, ox in itertools.product((0, 1), repeat=3):
        lo = c[..., : Z - oz, : Y - oy, : X - ox]
        hi = c[..., oz:, oy:, ox:]
        pat[(oz, oy, ox)] = lo if (oz | oy | ox) == 0 else 0.5 * (lo + hi)
    q = {(oz, oy): _interleave(pat[(oz, oy, 0)], pat[(oz, oy, 1)], axis=-1)
         for oz, oy in itertools.product((0, 1), repeat=2)}
    r0 = _interleave(q[(0, 0)], q[(0, 1)], axis=-2)
    r1 = _interleave(q[(1, 0)], q[(1, 1)], axis=-2)
    return _interleave(r0, r1, axis=-3)


def restrict_h_plain(f: torch.Tensor) -> torch.Tensor:
    """Adjoint of prolong_h_plain (fine vertex grid -> coarse vertex
    grid): the centre, then for each odd pattern (oz, oy, ox) in
    itertools.product order the half-weighted term at 2i + o before the
    one at 2i - o.  Shifted slices, on any device."""
    r0, r1 = _deinterleave(f, axis=-3)
    q00, q01 = _deinterleave(r0, axis=-2)
    q10, q11 = _deinterleave(r1, axis=-2)
    c = None
    for (oz, oy), qq in (((0, 0), q00), ((0, 1), q01),
                         ((1, 0), q10), ((1, 1), q11)):
        e, o = _deinterleave(qq, axis=-1)
        for ox, part in ((0, e), (1, o)):
            if (oz | oy | ox) == 0:
                c = part if c is None else c + part
                continue
            half = 0.5 * part
            # adjoint of lo/hi averaging: pad on the odd axes
            c = c + F.pad(half, (0, ox, 0, oy, 0, oz))
            c = c + F.pad(half, (ox, 0, oy, 0, oz, 0))
    return c


def _lead_and_coarse(x: torch.Tensor, fine: bool
                     ) -> Tuple[Tuple[int, ...], Tuple[int, int, int]]:
    """(batch dims, coarse vertex extents (Z, Y, X)) of a [..., Z, Y, X]
    grid: a coarse one, or a fine one (odd extents 2n - 1)."""
    if x.dim() < 3:
        raise ValueError(f"an h-transfer takes [..., Z, Y, X] grids, got "
                         f"shape {tuple(x.shape)}")
    grid = tuple(x.shape[-3:])
    if fine and any(n % 2 == 0 for n in grid):
        raise ValueError(f"a fine grid of {grid} vertices: the extents of "
                         "a fine grid are odd (2n - 1)")
    coarse = tuple((n + 1) // 2 for n in grid) if fine else grid
    return tuple(x.shape[:-3]), coarse


def prolong_h(c: torch.Tensor) -> torch.Tensor:
    """P1 prolongation [..., Zc+1, Yc+1, Xc+1] -> [..., 2Zc+1, ...]
    (prolong_h_plain's function), through an unmasked
    ``prepare_h_transfers`` pair: the slices on the CPU, one launch of
    csrc/gmg_transfer.cu's kernel on a CUDA device."""
    lead, (Z, Y, X) = _lead_and_coarse(c, fine=False)
    _, prolong = prepare_h_transfers(math.prod(lead), (Z, Y, X), c.dtype,
                                     c.device)
    return prolong(c).reshape(lead + (2 * Z - 1, 2 * Y - 1, 2 * X - 1))


def restrict_h(f: torch.Tensor) -> torch.Tensor:
    """Adjoint of prolong_h (restrict_h_plain's function), dispatched as
    prolong_h is."""
    lead, coarse = _lead_and_coarse(f, fine=True)
    restrict, _ = prepare_h_transfers(math.prod(lead), coarse, f.dtype,
                                      f.device)
    return restrict(f).reshape(lead + coarse)


def prepare_h_transfers(batch: int, coarse: Tuple[int, int, int],
                        dtype: torch.dtype, device: torch.device,
                        fine_mask: Optional[torch.Tensor] = None,
                        coarse_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[Callable, Callable]:
    """The (restrict, prolong) pair of one level's h-transfers between
    ``batch`` fine grids [2Z-1, 2Y-1, 2X-1] and coarse grids ``coarse`` =
    (Z, Y, X), with the level's Dirichlet masks (bool, ``batch`` grids'
    entries each; None: none) on both sides, as GMG.vcycle applies them:

        restrict(f) = mask_c(restrict_h(mask_f(f)))
        prolong(c)  = mask_f(prolong_h(mask_c(c)))

    (mask_f, mask_c: masked_fill of the fine / coarse mask with 0).

    Each takes the batch's entries, contiguous, in any shape, and returns
    them flat.  On the CPU the slices; on a CUDA device a call is one
    launch of csrc/gmg_transfer.cu's kernel, with the dims, the masks'
    pointers and the entry point fixed here, and the output's
    ``torch.empty``; any other device raises.  Each call counts
    ``gmg.transfers``, a launch also ``gmg.transfers.kernel``, while
    spans are on; launches are counted in ``prepare_h_transfers.launches``
    always."""
    Z, Y, X = coarse
    fshape = (batch, 2 * Z - 1, 2 * Y - 1, 2 * X - 1)
    sizes = (math.prod(fshape), batch * Z * Y * X)
    masks = []
    for name, m, n in (("fine", fine_mask, sizes[0]),
                       ("coarse", coarse_mask, sizes[1])):
        if m is not None and (m.dtype != torch.bool or m.numel() != n
                              or m.device != device):
            raise ValueError(f"the {name} mask is {tuple(m.shape)} {m.dtype}"
                             f"@{m.device}: expected {n} bool entries on "
                             f"{device}")
        masks.append(None if m is None else m.reshape(-1))
    fine_mask, coarse_mask = masks
    if device.type == "cpu":
        def fill(v, mask):
            return v if mask is None else v.masked_fill(mask, 0.0)

        def restrict(f: torch.Tensor) -> torch.Tensor:
            count("gmg.transfers")
            c = restrict_h_plain(fill(f.reshape(-1), fine_mask)
                                 .reshape(fshape))
            return fill(c.reshape(-1), coarse_mask)

        def prolong(c: torch.Tensor) -> torch.Tensor:
            count("gmg.transfers")
            f = prolong_h_plain(fill(c.reshape(-1), coarse_mask)
                                .reshape((batch,) + tuple(coarse)))
            return fill(f.reshape(-1), fine_mask)

        return restrict, prolong
    if device.type != "cuda":
        raise RuntimeError(f"no h-transfer kernel for device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the h-transfer kernels take float32/float64, "
                        f"got {dtype}")
    from tpufem_torch import _build
    lib = _build.load().lib
    args = _build.TransferLaunch(
        fine_mask=None if fine_mask is None else fine_mask.data_ptr(),
        coarse_mask=None if coarse_mask is None else coarse_mask.data_ptr(),
        device=device.index, B=batch, Z=Z, Y=Y, X=X)
    addr = ctypes.addressof(args)
    raw_stream = _build.raw_stream_getter()
    index = device.index
    suffix = "f32" if dtype == torch.float32 else "f64"

    def launcher(kind: str, n_in: int, n_out: int) -> Callable:
        fn = getattr(lib, f"tpufem_gmg_{kind}_{suffix}")
        what = f"gmg {kind} of {batch} x {Z}x{Y}x{X} coarse vertices"

        def launch(x: torch.Tensor) -> torch.Tensor:
            if (x.dtype != dtype or x.device != device or x.numel() != n_in
                    or not x.is_contiguous()):
                raise ValueError(f"{what}: input {tuple(x.shape)} {x.dtype}@"
                                 f"{x.device}, expected {n_in} contiguous "
                                 f"{dtype} entries on {device}")
            y = torch.empty(n_out, dtype=dtype, device=device)
            rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
            if rc != 0:
                _build.raise_on(lib, rc, what)
            prepare_h_transfers.launches += 1
            count("gmg.transfers")
            count("gmg.transfers.kernel")
            return y

        launch.keep = (args, fine_mask, coarse_mask)  # what addr points at
        return launch

    return launcher("restrict", *sizes), launcher("prolong", *sizes[::-1])


prepare_h_transfers.launches = 0


def vertex_bc_mask(mesh: BoxTetMesh, bc_marker: Callable,
                   bs: int = 1) -> np.ndarray:
    """A P1 lattice's Dirichlet mask on the host: bool, True at the
    constrained dofs, in the flat (bs-interleaved) numbering."""
    space = FunctionSpace(mesh, 1, bs=bs)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(bc_marker))
    mask = np.zeros(space.ndofs, dtype=bool)
    mask[bc.flat_dofs()] = True
    return mask


def _join_batched(grids: List[torch.Tensor]) -> torch.Tensor:
    """[..., Z, Y, X, slots] grids of a layout -> [..., ndofs] flat."""
    lead = grids[0].shape[:-4]
    return torch.cat([g.reshape(lead + (-1,)) for g in grids], dim=-1)


def _split_batched(r: torch.Tensor, layout: GridLayout) -> List[torch.Tensor]:
    """[..., ndofs] flat -> the layout's [..., Z, Y, X, slots] grids."""
    lead = tuple(r.shape[:-1])
    return [r[..., b: b + X * Y * Z * s].reshape(lead + (Z, Y, X, s))
            for b, (X, Y, Z), s in layout.kinds]


def prolong_p(v: torch.Tensor, layout: GridLayout) -> torch.Tensor:
    """P1 -> P_k on the same lattice: the P1 vertex grid v [..., Z+1,
    Y+1, X+1] evaluated at the P_k nodes of ``layout`` (vertex copy; an
    edge node at parameter t gets (1 - t) va + t vb; a face centroid the
    average of its 3 vertices), as a flat [..., ndofs] P_k vector;
    leading axes are a batch (the planar components)."""
    k = layout.order
    grids = [v[..., None]]
    for (_, (X, Y, Z), _), d in zip(layout.kinds[1:8], EDGE_TYPES):
        va = v[..., :Z, :Y, :X]
        vb = v[..., d[2]: d[2] + Z, d[1]: d[1] + Y, d[0]: d[0] + X]
        grids.append(torch.stack([(1 - t) * va + t * vb for t in
                                  map(float, _edge_interior_params(
                                      k, "gll_warped"))], dim=-1))
    if k >= 3:
        for (_, (X, Y, Z), _), (o1, o2) in zip(layout.kinds[8:], FACE_TYPES):
            v0 = v[..., :Z, :Y, :X]
            v1 = v[..., o1[2]: o1[2] + Z, o1[1]: o1[1] + Y, o1[0]: o1[0] + X]
            v2 = v[..., o2[2]: o2[2] + Z, o2[1]: o2[1] + Y, o2[0]: o2[0] + X]
            grids.append(((v0 + v1 + v2) / 3.0)[..., None])
    return _join_batched(grids)


def restrict_p(r: torch.Tensor, layout: GridLayout) -> torch.Tensor:
    """Adjoint of prolong_p: a flat [..., ndofs] P_k residual -> the P1
    vertex grid [..., Z+1, Y+1, X+1], summed in tpufem's order."""
    k = layout.order
    grids = _split_batched(r, layout)  # [..., Z, Y, X, slots]
    out = grids[0][..., 0].clone()
    tparams = [float(t) for t in _edge_interior_params(k, "gll_warped")]
    for g, d in zip(grids[1:8], EDGE_TYPES):
        Z, Y, X = g.shape[-4:-1]
        for s, t in enumerate(tparams):
            out[..., :Z, :Y, :X] += (1 - t) * g[..., s]
            out[..., d[2]: d[2] + Z, d[1]: d[1] + Y,
                d[0]: d[0] + X] += t * g[..., s]
    if k >= 3:
        for g, (o1, o2) in zip(grids[8:], FACE_TYPES):
            Z, Y, X = g.shape[-4:-1]
            third = g[..., 0] / 3.0
            out[..., :Z, :Y, :X] += third
            out[..., o1[2]: o1[2] + Z, o1[1]: o1[1] + Y,
                o1[0]: o1[0] + X] += third
            out[..., o2[2]: o2[2] + Z, o2[1]: o2[1] + Y,
                o2[0]: o2[0] + X] += third
    return out


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GLevel:
    op: object      # a DiaOperator, or a StructuredOperator at order k > 1
    dinv: torch.Tensor
    lmax: float


@dataclasses.dataclass
class GMG:
    """Geometric multigrid preconditioner for BoxTetMesh problems (scalar
    or planar bs = 3, P1-P3); level 0 is the finest, of order ``order``,
    the others P1."""

    levels: List[GLevel]
    coarse_inv: torch.Tensor
    coarse_bc_mask: torch.Tensor
    dims: Tuple                  # per-level (Nx, Ny, Nz), coarsest last
    smoother_degree: int = 2
    bs: int = 1
    planar: bool = False         # bs > 1: component-planar vectors
    order: int = 1               # fine order (a p-transfer below it if > 1)

    def __post_init__(self) -> None:
        d = self.smoother_degree
        self._smooth = [chebyshev_smoother(lv.op.apply, lv.dinv, lv.lmax,
                                           degree=d) for lv in self.levels]
        self._smooth0 = [chebyshev_smoother_zero(lv.op.apply, lv.dinv,
                                                 lv.lmax, degree=d)
                         for lv in self.levels]
        # the V-cycle's span names, built once: (smooth, restrict,
        # prolong) of each smoothed level
        self._spans = [tuple(f"gmg.{phase}.L{i}" for phase in
                             ("smooth", "restrict", "prolong"))
                       for i in range(len(self.levels))]
        # each level's (restrict, prolong) pair with its masks and the
        # next level's, prepared once: the h-transfers (on the card one
        # kernel launch each), or the p-transfers below an order-k level 0
        self._transfers = [
            self._p_transfers() if self.order > 1 and i == 0
            else prepare_h_transfers(
                self.bs, self._vertex_grid(i + 1), lv.dinv.dtype,
                lv.dinv.device, fine_mask=lv.op.bc_mask,
                coarse_mask=self._bc_mask_of(i + 1))
            for i, lv in enumerate(self.levels)]

    @classmethod
    def setup(cls, mesh: BoxTetMesh, order: int, problem: str,
              bc_marker: Callable, device: torch.device,
              dtype: torch.dtype = torch.float32,
              coarse_limit: int = 1000, smoother_degree: int = 2,
              max_levels: int = 12, planar: bool = False) -> "GMG":
        """``problem`` "poisson" or "elasticity" (bs = 3, in the
        component-planar layout: ``planar``), order 1-3.  Order k > 1:
        the levels are [the order-k operator, P1 on the same lattice, the
        P1 halvings], each order smoothing on its own surrogate lmax
        (tpufem/la/gmg.py:250-308).  tpufem runs order-k elasticity
        interleaved (its planar GMG is P1-only, :246-248); the port runs
        every level planar, which computes the same V-cycle."""
        if problem not in ("poisson", "elasticity"):
            raise NotImplementedError(f"GMG for {problem}")
        bs = 3 if problem == "elasticity" else 1
        if bs > 1 and not planar:
            raise NotImplementedError(
                "the interleaved bs = 3 GMG (the port runs elasticity in "
                "the planar layout)")
        planar = planar and bs > 1

        def level_bc(m: BoxTetMesh, k: int) -> DirichletBC:
            space = FunctionSpace(m, k, bs=bs)
            return DirichletBC.from_space(space,
                                          m.locate_boundary_facets(bc_marker))

        top = [mesh] if order > 1 else []
        meshes = top + hierarchy(mesh, coarse_limit, max_levels - len(top),
                                 bs)
        orders = [order] + [1] * (len(meshes) - 1)
        mC = meshes[-1]
        coarse_ndofs = (mC.Nx + 1) * (mC.Ny + 1) * (mC.Nz + 1) * bs
        if coarse_ndofs > 8 * coarse_limit:
            raise ValueError(
                f"GMG coarsest level has {coarse_ndofs} dofs "
                f"(dims {mC.Nx}x{mC.Ny}x{mC.Nz}); pick lattice dims "
                f"divisible by 2^levels (compute_box_size_structured)")

        lmax_of = {k: surrogate_lmax(mesh, k, problem, bc_marker, dtype)
                   for k in sorted(set(orders[:-1]))}
        levels: List[GLevel] = []
        for m, k in zip(meshes[:-1], orders[:-1]):
            op = build_operator(m, k, problem,
                                bc_dofs=level_bc(m, k).flat_dofs(),
                                dtype=dtype, device=device, planar=planar)
            dinv_np = 1.0 / op.diagonal_np()
            levels.append(GLevel(
                op=op, lmax=lmax_of[k],
                dinv=torch.from_numpy(dinv_np.astype(np_dtype(dtype))).to(device)))

        # coarsest: dense inverse of the BC-eliminated P1 operator
        # (interleaved), permuted to planar component order
        cmask = vertex_bc_mask(mC, bc_marker, bs)
        Ac = build_operator(mC, 1, problem, bc_dofs=np.flatnonzero(cmask),
                            dtype=torch.float64).to_scipy().toarray()
        coarse_inv = np.linalg.inv(Ac)
        if planar:
            perm = np.arange(coarse_ndofs).reshape(-1, bs).T.reshape(-1)
            coarse_inv = coarse_inv[np.ix_(perm, perm)]
            cmask = cmask[perm]
        return cls(levels=levels,
                   coarse_inv=torch.from_numpy(coarse_inv).to(
                       device=device, dtype=dtype),
                   coarse_bc_mask=torch.from_numpy(cmask).to(device),
                   dims=tuple((m.Nx, m.Ny, m.Nz) for m in meshes),
                   smoother_degree=smoother_degree, bs=bs, planar=planar,
                   order=order)

    def _bc_mask_of(self, i: int) -> torch.Tensor:
        if i == len(self.levels):
            return self.coarse_bc_mask
        return self.levels[i].op.bc_mask

    def _p_transfers(self) -> Tuple[Callable, Callable]:
        """The (restrict, prolong) pair between the order-k level 0 and
        the P1 level 1: restrict_p / prolong_p between the two levels'
        masks, on flat vectors."""
        mask, cmask = self.levels[0].op.bc_mask, self._bc_mask_of(1)
        layout = self.levels[0].op.layout

        def restrict(rr: torch.Tensor) -> torch.Tensor:
            rc = restrict_p(rr.masked_fill(mask, 0.0).reshape(self.bs, -1),
                            layout)
            return rc.reshape(-1).masked_fill(cmask, 0.0)

        def prolong(xc: torch.Tensor) -> torch.Tensor:
            e = prolong_p(self._grid(xc.masked_fill(cmask, 0.0), 1), layout)
            return e.reshape(-1).masked_fill(mask, 0.0)

        return restrict, prolong

    def _vertex_grid(self, i: int) -> Tuple[int, int, int]:
        """Level i's vertex extents (Z, Y, X)."""
        Nx, Ny, Nz = self.dims[i]
        return (Nz + 1, Ny + 1, Nx + 1)

    def _grid(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Level i's vector as its vertex grid(s): [Z, Y, X], or [3, Z,
        Y, X] planar (the transfers batch over the components)."""
        grid = self._vertex_grid(i)
        return x.reshape(grid if self.bs == 1 else (self.bs,) + grid)

    def vcycle(self, r: torch.Tensor, i: int = 0) -> torch.Tensor:
        """One V-cycle from level ``i`` down.  Spans (timing.span): the
        pre- and post-smoothing ``gmg.smooth.L{i}``, each transfer with
        its masks ``gmg.restrict.L{i}`` / ``gmg.prolong.L{i}``, with the
        coarser levels between them, and the dense ``gmg.coarse``."""
        if i == len(self.levels):
            with span("gmg.coarse"):
                return torch.matmul(self.coarse_inv, r)
        smooth, restrict, prolong = self._spans[i]
        # pre-smoothing from zero returns the residual r - A x
        with span(smooth):
            x, rr = self._smooth0[i](r)
        # symmetric BC-filtered transfers keep the preconditioner SPD
        to_coarse, to_fine = self._transfers[i]
        with span(restrict):
            rc = to_coarse(rr)
        xc = self.vcycle(rc, i + 1)
        with span(prolong):
            e = to_fine(xc)
        with span(smooth):
            return self._smooth[i](x + e, r)


def hierarchy(mesh: BoxTetMesh, coarse_limit: int = 1000,
              max_levels: int = 12, bs: int = 1) -> List[BoxTetMesh]:
    """The lattices of the GMG levels, finest first: halve every axis
    while the level has more than ``coarse_limit`` dofs (bs per vertex),
    all dims are even and at least 4, and fewer than ``max_levels``
    levels exist."""
    meshes = [mesh]
    while True:
        m = meshes[-1]
        if ((m.Nx + 1) * (m.Ny + 1) * (m.Nz + 1) * bs <= coarse_limit
                or len(meshes) >= max_levels
                or m.Nx % 2 or m.Ny % 2 or m.Nz % 2
                or min(m.Nx, m.Ny, m.Nz) < 4):
            return meshes
        meshes.append(BoxTetMesh(m.Nx // 2, m.Ny // 2, m.Nz // 2))


def gmg_viable(mesh: BoxTetMesh, bs: int = 1, coarse_limit: int = 1000,
               max_levels: int = 12) -> bool:
    """Would GMG.setup succeed on this lattice (bs dofs per vertex)?"""
    mC = hierarchy(mesh, coarse_limit, max_levels, bs)[-1]
    return (mC.Nx + 1) * (mC.Ny + 1) * (mC.Nz + 1) * bs <= 8 * coarse_limit


def surrogate_lmax(mesh: BoxTetMesh, order: int, problem: str,
                   bc_marker: Callable,
                   dtype: torch.dtype = torch.float32) -> float:
    """lmax(D^-1 A) estimated on a small surrogate lattice with the same
    (hx : hy : hz) anisotropy; one host estimate serves every level of
    order ``order``.  The surrogate is interleaved for bs = 3, as
    tpufem's: the seeded start vector of the power iteration depends on
    the layout.  At order k > 1 the surrogate lattice is often too small
    for the const DIA form (P2 500k: 4x5x6), and its operator is the
    per-perm StructuredOperator, as it always is for elasticity (the
    blocked one, interleaved)."""
    g = math.gcd(math.gcd(mesh.Nx, mesh.Ny), mesh.Nz)
    sdims = (mesh.Nx // g, mesh.Ny // g, mesh.Nz // g)
    scale = max(1, 8 // max(sdims))
    surrogate = BoxTetMesh(*(d * scale for d in sdims))
    space = FunctionSpace(surrogate, order,
                          bs=3 if problem == "elasticity" else 1)
    bc = DirichletBC.from_space(
        space, surrogate.locate_boundary_facets(bc_marker))
    sop = build_operator(surrogate, order, problem, bc_dofs=bc.flat_dofs(),
                         dtype=dtype)
    return _host_lmax(sop, 1.0 / sop.diagonal_np()) * 1.05


def _host_lmax(op, dinv_np: np.ndarray,
               iters: int = 20) -> float:
    """Host power iteration for lambda_max(D^-1 A), from a seeded start
    vector (the Chebyshev interval decides iteration counts)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(dinv_np.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv_np * op.apply_np(v)
        lam = float(np.linalg.norm(w))
        v = w / lam
    return lam
