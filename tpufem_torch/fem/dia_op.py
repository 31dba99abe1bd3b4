"""DIA (shift-diagonal stencil) operator of the Kuhn lattice
(counterpart of tpufem/fem/dia_op.py).

The matrix is stored as shift diagonals between typed dof grids
(fem.structured_op.grid_layout):

  y[dst](z, y, x) += W[(dst, src, d)](z, y, x) * x[src](z+dz, y+dy, x+dx)

with 15 diagonals for P1 (the Kuhn cube couples each vertex to 14
neighbours) and 230 / 1311 terms for P2 / P3; the P1 elasticity operator
(bs = 3) has a [3, 3] block per diagonal.  The host build is tpufem's
numpy code, so its tables are bitwise equal to tpufem's:

- const mode: each term's weight field is translation-invariant away
  from the lattice boundary, so it is built on an 8^3 surrogate lattice
  and expanded to z-zone fields (lo[3, Y, X], mid[1, Y, X] broadcast
  along z, hi[3, Y, X]; grids under 7 planes keep the full field).  P1
  takes it on lattices with >= 6 cubes per axis; P2/P3 through
  ``try_const`` (None when the lattice is too small);
- dense mode (smaller P1 lattices): one full weight array per diagonal.

Dirichlet elimination (zeroed rows and columns, unit diagonal) is baked
into the weights (``bake_bc=True``), or only recorded in the mask
(``bake_bc=False``, the matrix-free rows-zero convention).  On the
device a P1 operator stacks its fields into one [D, R, Y, X] tensor and
``apply`` is ONE stencil launch (fem.stencil.stencil_apply, the CUDA
kernel on a card).  A P2/P3 operator packs the fields of all its terms
into one buffer with a term table grouped by output (fem.dia_zones), and
``apply`` is ONE launch of the multi-kind zone kernel
(fem.dia_zones.dia_zones_apply); ``cgpoisson`` runs the same matrix as a
fem.strip_op.StripOperator by default.

Elasticity (bs = 3; on a device P1 only, P2/P3 elasticity runs the
blocked StructuredOperator, as tpufem's): each [3, 3] block
expands into 9 scalar zone terms (tpufem's zone plan, entries
``(ko, so, ki, si, d, r, s)``), and the device stacks them as [3, D, 3,
R, Y, X] for the three-component form of the kernel
(fem.stencil.stencil_apply_bs3, ONE launch an apply).  ``planar``
selects tpufem's component-planar vector layout, ``c * n + i``, in
which the solve runs; the default is the reference's interleaved
``3 * i + c``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dia_zones import (ZonePack, dia_zones_apply,
                                        pack_terms, prepare_dia_zones)
from tpufem_torch.fem.stencil import (compress_bs3, prepare_stencil,
                                      prepare_stencil_bs3, stencil_apply,
                                      stencil_apply_bs3)
from tpufem_torch.fem.structured_op import (GridLayout, StructuredOperator,
                                            dof_slice_plan, grid_layout,
                                            np_dtype, perm_element_matrices,
                                            to_interleaved, to_planar)
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.timing import count

_SHELL = 2  # per-axis shell margin: truncation (1) + BC adjacency (1)
_SURR = 8   # surrogate lattice cubes per axis

def _overlap(Zo, Yo, Xo, Zi, Yi, Xi, d):
    """Static dst-slice bounds such that src = dst + d stays in range."""
    dz, dy, dx = d[2], d[1], d[0]
    z0, z1 = max(0, -dz), min(Zo, Zi - dz)
    y0, y1 = max(0, -dy), min(Yo, Yi - dy)
    x0, x1 = max(0, -dx), min(Xo, Xi - dx)
    return (z0, z1, y0, y1, x0, x1)


def _rep_index(Lr: int, Ls: int, m: int) -> np.ndarray:
    """Surrogate index -> representative real index."""
    r = np.full(Ls, Lr // 2, dtype=np.int64)
    r[:m] = np.arange(m)
    r[Ls - m:] = Lr - (Ls - np.arange(Ls - m, Ls))
    return r


def _clamp_index(Lr: int, Ls: int, m: int) -> np.ndarray:
    """Real index -> surrogate index (exact when deviations from the
    interior constant sit within m of each end)."""
    q = np.full(Lr, Ls // 2, dtype=np.int64)
    q[:m] = np.arange(m)
    q[Lr - m:] = Ls - (Lr - np.arange(Lr - m, Lr))
    return q


def _block_size(problem: str) -> int:
    """bs of ``problem``."""
    return 3 if problem == "elasticity" else 1


@dataclasses.dataclass
class DiaOperator:
    """DIA stencil matrix between typed dof grids (scalar, or bs = 3).

    Host state (numpy, equal to tpufem's): ``plan`` holds one entry per
    (dst, src, shift) term, ``(dst kind, dst slot, src kind, src slot,
    (dx, dy, dz), dst-slice bounds, mode)`` with mode "table" (const
    mode: ``weights`` holds the absolute surrogate table) or None (dense
    mode: ``weights`` holds the dst-slice array), each weight with a
    trailing [bs, bs] block when bs > 1; ``zone_plan``/``zones`` the
    precomputed z-zone fields of a const-mode operator, one per scalar
    (r, s) component of a block; ``bc_mask_np`` the Dirichlet mask, in
    the operator's vector layout (planar when ``planar``).

    Device state (after ``_finalize(device)``): ``bc_mask``; for a P1
    (single-kind) operator ``fields`` [D, R, Y, X] (bs = 3: [9 D, R, Y,
    X], the [3, D, 3] (r, d, s) fields flattened) and ``offsets`` (D
    triples (dx, dy, dz)); for a P2/P3 (multi-kind) one ``zone_pack``.
    """

    weights: List[np.ndarray]
    bc_mask_np: np.ndarray
    plan: Tuple
    layout: GridLayout
    surr_dims: Optional[Tuple[int, int, int]] = None
    zones: Optional[Tuple] = None
    zone_plan: Optional[Tuple] = None
    fields: Optional[torch.Tensor] = None
    offsets: Optional[Tuple] = None
    bc_mask: Optional[torch.Tensor] = None
    zone_pack: Optional[ZonePack] = None
    bs: int = 1
    planar: bool = False   # bs > 1: component-planar vectors, c * n + i

    def terms(self):
        """Yield (meta, weight) walking the weight list in plan order."""
        for meta, w in zip(self.plan, self.weights):
            yield meta, w

    def is_const(self) -> bool:
        return bool(self.plan) and all(m[6] == "table" for m in self.plan)

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        """(Z, Y, X) of the vertex grid."""
        lay = self.layout
        return (lay.Nz + 1, lay.Ny + 1, lay.Nx + 1)

    # -- construction -----------------------------------------------------------
    @property
    def multi_kind(self) -> bool:
        """True for P2/P3 layouts (more than the vertex grid)."""
        return len(self.layout.kinds) > 1

    @classmethod
    def build(cls, mesh: BoxTetMesh, order: int, problem: str,
              bc_dofs: Optional[np.ndarray] = None,
              dtype: torch.dtype = torch.float32, mode: str = "auto",
              device: Optional[torch.device] = None,
              bake_bc: bool = True, planar: bool = False,
              h_override=None) -> "DiaOperator":
        """``mode``: "const" | "dense" | "auto" (const for P1 on lattices
        with >= 6 cubes per axis, dense otherwise).  ``bake_bc=False``
        records the BC mask without eliminating rows/cols in the weights.
        ``device=None`` keeps the operator on the host (numpy twins
        only).  ``planar``: the component-planar layout (bs = 3).
        ``h_override`` gives the cube size (hx, hy, hz) where it is not
        the mesh's own 1 / N (a z-slab of a larger lattice)."""
        npdtype = np_dtype(dtype)
        if mode == "auto":
            mode = ("const" if order == 1
                    and min(mesh.Nx, mesh.Ny, mesh.Nz) >= 6 else "dense")
        op = None
        if mode == "const":
            op = cls._build_const(mesh, order, problem, bc_dofs, npdtype,
                                  bake_bc, h_override)
        if op is None:
            op = cls._build_dense(mesh, order, problem, bc_dofs, npdtype,
                                  h_override=h_override, bake_bc=bake_bc)
        return op._make_planar(planar)._finalize(device)

    def _make_planar(self, planar: bool) -> "DiaOperator":
        """Set the planar layout (bs > 1 only) and permute the mask to it
        (tpufem/fem/dia_op.py:205, 216-218)."""
        self.planar = planar and self.bs > 1
        if self.planar:
            self.bc_mask_np = to_planar(self.bc_mask_np, self.bs)
        return self

    @classmethod
    def try_const(cls, mesh: BoxTetMesh, order: int, problem: str,
                  bc_dofs: Optional[np.ndarray] = None,
                  dtype: torch.dtype = torch.float32, bake_bc: bool = True,
                  device: Optional[torch.device] = None, h_override=None
                  ) -> Optional["DiaOperator"]:
        """Const-mode build (no dense fallback) or None: the scalar P2/P3
        path; callers fall back to StructuredOperator."""
        op = cls._build_const(mesh, order, problem, bc_dofs,
                              np_dtype(dtype), bake_bc, h_override)
        return None if op is None else op._finalize(device)

    def _finalize(self, device: Optional[torch.device]) -> "DiaOperator":
        """Precompute the zone fields (const mode) and, given a device,
        ship the bc mask and the stacked fields (single-kind operators)
        or the zone pack (multi-kind) there."""
        if self.is_const() and self.zones is None:
            self._build_zones_np()
        if device is None:
            return self
        if self.bs > 1 and not self.planar:
            raise NotImplementedError(
                "an interleaved bs = 3 operator on a device: the port runs "
                "elasticity planar, its SA-AMG included (the interleaved "
                "form is host-only: the certification twin, the lmax "
                "surrogate and the CSR export SA-AMG coarsens)")
        if self.bs > 1 and self.multi_kind:
            raise NotImplementedError(
                "a blocked P2/P3 DiaOperator on a device: the blocked P2/P3 "
                "operator is the StructuredOperator (build_operator)")
        self.bc_mask = torch.from_numpy(self.bc_mask_np).to(device)
        if self.multi_kind:
            dtype = (torch.float32 if np.asarray(self.weights[0]).dtype
                     == np.float32 else torch.float64)
            self.zone_pack = pack_terms(self.layout, self._zone_terms_np(),
                                        dtype, device)
            return self
        fields, offsets = self._stencil_fields_np()
        host = torch.from_numpy(np.ascontiguousarray(fields))
        self.fields = host.to(device)
        self.offsets = tuple(tuple(int(v) for v in d) for d in offsets)
        if self.bs > 1 and self.fields.device.type == "cuda":
            # the launch prepared in the build's time, its table compressed
            # from the host's fields rather than a copy back from the card
            self._stencil_table = compress_bs3(host, self.grid_dims,
                                               self.fields.device)
            self._stencil
        return self

    @classmethod
    def _build_dense(cls, mesh, order, problem, bc_dofs, npdtype,
                     h_override=None, bake_bc: bool = True) -> "DiaOperator":
        lay = grid_layout(mesh, order)
        splan = dof_slice_plan(order)
        Ap = perm_element_matrices(mesh, order, problem, h_override=h_override)
        bs = _block_size(problem)
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
        n = len(splan[0])
        kinds = lay.kinds
        gdims = [(k[1][2], k[1][1], k[1][0]) for k in kinds]  # (Z, Y, X)

        # constant coefficients per (dst, src, shift), accumulated onto
        # dst-grid-sized weight arrays
        acc: Dict[Tuple, np.ndarray] = {}
        for p in range(6):
            A = Ap[p].reshape(n, bs, n, bs)
            for lo, (ko, (ox, oy, oz), so) in enumerate(splan[p]):
                for li, (ki, (ix, iy, iz), si) in enumerate(splan[p]):
                    c = A[lo, :, li, :]  # [bs, bs]
                    if not np.any(c):
                        continue
                    key = (ko, so, ki, si, (ix - ox, iy - oy, iz - oz))
                    Zo, Yo, Xo = gdims[ko]
                    if key not in acc:
                        acc[key] = np.zeros((Zo, Yo, Xo, bs, bs))
                    acc[key][oz: oz + Nz, oy: oy + Ny, ox: ox + Nx] += c

        bc_grids = None
        if bake_bc and bc_dofs is not None and len(bc_dofs):
            mask = np.zeros(lay.ndofs * bs, dtype=bool)
            mask[bc_dofs] = True
            mask = mask.reshape(-1, bs)
            bc_grids = []
            for base, (X, Y, Z), s in kinds:
                seg = mask[base: base + X * Y * Z * s]
                bc_grids.append(seg.reshape(Z, Y, X, s, bs))

        plan = []
        weights = []
        for (ko, so, ki, si, d), W in sorted(acc.items()):
            Zo, Yo, Xo = gdims[ko]
            Zi, Yi, Xi = gdims[ki]
            z0, z1, y0, y1, x0, x1 = _overlap(Zo, Yo, Xo, Zi, Yi, Xi, d)
            Wc = W[z0:z1, y0:y1, x0:x1].copy()
            if bc_grids is not None:
                dst_bc = bc_grids[ko][z0:z1, y0:y1, x0:x1, so]
                src_bc = bc_grids[ki][z0 + d[2]: z1 + d[2],
                                      y0 + d[1]: y1 + d[1],
                                      x0 + d[0]: x1 + d[0], si]
                Wc = np.where(dst_bc[..., :, None], 0.0, Wc)
                Wc = np.where(src_bc[..., None, :], 0.0, Wc)
                if (ko, so, d) == (ki, si, (0, 0, 0)):
                    Wc = np.where(dst_bc[..., :, None], np.eye(bs), Wc)
            if bs == 1:
                Wc = Wc[..., 0, 0]
            if not np.any(Wc):
                continue
            plan.append((ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), None))
            weights.append(Wc.astype(npdtype))

        flat_mask = np.zeros(lay.ndofs * bs, dtype=bool)
        if bc_dofs is not None and len(bc_dofs):
            flat_mask[bc_dofs] = True
        return cls(weights=weights, bc_mask_np=flat_mask, plan=tuple(plan),
                   layout=lay, bs=bs)

    @classmethod
    def _build_const(cls, mesh, order, problem, bc_dofs, npdtype,
                     bake_bc: bool = True,
                     h_override=None) -> Optional["DiaOperator"]:
        """O(1) constant-weight build via a surrogate lattice, for every
        typed dof grid of the layout; None when the weight structure is
        not shell-representable (the caller falls back)."""
        M = _SHELL
        lay = grid_layout(mesh, order)
        bs = _block_size(problem)
        if bs > 1 and len(lay.kinds) != 1:
            return None  # the blocked const form is P1 only
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
        if min(Nx, Ny, Nz) < 2 * (M + 1):
            return None
        h = (tuple(h_override) if h_override is not None
             else (1.0 / Nx, 1.0 / Ny, 1.0 / Nz))
        sdims = (min(Nx, _SURR), min(Ny, _SURR), min(Nz, _SURR))
        smesh = BoxTetMesh(*sdims)
        slay = grid_layout(smesh, order)
        rdims = [(k[1][2], k[1][1], k[1][0]) for k in lay.kinds]
        surr_kdims = [(k[1][2], k[1][1], k[1][0]) for k in slay.kinds]

        # transport the BC pattern to the surrogate (exact only for
        # axis-shell patterns; verified by clamping back)
        flat_mask = np.zeros(lay.ndofs * bs, dtype=bool)
        sbc_flat = None
        if bc_dofs is not None and len(bc_dofs):
            flat_mask[bc_dofs] = True
        if bake_bc and bc_dofs is not None and len(bc_dofs):
            mask2 = flat_mask.reshape(-1, bs)
            parts = []
            for (b, (X, Y, Zd), s), (Zr, Yr, Xr), (Zs, Ys, Xs) in zip(
                    lay.kinds, rdims, surr_kdims):
                g = mask2[b: b + X * Y * Zd * s].reshape(Zr, Yr, Xr, s, bs)
                rz, ry, rx = (_rep_index(Zr, Zs, M), _rep_index(Yr, Ys, M),
                              _rep_index(Xr, Xs, M))
                gs = g[np.ix_(rz, ry, rx)]
                qz, qy, qx = (_clamp_index(Zr, Zs, M),
                              _clamp_index(Yr, Ys, M),
                              _clamp_index(Xr, Xs, M))
                if not np.array_equal(g, gs[np.ix_(qz, qy, qx)]):
                    return None
                parts.append(gs.reshape(-1, bs))
            sbc_flat = np.nonzero(np.concatenate(parts).reshape(-1))[0]

        surr = cls._build_dense(smesh, order, problem, sbc_flat,
                                np.dtype(np.float64), h_override=h,
                                bake_bc=bake_bc)

        plan = []
        weights: List[np.ndarray] = []
        for (ko, so, ki, si, d, (sz0, sz1, sy0, sy1, sx0, sx1), _), Ws in \
                zip(surr.plan, surr.weights):
            Zr, Yr, Xr = rdims[ko]
            Zi, Yi, Xi = rdims[ki]
            z0, z1, y0, y1, x0, x1 = _overlap(Zr, Yr, Xr, Zi, Yi, Xi, d)
            Lz, Ly, Lx = z1 - z0, y1 - y0, x1 - x0
            Ws = np.asarray(Ws, dtype=np.float64)
            Lsz, Lsy, Lsx = Ws.shape[:3]
            if min(Lsz, Lsy, Lsx) < 2 * M + 2 or min(Lz, Ly, Lx) < 2 * M:
                return None
            inner = Ws[M: Lsz - M, M: Lsy - M, M: Lsx - M]
            w0 = inner.reshape((-1,) + Ws.shape[3:])[0]
            if not (inner == w0).all():
                return None  # interior not translation-invariant
            if not Ws.any():
                continue
            # the ABSOLUTE surrogate weight grid as a lookup table; zeros
            # outside the dst slice make the bounds implicit
            sZ, sY, sX = surr_kdims[ko]
            T = np.zeros((sZ, sY, sX) + Ws.shape[3:])
            T[sz0:sz1, sy0:sy1, sx0:sx1] = Ws
            plan.append((ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1),
                         "table"))
            weights.append(T.astype(npdtype))

        return cls(weights=weights, bc_mask_np=flat_mask, plan=tuple(plan),
                   layout=lay, surr_dims=sdims, bs=bs)

    def _kind_dims(self, kind: int):
        """((Zr, Yr, Xr), (Zs, Ys, Xs)) real/surrogate dims of one kind."""
        lay = self.layout
        sd = self.surr_dims or (min(lay.Nx, 6), min(lay.Ny, 6),
                                min(lay.Nz, 6))
        slay = grid_layout(BoxTetMesh(*sd), lay.order)
        k, sk = lay.kinds[kind], slay.kinds[kind]
        return ((k[1][2], k[1][1], k[1][0]),
                (sk[1][2], sk[1][1], sk[1][0]))

    def _build_zones_np(self) -> None:
        """Expand every const-table term into z-zone weight fields over
        the full dst grid: (lo[3, Y, X], mid[1, Y, X], hi[3, Y, X]), or
        the full field for grids shorter than 7 planes; a [bs, bs] block
        into its bs^2 scalar (r, s) components, all-zero ones left out."""
        m = _SHELL + 1
        zone_plan = []
        zones = []
        for (ko, so, ki, si, d, _b, _c), T in self.terms():
            (Zr, Yr, Xr), _sd = self._kind_dims(ko)
            qz, qy, qx = self._clamp_maps_np(ko)
            Tn = np.asarray(T)
            for r in range(self.bs):
                for s in range(self.bs):
                    Trs = Tn[..., r, s] if self.bs > 1 else Tn
                    if not Trs.any():
                        continue
                    if Zr >= 2 * m + 1:
                        fields = (Trs[np.ix_(qz[:m], qy, qx)],
                                  Trs[np.ix_(qz[m: m + 1], qy, qx)],
                                  Trs[np.ix_(qz[Zr - m:], qy, qx)])
                    else:
                        fields = (Trs[np.ix_(qz, qy, qx)],)
                    zone_plan.append((ko, so, ki, si, d, r, s))
                    zones.append(tuple(f.copy() for f in fields))
        self.zone_plan = tuple(zone_plan)
        self.zones = tuple(zones)

    def _zone_terms_np(self):
        """The terms of a scalar multi-kind operator as the zone pack takes
        them, in plan order: ((ko, so, ki, si, d), fields) with the z-zone
        fields of a const-mode operator, or one full field (zero outside
        the dst slice) per dense-mode term."""
        if self.zones is not None:
            return [(zp[:5], z) for zp, z in zip(self.zone_plan, self.zones)]
        out = []
        for meta, W in self.terms():
            (z0, z1, y0, y1, x0, x1) = meta[5]
            _, (X, Y, Z), _ = self.layout.kinds[meta[0]]
            full = np.zeros((Z, Y, X), dtype=np.asarray(W).dtype)
            full[z0:z1, y0:y1, x0:x1] = self._dense_weight_np(meta, W)
            out.append((meta[:5], (full,)))
        return out

    def _stencil_fields_np(self):
        """The device stack of a single-kind operator: the zone fields
        (R = 7 rows) or full fields (R = Z) as [bs, D, bs, R, Y, X] (r, d,
        s; zero where the operator has no (d, r, s) term) flattened to
        [bs^2 D, R, Y, X], and the D shifts in ascending order, the
        plan's."""
        bs = self.bs
        if self.zones is not None:
            terms = [(zp[4], zp[5], zp[6], np.concatenate(z, axis=0))
                     for zp, z in zip(self.zone_plan, self.zones)]
        else:
            terms = []
            for meta, W in self.terms():
                full = self._full_field_np(meta, W).reshape(
                    self.grid_dims + (bs, bs))
                terms += [(meta[4], r, s, full[..., r, s])
                          for r in range(bs) for s in range(bs)
                          if full[..., r, s].any()]
        offsets = sorted({d for d, _, _, _ in terms})
        at = {d: i for i, d in enumerate(offsets)}
        R, Y, X = terms[0][3].shape
        F = np.zeros((bs, len(offsets), bs, R, Y, X), dtype=terms[0][3].dtype)
        for d, r, s, f in terms:
            F[r, at[d], s] = f
        return F.reshape(-1, R, Y, X), offsets

    # -- apply ------------------------------------------------------------------
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on the operator's device (one stencil launch; bs = 3:
        one launch of the three-component form, on planar vectors; P2/P3:
        one launch of the multi-kind zone kernel)."""
        if self.multi_kind:
            if self.zone_pack is None:
                raise RuntimeError("host-only operator: build it with a "
                                   "device")
            if self.zone_pack.fields.device.type == "cuda":
                return self._dia_zones(x)
            return dia_zones_apply(x, self.zone_pack)
        if self.fields is None:
            raise RuntimeError("host-only operator: build it with a device")
        if self.fields.device.type == "cuda":
            return self._stencil(x)
        if self.bs > 1:
            count("stencil.bs3")
            return stencil_apply_bs3(x, self.fields, self.offsets,
                                     self.grid_dims)
        return stencil_apply(x, self.fields, self.offsets, self.grid_dims)

    @functools.cached_property
    def _dia_zones(self):
        """The operator's prepared zone-kernel launch (pack on a card)."""
        return prepare_dia_zones(self.zone_pack)

    @functools.cached_property
    def _stencil(self):
        """The operator's prepared stencil launch (fields on a card);
        bs = 3 counts each launch as ``stencil.bs3`` and, read from its
        table (prepared with the operator), ``stencil.bs3.table``."""
        if self.bs == 1:
            return prepare_stencil(self.fields, self.offsets, self.grid_dims)
        launch = prepare_stencil_bs3(
            self.fields, self.offsets, self.grid_dims,
            table=self.__dict__.get("_stencil_table"))

        def counted(x: torch.Tensor) -> torch.Tensor:
            count("stencil.bs3")
            count("stencil.bs3.table")
            return launch(x)

        return counted

    def apply_bc_rows_zero(self, x: torch.Tensor) -> torch.Tensor:
        """cgpoisson convention for an unbaked operator: zero BC rows only
        (reference cgpoisson_problem.cpp:207)."""
        return torch.where(self.bc_mask, 0.0, self.apply(x))

    # -- host twins (numpy float64) ----------------------------------------------
    def _clamp_maps_np(self, kind: int = 0):
        m = _SHELL + 1
        (rz, ry, rx), (sz, sy, sx) = self._kind_dims(kind)
        return (_clamp_index(rz, sz, m), _clamp_index(ry, sy, m),
                _clamp_index(rx, sx, m))

    def _dense_weight_np(self, meta, W) -> np.ndarray:
        """One term's full dst-slice weight array (float64)."""
        (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
        if corrs is None:
            return np.asarray(W, dtype=np.float64)
        qz, qy, qx = self._clamp_maps_np(ko)
        full = np.asarray(W, dtype=np.float64)[np.ix_(qz, qy, qx)]
        return full[z0:z1, y0:y1, x0:x1]

    def _full_field_np(self, meta, W) -> np.ndarray:
        """One term's weight field over the whole grid (zero outside the
        dst slice; [.., bs, bs] blocks for bs > 1), in the weights' dtype
        — the K2 weight form."""
        (z0, z1, y0, y1, x0, x1) = meta[5]
        full = np.zeros(self.grid_dims + np.shape(W)[3:],
                        dtype=np.asarray(W).dtype)
        full[z0:z1, y0:y1, x0:x1] = self._dense_weight_np(meta, W)
        return full

    def diagonal_np(self) -> np.ndarray:
        """The matrix diagonal, float64, in the operator's layout."""
        lay = self.layout
        bs = self.bs
        outs = [np.zeros((k[1][2], k[1][1], k[1][0], k[2], bs))
                for k in lay.kinds]
        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
            if (ko, so, d) != (ki, si, (0, 0, 0)):
                continue
            Wn = self._dense_weight_np(meta, W)
            if bs > 1:
                Wn = np.diagonal(Wn, axis1=-2, axis2=-1)
            else:
                Wn = Wn[..., None]
            outs[ko][z0:z1, y0:y1, x0:x1, so, :] += Wn
        d = np.concatenate([o.reshape(-1, bs) for o in outs]).reshape(-1)
        return to_planar(d, bs) if self.planar else d

    def to_scipy(self):
        """The operator as a scipy CSR matrix (float64, the interleaved
        dof order whatever the layout).  Scalar P1: one dof kind and one
        term per shift diagonal, so col = row + constant shift and the CSR
        comes out sorted without a dedup pass; P2/P3 and bs = 3: triplets
        per term (and (r, s) component) through scipy's COO."""
        import scipy.sparse as sp
        lay = self.layout
        if self.multi_kind or self.bs > 1:
            return self._to_scipy_kinds(sp)
        plan = list(self.terms())
        shifts_seen = [meta[4] for meta, _ in plan]
        if len(set(shifts_seen)) != len(shifts_seen):
            raise ValueError("to_scipy needs one term per shift diagonal")
        _, (X, Y, Z), _ = lay.kinds[0]
        n = lay.ndofs
        order = sorted(range(len(plan)),
                       key=lambda i: (plan[i][0][4][2] * Y
                                      + plan[i][0][4][1]) * X
                       + plan[i][0][4][0])
        D = len(order)
        V = np.zeros((n, D))
        keep = np.zeros((n, D), dtype=bool)
        shifts = np.empty(D, dtype=np.int64)
        f3 = np.zeros((Z, Y, X))
        m3 = np.zeros((Z, Y, X), dtype=bool)
        for k, i in enumerate(order):
            meta, W = plan[i]
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), _) = meta
            shifts[k] = (d[2] * Y + d[1]) * X + d[0]
            f3[...] = 0.0
            f3[z0:z1, y0:y1, x0:x1] = self._dense_weight_np(meta, W)
            V[:, k] = f3.reshape(-1)
            m3[...] = False
            m3[z0:z1, y0:y1, x0:x1] = True
            keep[:, k] = m3.reshape(-1)
        keep &= V != 0.0  # eliminate_zeros semantics
        counts = keep.sum(axis=1)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        cols = (np.arange(n, dtype=np.int64)[:, None]
                + shifts[None, :])[keep].astype(np.int32)
        return sp.csr_matrix((V[keep], cols, indptr), shape=(n, n))

    def _to_scipy_kinds(self, sp):
        """Triplet export of a multi-kind or blocked operator (tpufem's
        general ``to_scipy`` path, with scipy's COO -> CSR in place of
        its native helper)."""
        lay = self.layout
        kinds = lay.kinds
        bs = self.bs

        def flat_nodes(kind, slot, z0, z1, y0, y1, x0, x1):
            b, (X, Y, Z), s = kinds[kind]
            z, y, x = np.meshgrid(np.arange(z0, z1), np.arange(y0, y1),
                                  np.arange(x0, x1), indexing="ij")
            return b + ((z * Y + y) * X + x) * s + slot

        rows_l, cols_l, vals_l = [], [], []
        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), _) = meta
            rr = flat_nodes(ko, so, z0, z1, y0, y1, x0, x1).ravel()
            cc = flat_nodes(ki, si, z0 + d[2], z1 + d[2], y0 + d[1],
                            y1 + d[1], x0 + d[0], x1 + d[0]).ravel()
            Wn = self._dense_weight_np(meta, W)
            if bs == 1:
                rows_l.append(rr)
                cols_l.append(cc)
                vals_l.append(Wn.ravel())
                continue
            for r in range(bs):
                for s in range(bs):
                    w = Wn[..., r, s]
                    if w.any():
                        rows_l.append(rr * bs + r)
                        cols_l.append(cc * bs + s)
                        vals_l.append(w.ravel())
        n = lay.ndofs * bs
        A = sp.coo_matrix((np.concatenate(vals_l),
                           (np.concatenate(rows_l), np.concatenate(cols_l))),
                          shape=(n, n)).tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        return A

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Host float64 twin of ``apply`` (setup-phase spectral estimates,
        certification), in the operator's layout (planar through the
        interleaved twin, tpufem/fem/dia_op.py:709-717)."""
        bs = self.bs
        if self.planar:
            return to_planar(self._apply_interleaved_np(
                to_interleaved(x, bs)), bs)
        return self._apply_interleaved_np(x)

    def _apply_interleaved_np(self, x: np.ndarray) -> np.ndarray:
        lay = self.layout
        bs = self.bs
        xr = x.reshape(-1, bs)
        grids = [xr[b: b + X * Y * Z * s].reshape(Z, Y, X, s, bs)
                 for b, (X, Y, Z), s in lay.kinds]
        outs = [np.zeros_like(g) for g in grids]
        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
            Wn = self._dense_weight_np(meta, W)
            src = grids[ki][z0 + d[2]: z1 + d[2], y0 + d[1]: y1 + d[1],
                            x0 + d[0]: x1 + d[0], si]
            if bs == 1:
                outs[ko][z0:z1, y0:y1, x0:x1, so, 0] += Wn * src[..., 0]
            else:
                outs[ko][z0:z1, y0:y1, x0:x1, so, :] += np.einsum(
                    "...rs,...s->...r", Wn, src)
        return np.concatenate([o.reshape(-1, bs) for o in outs]).reshape(-1)


def build_operator(mesh: BoxTetMesh, order: int, problem: str,
                   bc_dofs: Optional[np.ndarray] = None,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None,
                   bake_bc: bool = True, planar: bool = False):
    """The structured operator (tpufem/fem/dia_op.py:741-775):

    - P1: the DIA stencil (const zone form on lattices with >= 6 cubes
      per axis, dense below), scalar or bs = 3 (``planar`` selects the
      component-planar layout);
    - P2/P3 scalar: the const-table DIA across all typed dof grids, or
      the per-perm StructuredOperator when the lattice is too small for
      the shell reconstruction;
    - P2/P3 elasticity: the blocked (bs = 3) StructuredOperator (tpufem
      has no blocked const DIA form), ``planar`` as at P1.
    """
    if order == 1:
        return DiaOperator.build(mesh, order, problem, bc_dofs=bc_dofs,
                                 dtype=dtype, device=device, bake_bc=bake_bc,
                                 planar=planar)
    if problem == "elasticity":
        return StructuredOperator.build(mesh, order, problem, bc_dofs=bc_dofs,
                                        dtype=dtype, device=device,
                                        planar=planar)
    if planar:
        raise ValueError("planar layout is implemented for bs = 3 "
                         "operators only")
    if order in (2, 3):
        op = DiaOperator.try_const(mesh, order, problem, bc_dofs=bc_dofs,
                                   dtype=dtype, bake_bc=bake_bc,
                                   device=device)
        if op is not None:
            return op
    return StructuredOperator.build(mesh, order, problem, bc_dofs=bc_dofs,
                                    dtype=dtype, device=device)
