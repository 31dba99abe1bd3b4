"""Channel-plane P2/P3 stencil operator (counterpart of
tpufem/fem/flat_op.py), with the CUDA kernel of TPU kernel K5.

The const-table DiaOperator's matrix on a plane buffer ``[Zp, CP, LW]``:
buffer plane ``bp = 1 + z`` (planes 0 and > Zc are a zero halo), channel
``c`` (every (kind, slot) typed dof grid, padded to CP, a multiple of 8),
lane ``G + (1 + y) * Xp + 1 + x`` (the zero-padded (y, x) plane flattened
behind a 128-lane guard), so a lattice shift (dx, dy, dz) is (plane
offset dz, lane offset dy * Xp + dx).  The apply is tpufem's, value for
value in its tables:

- the interior: per buffer plane, the stacked weights
  ``WT_bp = W0 (+ AZT[slot_of[bp - 1]] on the 7 z-boundary planes)``
  [CP, K = D * CP] times the D shifted source blocks [K, TILE];
- the corrections: the face, edge and corner deviations of every term as
  six slab einsums (O(surface) data), summed into a zeroed canvas;
- ``(interior + corrections) * fmask``, so pad and guard lanes, pad
  channels and halo planes are exactly zero and buffer dots equal dof
  dots through a channel-resident CG.

The tables are float32 whatever the problem's dtype, as tpufem's are:
``to_flat`` casts to the tables' dtype and ``apply`` casts back.

- ``interior`` (K5, replaces ``FlatOperator._interior_pallas``,
  tpufem/fem/flat_op.py:308): csrc/flat_interior.cu on a CUDA tensor,
  the plain PyTorch version ``interior_plain`` on a CPU tensor.  A CUDA
  tensor launches the kernel or raises; nothing falls back.  Launches
  are counted in ``FlatOperator.interior.launches``.  The kernel works
  through the nonzero weights only (``sparse_plan``); the plain version
  stays the dense product.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.structured_op import GridLayout

_GUARD = 128   # left lane guard >= max |in-plane shift| (dy * Xp + dx)
_W = 3         # deviation width per axis end (clamp-map shell)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


class FlatSparsePlan(NamedTuple):
    """The nonzero weights of the interior product, CSR by output
    channel: channel ``co`` owns entries ``ptr[co]:ptr[co + 1]``, in
    ascending ``k`` (= shift slot j * CP + source channel ci)."""

    ptr: np.ndarray      # [CP + 1] int32
    k: np.ndarray        # [nnz] int32
    ent: np.ndarray      # [nnz, 2] int32: (source row (dz + 1) * CP + ci,
    #                      lane offset dy * Xp + dx)
    vals: torch.Tensor   # [1 + NZP, nnz]: row 0 W0, row 1 + s W0 + AZT[s]


class FlatGeom(NamedTuple):
    """Static geometry; the same tuple as tpufem's ``meta[0]``."""

    C: int
    CP: int
    D: int
    shifts: Tuple
    Zc: int
    Yc: int
    Xc: int
    Yp: int
    Xp: int
    PF: int
    TILE: int
    LW: int
    KP: int
    ZB: int
    Zp: int
    K: int
    PZ: Tuple
    NS: int
    kdims: Tuple


# the six corrections of tpufem's _corrections (flat_op.py:466-475): the
# table field, the einsum, and which axes are slabs (z at the PZ planes,
# y and x at the _W + (_W + 1) rows by each end); the einsum's output is
# [nz, C, ny, nx] over the dst rows of its slab axes
_CORR = (("TY", "doia,dziax->zoax", (False, True, False)),
         ("TX", "doia,dziya->zoya", (False, False, True)),
         ("BYZ", "doipa,dpiax->poax", (True, True, False)),
         ("BZX", "doipa,dpiya->poya", (True, False, True)),
         ("BYX", "doiab,dziab->zoab", (False, True, True)),
         ("CC", "doipab,dpiab->poab", (True, True, True)))

_TABLES = ("W0", "AZT", "TY", "TX", "BYZ", "BZX", "BYX", "CC", "fmask")


@dataclasses.dataclass
class FlatOperator:
    """Channel-plane const-stencil matrix (scalar P2/P3 cube path)."""

    W0: torch.Tensor        # [CP, K] stacked interior weights
    AZT: torch.Tensor       # [NZP, CP, K] per-boundary-plane deltas
    slot_of: torch.Tensor   # [1, ZB] int32: plane -> AZT slot or -1
    TY: torch.Tensor        # [D, C, C, NS] y-face profiles
    TX: torch.Tensor        # [D, C, C, NS] x-face profiles
    BYZ: torch.Tensor       # [D, C, C, NZP, NS] (z, y) edge terms
    BZX: torch.Tensor       # [D, C, C, NZP, NS] (z, x)
    BYX: torch.Tensor       # [D, C, C, NS, NS] (y, x)
    CC: torch.Tensor        # [D, C, C, NZP, NS, NS] corner residual
    fmask: torch.Tensor     # [Zp, CP, LW] channel-extent mask
    geom: FlatGeom
    channels: Tuple         # per channel (kind, slot)
    layout: GridLayout

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator,
                 device: torch.device = torch.device("cpu")
                 ) -> Optional["FlatOperator"]:
        """Build from a const-mode scalar DiaOperator, or None when the
        structure does not fit (a kind dimension under 8, or a shift
        beyond 1): tpufem's ``from_dia`` (flat_op.py:126-261)."""
        if not dia.is_const():
            return None
        lay = dia.layout
        channels = []
        kdims = []
        for kind, (base, (X, Y, Z), s) in enumerate(lay.kinds):
            for slot in range(s):
                channels.append((kind, slot))
            kdims.append((Z, Y, X))
        C = len(channels)
        chan_of = {ks: c for c, ks in enumerate(channels)}
        Zc = max(d[0] for d in kdims)
        Yc = max(d[1] for d in kdims)
        Xc = max(d[2] for d in kdims)
        if min(min(d) for d in kdims) < 2 * _W + 2:
            return None
        shifts = sorted({m[4] for m in dia.plan})
        if any(max(abs(c) for c in d) > 1 for d in shifts):
            return None
        D = len(shifts)
        dslot = {d: j for j, d in enumerate(shifts)}

        CP = _rup(C, 8)
        Yp, Xp = Yc + 2, Xc + 2
        PF = Yp * Xp
        TILE = _rup(PF, 128)
        LW = _GUARD + TILE + 128
        KP = 2
        ZB = _rup(Zc, KP)
        Zp = ZB + 2
        K = D * CP
        PZ = sorted({0, 1, 2, Zc - 4, Zc - 3, Zc - 2, Zc - 1})
        NZP = len(PZ)
        NS = 2 * _W + 1  # per-axis slab slots: _W lo + (_W + 1) hi

        W0 = np.zeros((CP, K), dtype=np.float32)
        AZT = np.zeros((NZP, CP, K), dtype=np.float32)
        TY = np.zeros((D, C, C, NS), dtype=np.float32)
        TX = np.zeros((D, C, C, NS), dtype=np.float32)
        BYZ = np.zeros((D, C, C, NZP, NS), dtype=np.float32)
        BZX = np.zeros((D, C, C, NZP, NS), dtype=np.float32)
        BYX = np.zeros((D, C, C, NS, NS), dtype=np.float32)
        CC = np.zeros((D, C, C, NZP, NS, NS), dtype=np.float32)
        # slab slot -> real axis index (hi slots anchored at the COMMON hi
        # window; per-channel short axes leave unused slots at 0, and
        # fmask masks invalid rows)
        ys = ([(s_, s_) for s_ in range(_W)]
              + [(_W + t, Yc - 1 - _W + t) for t in range(_W + 1)])
        xs = ([(s_, s_) for s_ in range(_W)]
              + [(_W + t, Xc - 1 - _W + t) for t in range(_W + 1)])
        zs = list(enumerate(PZ))

        for (ko, so, ki, si, d, _b, _c), T in dia.terms():
            co = chan_of[(ko, so)]
            ci = chan_of[(ki, si)]
            j = dslot[d]
            Zk, Yk, Xk = kdims[ko]
            qz, qy, qx = dia._clamp_maps_np(ko)
            Tn = np.asarray(T, dtype=np.float64)
            mz, my, mx = qz[Zk // 2], qy[Yk // 2], qx[Xk // 2]
            w0 = Tn[mz, my, mx]
            Az = Tn[qz, my, mx] - w0                      # [Zk]
            Ay = Tn[mz, qy, mx] - w0                      # [Yk]
            Ax = Tn[mz, my, qx] - w0                      # [Xk]
            W0[co, j * CP + ci] = w0
            for s_, p in enumerate(PZ):
                if p < Zk:
                    AZT[s_, co, j * CP + ci] = Az[p]
            for sy, y in ys:
                if 0 <= y < Yk:
                    TY[j, co, ci, sy] = Ay[y]
            for sx, x in xs:
                if 0 <= x < Xk:
                    TX[j, co, ci, sx] = Ax[x]
            for sz, z in zs:
                if not (0 <= z < Zk):
                    continue
                for sy, y in ys:
                    if 0 <= y < Yk:
                        BYZ[j, co, ci, sz, sy] = (
                            Tn[qz[z], qy[y], mx] - w0 - Az[z] - Ay[y])
                for sx, x in xs:
                    if 0 <= x < Xk:
                        BZX[j, co, ci, sz, sx] = (
                            Tn[qz[z], my, qx[x]] - w0 - Az[z] - Ax[x])
            for sy, y in ys:
                if not (0 <= y < Yk):
                    continue
                for sx, x in xs:
                    if 0 <= x < Xk:
                        BYX[j, co, ci, sy, sx] = (
                            Tn[mz, qy[y], qx[x]] - w0 - Ay[y] - Ax[x])
            for sz, z in zs:
                if not (0 <= z < Zk):
                    continue
                for sy, y in ys:
                    if not (0 <= y < Yk):
                        continue
                    for sx, x in xs:
                        if 0 <= x < Xk:
                            CC[j, co, ci, sz, sy, sx] = (
                                Tn[qz[z], qy[y], qx[x]] - w0
                                - Az[z] - Ay[y] - Ax[x]
                                - BYZ[j, co, ci, sz, sy]
                                - BZX[j, co, ci, sz, sx]
                                - BYX[j, co, ci, sy, sx])

        slot_of = np.full((1, ZB), -1, dtype=np.int32)
        for s_, p in enumerate(PZ):
            slot_of[0, p] = s_

        fmask = np.zeros((Zp, CP, LW), dtype=np.float32)
        for c, (kind, slot) in enumerate(channels):
            Zk, Yk, Xk = kdims[kind]
            for y in range(Yk):
                r0 = _GUARD + (1 + y) * Xp + 1
                fmask[1:1 + Zk, c, r0:r0 + Xk] = 1.0

        geom = FlatGeom(C, CP, D, tuple(shifts), Zc, Yc, Xc, Yp, Xp, PF, TILE,
                        LW, KP, ZB, Zp, K, tuple(PZ), NS, tuple(kdims))
        t = {k: torch.from_numpy(v).to(device) for k, v in dict(
            W0=W0, AZT=AZT, slot_of=slot_of, TY=TY, TX=TX, BYZ=BYZ, BZX=BZX,
            BYX=BYX, CC=CC, fmask=fmask).items()}
        return cls(**t, geom=geom, channels=tuple(channels), layout=lay)

    @property
    def device(self) -> torch.device:
        return self.W0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.W0.dtype

    def astype(self, dtype: torch.dtype) -> "FlatOperator":
        """The same operator with its float tables cast to ``dtype``."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dtype) for k in _TABLES})

    # -- layout conversion --------------------------------------------------------
    def to_flat(self, u: torch.Tensor) -> torch.Tensor:
        """[ndofs] -> [Zp, CP, LW] zero-padded plane buffer in the tables'
        dtype (once per solve; the CG loop stays channel-resident)."""
        g = self.geom
        canvas = torch.zeros((g.Zp, g.CP, g.Yp, g.Xp), dtype=self.dtype,
                             device=u.device)
        grids = self.layout.split(u.to(self.dtype).reshape(-1, 1))
        for c, (kind, slot) in enumerate(self.channels):
            Zk, Yk, Xk = g.kdims[kind]
            canvas[1:1 + Zk, c, 1:1 + Yk, 1:1 + Xk] = grids[kind][..., slot, 0]
        out = torch.zeros((g.Zp, g.CP, g.LW), dtype=self.dtype,
                          device=u.device)
        out[:, :, _GUARD:_GUARD + g.PF] = canvas.reshape(g.Zp, g.CP, g.PF)
        return out

    def from_flat(self, yf: torch.Tensor) -> torch.Tensor:
        g = self.geom
        view = yf[:, :, _GUARD:_GUARD + g.PF].reshape(g.Zp, g.CP, g.Yp, g.Xp)
        chan_of = {ks: c for c, ks in enumerate(self.channels)}
        outs = []
        for kind, (base, (X, Y, Z), s) in enumerate(self.layout.kinds):
            cols = [view[1:1 + Z, chan_of[(kind, slot)], 1:1 + Y, 1:1 + X]
                    for slot in range(s)]
            outs.append(cols[0].reshape(-1) if s == 1
                        else torch.stack(cols, dim=-1).reshape(-1))
        return torch.cat(outs)

    # -- apply --------------------------------------------------------------------
    def apply_flat(self, x: torch.Tensor) -> torch.Tensor:
        """[Zp, CP, LW] -> [Zp, CP, LW]: ``(interior + corrections) *
        fmask``, in place on the interior's fresh output."""
        y = self.interior(x)
        y += self.corrections(x)
        y *= self.fmask
        return y

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Flat dof-vector apply (tests / drop-in use; the CG loop runs
        channel-resident through ``apply_flat``)."""
        return self.from_flat(self.apply_flat(self.to_flat(u))).to(u.dtype)

    # -- interior (K5) --------------------------------------------------------------
    def _check_flat(self, x: torch.Tensor) -> None:
        g = self.geom
        if tuple(x.shape) != (g.Zp, g.CP, g.LW):
            raise ValueError(f"plane buffer of shape {tuple(x.shape)}, "
                             f"expected {(g.Zp, g.CP, g.LW)}")
        if x.dtype != self.dtype or x.device != self.device:
            raise TypeError(f"plane buffer {x.dtype}@{x.device} does not "
                            f"match the operator {self.dtype}@{self.device}")
        if not x.is_contiguous():
            raise ValueError("plane buffer must be contiguous")

    def interior(self, x: torch.Tensor) -> torch.Tensor:
        """The interior product of every buffer plane (see
        ``interior_plain``).  A CPU tensor takes the plain version; a CUDA
        tensor launches the K5 kernel (counted in
        ``FlatOperator.interior.launches``)."""
        self._check_flat(x)
        if x.device.type == "cpu":
            return self.interior_plain(x)
        if x.device.type != "cuda":
            raise RuntimeError(f"no flat interior kernel for {x.device}")
        return self._launch_interior(x)

    @functools.cached_property
    def shift_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dz, lane offset dy * Xp + dx) per shift slot j, int32."""
        g = self.geom
        dz = np.array([d[2] for d in g.shifts], dtype=np.int32)
        off = np.array([d[1] * g.Xp + d[0] for d in g.shifts], dtype=np.int32)
        return dz, off

    def plane_weights(self) -> torch.Tensor:
        """WT [Zc, CP, K]: W0, plus AZT[slot] on planes with a slot."""
        g = self.geom
        slot = self.slot_of[0, :g.Zc].long()
        delta = self.AZT[slot.clamp(min=0)]
        return self.W0 + torch.where((slot >= 0)[:, None, None], delta,
                                     torch.zeros_like(delta))

    def shift_stack(self, x: torch.Tensor) -> torch.Tensor:
        """S [Zc, K, TILE]: S[z, j * CP + ci, l] = x[clip(1 + z + dz_j, 0,
        Zp - 1), ci, G + off_j + l]."""
        g = self.geom
        dz, off = (torch.from_numpy(a).to(x.device) for a in self.shift_tables)
        zi = (1 + torch.arange(g.Zc, device=x.device)[:, None]
              + dz[None, :]).clamp(0, g.Zp - 1)                # [Zc, D]
        lane = (_GUARD + off[:, None]
                + torch.arange(g.TILE, device=x.device)[None, :])  # [D, TILE]
        ci = torch.arange(g.CP, device=x.device)
        S = x[zi[:, :, None, None], ci[None, None, :, None],
              lane[None, :, None, :]]                    # [Zc, D, CP, TILE]
        return S.reshape(g.Zc, g.K, g.TILE)

    def interior_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of K5, the Pallas kernel's semantics: for
        buffer plane 1 <= bp <= Zc, ``y[bp, :, G:G + TILE] = WT_bp @
        S_bp`` (halo lanes of the tile included); every other plane and
        the guard lanes are zero."""
        g = self.geom
        y = torch.zeros_like(x)
        y[1:1 + g.Zc, :, _GUARD:_GUARD + g.TILE] = torch.bmm(
            self.plane_weights(), self.shift_stack(x))
        return y

    @functools.cached_property
    def sparse_plan(self) -> FlatSparsePlan:
        """The union of the nonzero positions of W0 and of every AZT
        slot, with the weights of every plane variant summed in the
        tables' dtype (what a dense kernel would sum per plane).
        Ascending k within a channel is the order of a dense k loop, so
        a kernel that skips the zeros gives the dense loop's bits."""
        g = self.geom
        mask = ((self.W0 != 0) | (self.AZT != 0).any(dim=0)).cpu().numpy()
        co, k = np.nonzero(mask)             # row-major: k ascends per co
        ptr = np.zeros(g.CP + 1, dtype=np.int32)
        ptr[1:] = np.cumsum(mask.sum(axis=1))
        dz, off = self.shift_tables
        j, ci = np.divmod(k, g.CP)
        ent = np.stack([(dz[j] + 1) * g.CP + ci, off[j]], axis=1)
        variants = torch.cat([self.W0[None], self.W0[None] + self.AZT])
        idx = (torch.from_numpy(co).to(self.device),
               torch.from_numpy(k).to(self.device))
        return FlatSparsePlan(ptr, k.astype(np.int32), ent.astype(np.int32),
                              variants[:, idx[0], idx[1]].contiguous())

    def _prepare_interior(self, lanes: int = 0):
        """A launcher ``x -> y`` of the K5 kernel with everything that
        does not change between calls (shapes, plan tables, the entry
        point) packed once; a call passes x, y and the stream.  A block
        covers 32 * ``lanes`` lanes (2 or 4; 0: the launch chooses by the
        shared memory a block needs)."""
        from tpufem_torch import _build
        lib = _build.load().lib
        g = self.geom
        plan = self.sparse_plan
        fn = (lib.tpufem_flat_interior_f32 if self.dtype == torch.float32
              else lib.tpufem_flat_interior_f64)
        ptr = torch.from_numpy(plan.ptr).to(self.device)
        ent = torch.from_numpy(plan.ent).to(self.device)
        halo = int(np.abs(plan.ent[:, 1]).max(initial=0))
        args = _build.FlatLaunch(
            ptr=ptr.data_ptr(), ent=ent.data_ptr(), val=plan.vals.data_ptr(),
            slot_of=self.slot_of.data_ptr(), device=self.device.index,
            CP=g.CP, Zc=g.Zc, Zp=g.Zp, LW=g.LW, TILE=g.TILE, G=_GUARD,
            halo=halo, nnz=len(plan.k), nvar=plan.vals.shape[0], lanes=lanes)
        addr = ctypes.addressof(args)
        # what ``addr`` and the pointers packed in it point into
        keep = (args, ptr, ent, plan, self.slot_of)
        what = f"flat_interior on [{g.Zp}, {g.CP}, {g.LW}]"
        raw_stream = _build.raw_stream_getter()
        index = self.device.index

        def launch(x: torch.Tensor) -> torch.Tensor:
            y = torch.empty_like(x)
            rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
            if rc != 0:
                _build.raise_on(lib, rc, what)
            FlatOperator.interior.launches += 1
            return y

        launch.keep = keep
        return launch

    @functools.cached_property
    def _launch_interior(self):
        return self._prepare_interior()

    # -- slab corrections -----------------------------------------------------------
    def corrections(self, x: torch.Tensor) -> torch.Tensor:
        """Face/edge/corner deviation terms (tpufem's ``_corrections``,
        flat_op.py:417-524): per correction one gather of its slab
        sources from the plane buffer, one einsum, and one index_add_ of
        the result into a zeroed [Zp, CP, LW] canvas, in tpufem's order.
        Within one correction no two entries share a destination, so the
        sum at every position adds the six in tpufem's order."""
        xf = x.reshape(-1)
        out = torch.zeros_like(xf)
        for (name, eq, _), (src, dst, shape) in zip(_CORR, self._corr_index):
            s = xf.index_select(0, src).view(shape)
            out.index_add_(0, dst, torch.einsum(eq, getattr(self, name),
                                                s).reshape(-1))
        return out.view(x.shape)

    @functools.cached_property
    def _corr_index(self):
        """Per correction (gather index into the buffer, scatter index of
        its einsum output, the gathered [D, nz, C, ny, nx] shape), int32
        on the operator's device, built once."""
        return _corr_indices(self.geom, self.device)


FlatOperator.interior.launches = 0


def _corr_indices(g: FlatGeom, device: torch.device):
    """Flat buffer indices of every correction's slab sources (src[d, z,
    ci, y, x] = x[1 + z + dz_d, ci, lane of (y + dy_d, x + dx_d)]) and of
    its output rows (dst[z, co, y, x]), over the rows of each axis: all
    of them, or the slab rows (z at PZ, y and x at _W by the lo end and
    _W + 1 by the hi end)."""
    w = _W
    full = (np.arange(g.Zc), np.arange(g.Yc), np.arange(g.Xc))
    slab = (np.asarray(g.PZ), np.r_[0:w, g.Yc - 1 - w:g.Yc],
            np.r_[0:w, g.Xc - 1 - w:g.Xc])
    sh = np.asarray(g.shifts)                       # [D, (dx, dy, dz)]
    dx, dy, dz = (sh[:, k].reshape(-1, 1, 1, 1, 1) for k in range(3))
    ci = np.arange(g.C).reshape(1, 1, -1, 1, 1)

    def lane_index(z, c, y, x):
        return ((1 + z) * g.CP + c) * g.LW + _GUARD + (1 + y) * g.Xp + 1 + x

    out = []
    for _, _, slabs in _CORR:
        zr, yr, xr = (s if on else f for s, f, on in zip(slab, full, slabs))
        z = zr.reshape(1, -1, 1, 1, 1)
        y = yr.reshape(1, 1, 1, -1, 1)
        x = xr.reshape(1, 1, 1, 1, -1)
        shape = (g.D, len(zr), g.C, len(yr), len(xr))
        src = lane_index(z + dz, ci, y + dy, x + dx)
        dst = np.broadcast_to(lane_index(z, ci, y, x)[0], shape[1:])
        out.append(tuple(torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32).reshape(-1)).to(device)
            for a in (src, dst)) + (shape,))
    return tuple(out)
