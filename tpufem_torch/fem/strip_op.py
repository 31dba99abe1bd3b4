"""Channel-strip P2/P3 stencil operator (counterpart of
tpufem/fem/strip_op.py), with the CUDA kernels of TPU kernels K3 and K4.

The const-table DiaOperator's matrix is evaluated on a channel-resident
buffer ``[C, Zp, LW]``: every (kind, slot) typed dof grid is one channel
``c``; per channel the z-planes are rows and the zero-padded (y, x)
plane, flattened and led by a 128-lane guard, is the lane axis, so a
lattice shift (dx, dy, dz) is (row offset dz, lane offset dy * Xp + dx).
Every row is 128 values wide (aligned, coalesced loads), and the
layout, ``to_strips`` and ``from_strips`` are tpufem's, value for value.

The apply is the kernel form of tpufem's ``_apply_pallas``: per output
channel co, the sum over its mid terms of ``mid[mi] * x[ci, z+dz,
lane+off]`` over the channel's whole z range, plus sparse delta rows
where a z-boundary plane deviates from the mid strip (lo/hi minus mid).
A term whose grid is too short for z-zones (under 7 planes, tpufem's
"full" mode, where tpufem has no kernel plan and runs its XLA twin) is
written as a zero mid strip (left out) plus one delta row per nonzero
plane: the same matrix, so every operator has a kernel plan.

Pad, guard and out-of-extent planes are exactly zero in every output,
so CG runs on the padded buffer and buffer dots equal dof dots.

- ``apply_strips`` (K3, replaces ``StripOperator._apply_pallas``,
  tpufem/fem/strip_op.py:300): csrc/strip_apply.cu on a CUDA tensor, the
  plain PyTorch version ``apply_strips_plain`` on a CPU tensor.  A block
  of the kernel owns 32 lanes of every channel for a run of z planes
  (``apply_runs``), and its warps draw (channel, 4 planes) units,
  heaviest channel first (``apply_order``); what a launch needs beside
  x, y and the stream is packed once per operator (``_launch_apply``);
- ``cg_resident`` (K4, replaces ``StripOperator.cg_pallas``,
  strip_op.py:434): the whole Chronopoulos-Gear CG as one cooperative
  kernel (csrc/strip_cg.cu) on a CUDA tensor, the plain version
  ``cg_resident_plain`` on a CPU tensor.  The kernel cuts the buffer's
  body into bricks (``cg_bricks``) that its blocks own for the whole
  solve.

A CUDA tensor launches the kernel or raises; nothing falls back.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.structured_op import GridLayout, np_dtype

_GUARD = 128  # left lane guard >= max |in-plane shift| (|dy| * Xp + |dx|)
_M = 3        # z-zone shell width (dia_op._SHELL + 1)
CG_RESIDENT_LIMIT = 14 * 2**20  # tpufem's whole-CG residency gate (bytes)
# a brick of the whole-CG kernel: all channels of 2 z-planes over 32 lanes
# (csrc/strip_cg.cu's kBrickPlanes, kBrickLanes)
_CG_BRICK_LANES, _CG_BRICK_PLANES = 32, 2
# a block of the apply kernel: 32 lanes of all channels over a z run of at
# most 8 planes, worked off in units of 4 planes (csrc/strip_apply.cu's
# kLanes, kRun, kGroup); 227 KB of shared memory a block (sm_90)
_APPLY_LANES, _APPLY_RUN = 32, 8
_MAX_SMEM = 232448


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass
class StripOperator:
    """Channel-strip const-stencil matrix (scalar P2/P3 cube path).

    ``mid_pack`` [NT, TILE] holds the mid strips, ``dlt_pack`` [ND, TILE]
    the delta rows (at least one row, zero when there is none).
    ``kplan[co] = (mid entries (mi, ci, dz, off), delta entries (di, row,
    ci, dz, off))`` is the per-output-channel plan; ``tables`` the same
    as device int32 CSR tables (see ``_tables``)."""

    mid_pack: torch.Tensor
    dlt_pack: torch.Tensor
    kplan: Tuple
    layout: GridLayout
    channels: Tuple          # per channel (kind, slot)
    kdims: Tuple             # per kind (Z, Y, X)
    dims: Tuple              # (C, Zc, Yp, Xp, PF, TILE, LW, Zp)
    bc_mask: np.ndarray      # flat BC mask of the underlying matrix
    tables: Tuple[torch.Tensor, ...]

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")
                 ) -> Optional["StripOperator"]:
        """Build from a const-mode scalar DiaOperator, or None when the
        structure does not fit (non-const, or in-plane shifts beyond the
        lane guard)."""
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
        Yp, Xp = Yc + 2, Xc + 2
        if any(abs(d[4][1]) * Xp + abs(d[4][0]) > _GUARD
               or abs(d[4][2]) > 1 for d in dia.plan):
            return None
        PF = Yp * Xp
        TILE = _rup(PF, 128)
        LW = _GUARD + TILE + 128
        Zp = Zc + 2
        npdt = np_dtype(dtype)

        mids: List[np.ndarray] = []
        dlts: List[np.ndarray] = []
        kmid = [[] for _ in range(C)]   # per co: (mi, ci, dz, off)
        kdlt = [[] for _ in range(C)]   # per co: (di, row, ci, dz, off)
        for term_meta, T in dia.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), _c) = term_meta
            co = chan_of[(ko, so)]
            ci = chan_of[(ki, si)]
            Zk, Yk, Xk = kdims[ko]
            off = d[1] * Xp + d[0]
            # full dst-grid weight field, zero outside the slice bounds
            # (exactly dia._dense_weight_np's reconstruction)
            F = np.zeros((Zk, Yk, Xk))
            F[z0:z1, y0:y1, x0:x1] = dia._dense_weight_np(term_meta, T)
            if not F.any():
                continue

            def embed(planes: np.ndarray) -> np.ndarray:
                """[nz, Yk, Xk] -> lane strips [nz, TILE] at (1 + y, 1 + x)."""
                nz = planes.shape[0]
                canvas = np.zeros((nz, Yp, Xp))
                canvas[:, 1:1 + Yk, 1:1 + Xk] = planes
                out = np.zeros((nz, TILE), dtype=npdt)
                out[:, :PF] = canvas.reshape(nz, PF)
                return out

            if Zk >= 2 * _M + 1:
                # mid-zone constancy in z follows from the clamp maps;
                # checked so a violation can never give a wrong operator
                mid = F[_M: Zk - _M]
                if not (mid == mid[:1]).all():
                    return None
                lo_s, mid_s, hi_s = (embed(F[:_M]), embed(F[_M: _M + 1]),
                                     embed(F[Zk - _M:]))
                kmid[co].append((len(mids), ci, d[2], off))
                mids.append(mid_s[0])
                for r in range(_M):
                    if not np.array_equal(lo_s[r], mid_s[0]):
                        kdlt[co].append((len(dlts), r, ci, d[2], off))
                        dlts.append(lo_s[r] - mid_s[0])
                    if not np.array_equal(hi_s[r], mid_s[0]):
                        kdlt[co].append((len(dlts), Zk - _M + r, ci,
                                         d[2], off))
                        dlts.append(hi_s[r] - mid_s[0])
            else:
                # a short grid: zero mid strip, one delta row per plane
                full = embed(F)
                for r in range(Zk):
                    if full[r].any():
                        kdlt[co].append((len(dlts), r, ci, d[2], off))
                        dlts.append(full[r])

        kplan = tuple((tuple(kmid[c]), tuple(kdlt[c])) for c in range(C))
        mid_pack = np.stack(mids) if mids else np.zeros((1, TILE), npdt)
        dlt_pack = np.stack(dlts) if dlts else np.zeros((1, TILE), npdt)
        dims = (C, Zc, Yp, Xp, PF, TILE, LW, Zp)
        zk = [kdims[kind][0] for kind, _ in channels]
        return cls(mid_pack=torch.from_numpy(mid_pack).to(device),
                   dlt_pack=torch.from_numpy(dlt_pack).to(device),
                   kplan=kplan, layout=lay, channels=tuple(channels),
                   kdims=tuple(kdims), dims=dims,
                   bc_mask=np.asarray(dia.bc_mask_np),
                   tables=_tables(kplan, zk, Zc, device))

    @property
    def device(self) -> torch.device:
        return self.mid_pack.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mid_pack.dtype

    # -- layout conversion --------------------------------------------------------
    def to_strips(self, u: torch.Tensor) -> torch.Tensor:
        """[ndofs] -> [C, Zp, LW] zero-padded channel buffer (once per
        solve; the CG loop stays channel-resident)."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        canvas = torch.zeros((C, Zp, Yp, Xp), dtype=self.dtype,
                             device=u.device)
        grids = self.layout.split(u.to(self.dtype).reshape(-1, 1))
        for c, (kind, slot) in enumerate(self.channels):
            Zk, Yk, Xk = self.kdims[kind]
            canvas[c, 1:1 + Zk, 1:1 + Yk, 1:1 + Xk] = grids[kind][..., slot, 0]
        out = torch.zeros((C, Zp, LW), dtype=self.dtype, device=u.device)
        out[:, :, _GUARD:_GUARD + PF] = canvas.reshape(C, Zp, PF)
        return out

    def from_strips(self, yb: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        view = yb[:, :, _GUARD:_GUARD + PF].reshape(C, Zp, Yp, Xp)
        chan_of = {ks: c for c, ks in enumerate(self.channels)}
        outs = []
        for kind, (base, (X, Y, Z), s) in enumerate(self.layout.kinds):
            cols = [view[chan_of[(kind, slot)], 1:1 + Z, 1:1 + Y, 1:1 + X]
                    for slot in range(s)]
            outs.append(cols[0].reshape(-1) if s == 1
                        else torch.stack(cols, dim=-1).reshape(-1))
        y = torch.cat(outs)
        return y.to(dtype) if dtype is not None else y

    # -- apply (K3) ---------------------------------------------------------------
    def _check_strips(self, x: torch.Tensor) -> None:
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        if tuple(x.shape) != (C, Zp, LW):
            raise ValueError(f"strip buffer of shape {tuple(x.shape)}, "
                             f"expected {(C, Zp, LW)}")
        if x.dtype != self.dtype or x.device != self.device:
            raise TypeError(f"strip buffer {x.dtype}@{x.device} does not "
                            f"match the operator {self.dtype}@{self.device}")
        if not x.is_contiguous():
            raise ValueError("strip buffer must be contiguous")

    def apply_strips(self, x: torch.Tensor) -> torch.Tensor:
        """[C, Zp, LW] -> [C, Zp, LW]: the stencil apply.  A CPU tensor
        takes the plain version; a CUDA tensor launches the K3 kernel
        (counted in ``StripOperator.apply_strips.launches``)."""
        self._check_strips(x)
        if x.device.type == "cpu":
            return self.apply_strips_plain(x)
        if x.device.type != "cuda":
            raise RuntimeError(f"no strip kernel for device {x.device}")
        return self._launch_apply(x)

    def apply_action(self, like: torch.Tensor):
        """``apply_strips`` as a callable ``x -> y`` for a solver's loop
        on buffers like ``like``: shape, dtype, device and contiguity are
        checked once, here, and not again on every call."""
        self._check_strips(like)
        if like.device.type == "cpu":
            return self.apply_strips_plain
        if like.device.type != "cuda":
            raise RuntimeError(f"no strip kernel for device {like.device}")
        return self._launch_apply

    def _plain_index(self):
        """Index tensors of the plain version (built once)."""
        got = self.__dict__.get("_plain_idx")
        if got is not None:
            return got
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        mid = [(co, mi, ci, dz, off) for co, (km, _) in enumerate(self.kplan)
               for (mi, ci, dz, off) in km]
        dlt = [(co, di, row, ci, dz, off)
               for co, (_, kd) in enumerate(self.kplan)
               for (di, row, ci, dz, off) in kd]
        dev = self.device

        def cols(rows, n):
            a = np.asarray(rows, dtype=np.int64).reshape(-1, n)
            return [torch.from_numpy(a[:, j].copy()).to(dev) for j in range(n)]

        m_co, m_mi, m_ci, m_dz, m_off = cols(mid, 5)
        d_co, d_di, d_row, d_ci, d_dz, d_off = cols(dlt, 6)
        z = torch.arange(Zc, device=dev)
        lane = torch.arange(TILE, device=dev)
        zk = torch.tensor([self.kdims[k][0] for k, _ in self.channels],
                          device=dev)
        got = dict(
            m_co=m_co, m_mi=m_mi, m_ci=m_ci[:, None, None],
            m_z=(1 + m_dz)[:, None, None] + z[None, :, None],
            m_lane=(_GUARD + m_off)[:, None, None] + lane[None, None, :],
            d_co=d_co, d_row=d_row, d_di=d_di, d_ci=d_ci[:, None],
            d_z=(1 + d_row + d_dz)[:, None],
            d_lane=(_GUARD + d_off)[:, None] + lane[None, :],
            planes=(z[None, :] < zk[:, None])[..., None])
        self.__dict__["_plain_idx"] = got
        return got

    def apply_strips_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of K3, the kernel's arithmetic: mid terms
        over the full z range (rows past a channel's extent masked off),
        then the delta rows, written to the body [1:1+Zk, G:G+TILE];
        every other slot zero."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        ix = self._plain_index()
        body = torch.zeros((C, Zc, TILE), dtype=x.dtype, device=x.device)
        if ix["m_co"].numel():
            src = x[ix["m_ci"], ix["m_z"], ix["m_lane"]]   # [NT, Zc, TILE]
            body.index_add_(0, ix["m_co"],
                            self.mid_pack[ix["m_mi"]][:, None, :] * src)
        body = body * ix["planes"]
        if ix["d_co"].numel():
            src = x[ix["d_ci"], ix["d_z"], ix["d_lane"]]   # [ND, TILE]
            body.index_put_((ix["d_co"], ix["d_row"]),
                            self.dlt_pack[ix["d_di"]] * src, accumulate=True)
        y = torch.zeros_like(x)
        y[:, 1:1 + Zc, _GUARD:_GUARD + TILE] = body
        return y

    @property
    def apply_order(self) -> np.ndarray:
        """The output channels in the order the apply kernel's warps draw
        them: most mid entries first (ties in channel order), int32 [C]."""
        counts = np.array([len(km) for km, _ in self.kplan])
        return np.argsort(-counts, kind="stable").astype(np.int32)

    @property
    def delta_plane_ends(self) -> np.ndarray:
        """ends[z] = the delta entries of all channels on planes below z,
        int64 [Zc + 1]."""
        Zc = self.dims[1]
        rows = np.array([e[1] for _, kd in self.kplan for e in kd],
                        dtype=np.int64)
        return np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                          minlength=Zc))])

    def apply_smem_bytes(self, run: int, itemsize: int,
                         stage_weights: bool = True) -> int:
        """Shared memory of an apply block whose z run has ``run`` planes:
        the staged source planes (the run and one either side; all
        channels; 32 lanes and the halo), with ``stage_weights`` the delta
        weights of the longest run, the mid entries and the longest run's
        delta entries, and the row, channel and unit tables
        (csrc/strip_apply.cu:smem_bytes)."""
        C = self.dims[0]
        nmid = sum(len(km) for km, _ in self.kplan)
        dcap = self.apply_delta_cap(run)
        return ((C * (run + 2) * (_APPLY_LANES + 2 * self.cg_halo)
                 + (dcap * _APPLY_LANES if stage_weights else 0)) * itemsize
                + (nmid + dcap) * 8 + (C * (2 * run + 5) + 2) * 4)

    def apply_delta_cap(self, run: int) -> int:
        """The most delta entries of one z run of ``run`` planes."""
        Zc = self.dims[1]
        ends = self.delta_plane_ends
        z0 = np.arange(0, Zc, run)
        return int((ends[np.minimum(z0 + run, Zc)] - ends[z0]).max())

    def apply_shape(self, itemsize: int) -> Tuple[int, bool]:
        """(planes of a block's z run, whether the run's delta weights
        are staged in shared memory) of the apply kernel, from the bytes
        a block needs: the z range is cut into the fewest runs of at most
        8 planes, of equal length but the last; where a block of that run
        does not fit the shared memory, into shorter ones.  The delta
        weights are staged unless that costs more than half the run (they
        then come from global memory as the mid weights do)."""
        Zc = self.dims[1]
        longest = -(-Zc // -(-Zc // _APPLY_RUN))
        fits = {staged: next((run for run in range(longest, 0, -1)
                              if self.apply_smem_bytes(run, itemsize, staged)
                              <= _MAX_SMEM), 0)
                for staged in (True, False)}
        if fits[False] == 0:
            raise RuntimeError(
                f"strip_apply: three planes of {self.dims[0]} channels with "
                f"a halo of {self.cg_halo} lanes do not fit a block's shared "
                f"memory ({self.apply_smem_bytes(1, itemsize, False)} bytes)")
        staged = 2 * fits[True] >= fits[False]
        return fits[staged], staged

    def apply_runs(self, itemsize: int) -> np.ndarray:
        """The z runs of the apply kernel's blocks, int32 [n, 2]: (first
        plane, planes)."""
        Zc = self.dims[1]
        run, _ = self.apply_shape(itemsize)
        return np.array([(z0, min(run, Zc - z0)) for z0 in range(0, Zc, run)],
                        dtype=np.int32)

    @functools.cached_property
    def _launch_apply(self):
        """A launcher ``x -> y`` of the K3 kernel with everything that
        does not change between calls (shapes, table pointers, the z run,
        the entry point) packed once; a call passes x, y and the stream."""
        from tpufem_torch import _build
        lib = _build.load().lib
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        item = self.mid_pack.element_size()
        fn = (lib.tpufem_strip_apply_f32 if self.dtype == torch.float32
              else lib.tpufem_strip_apply_f64)
        mptr, ment, dptr, dent, zk = self.tables
        order = torch.from_numpy(self.apply_order).to(self.device)
        run, staged = self.apply_shape(item)
        halo = max((abs(e[-1]) for km, kd in self.kplan for e in km + kd),
                   default=0)
        args = _build.StripLaunch(
            mid=self.mid_pack.data_ptr(), dlt=self.dlt_pack.data_ptr(),
            mid_ptr=mptr.data_ptr(), mid_ent=ment.data_ptr(),
            dlt_ptr=dptr.data_ptr(), dlt_ent=dent.data_ptr(),
            zk=zk.data_ptr(), order=order.data_ptr(),
            device=self.device.index, C=C, Zc=Zc, Zp=Zp, LW=LW, TILE=TILE,
            G=_GUARD, halo=halo, nmid=ment.shape[0], run=run,
            dcap=self.apply_delta_cap(run), stage_delta_weights=int(staged))
        addr = ctypes.addressof(args)
        # what ``addr`` and the pointers packed in it point into
        keep = (args, order, self.tables, self.mid_pack, self.dlt_pack)
        what = f"strip_apply on [{C}, {Zp}, {LW}] in runs of {run} planes"
        raw_stream = _build.raw_stream_getter()
        index = self.device.index

        def launch(x: torch.Tensor) -> torch.Tensor:
            y = torch.empty_like(x)
            rc = fn(addr, x.data_ptr(), y.data_ptr(), raw_stream(index))
            if rc != 0:
                _build.raise_on(lib, rc, what)
            StripOperator.apply_strips.launches += 1
            return y

        launch.keep = keep
        return launch

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Flat dof-vector apply (tests / drop-in use; the CG loop runs
        channel-resident through ``apply_strips``)."""
        return self.from_strips(self.apply_strips(self.to_strips(u)),
                                dtype=u.dtype)

    # -- whole-CG kernel (K4) -------------------------------------------------------
    def cg_resident_bytes(self) -> int:
        """Resident state of the in-kernel CG: b (in), x (out), p/s/r,
        plus the weight packs (tpufem's VMEM gate; on the card the state
        sits in the 50 MB L2)."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        itemsize = self.mid_pack.element_size()
        packs = (self.mid_pack.shape[0] + self.dlt_pack.shape[0]) * TILE
        return (5 * C * Zp * LW + packs) * itemsize

    @property
    def cg_kernel_ok(self) -> bool:
        """tpufem's gate: a kernel plan (every port operator has one) and
        a resident state within 14 MiB."""
        return self.cg_resident_bytes() <= CG_RESIDENT_LIMIT

    def cg_resident(self, b_strips: torch.Tensor, rtol: float, maxit: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The whole unpreconditioned Chronopoulos-Gear CG from a zero
        guess: (x_strips, iterations, rel) with iterations an int32 and
        rel (sqrt(rr / rr0) of the recurrence) a 0-d tensor of the
        working dtype, both on the buffer's device.  The pad, guard and
        halo slots of ``b_strips`` must be zero, as ``to_strips`` leaves
        them.  A CPU tensor takes the plain version; a CUDA tensor
        launches the K4 kernel (counted in
        ``StripOperator.cg_resident.launches``)."""
        self._check_strips(b_strips)
        if b_strips.device.type == "cpu":
            return self.cg_resident_plain(b_strips, rtol, maxit)
        if b_strips.device.type != "cuda":
            raise RuntimeError(f"no CG kernel for device {b_strips.device}")
        return self._launch_cg(b_strips, rtol, maxit)

    def cg_resident_plain(self, b: torch.Tensor, rtol: float, maxit: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Plain version of K4: tpufem's ``cg_pallas`` recurrence
        (strip_op.py:487-520) as a torch loop.  s is updated in place as
        s <- beta s + A r and w.r is recovered as s_new.r - beta s_old.r;
        once rr <= rtol^2 rr0 the step is frozen, after which no later
        step changes x, r, rr or the count, so the loop stops there (the
        kernel stops at the same step).  Dots accumulate in the working
        dtype, as cg_pallas's do."""
        x = torch.zeros_like(b)
        p = torch.zeros_like(b)
        s = torch.zeros_like(b)
        r = b.clone()
        rr0 = torch.sum(r * r)
        thresh = float(rtol) ** 2 * rr0
        rr, rr_prev = rr0, torch.ones_like(rr0)
        alpha_prev = torch.ones_like(rr0)
        cnt = 0
        for k in range(int(maxit)):
            if not bool(rr > thresh):
                break
            beta = torch.zeros_like(rr) if k == 0 else rr / rr_prev
            sr_old = torch.sum(s * r)
            s = beta * s + self.apply_strips_plain(r)
            wr = torch.sum(s * r) - beta * sr_old
            alpha = rr / (wr - beta * rr / alpha_prev)
            p = r + beta * p
            x = x + alpha * p
            r = r - alpha * s
            rr_prev, rr, alpha_prev = rr, torch.sum(r * r), alpha
            cnt += 1
        it = torch.tensor(cnt, dtype=torch.int32, device=b.device)
        return x, it, torch.sqrt(rr / rr0)

    @property
    def cg_halo(self) -> int:
        """Lanes either side of a brick that its apply reads: the largest
        |lane offset| of the plan, rounded up to 4 (16-byte copies)."""
        offs = [abs(e[-1]) for km, kd in self.kplan for e in km + kd]
        return _rup(max(offs, default=0), 4)

    def cg_bricks(self) -> np.ndarray:
        """The bricks of the whole-CG kernel, int32 [n, 3]: (first plane
        z0, planes nz, first buffer lane).  A brick holds all channels of
        its 2 planes (1 for the last one of an odd Zc) and 32 lanes;
        together the bricks cover the body (z < Zc, G <= lane < G + TILE)
        once."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        lanes, planes = _CG_BRICK_LANES, _CG_BRICK_PLANES
        return np.array([(z0, min(planes, Zc - z0), l0)
                         for l0 in range(_GUARD, _GUARD + TILE, lanes)
                         for z0 in range(0, Zc, planes)], dtype=np.int32)

    def cg_delta_cap(self, bricks: np.ndarray) -> int:
        """The most delta entries any one brick of ``bricks`` reads (the
        kernel stages a brick's entries in shared memory)."""
        ends = self.delta_plane_ends
        return int((ends[bricks[:, 0] + bricks[:, 1]]
                    - ends[bricks[:, 0]]).max())

    def _cg_launch_shape(self, dtype: torch.dtype):
        """(bricks on the device, halo, delta entries to stage, co-resident
        blocks to launch) of the whole-CG kernel for ``dtype``, built once
        per dtype."""
        cache = self.__dict__.setdefault("_cg_shapes", {})
        if dtype not in cache:
            from tpufem_torch import _build
            lib = _build.load().lib
            C = self.dims[0]
            bricks = self.cg_bricks()
            halo = self.cg_halo
            dcap = self.cg_delta_cap(bricks)
            suffix = "f32" if dtype == torch.float32 else "f64"
            nblk = getattr(lib, f"tpufem_strip_cg_blocks_{suffix}")(
                self.device.index, C, halo, self.tables[1].shape[0], dcap)
            if nblk <= 0:
                _build.raise_on(lib, -nblk, "strip_cg occupancy query")
            cache[dtype] = (torch.from_numpy(bricks).to(self.device), halo,
                            dcap, min(nblk, len(bricks)))
        return cache[dtype]

    def _launch_cg(self, b: torch.Tensor, rtol: float, maxit: int,
                   max_blocks: Optional[int] = None):
        """Launch K4 on ``b``; ``max_blocks`` caps the grid below the
        co-resident capacity (a block then owns more bricks)."""
        from tpufem_torch import _build
        lib = _build.load().lib
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        suffix = "f32" if b.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"tpufem_strip_cg_{suffix}")
        bricks, halo, dcap, nblk = self._cg_launch_shape(b.dtype)
        if max_blocks is not None:
            nblk = min(nblk, max_blocks)
        x = torch.empty_like(b)
        work = torch.empty((3, C, Zp, LW), dtype=b.dtype, device=b.device)
        # per-block partials: [sr_old, sr_new] and rr, in separate arrays
        partials = torch.empty(3 * nblk, dtype=b.dtype, device=b.device)
        it = torch.empty((), dtype=torch.int32, device=b.device)
        rel = torch.empty((), dtype=b.dtype, device=b.device)
        mptr, ment, dptr, dent, zk = self.tables
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = fn(b.device.index, b.data_ptr(), self.mid_pack.data_ptr(),
                self.dlt_pack.data_ptr(), mptr.data_ptr(), ment.data_ptr(),
                dptr.data_ptr(), dent.data_ptr(), zk.data_ptr(),
                bricks.data_ptr(), x.data_ptr(), work.data_ptr(),
                partials.data_ptr(), it.data_ptr(), rel.data_ptr(), C, Zc, Zp,
                LW, TILE, _GUARD, bricks.shape[0], halo, ment.shape[0], dcap,
                float(rtol) ** 2, int(maxit), nblk, stream)
        _build.raise_on(lib, rc,
                        f"strip_cg on [{C}, {Zp}, {LW}] with {nblk} blocks "
                        f"of {bricks.shape[0]} bricks")
        StripOperator.cg_resident.launches += 1
        return x, it, rel


StripOperator.apply_strips.launches = 0
StripOperator.cg_resident.launches = 0


def _tables(kplan, zk, Zc: int, device: torch.device):
    """The plan as int32 CSR tables for the kernels: mid entries (mi, ci,
    dz, off) grouped by output channel (``mid_ptr`` [C + 1]); delta
    entries (di, ci, dz, off) grouped by (channel, row) (``dlt_ptr``
    [C * Zc + 1], row-major); ``zk`` [C] the channel's plane count."""
    C = len(kplan)
    mid_ptr = np.zeros(C + 1, dtype=np.int32)
    mid_ent: List[Tuple[int, ...]] = []
    dlt_ptr = np.zeros(C * Zc + 1, dtype=np.int32)
    dlt_ent: List[Tuple[int, ...]] = []
    for co, (km, kd) in enumerate(kplan):
        mid_ent.extend(km)
        mid_ptr[co + 1] = len(mid_ent)
        by_row = [[] for _ in range(Zc)]
        for (di, row, ci, dz, off) in kd:
            by_row[row].append((di, ci, dz, off))
        for row in range(Zc):
            dlt_ent.extend(by_row[row])
            dlt_ptr[co * Zc + row + 1] = len(dlt_ent)

    def dev(a, n):
        a = np.asarray(a, dtype=np.int32).reshape(-1, n) if n else a
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(mid_ptr, 0), dev(mid_ent or np.zeros((0, 4)), 4),
            dev(dlt_ptr, 0), dev(dlt_ent or np.zeros((0, 4)), 4),
            dev(np.asarray(zk, dtype=np.int32), 0))
