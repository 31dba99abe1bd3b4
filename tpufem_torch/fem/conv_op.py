"""The P2/P3 lattice operator as a channel convolution (counterpart of
tpufem/fem/conv_op.py), the operator of ``cgpoisson -use_conv 1``.

Every cube of the lattice owns one entity of each (kind, slot) pair of
the typed dof grids (P2: 8 channels, P3: 27), so the dof vector lays out
as a channel tensor ``[Gz, Gy, Gx, C]`` over cube anchors (kind grids one
plane short of G hold a zero "phantom" entry there), and the interior of
the const-table DIA's matrix is ONE 3x3x3 convolution ``[C -> C]``.  Near
the lattice faces each term's weight deviates from its interior constant
by a sum of per-axis profiles within 3 planes of each end, so the whole
operator is, by inclusion-exclusion (tpufem's module docstring has the
derivation):

  bulk 3^3 conv + 6 face contractions (3-4 planes each)
               + 12 edge contractions + 8 corner contractions.

``from_dia`` extracts the kernels from a const-mode scalar DiaOperator's
surrogate tables on the host, in numpy, as tpufem's does
(conv_op.py:113-258), and raises ValueError where tpufem's does.

The apply (conv_op.py:260-321, 366-438) works on torch tensors of the
operator's device: the bulk product is one ``torch.nn.functional.conv3d``
(tpufem's ``lax.conv_general_dilated``, NDHWC x DHWIO, cross-correlation
in both libraries), and the 26 boundary contractions are ``torch.einsum``
with tpufem's subscripts.  tpufem computes this operator with XLA, not in
a Pallas kernel, so cuDNN's convolution and torch's matmuls are its port;
on a CUDA tensor they run on the card or raise.  The state lives
channels-last, ``[Z, Y, X, C]`` as tpufem's, and reaches conv3d as the
``[1, C, Z, Y, X]`` view of that memory (channels_last_3d); the weight is
tpufem's ``Kc[kz, ky, kx, ci, co]`` permuted to ``[co, ci, kz, ky, kx]``.

A float32 apply on a CUDA tensor refuses TF32: cuDNN convolutions and
CUDA matmuls may round float32 operands to 10 mantissa bits when
``torch.backends.cudnn.allow_tf32`` / ``torch.backends.cuda.matmul.
allow_tf32`` are on (cuDNN's flag is on by default), and tpufem's apply
is full float32 (``Precision.HIGHEST``).  The CLI turns both off.

Only tpufem's ``prec="highest"`` form is here.  Its ``"dot"`` and
``"split3"`` forms (conv_op.py:327-356) are TPU workarounds that no
caller reaches, as is GMG's ``use_conv`` parameter (tpufem/la/gmg.py:241,
290: nothing in tpufem passes it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpufem_torch.fem.dia_op import DiaOperator
from tpufem_torch.fem.structured_op import GridLayout, np_dtype

_M = 3    # per-axis correction shell planes at the LO end
_MH = 4   # HI-end window in common coordinates (kind dims differ by 1)

# the boundary pieces in tpufem's order: edges over the axis pairs (z, y),
# (z, x), (y, x), each (lo/hi, lo/hi); corners (z, y, x) lo/hi
_EDGE_SPECS = tuple((ai, aj, ei, ej) for ai, aj in ((0, 1), (0, 2), (1, 2))
                    for ei in (0, 1) for ej in (0, 1))
_CORNER_SPECS = tuple((ez, ey, ex) for ez in (0, 1) for ey in (0, 1)
                      for ex in (0, 1))


def _axis_windows(G: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((lo0, lo1), (hi0, hi1)) common-coordinate plane windows."""
    return (0, _M), (G - _MH, G)


def _width(end: int) -> int:
    return _MH if end else _M


@dataclasses.dataclass
class ConvStencilOp:
    """Channel-convolution form of a const-mode scalar DiaOperator, with
    its apply contract: ``apply`` the baked-BC operator,
    ``apply_bc_rows_zero`` the rows-zero convention, both over the flat
    dof vector; ``apply_channels`` over the padded channel tensor, the
    state of a channel-resident CG."""

    weight: torch.Tensor   # [C, C, 3, 3, 3] conv3d weight (co, ci, z, y, x)
    Kfaces: Tuple          # 6 x [W, 27, C, C] (z-lo, z-hi, y-lo, ...)
    Kedges: Tuple          # 12 x [Wa, Wb, 27, C, C]
    Kcorners: Tuple        # 8 x [Wz, Wy, Wx, 27, C, C]
    bc_mask: torch.Tensor  # flat [ndofs] bool
    chan_mask: torch.Tensor  # [Gz, Gy, Gx, C]: 1 on real dofs, 0 on phantoms
    layout: GridLayout
    gdims: Tuple[int, int, int]  # (Gz, Gy, Gx)

    @property
    def device(self) -> torch.device:
        return self.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.weight.dtype

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")
                 ) -> "ConvStencilOp":
        """Build from a const-mode scalar DiaOperator (ValueError
        otherwise): the kernels by tpufem's host extraction, in float64,
        then cast to ``dtype`` and shipped to ``device``."""
        if dia.bs != 1:
            raise ValueError("ConvStencilOp is scalar-only (bs=1)")
        if not dia.is_const():
            raise ValueError("ConvStencilOp requires a const-mode operator")
        lay = dia.layout
        kinds = lay.kinds
        # channel map: kinds in layout order, slots within a kind
        chan_base = []
        C = 0
        for _b, _dims, s in kinds:
            chan_base.append(C)
            C += s
        rdims = [(k[1][2], k[1][1], k[1][0]) for k in kinds]  # (Z, Y, X)
        Gz = max(d[0] for d in rdims)
        Gy = max(d[1] for d in rdims)
        Gx = max(d[2] for d in rdims)
        for (Zk, Yk, Xk) in rdims:
            if Gz - Zk > 1 or Gy - Yk > 1 or Gx - Xk > 1:
                raise ValueError("kind grids differ by more than one plane")
        if min(Gz, Gy, Gx) < _M + _MH:
            raise ValueError("lattice too small for the boundary windows")

        Kc = np.zeros((3, 3, 3, C, C))
        # face kernels [W, 27, C, C]: W output planes in the window
        Kfaces = [np.zeros((_width(e), 27, C, C)) for _ax in range(3)
                  for e in (0, 1)]
        Kedges = [np.zeros((_width(ei), _width(ej), 27, C, C))
                  for (_ai, _aj, ei, ej) in _EDGE_SPECS]
        Kcorners = [np.zeros((_width(ez), _width(ey), _width(ex), 27, C, C))
                    for (ez, ey, ex) in _CORNER_SPECS]

        def planes(Ls, Lr, G, end):
            """[(surrogate index, window position)] of one kind, axis and
            end: the LO end's first _M planes, or the HI end's last _M
            placed in the common _MH-plane window."""
            if end == 0:
                return [(p, p) for p in range(_M)]
            off = _MH - (G - Lr) - _M   # window position of kind plane 0
            return [(Ls - _M + j, off + j) for j in range(_M)]

        for (ko, so, ki, si, d, _bounds, tag), T in dia.terms():
            if tag != "table":
                raise ValueError("mixed const/dense operator")
            co = chan_base[ko] + so
            ci = chan_base[ki] + si
            dx, dy, dz = d
            tap = ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)
            T = np.asarray(T, dtype=np.float64)
            Zs, Ys, Xs = T.shape
            mz, my, mx = Zs // 2, Ys // 2, Xs // 2
            Zo, Yo, Xo = rdims[ko]
            c0 = T[mz, my, mx]
            Kc[dz + 1, dy + 1, dx + 1, ci, co] += c0

            zpl = [planes(Zs, Zo, Gz, e) for e in (0, 1)]
            ypl = [planes(Ys, Yo, Gy, e) for e in (0, 1)]
            xpl = [planes(Xs, Xo, Gx, e) for e in (0, 1)]

            # face profiles: the deviation along one axis, the others mid
            fz, fy, fx = {}, {}, {}
            for e in (0, 1):
                for sidx, w in zpl[e]:
                    v = T[sidx, my, mx] - c0
                    fz[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[0 + e][w, tap, ci, co] += v
                for sidx, w in ypl[e]:
                    v = T[mz, sidx, mx] - c0
                    fy[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[2 + e][w, tap, ci, co] += v
                for sidx, w in xpl[e]:
                    v = T[mz, my, sidx] - c0
                    fx[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[4 + e][w, tap, ci, co] += v

            # edge cross terms by inclusion-exclusion
            prof_ax = (zpl, ypl, xpl)
            fax = (fz, fy, fx)

            def Tat(a_, b_, axes):
                idx = [mz, my, mx]
                idx[axes[0]] = a_
                idx[axes[1]] = b_
                return T[tuple(idx)]

            for eidx, (ai, aj, ei, ej) in enumerate(_EDGE_SPECS):
                for sa, wa in prof_ax[ai][ei]:
                    for sb, wb in prof_ax[aj][ej]:
                        v = (Tat(sa, sb, (ai, aj)) - c0
                             - fax[ai][(ei, sa)] - fax[aj][(ej, sb)])
                        if v != 0.0:
                            Kedges[eidx][wa, wb, tap, ci, co] += v

            for cidx, (ez, ey, ex) in enumerate(_CORNER_SPECS):
                for sa, wa in zpl[ez]:
                    for sb, wb in ypl[ey]:
                        for sc, wc in xpl[ex]:
                            v = (T[sa, sb, sc] - c0
                                 - fz[(ez, sa)] - fy[(ey, sb)] - fx[(ex, sc)]
                                 - (Tat(sa, sb, (0, 1)) - c0
                                    - fz[(ez, sa)] - fy[(ey, sb)])
                                 - (Tat(sa, sc, (0, 2)) - c0
                                    - fz[(ez, sa)] - fx[(ex, sc)])
                                 - (Tat(sb, sc, (1, 2)) - c0
                                    - fy[(ey, sb)] - fx[(ex, sc)]))
                            if v != 0.0:
                                Kcorners[cidx][wa, wb, wc, tap, ci, co] += v

        npdt = np_dtype(dtype)
        cmask = np.zeros((Gz, Gy, Gx, C), dtype=npdt)
        c0 = 0
        for _b, (Xk, Yk, Zk), s in kinds:
            cmask[:Zk, :Yk, :Xk, c0:c0 + s] = 1.0
            c0 += s

        def dev(a):
            return torch.from_numpy(
                np.ascontiguousarray(a.astype(npdt))).to(device)

        return cls(weight=dev(Kc.transpose(4, 3, 0, 1, 2)),
                   Kfaces=tuple(dev(k) for k in Kfaces),
                   Kedges=tuple(dev(k) for k in Kedges),
                   Kcorners=tuple(dev(k) for k in Kcorners),
                   bc_mask=torch.from_numpy(
                       np.asarray(dia.bc_mask_np, dtype=bool)).to(device),
                   chan_mask=dev(cmask), layout=lay, gdims=(Gz, Gy, Gx))

    # -- layout -----------------------------------------------------------------
    def _to_channels(self, x: torch.Tensor) -> torch.Tensor:
        """Flat dofs -> padded channel tensor [Gz+2, Gy+2, Gx+2, C]."""
        Gz, Gy, Gx = self.gdims
        parts = []
        for g in self.layout.split(x.reshape(-1)):
            Zk, Yk, Xk, _s = g.shape
            parts.append(F.pad(g, (0, 0, 1, Gx - Xk + 1, 1, Gy - Yk + 1,
                                   1, Gz - Zk + 1)))
        return torch.cat(parts, dim=-1)

    def _from_channels(self, y: torch.Tensor) -> torch.Tensor:
        """Channel tensor [Gz, Gy, Gx, C] -> flat dofs (drop phantoms)."""
        outs = []
        c0 = 0
        for _b, (Xk, Yk, Zk), s in self.layout.kinds:
            outs.append(y[:Zk, :Yk, :Xk, c0:c0 + s].reshape(-1))
            c0 += s
        return torch.cat(outs)

    def to_channels_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Flat dof vector -> padded channel tensor (the channel-resident
        CG state; see apply_channels)."""
        return self._to_channels(x)

    def from_channels_padded(self, xp: torch.Tensor) -> torch.Tensor:
        return self._from_channels(xp[1:-1, 1:-1, 1:-1, :])

    # -- apply ------------------------------------------------------------------
    def _check(self, xp: torch.Tensor) -> None:
        Gz, Gy, Gx = self.gdims
        C = self.weight.shape[0]
        if (xp.dtype != self.dtype or xp.device != self.device
                or tuple(xp.shape) != (Gz + 2, Gy + 2, Gx + 2, C)):
            raise ValueError(
                f"ConvStencilOp: x is {tuple(xp.shape)} {xp.dtype}@"
                f"{xp.device}, expected ({Gz + 2}, {Gy + 2}, {Gx + 2}, {C}) "
                f"{self.dtype}@{self.device}")
        if xp.device.type == "cuda" and xp.dtype == torch.float32 and (
                torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "ConvStencilOp: TF32 is on (torch.backends.cudnn.allow_tf32 "
                f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda."
                f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32})"
                ": the float32 products would keep 10 mantissa bits; turn "
                "both off")

    def _patches(self, xp: torch.Tensor, z0, z1, y0, y1, x0, x1):
        """[27, z1-z0, y1-y0, x1-x0, C] tap-shifted slices of the padded
        tensor over a dst window given in common coordinates, tap t =
        (dz + 1) * 9 + (dy + 1) * 3 + dx + 1: tpufem's stack of 27 slices,
        taken as one strided view of the window's corner (one copy, not
        27 slices and a stack)."""
        sz, sy, sx, sc = xp.stride()
        window = xp[z0:, y0:, x0:].as_strided(
            (3, 3, 3, z1 - z0, y1 - y0, x1 - x0, xp.shape[3]),
            (sz, sy, sx, sz, sy, sx, sc))
        return window.reshape((27,) + window.shape[3:])

    def _apply_interior(self, xp: torch.Tensor) -> torch.Tensor:
        """The operator on the padded channel tensor: [Gz, Gy, Gx, C]."""
        self._check(xp)
        Gz, Gy, Gx = self.gdims
        # NDHWC memory as the NCDHW view conv3d takes (channels_last_3d)
        y = F.conv3d(xp.permute(3, 0, 1, 2)[None], self.weight)[0]
        y = y.permute(1, 2, 3, 0)
        zw, yw, xw = (_axis_windows(G) for G in (Gz, Gy, Gx))

        # faces: z windows span all y, x (and symmetrically)
        for e in (0, 1):
            a0, a1 = zw[e]
            p = self._patches(xp, a0, a1, 0, Gy, 0, Gx)
            y[a0:a1] += torch.einsum("tpabc,ptcd->pabd", p, self.Kfaces[e])
            b0, b1 = yw[e]
            p = self._patches(xp, 0, Gz, b0, b1, 0, Gx)
            y[:, b0:b1] += torch.einsum("tzpbc,ptcd->zpbd", p,
                                        self.Kfaces[2 + e])
            c0, c1 = xw[e]
            p = self._patches(xp, 0, Gz, 0, Gy, c0, c1)
            y[:, :, c0:c1] += torch.einsum("tzapc,ptcd->zapd", p,
                                           self.Kfaces[4 + e])

        axw = (zw, yw, xw)
        for eidx, (ai, aj, ei, ej) in enumerate(_EDGE_SPECS):
            a0, a1 = axw[ai][ei]
            b0, b1 = axw[aj][ej]
            K = self.Kedges[eidx]
            if (ai, aj) == (0, 1):
                p = self._patches(xp, a0, a1, b0, b1, 0, Gx)
                y[a0:a1, b0:b1] += torch.einsum("tpqbc,pqtcd->pqbd", p, K)
            elif (ai, aj) == (0, 2):
                p = self._patches(xp, a0, a1, 0, Gy, b0, b1)
                y[a0:a1, :, b0:b1] += torch.einsum("tpaqc,pqtcd->paqd", p, K)
            else:
                p = self._patches(xp, 0, Gz, a0, a1, b0, b1)
                y[:, a0:a1, b0:b1] += torch.einsum("tzpqc,pqtcd->zpqd", p, K)

        for cidx, (ez, ey, ex) in enumerate(_CORNER_SPECS):
            a0, a1 = zw[ez]
            b0, b1 = yw[ey]
            c0, c1 = xw[ex]
            p = self._patches(xp, a0, a1, b0, b1, c0, c1)
            y[a0:a1, b0:b1, c0:c1] += torch.einsum(
                "tpqrc,pqrtcd->pqrd", p, self.Kcorners[cidx])
        return y

    def apply_channels(self, xp: torch.Tensor) -> torch.Tensor:
        """Channel-resident apply: padded tensor in, padded tensor out.

        The phantom entries (kind grids one plane short of the common
        grid) and the one-plane zero ring are zeroed again every apply
        (``chan_mask`` and the re-pad), so dots over the whole tensor equal
        dots over the dof vector and a CG loop pays the flat <-> channel
        relayout once per solve."""
        y = self._apply_interior(xp) * self.chan_mask
        return F.pad(y, (0, 0, 1, 1, 1, 1, 1, 1))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Baked-BC operator (the DIA weights already eliminate the BC
        rows and columns and carry the unit diagonal)."""
        return self._from_channels(self._apply_interior(self._to_channels(x)))

    def apply_bc_rows_zero(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.bc_mask, 0.0, self.apply(x))
