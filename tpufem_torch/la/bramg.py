"""Lattice-brick smoothed-aggregation AMG (counterpart of
tpufem/la/bramg.py; its module docstring, :1-53, has the design).

Smoothed aggregation on the structured P1 cube: 3x3x3 lattice bricks are
the aggregates, a per-brick QR of the near-nullspace gives the tentative
prolongator P0, one damped Jacobi step the smoothed P = (I - w D^-1 A)
P0, and every coarse operator P^T A P is probed (27 colours x m probe
columns of the factored Galerkin product) into a 27-point block stencil
on the aggregate lattice, flattened to scalar shift-diagonals.  Levels
smooth with Chebyshev; the coarsest level is an eigen-clipped dense
inverse.

What runs where:

- host numpy, copies of tpufem's and pinned equal to them by the tests:
  ``brick_qr``, ``_flat_plan``, ``stencil_to_flat_fields``,
  ``flat_apply_np``, ``_symmetrize_stencil``, ``_stencil_to_dense``,
  ``_power_lmax_np``, ``brick_viable``, and the assembly of the probed
  stencil;
- the device: the level-0 operator is the caller's (the P1 DiaOperator:
  K1's kernel, or its three-component form for planar elasticity); a
  coarse level's operator is ONE launch of csrc/brick_flat.cu
  (la.brick_flat); the tentative transfers are plain torch (an upsample,
  a multiply and a sum over the m axis, at full precision); the 27 m
  probe columns run one after another, as tpufem's ``lax.scan`` runs
  them, and are read back once; the coarse solve is ``torch.matmul``.

Vector layout: scalar problems use the flat z-major node grid; bs = 3
uses the component-planar layout at level 0 (``c * nnodes + node``) and
x' = x * m + i on the flat coarse grids.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpufem_torch.fem.structured_op import np_dtype
from tpufem_torch.la.brick_flat import brick_flat_apply, prepare_brick_flat
from tpufem_torch.la.chebyshev import (chebyshev_smoother,
                                       chebyshev_smoother_zero)
from tpufem_torch.la.gmg import surrogate_lmax
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common

logger = logging.getLogger("tpufem_torch")

BRICK = 3  # aggregate brick edge (the fine stencil's reach 1 needs >= 3)


def _ceil3(n: int) -> int:
    return -(-n // BRICK)


# ---------------------------------------------------------------------------
# Host setup (numpy; tpufem's code)
# ---------------------------------------------------------------------------


def brick_qr(B_lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-brick QR of the near-nullspace candidates.

    B_lat: [gz, gy, gx, c, m] nullspace values at lattice nodes (c = the
    level's per-node block size, m = candidate columns; BC rows zeroed).
    Returns (fw [gz, gy, gx, c, m] tentative weights, Bc [az, ay, ax, m, m]
    coarse candidates (the R factors), dead [az, ay, ax, m] bool mask of
    rank-deficient coarse dofs, whose fw columns and R rows are zeroed).
    """
    gz, gy, gx, c, m = B_lat.shape
    az, ay, ax = _ceil3(gz), _ceil3(gy), _ceil3(gx)
    pad = np.zeros((az * BRICK, ay * BRICK, ax * BRICK, c, m))
    pad[:gz, :gy, :gx] = B_lat
    # [az, ay, ax, 27*c, m] brick blocks
    blocks = (pad.reshape(az, BRICK, ay, BRICK, ax, BRICK, c, m)
              .transpose(0, 2, 4, 1, 3, 5, 6, 7)
              .reshape(az, ay, ax, BRICK ** 3 * c, m))
    Q, R = np.linalg.qr(blocks)
    rdiag = np.abs(np.diagonal(R, axis1=-2, axis2=-1))  # [az, ay, ax, m]
    scale = np.maximum(rdiag.max(axis=-1, keepdims=True), 1e-300)
    dead = (rdiag < 1e-8 * scale) | (rdiag < 1e-12)
    if dead.any():
        Q = np.where(dead[..., None, :], 0.0, Q)
        R = np.where(dead[..., :, None], 0.0, R)
    fw = (Q.reshape(az, ay, ax, BRICK, BRICK, BRICK, c, m)
          .transpose(0, 3, 1, 4, 2, 5, 6, 7)
          .reshape(az * BRICK, ay * BRICK, ax * BRICK, c, m)
          [:gz, :gy, :gx])
    return fw, R, dead


def _flat_plan(m: int) -> List[Tuple[int, int, int]]:
    """(dz, dy, s) flat-field plan covering all (dz, dy, dx, i, j):
    s = dx*m + j - i ranges over [-(2m-1), 2m-1]."""
    plan = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for s in range(-(2 * m - 1), 2 * m):
                plan.append((dz, dy, s))
    return plan


def stencil_to_flat_fields(W: np.ndarray, m: int) -> Tuple[Tuple, List[np.ndarray]]:
    """W: [3, 3, 3, az, ay, ax, m, m] block-stencil fields indexed by
    (dz+1, dy+1, dx+1).  Returns (plan, fields): for each kept
    (dz, dy, s), one [az, ay, ax*m] weight field with
    field[z, y, x*m + i] = W[dz, dy, dx, z, y, x, i, j] where
    s = dx*m + j - i (disjoint-lane merge across dx for equal s).  At
    most 9 (4m - 1) fields: 207 for m = 6."""
    az, ay, ax = W.shape[3:6]
    fields = {}
    for dxi, dx in enumerate((-1, 0, 1)):
        Wd = W[:, :, dxi]  # [3, 3, az, ay, ax, m, m]
        for i in range(m):
            for j in range(m):
                s = dx * m + j - i
                blk = Wd[..., i, j]  # [3, 3, az, ay, ax]
                if not blk.any():
                    continue
                for dzi in range(3):
                    for dyi in range(3):
                        w = blk[dzi, dyi]
                        if not w.any():
                            continue
                        key = (dzi - 1, dyi - 1, s)
                        f = fields.get(key)
                        if f is None:
                            f = np.zeros((az, ay, ax * m))
                            fields[key] = f
                        f[:, :, i::m] = w
    plan = sorted(fields)
    return tuple(plan), [fields[k] for k in plan]


def flat_apply_np(plan, fields, adims, m, x_flat):
    """Host numpy twin of the flat apply (lmax power iteration at setup)."""
    az, ay, ax = adims
    P = 2 * m - 1 if m > 1 else 1
    x = x_flat.reshape(az, ay, ax * m)
    xp = np.pad(x, ((1, 1), (1, 1), (P, P)))
    out = np.zeros_like(x)
    for (dz, dy, s), f in zip(plan, fields):
        out += np.asarray(f) * xp[1 + dz: 1 + dz + az,
                                  1 + dy: 1 + dy + ay,
                                  P + s: P + s + ax * m]
    return out.reshape(-1)


def _symmetrize_stencil(W: np.ndarray) -> np.ndarray:
    """W[d][I] <- (W[d][I] + W[-d][I + d]^T) / 2: the probed stencil as an
    exactly symmetric operator (out-of-range partners are zero, matching
    the zeroed out-of-range entries)."""
    az, ay, ax = W.shape[3:6]
    Ws = np.zeros_like(W)
    for dzi, dyi, dxi in np.ndindex(3, 3, 3):
        dz, dy, dx = dzi - 1, dyi - 1, dxi - 1
        adj = np.zeros_like(W[dzi, dyi, dxi])
        z0, z1 = max(0, -dz), min(az, az - dz)
        y0, y1 = max(0, -dy), min(ay, ay - dy)
        x0, x1 = max(0, -dx), min(ax, ax - dx)
        adj[z0:z1, y0:y1, x0:x1] = np.swapaxes(
            W[2 - dzi, 2 - dyi, 2 - dxi][z0 + dz: z1 + dz,
                                         y0 + dy: y1 + dy,
                                         x0 + dx: x1 + dx], -1, -2)
        Ws[dzi, dyi, dxi] = 0.5 * (W[dzi, dyi, dxi] + adj)
    return Ws


def _stencil_to_dense(W: np.ndarray, adims, m: int) -> np.ndarray:
    """[3,3,3,az,ay,ax,m,m] block stencil -> dense [n, n] (host, for the
    coarsest-level inverse)."""
    az, ay, ax = adims
    n = az * ay * ax * m
    A = np.zeros((n, n))
    node = (np.arange(az)[:, None, None] * ay
            + np.arange(ay)[None, :, None]) * ax + np.arange(ax)[None, None, :]
    for dz, dy, dx in np.ndindex(3, 3, 3):
        blk = W[dz, dy, dx]  # [az, ay, ax, m, m]
        z0, z1 = max(0, 1 - dz), min(az, az + 1 - dz)
        y0, y1 = max(0, 1 - dy), min(ay, ay + 1 - dy)
        x0, x1 = max(0, 1 - dx), min(ax, ax + 1 - dx)
        src_node = node[z0 + dz - 1: z1 + dz - 1,
                        y0 + dy - 1: y1 + dy - 1,
                        x0 + dx - 1: x1 + dx - 1]
        dst_node = node[z0:z1, y0:y1, x0:x1]
        sub = blk[z0:z1, y0:y1, x0:x1]
        rows = np.broadcast_to(
            dst_node[..., None, None] * m + np.arange(m)[:, None], sub.shape)
        cols = np.broadcast_to(
            src_node[..., None, None] * m + np.arange(m)[None, :], sub.shape)
        np.add.at(A, (rows.ravel(), cols.ravel()), sub.ravel())
    return A


def _power_lmax_np(plan, fields, adims, m, dinv_c, iters: int = 20) -> float:
    """Host power iteration for lmax(D^-1 A) on a flat-field level."""
    n = dinv_c.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv_c * flat_apply_np(plan, fields, adims, m, v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05


def brick_viable(mesh, order: int, options) -> bool:
    """Use BrickAMG on this problem?  Structured P1 only (higher orders
    take tpufem's generic SA path, la.amg); opt-out via -amg_brick."""
    if str(options.get("amg_brick", "auto")) == "off":
        return False
    return isinstance(mesh, BoxTetMesh) and order == 1


# ---------------------------------------------------------------------------
# Brick transfers (device, plain torch)
# ---------------------------------------------------------------------------


def _upsample3(xc: torch.Tensor, gdims) -> torch.Tensor:
    """[az, ay, ax, ...] -> [gz, gy, gx, ...]: each brick's value
    repeated 3x per axis, truncated to the real grid."""
    az, ay, ax = xc.shape[:3]
    rest = tuple(xc.shape[3:])
    up = (xc[:, None, :, None, :, None]
          .expand((az, BRICK, ay, BRICK, ax, BRICK) + rest)
          .reshape((az * BRICK, ay * BRICK, ax * BRICK) + rest))
    gz, gy, gx = gdims
    return up[:gz, :gy, :gx]


def _bricksum3(t: torch.Tensor, adims) -> torch.Tensor:
    """[gz, gy, gx, ...] -> [az, ay, ax, ...]: zero-pad to brick
    multiples and sum each 3x3x3 brick."""
    az, ay, ax = adims
    gz, gy, gx = t.shape[:3]
    rest = tuple(t.shape[3:])
    t = F.pad(t, (0, 0) * len(rest) + (0, ax * BRICK - gx, 0, ay * BRICK - gy,
                                       0, az * BRICK - gz))
    t = t.reshape((az, BRICK, ay, BRICK, ax, BRICK) + rest)
    return t.sum(dim=(1, 3, 5))


# ---------------------------------------------------------------------------
# Level + hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _BLevel:
    """One level: its operator (None at level 0: the caller's fine
    matvec) and the factored smoothed transfer to the next level."""

    fields: Optional[torch.Tensor]  # [F, gz, gy, gx * c] flat stencil weights
    dinv: torch.Tensor              # flat [n]
    fw: torch.Tensor                # [gz, gy, gx, c, m] tentative weights
    omega_dinv: torch.Tensor        # flat [n]
    lmax: float
    plan: Tuple                     # the fields' (dz, dy, s)
    gdims: Tuple[int, int, int]     # node lattice
    adims: Tuple[int, int, int]     # aggregate lattice (the next level's)
    c: int                          # block size at this level
    m: int                          # the next level's block size
    planar: bool                    # level 0 bs > 1: planar components

    # flat vector <-> [gz, gy, gx, c] lattice
    def _to_lat(self, v: torch.Tensor) -> torch.Tensor:
        gz, gy, gx = self.gdims
        if self.planar:  # [c * n + node] planar components
            return v.reshape(self.c, gz, gy, gx).permute(1, 2, 3, 0)
        # flat levels store x' = x*c + i (c minor within x)
        return v.reshape(gz, gy, gx, self.c)

    def _to_flat(self, t: torch.Tensor) -> torch.Tensor:
        if self.planar:
            return t.permute(3, 0, 1, 2).reshape(-1)
        return t.reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """The level's operator: one launch of the brick flat kernel on a
        card (the level's prepared launch), the plain version on the CPU."""
        if self.fields.device.type == "cuda":
            return self._launch(x)
        return brick_flat_apply(x, self.fields, self.plan, self.gdims, self.c)

    @functools.cached_property
    def _launch(self):
        return prepare_brick_flat(self.fields, self.plan, self.gdims, self.c)

    # transfers at full precision: a multiply and a sum over the m (or c)
    # axis, as tpufem's Precision.HIGHEST einsums
    def p0_apply(self, xc: torch.Tensor) -> torch.Tensor:
        """Tentative prolongation: next-level flat -> this-level flat."""
        az, ay, ax = self.adims
        up = _upsample3(xc.reshape(az, ay, ax, self.m), self.gdims)
        return self._to_flat((self.fw * up[..., None, :]).sum(-1))

    def p0t_apply(self, v: torch.Tensor) -> torch.Tensor:
        """Tentative restriction: this-level flat -> next-level flat."""
        t = (self.fw * self._to_lat(v)[..., :, None]).sum(-2)
        return _bricksum3(t, self.adims).reshape(-1)


@dataclasses.dataclass(eq=False)
class BrickAMG:
    """The hierarchy: levels finest first, the dense coarsest inverse,
    and the setup's phase seconds (``last_phase_s``)."""

    levels: List[_BLevel]
    coarse_inv: torch.Tensor
    smoother_degree: int
    level_sizes: List[int]
    last_phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self._smooth_cache: Dict[int, Tuple] = {}

    # -- setup ---------------------------------------------------------------
    @classmethod
    def setup(cls, fine_op, mesh: BoxTetMesh, bs: int, options,
              dtype: torch.dtype = torch.float32,
              near_nullspace: Optional[np.ndarray] = None,
              bc_mask: Optional[np.ndarray] = None) -> "BrickAMG":
        """Build the hierarchy from the structured fine operator, on its
        device (tpufem/la/bramg.py:309-470).

        fine_op: the P1 DiaOperator (planar layout when bs > 1), built
        with a device: its ``apply`` is both the probing engine and the
        V-cycle's fine-level matvec; no CSR export happens.
        near_nullspace: [m, ndofs] in the node-interleaved dof order.
        bc_mask: [ndofs] or [nnodes] bool, interleaved order.
        """
        t_total = time.perf_counter()
        ph = {"qr": 0.0, "probe": 0.0, "fields": 0.0, "eig": 0.0,
              "coarse": 0.0}
        nd = np_dtype(dtype)
        device = fine_op.fields.device

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a.astype(nd))).to(device)

        gz, gy, gx = mesh.Nz + 1, mesh.Ny + 1, mesh.Nx + 1
        nnode = gz * gy * gx
        coarse_limit = int(options.get("amg_coarse_eq_limit"))
        max_levels = int(options.get("amg_max_levels"))
        damping = float(options.get("amg_prolongator_damping"))
        degree = int(options.get("amg_smoother_degree"))
        planar = bool(getattr(fine_op, "planar", False))

        if near_nullspace is None:
            B = np.ones((nnode * bs, 1))
        else:
            B = np.ascontiguousarray(near_nullspace.T)  # [ndofs, m]
        if bc_mask is not None:
            flat = (np.repeat(bc_mask, bs)
                    if bc_mask.shape[0] * bs == B.shape[0] else bc_mask)
            B = B * (~flat)[:, None]
        m = B.shape[1]
        B_lat = B.reshape(gz, gy, gx, bs, m)

        # fine dinv / lmax (host stencil diagonal + surrogate estimate)
        d0 = fine_op.diagonal_np()  # planar order when planar
        dinv0 = np.where(d0 != 0, 1.0 / np.where(d0 == 0, 1.0, d0), 0.0)
        t0 = time.perf_counter()
        marker = (common.elasticity_bc_marker if bs == 3
                  else common.poisson_bc_marker)
        problem = "elasticity" if bs == 3 else "poisson"
        lmax0 = surrogate_lmax(mesh, 1, problem, marker, dtype)
        ph["eig"] += time.perf_counter() - t0

        levels: List[_BLevel] = []
        sizes = [nnode * bs]

        # ---- level 0: fine (operator external) -----------------------------
        t0 = time.perf_counter()
        fw0, R0, dead0 = brick_qr(B_lat)
        ph["qr"] += time.perf_counter() - t0
        az, ay, ax = _ceil3(gz), _ceil3(gy), _ceil3(gx)
        omega0 = damping / lmax0
        lv0 = _BLevel(fields=None, dinv=dev(dinv0), fw=dev(fw0),
                      omega_dinv=dev(omega0 * dinv0), lmax=lmax0, plan=(),
                      gdims=(gz, gy, gx), adims=(az, ay, ax), c=bs, m=m,
                      planar=planar)
        levels.append(lv0)

        mv_here = fine_op.apply  # the DiaOperator at level 0, a level deeper
        lv_here = lv0
        Bc = R0
        dead = dead0
        while True:
            adims = lv_here.adims
            azc, ayc, axc = adims
            nc = azc * ayc * axc * m
            sizes.append(nc)
            # ---- probe the coarse stencil (27 colours x m comps) -----------
            t0 = time.perf_counter()
            W = _probe_stencil(lv_here, mv_here, adims, m)
            # exact symmetrization: f32 probe rounding leaves ~1e-7
            # relative asymmetry, enough to break PCG through the V-cycle
            W = _symmetrize_stencil(W)
            # rank-deficient coarse dofs are inert: zero their couplings
            # (probe rounding noise) and give them a unit diagonal
            dd = dead.reshape(azc, ayc, axc, m)
            ii = np.arange(m)
            fix = dd | (np.abs(W[1, 1, 1][..., ii, ii]) < 1e-30)
            if fix.any():
                W *= ~fix[..., :, None]
                W *= ~fix[..., None, :]
            W[1, 1, 1][..., ii, ii] = np.where(
                fix, 1.0, W[1, 1, 1][..., ii, ii])
            ph["probe"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            plan, fields = stencil_to_flat_fields(W, m)
            dc = np.ascontiguousarray(W[1, 1, 1][..., ii, ii]).reshape(-1)
            dinv_c = np.where(dc != 0, 1.0 / np.where(dc == 0, 1.0, dc), 1.0)
            ph["fields"] += time.perf_counter() - t0

            if nc <= 8 * coarse_limit or len(levels) >= max_levels - 1 \
                    or min(azc, ayc, axc) < 2:
                # ---- coarsest: SPD inverse via eigen-clipping --------------
                # probe rounding can flip the smallest eigenvalues (where
                # elasticity's near-nullspace modes sit) negative; clipping
                # at eps * lmax keeps the V-cycle SPD
                t0 = time.perf_counter()
                dense = _stencil_to_dense(W, adims, m)
                dense = 0.5 * (dense + dense.T)
                evals, evecs = np.linalg.eigh(dense)
                eps = 3e-7 if nd.itemsize <= 4 else 1e-13
                floor = eps * max(float(evals.max()), 1e-300)
                evals = np.maximum(evals, floor)
                coarse_inv = dev((evecs / evals) @ evecs.T)
                ph["coarse"] += time.perf_counter() - t0
                break

            # ---- this coarse grid becomes a full level ---------------------
            t0 = time.perf_counter()
            lam = _power_lmax_np(plan, fields, adims, m, dinv_c)
            ph["eig"] += time.perf_counter() - t0

            # next-level candidates: R factors, zeroed at dead dofs, on the
            # coarse node lattice with c = m
            Bc_lat = Bc.reshape(azc, ayc, axc, m, m)
            Bc_lat = np.where(dd[..., :, None], 0.0, Bc_lat)
            t0 = time.perf_counter()
            fwc, Rc, deadc = brick_qr(Bc_lat)
            ph["qr"] += time.perf_counter() - t0

            omega_c = damping / lam
            lvc = _BLevel(fields=dev(np.stack(fields)), dinv=dev(dinv_c),
                          fw=dev(fwc), omega_dinv=dev(omega_c * dinv_c),
                          lmax=lam, plan=plan, gdims=adims,
                          adims=(_ceil3(azc), _ceil3(ayc), _ceil3(axc)),
                          c=m, m=m, planar=False)
            levels.append(lvc)
            mv_here = lvc.matvec
            lv_here = lvc
            Bc = Rc
            dead = deadc

        ph["total"] = time.perf_counter() - t_total
        out = cls(levels=levels, coarse_inv=coarse_inv,
                  smoother_degree=degree, level_sizes=sizes,
                  last_phase_s=dict(ph))
        logger.info("Brick-AMG setup %.2fs: levels %s | %s",
                    ph["total"], sizes,
                    " ".join(f"{k} {v:.2f}s" for k, v in ph.items()
                             if k != "total" and v > 0.005))
        return out

    # -- V-cycle -------------------------------------------------------------
    def _smoothers(self, i: int, mv: Callable) -> Tuple[Callable, Callable]:
        """(smooth_zero, smooth) of level i with matvec ``mv``, built once
        per (level, matvec)."""
        cached = self._smooth_cache.get(i)
        if cached is None or cached[0] != mv:
            lv = self.levels[i]
            d = self.smoother_degree
            cached = (mv,
                      chebyshev_smoother_zero(mv, lv.dinv, lv.lmax, degree=d),
                      chebyshev_smoother(mv, lv.dinv, lv.lmax, degree=d))
            self._smooth_cache[i] = cached
        return cached[1], cached[2]

    def vcycle(self, r: torch.Tensor, i: int = 0,
               fine_matvec: Optional[Callable] = None) -> torch.Tensor:
        if i == len(self.levels):
            return torch.matmul(self.coarse_inv, r)
        lv = self.levels[i]
        mv = fine_matvec if i == 0 else lv.matvec
        if mv is None:
            raise ValueError("BrickAMG.vcycle requires fine_matvec")
        smooth0, smooth = self._smoothers(i, mv)
        x, rr = smooth0(r)
        # factored smoothed transfers
        v = rr - mv(lv.omega_dinv * rr)
        rc = lv.p0t_apply(v)
        xc = self.vcycle(rc, i + 1, fine_matvec=fine_matvec)
        y = lv.p0_apply(xc)
        x = x + y - lv.omega_dinv * mv(y)
        return smooth(x, r)

    def as_preconditioner(self, fine_matvec: Callable) -> Callable:
        return lambda r: self.vcycle(r, fine_matvec=fine_matvec)

    def profile_vcycle(self, fine_op, n: int, reps: int = 10) -> dict:
        """Per-stage milliseconds of one V-cycle apply
        (tpufem/la/bramg.py:498-571): ``smooth`` = level-0 Chebyshev pre
        and post sweeps; ``transfer`` = level-0 restrict + prolong with the
        two factored smoothing corrections (4 fine applies); ``below`` =
        the whole recursion beneath level 0; ``coarse`` = the dense coarse
        solve alone; ``total`` = one full V-cycle.  Each stage is the best
        of two passes of ``reps`` back-to-back calls, timed by CUDA events
        on a card and by the host clock on the CPU."""
        lv0 = self.levels[0]
        dt, device = lv0.dinv.dtype, lv0.dinv.device
        az, ay, ax = lv0.adims
        r = torch.ones(n, dtype=dt, device=device)
        rc = torch.ones(az * ay * ax * lv0.m, dtype=dt, device=device)
        rb = torch.ones(self.coarse_inv.shape[0], dtype=dt, device=device)
        mv = fine_op.apply
        smooth0, smooth = self._smoothers(0, mv)

        def st_smooth():
            x, _ = smooth0(r)
            return smooth(x, r)

        def st_transfer():
            v = r - mv(lv0.omega_dinv * r)
            y = lv0.p0_apply(lv0.p0t_apply(v))
            return y - lv0.omega_dinv * mv(y)

        stages = {
            "smooth": st_smooth,
            "transfer": st_transfer,
            "below": lambda: self.vcycle(rc, 1, fine_matvec=mv),
            "coarse": lambda: torch.matmul(self.coarse_inv, rb),
            "total": lambda: self.vcycle(r, fine_matvec=mv),
        }
        out = {k: _best_ms(fn, device, reps) for k, fn in stages.items()}
        out["smoother_degree"] = self.smoother_degree
        logger.info("V-cycle split (n=%d): %s", n, out)
        return out


def _best_ms(fn: Callable, device: torch.device, reps: int) -> float:
    """The lesser of two passes' mean milliseconds over ``reps``
    back-to-back calls, after one warm call."""
    fn()
    best = float("inf")
    for _ in range(2):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) / reps * 1e3
        best = min(best, ms)
    return best


# ---------------------------------------------------------------------------
# Probing
# ---------------------------------------------------------------------------


def _probe_stencil(lv: _BLevel, matvec: Callable, adims, m: int) -> np.ndarray:
    """Recover the 27-point block stencil of the Galerkin operator
    Ac = P0^T (I - w A D^-1) A (I - w D^-1 A) P0 by 3x3x3-colouring
    probes on ``lv``'s device (``matvec`` the level's operator).  Returns
    W [3, 3, 3, az, ay, ax, m, m] (numpy float64) indexed by (dz+1, dy+1,
    dx+1), out-of-range shifts zero (tpufem/la/bramg.py:579-674).

    The 27 m columns run one after another (tpufem's ``lax.scan``), three
    operator applies each, and come back in ONE readback.  Correct
    because the coarse stencil reaches one brick (brick size 3 >= the
    fine stencil's reach), so probe columns of one colour do not alias;
    the tests pin probe-vs-explicit equality."""
    az, ay, ax = adims
    nc = az * ay * ax * m
    device, dt = lv.dinv.device, lv.dinv.dtype
    phase = [torch.arange(k, device=device) % 3 for k in adims]
    comp = torch.arange(m, device=device)
    cols = []
    for cz, cy, cx in np.ndindex(3, 3, 3):
        node = ((phase[0] == cz)[:, None, None]
                & (phase[1] == cy)[None, :, None]
                & (phase[2] == cx)[None, None, :])
        for j in range(m):
            probe = (node[..., None] & (comp == j)).to(dt).reshape(nc)
            w = lv.p0_apply(probe)              # P0 xc
            w = w - lv.omega_dinv * matvec(w)   # (I - w D^-1 A) P0 xc
            z = matvec(w)                       # A P xc
            z = z - matvec(lv.omega_dinv * z)   # (I - w A D^-1) ...
            cols.append(lv.p0t_apply(z))        # P0^T -> coarse
    got = torch.stack(cols).cpu().numpy().astype(np.float64)  # [27*m, nc]
    Y = got.reshape(27, m, nc).transpose(0, 2, 1)  # [colour, node K*i, j]
    Y = Y.reshape(27, az, ay, ax, m, m)  # [colour, node K, i, probe j]

    W = np.zeros((3, 3, 3, az, ay, ax, m, m))
    # W[d][K] = Y[colour == (K + d) mod 3][K]
    for pz, py, px in np.ndindex(3, 3, 3):         # node phase
        sl = (slice(pz, None, 3), slice(py, None, 3), slice(px, None, 3))
        for dz, dy, dx in np.ndindex(3, 3, 3):     # shift d - 1
            cz, cy, cx = (pz + dz - 1) % 3, (py + dy - 1) % 3, \
                (px + dx - 1) % 3
            ci = (cz * 3 + cy) * 3 + cx
            W[dz, dy, dx][sl] = Y[ci][sl]
    # out-of-range shifts carry aliased contributions when the lattice has
    # fewer than 3 nodes along an axis (the coloured node wraps): zero them
    W[0, :, :, 0] = 0.0
    W[2, :, :, -1] = 0.0
    W[:, 0, :, :, 0] = 0.0
    W[:, 2, :, :, -1] = 0.0
    W[:, :, 0, :, :, 0] = 0.0
    W[:, :, 2, :, :, -1] = 0.0
    return W
