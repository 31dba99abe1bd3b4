"""The shard exchange layer: the port's counterpart of the collectives
tpufem's SPMD programs call inside ``shard_map`` (``jax.lax.ppermute``,
``psum``, ``all_gather`` over the 1-D "shard" mesh axis).

PyTorch has neither ``shard_map`` nor virtual devices.  Here a process
holds its shards as ONE stacked tensor ``[L, ...]`` on its one device
(row j is global shard ``local[j]``), and a ``ShardComm`` moves rows
between shards:

- **local shards** (one process, no process group): all S shards are
  rows of the tensor.  A ``ppermute`` round is a copy between rows (one
  slice copy for a shift such as the slab halo's s -> s - 1), ``psum`` a
  sum over the shard axis and ``all_gather`` the tensor itself.  This is
  how ``--num_shards N`` runs on one card, and the counterpart of the
  virtual CPU device mesh of tpufem's tests.
- **process groups** (``torch.distributed`` initialised, see
  parallel.multihost): each of the W ranks holds S / W consecutive
  shards as above.  Pairs of shards on one rank exchange as in the local
  form; pairs across ranks go through ``batch_isend_irecv``, one message
  a peer a round (the pairs' rows packed in the round's pair order).
  ``psum`` is a sum over the local rows then ``all_reduce``, and
  ``all_gather`` is ``all_gather``.

``ppermute`` keeps tpufem's semantics: shard d receives the buffer of the
shard s with (s, d) in the permutation, and zeros where no pair names it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Perm = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class _PermPlan:
    """A permutation's moves as seen by one process: rows copied within
    the process (``src`` -> ``dst``, or the slices ``shift`` when both are
    runs of consecutive rows), and per peer rank the local rows sent and
    received, in the permutation's pair order."""

    src: Optional[torch.Tensor]
    dst: Optional[torch.Tensor]
    shift: Optional[Tuple[int, int, int]]   # (src start, dst start, count)
    sends: Dict[int, List[int]]
    recvs: Dict[int, List[int]]


class ShardComm:
    """The S shards of a 1-D shard axis as seen by this process: its
    shards ``local`` (consecutive global indices, rank r holding
    [r S / W, (r + 1) S / W): tpufem's ``shard_devices`` /
    ``local_shard_indices``, decided here only), their ``device``, and
    the exchanges between them.  The process-group form where
    torch.distributed is initialised (``group``), else the local form
    (one process holds every shard)."""

    def __init__(self, nshards: int, device: torch.device) -> None:
        import torch.distributed as dist
        self.nshards = int(nshards)
        self.device = device
        self.group = dist.is_available() and dist.is_initialized()
        if self.group:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        if self.nshards % self.world:
            raise ValueError(f"{self.nshards} shards over {self.world} "
                             "processes: each process must hold as many "
                             "shards as every other")
        per = self.nshards // self.world
        self.local = np.arange(self.rank * per, (self.rank + 1) * per,
                               dtype=np.int64)
        self._plans: Dict[Perm, _PermPlan] = {}

    @property
    def nlocal(self) -> int:
        """L, the shards of this process."""
        return int(self.local.shape[0])

    def rank_of(self, shard: int) -> int:
        return int(shard) // self.nlocal

    def row_of(self, shard: int) -> int:
        """The local row of a shard of this process."""
        return int(shard) - int(self.local[0])

    def is_local(self, shard: int) -> bool:
        return self.rank_of(shard) == self.rank

    def local_mask(self, shards: Sequence[int]) -> torch.Tensor:
        """Bool [L], True where the local row's shard is in ``shards``."""
        m = np.isin(self.local, np.asarray(list(shards), dtype=np.int64))
        return torch.from_numpy(m).to(self.device)

    # -- the exchanges --------------------------------------------------------
    def _plan(self, perm: Perm) -> _PermPlan:
        plan = self._plans.get(perm)
        if plan is not None:
            return plan
        src, dst = [], []
        sends: Dict[int, List[int]] = {}
        recvs: Dict[int, List[int]] = {}
        for s, d in perm:
            if self.is_local(s) and self.is_local(d):
                src.append(self.row_of(s))
                dst.append(self.row_of(d))
            elif self.is_local(s):
                sends.setdefault(self.rank_of(d), []).append(self.row_of(s))
            elif self.is_local(d):
                recvs.setdefault(self.rank_of(s), []).append(self.row_of(d))
        shift = None
        if src and all(b - a == 1 for a, b in zip(src, src[1:])) and \
                all(b - a == 1 for a, b in zip(dst, dst[1:])):
            shift = (src[0], dst[0], len(src))

        def idx(v):
            return torch.tensor(v, dtype=torch.long, device=self.device)

        plan = _PermPlan(src=idx(src) if src and shift is None else None,
                         dst=idx(dst) if dst and shift is None else None,
                         shift=shift, sends=sends, recvs=recvs)
        self._plans[perm] = plan
        return plan

    def ppermute(self, buf: torch.Tensor, perm: Sequence[Tuple[int, int]]
                 ) -> torch.Tensor:
        """``jax.lax.ppermute`` over the shard axis: ``buf`` [L, ...] one
        buffer a local shard; returns [L, ...] with row d holding the
        buffer of the shard s with (s, d) in ``perm``, zeros elsewhere."""
        plan = self._plan(tuple((int(a), int(b)) for a, b in perm))
        out = torch.zeros_like(buf)
        if plan.shift is not None:
            s0, d0, n = plan.shift
            out[d0: d0 + n] = buf[s0: s0 + n]
        elif plan.src is not None:
            out.index_copy_(0, plan.dst, buf.index_select(0, plan.src))
        if plan.sends or plan.recvs:
            self._p2p(buf, out, plan)
        return out

    def _p2p(self, buf: torch.Tensor, out: torch.Tensor,
             plan: _PermPlan) -> None:
        """The moves across ranks: one message a peer, its rows packed in
        the permutation's pair order (both ends walk the same order)."""
        import torch.distributed as dist
        ops, landing = [], []
        for peer in sorted(set(plan.sends) | set(plan.recvs)):
            if peer in plan.sends:
                rows = plan.sends[peer]
                ops.append(dist.P2POp(dist.isend,
                                      buf[rows].contiguous(), peer))
            if peer in plan.recvs:
                rows = plan.recvs[peer]
                land = torch.empty((len(rows),) + tuple(buf.shape[1:]),
                                   dtype=buf.dtype, device=buf.device)
                ops.append(dist.P2POp(dist.irecv, land, peer))
                landing.append((rows, land))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for rows, land in landing:
            out[rows] = land

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum``: the sum over every shard of ``t`` [L, ...]
        (the local rows first, then across processes)."""
        s = t.sum(dim=0)
        if self.group:
            import torch.distributed as dist
            dist.all_reduce(s)
        return s

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_gather``: [L, ...] local rows -> [S, ...] every
        shard's row, in shard order."""
        if not self.group:
            return t
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=0)
