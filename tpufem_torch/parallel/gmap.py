"""General owned/ghost index maps for arbitrary shard neighbour graphs
(counterpart of tpufem/parallel/gmap.py).

The row-sharded solver's dof layout: each shard holds ``[max_owned |
max_ghost]`` local slots, zero-padded, the same shapes on every shard.
The ghost exchange is cut at setup into a static schedule of rounds, each
a partial permutation of the shard axis (every shard sends at most one
buffer and receives at most one), by tpufem's greedy edge colouring of
the shard neighbour digraph (``build_general_maps``); the dofs are
partitioned by a Morton curve (``partition_cells_sfc``).  The host code
is tpufem's, so maps, rounds and partitions are its bits.

On the device a process's shards are one stacked [L, nlocal] tensor
(parallel.comm): ``fwd`` (owners -> ghost copies) is a round of one
gather and one ``index_copy_`` over the flattened tensor for the pairs of
shards on this process, ``rev_add`` (ghost partial sums -> owners) one
gather and one ``index_add_``; pairs across processes travel as one
message a peer a round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class _Round:
    """One round as one process runs it over the flattened stacked
    tensor: owner slots ``own`` and ghost slots ``ghost`` of the pairs
    within the process (entry for entry), and per peer rank the flat
    owner slots whose values go out forward (``out``) and the ghost slots
    they land in (``inn``); rev_add sends ``inn`` back into ``out``."""

    own: torch.Tensor
    ghost: torch.Tensor
    out: Dict[int, torch.Tensor]
    inn: Dict[int, torch.Tensor]


@dataclasses.dataclass
class GeneralIndexMaps:
    """Static exchange metadata for one dof layout across S shards.

    Local vector layout per shard: ``[max_owned | max_ghost]`` slots,
    zero-padded; identical shapes on every shard.
    """

    nshards: int
    max_owned: int
    max_ghost: int
    nlocal: int
    local_gids: np.ndarray      # [S, nlocal] global dof per slot (pad 0)
    owned_counts: np.ndarray    # [S]
    ghost_counts: np.ndarray    # [S]
    owned_mask: np.ndarray      # [S, nlocal] bool
    # exchange schedule: R rounds
    rounds: Tuple                # tuple of perm lists [(src, dst), ...]
    buf: int                     # padded buffer length per round
    send_idx: np.ndarray         # [S, R, buf] local slots packed when
    #                              shard is a SENDER in round r (owned)
    send_mask: np.ndarray        # [S, R, buf] bool
    recv_idx: np.ndarray         # [S, R, buf] local ghost slots written
    #                              when shard is a RECEIVER in round r
    recv_mask: np.ndarray        # [S, R, buf] bool
    _plans: Dict = dataclasses.field(default_factory=dict, repr=False)

    # -- host-side helpers -------------------------------------------------
    def local_of_global(self, shard: int, gids: np.ndarray) -> np.ndarray:
        lg = self.local_gids[shard]
        n_own = int(self.owned_counts[shard])
        n_gh = int(self.ghost_counts[shard])
        own = lg[:n_own]
        gh = lg[self.max_owned: self.max_owned + n_gh]
        out = np.empty(gids.shape, dtype=np.int64)
        pos = np.searchsorted(own, gids)
        pos_c = np.clip(pos, 0, max(n_own - 1, 0))
        is_own = (own[pos_c] == gids) if n_own else np.zeros(gids.shape, bool)
        out[is_own] = pos_c[is_own]
        rest = ~is_own
        if rest.any():
            pos_g = np.searchsorted(gh, gids[rest])
            pos_g_c = np.clip(pos_g, 0, max(n_gh - 1, 0))
            if n_gh == 0 or not bool((gh[pos_g_c] == gids[rest]).all()):
                raise ValueError("gid not present on shard")
            out[rest] = self.max_owned + pos_g_c
        return out

    def distribute(self, x_global: np.ndarray) -> np.ndarray:
        out = np.zeros((self.nshards, self.nlocal), dtype=x_global.dtype)
        for s in range(self.nshards):
            no, ng = int(self.owned_counts[s]), int(self.ghost_counts[s])
            out[s, :no] = x_global[self.local_gids[s, :no]]
            sl = slice(self.max_owned, self.max_owned + ng)
            out[s, sl] = x_global[self.local_gids[s, sl]]
        return out

    def collect(self, x_local: np.ndarray, ndofs: int) -> np.ndarray:
        out = np.zeros(ndofs, dtype=x_local.dtype)
        for s in range(self.nshards):
            no = int(self.owned_counts[s])
            out[self.local_gids[s, :no]] = x_local[s, :no]
        return out

    # -- the exchange on a process's stacked [L, nlocal] tensor ----------------
    def _rounds_of(self, comm) -> List[_Round]:
        """The schedule as ``comm``'s process runs it, built once."""
        key = id(comm)
        got = self._plans.get(key)
        if got is not None and got[0] is comm:
            return got[1]
        dev = comm.device
        n = self.nlocal

        def t(v):
            return torch.tensor(np.asarray(v, dtype=np.int64).reshape(-1),
                                dtype=torch.long, device=dev)

        out_rounds = []
        for r, perm in enumerate(self.rounds):
            own, ghost = [], []
            out: Dict[int, list] = {}
            inn: Dict[int, list] = {}
            for (u, v) in perm:
                k = int(self.send_mask[u, r].sum())
                su = self.send_idx[u, r, :k]
                rv = self.recv_idx[v, r, :k]
                if comm.is_local(u) and comm.is_local(v):
                    own.append(comm.row_of(u) * n + su)
                    ghost.append(comm.row_of(v) * n + rv)
                elif comm.is_local(u):
                    out.setdefault(comm.rank_of(v), []).append(
                        comm.row_of(u) * n + su)
                elif comm.is_local(v):
                    inn.setdefault(comm.rank_of(u), []).append(
                        comm.row_of(v) * n + rv)
            cat = lambda parts: t(np.concatenate(parts) if parts  # noqa: E731
                                  else np.zeros(0, dtype=np.int64))
            out_rounds.append(_Round(
                own=cat(own), ghost=cat(ghost),
                out={p: cat(v) for p, v in out.items()},
                inn={p: cat(v) for p, v in inn.items()}))
        self._plans[key] = (comm, out_rounds)
        return out_rounds

    @staticmethod
    def _exchange(yf: torch.Tensor, out: Dict[int, torch.Tensor],
                  inn: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """One message a peer: send yf[out[p]], receive len(inn[p])."""
        if not out and not inn:
            return {}
        import torch.distributed as dist
        ops, got = [], {}
        for p in sorted(set(out) | set(inn)):
            if p in out:
                ops.append(dist.P2POp(dist.isend,
                                      yf.index_select(0, out[p]), p))
            if p in inn:
                got[p] = torch.empty(inn[p].shape[0], dtype=yf.dtype,
                                     device=yf.device)
                ops.append(dist.P2POp(dist.irecv, got[p], p))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def fwd(self, y: torch.Tensor, comm) -> torch.Tensor:
        """Refresh ghost slots from owners (scatter_fwd); ``y`` [L,
        nlocal], returned as a new tensor."""
        yf = y.reshape(-1).clone()
        for rd in self._rounds_of(comm):
            if rd.own.numel():
                yf.index_copy_(0, rd.ghost, yf.index_select(0, rd.own))
            for p, v in self._exchange(yf, rd.out, rd.inn).items():
                yf.index_copy_(0, rd.inn[p], v)
        return yf.reshape(y.shape)

    def rev_add(self, y: torch.Tensor, comm) -> torch.Tensor:
        """Accumulate ghost partial sums into owners (scatter_rev(plus)).

        Ghost slots keep their stale partial sums, as tpufem's: refresh
        them with ``fwd`` (or mask them) before reading the whole local
        vector."""
        yf = y.reshape(-1).clone()
        for rd in self._rounds_of(comm):
            if rd.own.numel():
                yf.index_add_(0, rd.own, yf.index_select(0, rd.ghost))
            for p, v in self._exchange(yf, rd.inn, rd.out).items():
                yf.index_add_(0, rd.out[p], v)
        return yf.reshape(y.shape)


def build_general_maps(local_gid_sets: Sequence[np.ndarray],
                       owner_of: np.ndarray) -> GeneralIndexMaps:
    """Build exchange maps from each shard's referenced global dofs and a
    global ownership array.

    local_gid_sets[s]: sorted unique global dofs shard s touches.
    owner_of[g]: owning shard of global dof g (every dof must be
    referenced by its owner).
    """
    S = len(local_gid_sets)
    owned: List[np.ndarray] = []
    ghosts: List[np.ndarray] = []
    for s in range(S):
        gids = np.asarray(local_gid_sets[s])
        own_mask = owner_of[gids] == s
        owned.append(gids[own_mask])
        ghosts.append(gids[~own_mask])

    max_owned = max((o.shape[0] for o in owned), default=1)
    max_ghost = max((g.shape[0] for g in ghosts), default=0)
    max_ghost = max(max_ghost, 1)
    nlocal = max_owned + max_ghost

    local_gids = np.zeros((S, nlocal), dtype=np.int64)
    owned_counts = np.array([o.shape[0] for o in owned])
    ghost_counts = np.array([g.shape[0] for g in ghosts])
    owned_mask = np.zeros((S, nlocal), dtype=bool)
    for s in range(S):
        local_gids[s, :owned_counts[s]] = owned[s]
        local_gids[s, max_owned: max_owned + ghost_counts[s]] = ghosts[s]
        owned_mask[s, :owned_counts[s]] = True

    # edges: (owner u -> ghost-holder v) with the sorted gid list per edge
    edge_gids = {}
    for v in range(S):
        if ghosts[v].size == 0:
            continue
        owners = owner_of[ghosts[v]]
        for u in np.unique(owners):
            sel = ghosts[v][owners == u]
            edge_gids[(int(u), v)] = sel  # sorted (ghosts[v] sorted)

    # greedy edge-coloring into partial-permutation rounds
    rounds: List[List[Tuple[int, int]]] = []
    round_edges: List[List[Tuple[int, int]]] = []
    for e in sorted(edge_gids):
        placed = False
        for r, perm in enumerate(rounds):
            if all(e[0] != a and e[1] != b for (a, b) in perm):
                perm.append(e)
                round_edges[r].append(e)
                placed = True
                break
        if not placed:
            rounds.append([e])
            round_edges.append([e])

    R = max(len(rounds), 1)
    buf = max((edge_gids[e].shape[0] for e in edge_gids), default=1)
    send_idx = np.zeros((S, R, buf), dtype=np.int64)
    send_mask = np.zeros((S, R, buf), dtype=bool)
    recv_idx = np.zeros((S, R, buf), dtype=np.int64)
    recv_mask = np.zeros((S, R, buf), dtype=bool)

    def slots_of(shard, gids):
        # owned slots (sender side)
        pos = np.searchsorted(owned[shard], gids)
        assert bool((owned[shard][pos] == gids).all())
        return pos

    def ghost_slots_of(shard, gids):
        pos = np.searchsorted(ghosts[shard], gids)
        assert bool((ghosts[shard][pos] == gids).all())
        return max_owned + pos

    for r, edges in enumerate(round_edges):
        for (u, v) in edges:
            g = edge_gids[(u, v)]
            n = g.shape[0]
            send_idx[u, r, :n] = slots_of(u, g)
            send_mask[u, r, :n] = True
            recv_idx[v, r, :n] = ghost_slots_of(v, g)
            recv_mask[v, r, :n] = True

    return GeneralIndexMaps(
        nshards=S, max_owned=max_owned, max_ghost=max_ghost, nlocal=nlocal,
        local_gids=local_gids, owned_counts=owned_counts,
        ghost_counts=ghost_counts, owned_mask=owned_mask,
        rounds=tuple(tuple(p) for p in rounds), buf=buf,
        send_idx=send_idx, send_mask=send_mask,
        recv_idx=recv_idx, recv_mask=recv_mask)


def partition_cells_sfc(centroids: np.ndarray, nshards: int) -> np.ndarray:
    """Cell -> shard by contiguous split of the Morton (Z-order) curve
    over cell centroids — the deterministic, communication-free stand-in
    for the reference's graph partitioner (ParMETIS/PT-SCOTCH,
    src/mesh.cpp:153-162): good locality, perfectly balanced counts."""
    c = np.asarray(centroids, dtype=np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    q = np.minimum(((c - lo) / span) * 1024.0, 1023.0).astype(np.uint64)

    key = np.zeros(c.shape[0], dtype=np.uint64)
    for b in range(10):  # 10 bits per axis, explicit interleave
        for ax in range(3):
            bit = (q[:, ax] >> np.uint64(b)) & np.uint64(1)
            key |= bit << np.uint64(3 * b + ax)
    order = np.argsort(key, kind="stable")
    C = c.shape[0]
    bounds = np.linspace(0, C, nshards + 1).astype(np.int64)
    shard = np.empty(C, dtype=np.int64)
    for s in range(nshards):
        shard[order[bounds[s]: bounds[s + 1]]] = s
    return shard
