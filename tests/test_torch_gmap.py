"""The port's general index maps (tpufem_torch/parallel/gmap.py) against
tpufem's: the maps, the edge-coloured rounds and the Morton partition bit
for bit, and the ghost exchanges ``fwd`` / ``rev_add`` on the stacked
shard tensor against tpufem's under its 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpufem.parallel import gmap as tpu_gmap

from tpufem_torch.parallel import gmap
from tpufem_torch.parallel.comm import ShardComm

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")

FIELDS = ("nshards", "max_owned", "max_ghost", "nlocal", "local_gids",
          "owned_counts", "ghost_counts", "owned_mask", "rounds", "buf",
          "send_idx", "send_mask", "recv_idx", "recv_mask")


def _sets(case: str):
    """(local dof sets, owner) of a shard graph: a random ownership with
    random ghosts (tpufem's test), the complete graph (every shard ghosts
    every dof: S - 1 rounds), and a Morton partition of a point cloud
    with a neighbourhood halo."""
    rng = np.random.default_rng(0)
    if case == "random":
        S, N = 4, 40
        owner = rng.integers(0, S, N)
        sets = []
        for s in range(S):
            own = np.flatnonzero(owner == s)
            gh = rng.choice(np.flatnonzero(owner != s), size=7, replace=False)
            sets.append(np.unique(np.concatenate([own, gh])))
        return sets, owner
    if case == "complete":
        S, N = 4, 16
        return [np.arange(N) for _ in range(S)], np.arange(N) % S
    S = 6
    pts = rng.random((300, 3))
    owner = gmap.partition_cells_sfc(pts, S)
    sets = []
    for s in range(S):
        own = np.flatnonzero(owner == s)
        d = np.linalg.norm(pts[:, None] - pts[own][None], axis=-1).min(1)
        sets.append(np.unique(np.concatenate([own,
                                              np.flatnonzero(d < 0.12)])))
    return sets, owner


def _assert_maps_equal(mine, ref):
    for f in FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("case", ["random", "complete", "sfc"])
def test_build_general_maps_bitwise(case):
    sets, owner = _sets(case)
    mine = gmap.build_general_maps(sets, owner)
    _assert_maps_equal(mine, tpu_gmap.build_general_maps(sets, owner))
    if case == "complete":
        assert len(mine.rounds) == 3


@pytest.mark.parametrize("S", [2, 3, 8])
def test_partition_cells_sfc_bitwise(S):
    pts = np.random.default_rng(S).random((1001, 3)) * [1.0, 2.0, 0.5]
    mine = gmap.partition_cells_sfc(pts, S)
    assert np.array_equal(mine, tpu_gmap.partition_cells_sfc(pts, S))
    counts = np.bincount(mine, minlength=S)
    assert counts.max() - counts.min() <= 1


def test_host_helpers_match_tpufem():
    sets, owner = _sets("sfc")
    mine = gmap.build_general_maps(sets, owner)
    ref = tpu_gmap.build_general_maps(sets, owner)
    xg = np.random.default_rng(1).standard_normal(owner.shape[0])
    assert np.array_equal(mine.distribute(xg), ref.distribute(xg))
    xl = mine.distribute(xg)
    assert np.array_equal(mine.collect(xl, xg.shape[0]), xg)
    for s in range(mine.nshards):
        g = mine.local_gids[s, :mine.owned_counts[s]][::3]
        assert np.array_equal(mine.local_of_global(s, g),
                              ref.local_of_global(s, g))


def _tpufem_exchange(ref, y):
    """tpufem's fwd and rev_add of y [S, nlocal] under shard_map."""
    S = ref.nshards
    mesh_axis = Mesh(np.array(jax.devices()[:S]), ("shard",))
    data = dict(send_idx=jnp.asarray(ref.send_idx),
                send_mask=jnp.asarray(ref.send_mask),
                recv_idx=jnp.asarray(ref.recv_idx),
                recv_mask=jnp.asarray(ref.recv_mask))

    def fn(d, v):
        d = {k: a[0] for k, a in d.items()}
        v = v[0]
        args = (d["send_idx"], d["send_mask"], d["recv_idx"], d["recv_mask"])
        return ref.fwd(v, *args)[None], ref.rev_add(v, *args)[None]

    run = jax.jit(jax.shard_map(
        fn, mesh=mesh_axis,
        in_specs=({k: P("shard") for k in data}, P("shard")),
        out_specs=(P("shard"), P("shard"))))
    z, w = run(data, jnp.asarray(y))
    return np.asarray(z), np.asarray(w)


@pytest.mark.parametrize("case", ["random", "complete", "sfc"])
def test_fwd_rev_add_match_tpufem(case):
    """The same bits as tpufem's ppermute rounds, from a vector whose
    ghost slots hold values of their own (so fwd must overwrite them and
    rev_add must carry them)."""
    sets, owner = _sets(case)
    mine = gmap.build_general_maps(sets, owner)
    ref = tpu_gmap.build_general_maps(sets, owner)
    y = np.random.default_rng(2).standard_normal((mine.nshards, mine.nlocal))
    z_ref, w_ref = _tpufem_exchange(ref, y)
    comm = ShardComm(mine.nshards, CPU)
    yt = torch.from_numpy(y)
    assert np.array_equal(mine.fwd(yt, comm).numpy(), z_ref)
    assert np.array_equal(mine.rev_add(yt, comm).numpy(), w_ref)
    assert np.array_equal(yt.numpy(), y)  # the input is left as it was


def test_fwd_rev_add_semantics():
    """fwd restores every ghost from its owner; rev_add accumulates every
    shard's ghost value into the owner (a dense global reduction)."""
    sets, owner = _sets("random")
    gm = gmap.build_general_maps(sets, owner)
    comm = ShardComm(gm.nshards, CPU)
    xg = np.random.default_rng(3).standard_normal(owner.shape[0])
    bad = gm.distribute(xg)
    for s in range(gm.nshards):
        bad[s, gm.max_owned: gm.max_owned + gm.ghost_counts[s]] = -99.0
    z = gm.fwd(torch.from_numpy(bad), comm).numpy()
    assert np.array_equal(z, gm.distribute(xg))
    w = gm.rev_add(torch.from_numpy(gm.distribute(xg)), comm).numpy()
    expect = xg.copy()
    for s in range(gm.nshards):
        gh = gm.local_gids[s, gm.max_owned: gm.max_owned + gm.ghost_counts[s]]
        expect[gh] += xg[gh]
    for s in range(gm.nshards):
        no = gm.owned_counts[s]
        assert np.allclose(w[s, :no], expect[gm.local_gids[s, :no]],
                           rtol=1e-15)
