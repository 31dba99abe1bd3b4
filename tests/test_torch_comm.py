"""The shard exchange layer (tpufem_torch/parallel/comm.py) in its local
form, one process holding every shard as a row of one tensor: ppermute,
psum and all_gather against jax.lax's own under tpufem's 8-device CPU
mesh.  The process-group form runs in tests/test_torch_multihost.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpufem_torch.parallel.comm import ShardComm

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
CPU = torch.device("cpu")
S = 8

PERMS = {
    "down": tuple((s, s - 1) for s in range(1, S)),
    "up": tuple((s, s + 1) for s in range(S - 1)),
    "ring": tuple((s, (s + 1) % S) for s in range(S)),
    "partial": ((0, 5), (3, 1), (6, 0), (7, 3)),
    "swap": ((2, 4), (4, 2)),
    "empty": (),
}


def _jax_collectives(buf: np.ndarray, perm):
    """(ppermute, psum, all_gather) of buf [S, ...] over the shard axis."""
    mesh_axis = Mesh(np.array(jax.devices()[:S]), ("shard",))

    def fn(v):
        v = v[0]
        return (jax.lax.ppermute(v, "shard", list(perm))[None],
                jax.lax.psum(v, "shard"),
                jax.lax.all_gather(v, "shard"))

    run = jax.jit(jax.shard_map(fn, mesh=mesh_axis, in_specs=P("shard"),
                                out_specs=(P("shard"), P(), P()),
                                check_vma=False))
    return tuple(np.asarray(a) for a in run(jnp.asarray(buf)))


@pytest.mark.parametrize("name", list(PERMS))
def test_local_form_matches_jax(name):
    perm = PERMS[name]
    buf = np.random.default_rng(len(perm)).standard_normal((S, 5, 3))
    ref_pp, ref_sum, ref_ag = _jax_collectives(buf, perm)
    comm = ShardComm(S, CPU)
    assert comm.nlocal == S and not comm.group
    t = torch.from_numpy(buf)
    assert np.array_equal(comm.ppermute(t, perm).numpy(), ref_pp)
    assert np.allclose(comm.psum(t).numpy(), ref_sum, rtol=1e-14,
                       atol=1e-14)
    assert np.array_equal(comm.all_gather(t).numpy(), ref_ag)


def test_ppermute_shift_is_a_slice_copy():
    """A run of consecutive rows (the slab halo's s -> s - 1) is one
    slice copy, no index tensors."""
    comm = ShardComm(S, CPU)
    comm.ppermute(torch.zeros(S, 2), PERMS["down"])
    plan = comm._plans[PERMS["down"]]
    assert plan.shift == (1, 0, S - 1) and plan.src is None
    comm.ppermute(torch.zeros(S, 2), PERMS["partial"])
    assert comm._plans[PERMS["partial"]].shift is None


def test_local_rows_and_masks():
    comm = ShardComm(4, CPU)
    assert list(comm.local) == [0, 1, 2, 3]
    assert [comm.row_of(s) for s in range(4)] == [0, 1, 2, 3]
    assert comm.local_mask([0, 2]).tolist() == [True, False, True, False]
