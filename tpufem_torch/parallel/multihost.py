"""Multi-process runs over ``torch.distributed`` (counterpart of
tpufem/parallel/multihost.py).

tpufem joins one process per host with ``jax.distributed.initialize``
and spans the SPMD programs over the global device list.  The port joins
its processes with ``torch.distributed.init_process_group`` and gives
each rank one device: every rank holds S / W consecutive shards as one
stacked tensor on it (parallel.comm).  The backend follows the device:
``gloo`` for the CPU, ``nccl`` for CUDA, where each rank takes the GPU
of its ``LOCAL_RANK``.  NCCL runs one rank a GPU: a second rank on a
card raises, and nothing switches to gloo.

The builders of a sharded solver run only for the shards this process
holds (``make_sharded_rows``), tpufem's per-host setup split; which
shards those are is the ``ShardComm``'s layout (parallel.comm).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init_from_env(device: torch.device) -> Tuple[int, int]:
    """Join (or start) the process group; returns (rank, world size).

    The MPI_Init analogue (tpufem/parallel/multihost.py:35-63).  It reads
    ``MASTER_ADDR`` / ``MASTER_PORT`` and ``RANK`` / ``WORLD_SIZE``, or
    tpufem's ``TPUFEM_PROCESS_ID`` / ``TPUFEM_NUM_PROCESSES``; with none
    of them set it returns (0, 1) and touches no runtime.  On a CUDA
    ``device`` the backend is NCCL and the rank's GPU is
    ``cuda:LOCAL_RANK`` (``set_device``); on the CPU gloo.  A group
    already initialised is joined as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = _env_int("WORLD_SIZE", "TPUFEM_NUM_PROCESSES")
    rank = _env_int("RANK", "TPUFEM_PROCESS_ID")
    init_method = None
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        init_method = f"tcp://{addr}:{port}"
    if init_method is None and world_size is None:
        return 0, 1
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a process group needs MASTER_ADDR / MASTER_PORT, "
                         "WORLD_SIZE and RANK (or TPUFEM_NUM_PROCESSES / "
                         "TPUFEM_PROCESS_ID) together")
    if device.type == "cuda":
        rank_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    if backend == "nccl":
        _one_rank_per_gpu()
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: torch.device) -> torch.device:
    """The GPU of this rank: ``cuda:LOCAL_RANK`` (the device's own index
    where LOCAL_RANK is unset), made current.  Raises where LOCAL_RANK
    names no visible GPU: NCCL runs one rank a GPU."""
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = device.index if device.index is not None else 0
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"NCCL runs one rank a GPU: LOCAL_RANK {local} has no GPU of its "
            f"own ({n} visible); run at most {n} ranks on this host")
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def _one_rank_per_gpu() -> None:
    """Raise where two ranks of the group hold the same GPU."""
    import torch.distributed as dist
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    uid = f"{os.uname().nodename}/{getattr(props, 'uuid', props.name)}"
    seen: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(seen, uid)
    if len(set(seen)) != len(seen):
        raise RuntimeError("NCCL runs one rank a GPU: two ranks of this "
                           f"group share one ({seen})")


def make_sharded_rows(comm, row_shape: Tuple[int, ...], dtype,
                      builder: Callable[[int], np.ndarray]) -> np.ndarray:
    """[L, *row_shape]: the rows of the shards ``comm`` gives this
    process (``comm.local``), ``builder(s)`` called ONLY for them
    (tpufem/parallel/multihost.py:79-110)."""
    out = np.empty((comm.nlocal,) + tuple(row_shape), dtype=np.dtype(dtype))
    for j, s in enumerate(comm.local):
        out[j] = np.asarray(builder(int(s)), dtype=out.dtype)
    return out
