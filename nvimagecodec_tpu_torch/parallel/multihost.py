"""Several processes: initialisation and byte-stream distribution.

The port of nvimagecodec_tpu/parallel/multihost.py, on torch.distributed.
The flow:

1. every process calls `initialize()`, which joins one process group (NCCL
   between GPUs, gloo between CPU processes);
2. encoded byte streams live on the hosts: `shard_streams()` splits a batch
   of them across processes, largest first, so each process's decode work
   balances;
3. each process decodes its share (the host entropy stage is its own CPU
   work);
4. `global_batch()` views the per-process results as one global tensor
   sharded over the processes, in rank order, without moving pixels.

With one process every step is local.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """`torch.distributed.init_process_group` over
    `tcp://coordinator_address` ("host:port") with world size num_processes
    and rank process_id; the backend is "nccl" where CUDA is present unless
    the caller names another ("gloo" for CPU processes). A no-op for one
    process, and for a process that has already joined its group; any other
    failure is raised."""
    import torch.distributed as dist

    if num_processes in (None, 1) and coordinator_address is None:
        return
    if dist.is_initialized():  # tolerate only a second initialisation
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shard_streams(streams: Sequence[bytes], num_shards: int,
                  keys: Optional[Sequence[tuple]] = None) -> List[List[int]]:
    """Balanced split of encoded streams across processes: order by
    ascending cost key (default: minus the byte length, the area proxy, so
    the largest first), deal round-robin. Returns per-shard index lists
    (indices into `streams`)."""
    order = sorted(
        range(len(streams)),
        key=(lambda i: keys[i]) if keys is not None else (lambda i: -len(streams[i])),
    )
    shards: List[List[int]] = [[] for _ in range(num_shards)]
    for pos, idx in enumerate(order):
        shards[pos % num_shards].append(idx)
    return shards


def global_batch(local: torch.Tensor, mesh=None):
    """This process's decoded shard ([local_B, ...]) as one global
    `DTensor` whose leading axis is the concatenation over the processes in
    rank order.

    `DTensor.from_local` over a one-axis `DeviceMesh` of the ranks is the
    direct counterpart of the reference's `make_array_from_process_local_data`:
    each process keeps its pixels where they are, and only the shard sizes
    cross processes. They must split the global batch as `torch.chunk`
    does (equal, a shorter last shard), which is what `Shard(0)` describes;
    other sizes raise ValueError. `mesh` is that `DeviceMesh`, built over
    every rank of the default group when None. With no process group, the
    local tensor is the global batch."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return local
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    if mesh is None:
        mesh = init_device_mesh(local.device.type, (dist.get_world_size(),),
                                mesh_dim_names=("dp",))
    sizes: List[Optional[int]] = [None] * mesh.size()
    dist.all_gather_object(sizes, int(local.shape[0]),
                           group=mesh.get_group())
    total = sum(sizes)
    chunk = -(-total // len(sizes))
    if sizes != [max(0, min(chunk, total - k * chunk))
                 for k in range(len(sizes))]:
        raise ValueError(f"global_batch: shard sizes {sizes} are not an "
                         "even split of the batch")
    shape = (total,) + tuple(local.shape[1:])
    stride = torch.empty((0,) + shape[1:]).stride()
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False,
                              shape=torch.Size(shape), stride=stride)
