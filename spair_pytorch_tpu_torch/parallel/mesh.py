"""The data-parallel world (counterpart of ``spair_pytorch_tpu/parallel/
mesh.py``'s 'data' axis), on ``torch.distributed``.

The JAX package shards the batch over a device mesh and lets XLA insert the
gradient reduction. Here every rank is a process with one device: it trains
on its slice of the global batch (``shard_batch``, ``data/sharded.py``),
its gradients are summed over the ranks (``all_reduce_``) before clipping
and Adam, and its logged scalars are reduced (``reduce_metrics``). The world
comes from the environment that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
it the world has one rank. The backend is NCCL on CUDA devices (rank r on
``cuda:LOCAL_RANK``) and gloo on the CPU. A failed init raises.

On the card the data-parallel step is captured as a CUDA graph as the
one-process step is (``parallel/captured.py``), NCCL's collectives inside
it. So every collective of a step is one a graph can hold: its buffers are
made inside the step (a capture places them in the graph's pool), its
result is written into a tensor of a fixed shape, and the NCCL
communicator exists before the first step (``make_mesh`` creates it with
the group): its creation is not work a capture can hold.

The mesh's second axis, 'model' (the JAX package's ``parallel/
constraints.py``, which shards the object axis of the glimpse and render
paths over devices and lets GSPMD insert the collectives), is not ported,
by decision. It changes where work is placed, not what is computed, as
``scan_remat`` does; the JAX CLI never turns it on (its ``train`` builds the
mesh with ``n_model=1``); and a b128 main-path step peaks at 2.756 GiB of
device memory on an 80 GB H100 (``chip_smoke.py`` phase 14(d)), so no
configuration needs a model split over cards. Were one needed, it would be
object-parallel compositing: each rank pastes its share of the objects and
num/den are summed with one all-reduce.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from spair_pytorch_tpu_torch.data.sharded import host_slice


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world: ``world_size``
    ranks, this one ``rank``, computing on ``device``. ``owns_group``: the
    process group was initialized by ``make_mesh`` (``close`` ends it)."""
    world_size: int
    rank: int
    device: torch.device
    owns_group: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def slice(self, global_batch: int):
        """[start, stop) of the global batch this rank trains on."""
        return host_slice(global_batch, self.world_size, self.rank)

    def close(self):
        if self.owns_group and dist.is_initialized():
            if self.device.type == "cuda":
                # no collective of a replayed graph is left in flight
                torch.cuda.synchronize(self.device)
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(device="cuda") -> Mesh:
    """Join (or start) the process group of the world the environment
    describes, on ``device``'s type: ``cuda:LOCAL_RANK`` with NCCL, or the
    CPU with gloo. A process group that is already initialized is used as
    it is."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return Mesh(dist.get_world_size(), dist.get_rank(), device, False)
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init = "env://"
    elif world == 1:
        init = f"tcp://localhost:{_free_port()}"
    else:
        raise ValueError(f"WORLD_SIZE={world} needs MASTER_ADDR and "
                         "MASTER_PORT (torchrun sets them)")
    # device_id: NCCL's communicator is created here, not by the first
    # collective, which may lie inside a capture
    cuda = device.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world, rank=rank,
                            device_id=device if cuda else None)
    return Mesh(world, rank, device, True)


def shard_batch(mesh: Mesh, batch: Sequence[torch.Tensor]):
    """This rank's slice of a global batch (a tuple of tensors with the
    batch on the leading axis)."""
    start, stop = mesh.slice(batch[0].shape[0])
    return tuple(t[start:stop] for t in batch)


def _to_cpu(obj):
    """``obj`` (nested dicts and lists) with its tensors on the CPU, so that
    it unpickles on every rank's own device."""
    if torch.is_tensor(obj):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def replicate(mesh: Mesh, state):
    """Give every rank rank 0's train state: parameters and buffers, Adam's
    state, the step and the generator. Returns ``state``, updated in
    place."""
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            dist.broadcast(t, src=0)
    rest = [{"optimizer": _to_cpu(state.optimizer.state_dict()),
             "generator": state.generator.get_state(),
             "step": int(state.step)}] if mesh.is_main else [None]
    dist.broadcast_object_list(rest, src=0, device=mesh.device)
    if not mesh.is_main:
        state.optimizer.load_state_dict(rest[0]["optimizer"])
        state.generator.set_state(rest[0]["generator"])
        state.step.fill_(rest[0]["step"])
    return state


def all_reduce_(tensors: Sequence[torch.Tensor]):
    """Sum ``tensors`` over the ranks in place, as one flat all-reduce of a
    buffer made here (inside a capture, in the graph's pool)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def global_max(count: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's 0-d int32 ``count``, as a new 0-d
    tensor (one MAX all-reduce)."""
    out = count.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def reduce_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor]):
    """The step's scalars over the ranks, in one all-gather into a
    (world, keys) buffer: the loss terms (``losses/*``, each rank's share
    of the global loss) summed, ``debug/pres_count_max`` the largest, every
    other scalar averaged."""
    keys = list(metrics)
    local = torch.stack([metrics[k].to(torch.float32).reshape(())
                         for k in keys])
    every = local.new_empty(mesh.world_size * len(keys))
    dist.all_gather_into_tensor(every, local)
    every = every.view(mesh.world_size, len(keys))
    sums, maxes, means = (torch.sum(every, dim=0), torch.amax(every, dim=0),
                          torch.mean(every, dim=0))
    return {k: (sums if k.startswith("losses/") else
                maxes if k == "debug/pres_count_max" else means)[i]
            for i, k in enumerate(keys)}
