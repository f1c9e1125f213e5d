"""The (data, model) world (counterpart of ``spair_pytorch_tpu/parallel/
mesh.py``), on ``torch.distributed``.

The JAX package shards the batch over a device mesh and lets XLA insert the
gradient reduction. Here every rank is a process with one device: it trains
on its slice of the global batch (``shard_batch``, ``data/sharded.py``),
its gradients are summed over the ranks (``all_reduce_``) before clipping
and Adam, and its logged scalars are reduced (``reduce_metrics``). The world
comes from the environment that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
it the world has one rank. The backend is NCCL on CUDA devices (rank r on
``cuda:LOCAL_RANK``) and gloo on the CPU. A failed init raises.

The mesh's second axis, 'model' (the JAX package's ``make_mesh(n_data,
n_model)`` and ``parallel/constraints.py``), splits the cells of the
inference over the ranks of a model group. ``make_mesh(n_model=M)`` lays
the world out as JAX's ``reshape(n_data, n_model)`` does (``rank =
data_rank * M + model_rank``, ``mesh_coords``): a model group is M
consecutive ranks, which train on the same data slice, and a data group is
the ranks of one model rank, one from each model group. The batch slice and
the scenes a rank generates follow its data rank. How the cells are split,
and why the gradients come out right, is in ``parallel/constraints.py``.
With M = 1 no subgroup is made and the data group is the world.

On the card the step is captured as a CUDA graph as the one-process step
is (``parallel/captured.py``), NCCL's collectives inside it, those of the
subgroups too. So every collective of a step is one a graph can hold: its
buffers are made inside the step (a capture places them in the graph's
pool), its result is written into a tensor of a fixed shape, and every
NCCL communicator exists before the first step: ``make_mesh`` creates the
world's with the group (``device_id``) and each subgroup's with the
subgroup (bound to the device, so NCCL splits it off the world's there).
Every rank makes every subgroup, in the same order: a split is a
collective of the whole world.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from spair_pytorch_tpu_torch.data.sharded import host_slice


def mesh_coords(rank: int, world: int, n_model: int) -> Tuple[int, int]:
    """(data rank, model rank) of ``rank`` in a world of ``world`` ranks
    laid out as JAX's ``reshape(world // n_model, n_model)``. A world that
    ``n_model`` does not divide raises."""
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world of "
                         f"{world} ranks")
    return rank // n_model, rank % n_model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) world: ``world_size``
    ranks, this one ``rank``, computing on ``device``, ``n_model`` ranks to
    a model group. ``owns_group``: the process group was initialized by
    ``make_mesh`` (``close`` ends it). ``data_group`` / ``model_group``:
    this rank's subgroups, which ``close`` destroys (None with ``n_model``
    = 1, where the data group is the world)."""
    world_size: int
    rank: int
    device: torch.device
    owns_group: bool
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_rank(self) -> int:
        return mesh_coords(self.rank, self.world_size, self.n_model)[0]

    @property
    def model_rank(self) -> int:
        return mesh_coords(self.rank, self.world_size, self.n_model)[1]

    def slice(self, global_batch: int):
        """[start, stop) of the global batch this rank trains on: its data
        rank's slice."""
        return host_slice(global_batch, self.n_data, self.data_rank)

    def close(self):
        if not dist.is_initialized():
            return
        if self.device.type == "cuda":
            # no collective of a replayed graph is left in flight
            torch.cuda.synchronize(self.device)
        for group in (self.data_group, self.model_group):
            if group is not None:
                dist.destroy_process_group(group)
        if self.owns_group:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def subgroups(n_model: int, device):
    """Every model group (M consecutive ranks), then every data group (the
    ranks of one model rank), made on every rank in that order; on the card
    each is bound to ``device``, so its communicator is made here. Returns
    this rank's (data group, model group)."""
    device = torch.device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = world // n_model
    members = ([("model", [d * n_model + m for m in range(n_model)])
                for d in range(n_data)]
               + [("data", [d * n_model + m for d in range(n_data)])
                  for m in range(n_model)])
    mine = {}
    for axis, ranks in members:
        group = dist.new_group(
            ranks, device_id=device if device.type == "cuda" else None)
        if rank in ranks:
            mine[axis] = group
    return mine["data"], mine["model"]


def make_mesh(device="cuda", n_model: int = 1) -> Mesh:
    """Join (or start) the process group of the world the environment
    describes, on ``device``'s type: ``cuda:LOCAL_RANK`` with NCCL, or the
    CPU with gloo. A process group that is already initialized is used as
    it is. ``n_model`` > 1 lays the world out as a (data, model) mesh and
    makes its subgroups (module docstring); it must divide the world."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        torch.cuda.set_device(device)
    owns = not dist.is_initialized()
    if owns:
        mesh_coords(rank, world, n_model)
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
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=init, world_size=world,
                                rank=rank, device_id=device if cuda else None)
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh_coords(rank, world, n_model)
    if n_model == 1:
        return Mesh(world, rank, device, owns)
    data_group, model_group = subgroups(n_model, device)
    return Mesh(world, rank, device, owns, n_model, data_group, model_group)


def shard_batch(mesh: Mesh, batch: Sequence[torch.Tensor]):
    """This rank's slice of a global batch (a tuple of tensors with the
    batch on the leading axis): its data rank's."""
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
    (world, keys) buffer. The ranks of a model group hold the same values,
    so the rows of model rank 0 are read, one for each data rank: the loss
    terms (``losses/*``, each data rank's share of the global loss)
    summed, ``debug/pres_count_max`` the largest, every other scalar
    averaged."""
    keys = list(metrics)
    local = torch.stack([metrics[k].to(torch.float32).reshape(())
                         for k in keys])
    every = local.new_empty(mesh.world_size * len(keys))
    dist.all_gather_into_tensor(every, local)
    every = every.view(mesh.n_data, mesh.n_model, len(keys))[:, 0]
    sums, maxes, means = (torch.sum(every, dim=0), torch.amax(every, dim=0),
                          torch.mean(every, dim=0))
    return {k: (sums if k.startswith("losses/") else
                maxes if k == "debug/pres_count_max" else means)[i]
            for i, k in enumerate(keys)}



def gather_batch(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """Each of ``tensors`` (this data rank's rows of a batch, float32)
    concatenated over the data ranks in their order, as the one-process
    batch holds them, in one all-gather over the data group."""
    b = tensors[0].shape[0]
    local = torch.cat([t.reshape(b, -1) for t in tensors], dim=1)
    every = local.new_empty((mesh.n_data * b, local.shape[1]))
    dist.all_gather_into_tensor(every, local.contiguous(),
                                group=mesh.data_group)
    out, offset = [], 0
    for t in tensors:
        width = t[0].numel()
        out.append(every[:, offset:offset + width].reshape(
            (mesh.n_data * b,) + tuple(t.shape[1:])))
        offset += width
    return out
