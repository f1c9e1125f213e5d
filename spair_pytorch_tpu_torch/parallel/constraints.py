"""The mesh's 'model' axis: the cells of the inference split over the ranks
of a model group (counterpart of ``spair_pytorch_tpu/parallel/
constraints.py``, whose ``constrain`` lets GSPMD place the split and insert
its collectives; here they are written out).

The SPAIR grid has a second embarrassingly parallel axis besides the batch:
its N cells. In independent inference every head and the glimpse crop run
batched over (B, N, ...); the wavefront, raster and rowscan scans run each
front's K lanes batched over (B, K, ...). With ``make_mesh(n_model=M)``
(``parallel/mesh.py``) each rank of a model group takes one block of them:

- ``shard_cells(t, mesh)``: this rank's block of ``ceil(N / M)`` cells
  along an axis. The last block is padded by clamping the cell index to
  N - 1, so padded rows are real cells whose outputs are thrown away (they
  cannot turn into NaN, whose zero cotangent would still be NaN). Its
  backward writes the block's cotangent into zeros: no communication.
- ``gather_cells(t, mesh, n)``: every rank's block, in model-rank order,
  trimmed to n cells: one all-gather over the model group. Its backward is
  one reduce-scatter (a sum) of the zero-padded cotangent.

Everything after the gather (the decoder, the KLs, the render, the loss)
is replicated on the ranks of a model group, as the JAX package constrains
the inference alone. The scans split a front's lanes only when M divides
K, JAX's rule (``lanes_split``); otherwise every rank runs every lane.

The gradient rule. Each rank of a model group scales its loss by 1 / M,
and the gradients are then summed over the whole world by the data
parallel step's one flat all-reduce (``mesh.all_reduce_``). Every term
comes out right:

- what is replicated downstream computes the same gradient on all M
  ranks, scaled 1 / M, and the sum counts it once;
- the cotangent of a rank's block is the reduce-scatter of M such shares,
  the whole cotangent of the block: the heads' gradients on a rank are
  those of its own block's cells, and the sum over the model group
  completes them; so do the gradients that reach the backbone and the
  edge element through ``shard_cells``;
- lanes that are not split are replicated, and count once, as above;
- the sum over the data ranks is the data-parallel one, as before.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def lanes_split(k: int, mesh) -> bool:
    """Whether the scans split a front's ``k`` lanes over the mesh's model
    axis: when it has more than one rank and divides k (JAX's rule)."""
    return mesh is not None and mesh.n_model > 1 and k % mesh.n_model == 0


def block(n: int, mesh):
    """(start, stop, size) of this rank's block of ``n`` cells: ``size`` =
    ceil(n / M) rows, of which [start, stop) are real (stop - start may be
    less than size, or 0)."""
    size = -(-n // mesh.n_model)
    start = min(mesh.model_rank * size, n)
    return start, min(start + size, n), size


class _ShardCells(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, start, stop, size):
        ctx.dim, ctx.start, ctx.stop, ctx.n = dim, start, stop, t.shape[dim]
        real = t.narrow(dim, start, stop - start)
        pad = size - (stop - start)
        if pad == 0:
            return real.clone()
        shape = list(t.shape)
        shape[dim] = pad
        last = t.narrow(dim, t.shape[dim] - 1, 1)
        return torch.cat([real, last.expand(shape)], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        shape = list(grad.shape)
        shape[ctx.dim] = ctx.n
        out = grad.new_zeros(shape)
        out.narrow(ctx.dim, ctx.start, ctx.stop - ctx.start).copy_(
            grad.narrow(ctx.dim, 0, ctx.stop - ctx.start))
        return out, None, None, None, None


def shard_cells(t: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of the cells on ``t``'s axis ``dim``: ceil(N / M)
    cells, padded with copies of cell N - 1 (module docstring)."""
    start, stop, size = block(t.shape[dim], mesh)
    return _ShardCells.apply(t, dim, start, stop, size)


class _GatherCells(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, m, n):
        ctx.group, ctx.m, ctx.n = group, m, n
        b, size = t.shape[:2]
        every = t.new_empty((m * b,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(every, t.contiguous(), group=group)
        every = every.view((m, b) + tuple(t.shape[1:])).transpose(0, 1)
        return every.reshape((b, m * size) + tuple(t.shape[2:]))[:, :n]

    @staticmethod
    def backward(ctx, grad):
        m, n = ctx.m, ctx.n
        b, rest = grad.shape[0], tuple(grad.shape[2:])
        size = -(-n // m)
        padded = grad.new_zeros((b, m * size) + rest)
        padded[:, :n] = grad
        padded = padded.view((b, m, size) + rest).transpose(0, 1)
        out = grad.new_empty((b, size) + rest)
        dist.reduce_scatter_tensor(out, padded.reshape((m * b, size) + rest),
                                   op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None, None


def gather_cells(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Every rank's block ``t`` (B, ceil(n / M), ...) of the model group,
    in model-rank order on axis 1, trimmed to ``n`` cells (module
    docstring)."""
    return _GatherCells.apply(t, mesh.model_group, mesh.n_model, n)
