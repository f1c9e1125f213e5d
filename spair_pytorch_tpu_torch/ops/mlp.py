"""Shared-trunk MLP with linear heads (counterpart of
``spair_pytorch_tpu/ops/mlp.py``).

Module names follow the reference state_dict: a multi-head net keeps its
trunk under ``body`` (``body.dense<i>``) and its heads in
``output_layers.<j>``; a single-head net holds ``dense<i>`` and ``out``.
A layer that ``ops/quant.py`` quantized runs its int8 product; quantized
heads run one by one, unpacked.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spair_pytorch_tpu_torch.ops.quant import dense_int8, is_quantized


class MLP(nn.Module):
    def __init__(self, n_in: int, hidden: Sequence[int],
                 heads: Sequence[int]):
        super().__init__()
        self.multi = len(heads) > 1
        self.n_hidden = len(hidden)
        self.widths = tuple(heads)
        trunk = nn.Module() if self.multi else self
        n_prev = n_in
        for i, h in enumerate(hidden):
            trunk.add_module(f"dense{i}", nn.Linear(n_prev, h))
            n_prev = h
        if self.multi:
            self.body = trunk
            self.output_layers = nn.ModuleList(
                nn.Linear(n_prev, out) for out in heads)
        else:
            self.out = nn.Linear(n_prev, heads[0])

    def heads(self):
        return list(self.output_layers) if self.multi else [self.out]

    def forward(self, x, packed: bool = True, dtype=None,
                promote: bool = True):
        """x (..., n_in) -> tuple of head outputs (..., head_dim).

        With ``packed`` the heads run as one GEMM over their concatenated
        weights, split back afterwards (same columns, fewer launches). With
        ``dtype`` (bf16 compute) the input, weights and biases are cast to
        it, the float32 weights staying the masters, and the head outputs
        are promoted back to float32; without ``promote`` they are returned
        as the products made them (``cell_step``'s glue kernels read
        them so)."""
        def dense(v, w, b):
            if dtype is not None:
                w, b = w.to(dtype), b.to(dtype)
            return F.linear(v, w, b)

        def layer_out(v, layer):
            if is_quantized(layer):
                out = dense_int8(layer, v)
                return out.to(dtype) if dtype is not None else out
            return dense(v, layer.weight, layer.bias)

        if dtype is not None:
            x = x.to(dtype)
        trunk = self.body if self.multi else self
        for i in range(self.n_hidden):
            x = torch.relu(layer_out(x, getattr(trunk, f"dense{i}")))
        heads = self.heads()
        if packed and len(heads) > 1 and not any(map(is_quantized, heads)):
            w = torch.cat([h.weight for h in heads], dim=0)
            b = torch.cat([h.bias for h in heads], dim=0)
            outs = torch.split(dense(x, w, b), self.widths, dim=-1)
        else:
            outs = [layer_out(x, h) for h in heads]
        if dtype is not None and promote:
            outs = [o.to(torch.float32) for o in outs]
        return tuple(outs)
