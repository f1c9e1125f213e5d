"""Shared-trunk MLP with linear heads (counterpart of
``spair_pytorch_tpu/ops/mlp.py``).

Module names follow the reference state_dict: a multi-head net keeps its
trunk under ``body`` (``body.dense<i>``) and its heads in
``output_layers.<j>``; a single-head net holds ``dense<i>`` and ``out``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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

    def forward(self, x, packed: bool = True):
        """x (..., n_in) -> tuple of head outputs (..., head_dim).

        With ``packed`` the heads run as one GEMM over their concatenated
        weights, split back afterwards (same columns, fewer launches)."""
        trunk = self.body if self.multi else self
        for i in range(self.n_hidden):
            x = torch.relu(getattr(trunk, f"dense{i}")(x))
        heads = self.heads()
        if packed and len(heads) > 1:
            w = torch.cat([h.weight for h in heads], dim=0)
            b = torch.cat([h.bias for h in heads], dim=0)
            return tuple(torch.split(F.linear(x, w, b), self.widths, dim=-1))
        return tuple(h(x) for h in heads)
