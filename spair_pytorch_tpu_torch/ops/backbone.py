"""Conv backbone with receptive-field-aligned padding (counterpart of
``spair_pytorch_tpu/ops/backbone.py``).

Convs run in NCHW with OIHW kernels, PyTorch's own layout; the output is
permuted to the JAX package's (B, grid_h, grid_w, F) feature grid. Under
bf16 compute the input, weights and biases are cast in the forward, so the
float32 weights stay the masters. Module
names follow the reference state_dict (``net.conv_<i>``, ``net.conv_out``).
A conv that ``ops/quant.py`` quantized runs its int8 product on the float32
input, its output cast back to the compute dtype.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spair_pytorch_tpu_torch.ops.quant import conv_int8, is_quantized


def uniform_fan_in_(tensor, fan_in: int, generator: torch.Generator):
    """torch's default Linear/Conv init, U(-1/sqrt(fan_in), +1/sqrt(fan_in)),
    drawn from an explicit generator."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def reset_fan_in_(module: nn.Module, generator: torch.Generator):
    """Re-draw every Linear/Conv2d/ConvTranspose2d weight and bias in
    ``module`` (in registration order) with the fan-in uniform init; a
    transposed conv's fan-in is its input channels times its kernel area,
    as the JAX package counts it."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0]).numel()
            uniform_fan_in_(m.weight, fan_in, generator)
            uniform_fan_in_(m.bias, fan_in, generator)


def grid_geometry(image_hw: Tuple[int, int],
                  topology: Sequence[Tuple[int, int, int]]):
    """(pad_top, pad_bottom, pad_left, pad_right), (grid_h, grid_w),
    (cell_h, cell_w); pads (9, 14, 9, 14) and an 11x11 grid of 12-px cells
    for the reference topology on 128x128."""
    j = [1, 1]  # cumulative stride per axis
    r = [1, 1]  # receptive field per axis
    for (_, k, s) in topology:
        r = [r[i] + (k - 1) * j[i] for i in range(2)]
        j = [j[i] * s for i in range(2)]
    cell = j
    pre = [int(math.floor(r[i] / 2 - cell[i] / 2)) for i in range(2)]
    n_cells = [int(math.ceil(image_hw[i] / cell[i])) for i in range(2)]
    required = [r[i] + (n_cells[i] - 1) * cell[i] for i in range(2)]
    post = [required[i] - image_hw[i] - pre[i] for i in range(2)]
    pads = (pre[0], post[0], pre[1], post[1])
    return pads, tuple(n_cells), tuple(cell)


class Backbone(nn.Module):
    """ZeroPad (top, bottom, left, right), VALID strided convs with ReLU
    between, and a linear 1x1 output conv."""

    def __init__(self, in_channels: int, n_out: int,
                 topology: Sequence[Tuple[int, int, int]],
                 pads: Tuple[int, int, int, int]):
        super().__init__()
        layers = OrderedDict()
        c_prev = in_channels
        for i, (f, k, s) in enumerate(topology):
            layers[f"conv_{i}"] = nn.Conv2d(c_prev, f, k, stride=s)
            layers[f"relu_{i}"] = nn.ReLU()
            c_prev = f
        layers["conv_out"] = nn.Conv2d(c_prev, n_out, 1)
        self.net = nn.Sequential(layers)
        pt, pb, pl, pr = pads
        self.pad = nn.ZeroPad2d((pl, pr, pt, pb))

    def forward(self, x_nchw, dtype=None):
        """(B, C, H, W) -> features (B, grid_h, grid_w, n_out), computed in
        ``dtype`` when given (and returned in it)."""
        dtype = dtype or x_nchw.dtype
        x = self.pad(x_nchw.to(dtype))
        for m in self.net:
            if is_quantized(m):
                x = conv_int8(m, x).to(dtype)
            elif isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(dtype), m.bias.to(dtype),
                             m.stride)
            else:
                x = m(x)
        return x.permute(0, 2, 3, 1)
