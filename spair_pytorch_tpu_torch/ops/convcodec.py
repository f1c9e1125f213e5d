"""Convolutional object encoder and decoder (counterpart of
``spair_pytorch_tpu/ops/convcodec.py``), used when
``cfg.object_codec == 'conv'``.

The encoder is a stack of VALID strided convs over the glimpse, flattened
and mapped by a linear layer to 2 * n_attributes (posterior mean and
log-std); the decoder maps z_what linearly onto the encoder's smallest
feature map and runs transposed convs that mirror the topology back to the
(oh, ow, C + 1) logits. Layers that would shrink the map below 1x1 are left
out (``effective_topology``).

Convs run in NCHW with OIHW kernels. The public layouts are the JAX
package's: the encoder flattens its last feature map in (h, w, c) order
before the linear layer, the decoder's linear output is read as (h, w, c),
and the decoder returns (..., oh, ow, C + 1). The JAX transposed conv
(``lax.conv_transpose``, VALID, HWIO) does not flip its kernel, so it is
``F.conv_transpose2d`` with the kernel flipped in both spatial axes; each
transposed layer's output is padded with zeros or cropped to the mirrored
spatial size, after its bias. Under bf16 compute the input, weights and
biases are cast in the forward and the output returns in float32.

Parameter names (the JAX package's reference converter has none for this
codec, so the port defines them; ``utils/interop.py`` maps the JAX params
onto them): encoder ``convs.<i>.weight`` (out, in, k, k), ``convs.<i>.bias``,
``out.weight`` (2A, flat) over the (h, w, c) flattening, ``out.bias``;
decoder ``inp.weight`` (c*h*w, A) with rows in (h, w, c) order,
``inp.bias``, ``deconvs.<i>.weight`` (in, out, k, k), the JAX kernel flipped
in both spatial axes, and ``deconvs.<i>.bias``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (filters, kernel, stride)
CONV_CODEC_TOPOLOGY: Tuple[Tuple[int, int, int], ...] = (
    (32, 4, 2),
    (32, 3, 2),
    (32, 3, 2),
    (32, 1, 1),
)


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


def effective_topology(object_hw, topology=CONV_CODEC_TOPOLOGY):
    """The topology's leading layers that keep the feature map at least
    1x1 for glimpses of ``object_hw``."""
    h, w = object_hw
    out = []
    for (f, k, s) in topology:
        nh, nw = _conv_out(h, k, s), _conv_out(w, k, s)
        if nh < 1 or nw < 1:
            break
        out.append((f, k, s))
        h, w = nh, nw
    return tuple(out)


def codec_shapes(object_hw, topology=None):
    """Spatial shapes before and after each (effective) encoder conv."""
    topology = effective_topology(
        object_hw, CONV_CODEC_TOPOLOGY if topology is None else topology)
    shapes = [tuple(object_hw)]
    h, w = object_hw
    for (_, k, s) in topology:
        h, w = _conv_out(h, k, s), _conv_out(w, k, s)
        shapes.append((h, w))
    return shapes


def _cast(dtype, *tensors):
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) for t in tensors)


class ConvEncoder(nn.Module):
    """glimpses (..., C, oh, ow) -> (..., n_out) float32."""

    def __init__(self, in_channels: int, n_out: int, object_hw,
                 topology=CONV_CODEC_TOPOLOGY):
        super().__init__()
        self.topology = effective_topology(object_hw, topology)
        c_prev = in_channels
        convs = []
        for (f, k, s) in self.topology:
            convs.append(nn.Conv2d(c_prev, f, k, stride=s))
            c_prev = f
        self.convs = nn.ModuleList(convs)
        h, w = codec_shapes(object_hw, self.topology)[-1]
        self.out = nn.Linear(c_prev * h * w, n_out)

    def forward(self, glimpses, dtype=None):
        lead = glimpses.shape[:-3]
        x = glimpses.reshape((-1,) + tuple(glimpses.shape[-3:]))
        (x,) = _cast(dtype, x)
        for conv, (_, _, s) in zip(self.convs, self.topology):
            x = torch.relu(F.conv2d(x, *_cast(dtype, conv.weight, conv.bias),
                                    stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
        out = F.linear(x, *_cast(dtype, self.out.weight, self.out.bias))
        return out.reshape(tuple(lead) + (out.shape[-1],)).to(torch.float32)


class ConvDecoder(nn.Module):
    """z (..., n_in) -> logits (..., oh, ow, out_channels) float32."""

    def __init__(self, n_in: int, out_channels: int, object_hw,
                 topology=CONV_CODEC_TOPOLOGY):
        super().__init__()
        self.topology = effective_topology(object_hw, topology)
        self.object_hw = tuple(object_hw)
        shapes = codec_shapes(object_hw, self.topology)
        self.small = shapes[-1] + (self.topology[-1][0],)   # (h, w, c)
        # each up-layer's spatial output: the mirrored encoder input
        self.targets = tuple(reversed(shapes[:-1]))
        h, w, c_small = self.small
        self.inp = nn.Linear(n_in, c_small * h * w)
        rev = list(reversed(self.topology))
        deconvs = []
        c_prev = c_small
        for i, (_, k, s) in enumerate(rev):
            c_out = rev[i + 1][0] if i + 1 < len(rev) else out_channels
            deconvs.append(nn.ConvTranspose2d(c_prev, c_out, k, stride=s))
            c_prev = c_out
        self.deconvs = nn.ModuleList(deconvs)
        self.strides = tuple(s for (_, _, s) in rev)

    def forward(self, z, dtype=None):
        lead = z.shape[:-1]
        x = z.reshape(-1, z.shape[-1])
        (x,) = _cast(dtype, x)
        x = torch.relu(F.linear(x, *_cast(dtype, self.inp.weight,
                                          self.inp.bias)))
        h, w, c = self.small
        x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for i, (deconv, s) in enumerate(zip(self.deconvs, self.strides)):
            x = F.conv_transpose2d(x, *_cast(dtype, deconv.weight,
                                             deconv.bias), stride=s)
            th, tw = self.targets[i]
            x = F.pad(x, (0, max(0, tw - x.shape[3]), 0,
                          max(0, th - x.shape[2])))[:, :, :th, :tw]
            if i < last:
                x = torch.relu(x)
        oh, ow = self.object_hw
        x = x.permute(0, 2, 3, 1)
        return x.reshape(tuple(lead) + (oh, ow, x.shape[-1])).to(
            torch.float32)
