"""int8 weights and dynamic int8 activations for the serving path
(counterpart of ``spair_pytorch_tpu/ops/quant.py``).

The JAX package's scheme, unchanged:

  * weights: per-output-channel symmetric int8, scale = max(amax, 1e-8) /
    127, values round(w / scale) (half to even) clipped to +-127;
  * activations: dynamic symmetric int8 per row (the last axis) for dense
    layers and per sample (over C, H, W) for convs, the same rounding;
  * the products accumulate in int32 and are dequantized in float32 as
    ``y.float() * a_scale * w_scale + b``, in that order.

Scales divide by a tensor, not by the Python scalar 127: CUDA divides by a
Python scalar as a multiply by its reciprocal, an ulp away from the true
quotient that JAX computes, which can flip a round half to even.

A quantized layer is a module (``QuantLinear``, ``QuantConv2d``) that
carries ``w_q`` (int8), ``w_scale`` and ``b``. ``quantize_params_int8``
returns a copy of a model whose MLP and backbone layers are replaced by
them; ``ops/mlp.py::MLP`` and ``ops/backbone.py::Backbone`` dispatch on
``is_quantized``, layer by layer, so a model quantized in part works.

The products (``int_mm``) are ``torch._int_mm`` on a CUDA tensor:
cuBLASLt's int8 GEMM, as the JAX package leaves its int8 products to XLA.
It wants more than 16 rows, and inner and output widths that are multiples
of 8: the operands are padded with zeros, which is exact in integers, and
the result is sliced back. A conv is the int8 product of its patches
(``Tensor.unfold`` of the int8 input; PyTorch has no CUDA int8 conv). On a
CPU tensor ``int_mm`` is ``int_mm_plain``, the exact product in float64,
which is also what the card's product is held to.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8


class QuantLinear(nn.Module):
    """A linear layer as int8 weights ``w_q`` (out, in), per-output scales
    ``w_scale`` (out,) and a float32 bias ``b`` (out,)."""

    def __init__(self, w_q, w_scale, b):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)


class QuantConv2d(nn.Module):
    """A VALID conv as int8 weights ``w_q`` (out, in, kh, kw), per-output
    scales ``w_scale`` (out,), a float32 bias ``b`` and its ``stride``."""

    def __init__(self, w_q, w_scale, b, stride: int):
        super().__init__()
        self.stride = stride
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)


def _scale(amax):
    """max(amax, eps) / 127, dividing by a tensor (see the module note)."""
    a = torch.clamp(amax, min=_EPS)
    return a / torch.full_like(a, 127.0)


def _to_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def quantize_linear(layer: nn.Linear) -> QuantLinear:
    w = layer.weight.float()
    scale = _scale(torch.amax(torch.abs(w), dim=1))
    return QuantLinear(_to_int8(w, scale[:, None]), scale,
                       layer.bias.detach().float().clone())


@torch.no_grad()
def quantize_conv(layer: nn.Conv2d) -> QuantConv2d:
    if layer.padding != (0, 0) or layer.dilation != (1, 1) or \
            layer.groups != 1 or layer.stride[0] != layer.stride[1]:
        raise ValueError(f"only VALID, square-stride convs quantize: {layer}")
    w = layer.weight.float()
    scale = _scale(torch.amax(torch.abs(w), dim=(1, 2, 3)))
    return QuantConv2d(_to_int8(w, scale[:, None, None, None]), scale,
                       layer.bias.detach().float().clone(), layer.stride[0])


def quantize_params_int8(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose MLP and backbone layers (every
    ``nn.Linear`` and ``nn.Conv2d`` of an ``MLP`` or a ``Backbone``) are
    quantized; everything else (the edge element, the conv codec) is
    copied as it is. ``model`` itself is not changed."""
    from spair_pytorch_tpu_torch.ops.backbone import Backbone
    from spair_pytorch_tpu_torch.ops.mlp import MLP

    out = copy.deepcopy(model)
    owners = [m for m in out.modules() if isinstance(m, (MLP, Backbone))]
    for owner in owners:
        for parent in list(owner.modules()):
            for name, child in parent.named_children():
                if isinstance(child, nn.Linear):
                    setattr(parent, name, quantize_linear(child))
                elif isinstance(child, nn.Conv2d):
                    setattr(parent, name, quantize_conv(child))
    return out


def quantize_rows(x):
    """Dynamic symmetric int8 along the last axis: (x_q int8, scale
    float32 with a trailing axis of 1)."""
    scale = _scale(torch.amax(torch.abs(x), dim=-1, keepdim=True))
    return _to_int8(x, scale), scale


def int_mm_plain(a, b):
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32, exactly: float64
    holds every partial sum of products of int8 values exactly while K <
    2^53 / 127^2."""
    return (a.double() @ b.double()).to(torch.int32)


def _pad_to(t, dim: int, size: int):
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int_mm(a, w_q):
    """a (M, K) int8 @ w_q (N, K)^T -> (M, N) int32: ``torch._int_mm`` on
    a CUDA tensor, with the operands zero-padded to its shape rules (M >
    16; K and N multiples of 8) and the result sliced back; the exact
    ``int_mm_plain`` on a CPU tensor."""
    if not a.is_cuda:
        return int_mm_plain(a, w_q.t())
    m, k = a.shape
    n = w_q.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(_pad_to(a, 1, kp), 0, max(m, 17)).contiguous()
    w = _pad_to(_pad_to(w_q, 1, kp), 0, np_).contiguous()
    # row-major a against a column-major b, the layout cuBLASLt's int8
    # GEMM takes
    return torch._int_mm(a, w.t())[:m, :n]


def dense_int8(layer: QuantLinear, x):
    """x (..., I) float -> (..., O) float32: the int8 product with x
    quantized per row, dequantized, plus the bias."""
    x_q, a_scale = quantize_rows(x.to(torch.float32))
    y = int_mm(x_q.reshape(-1, x_q.shape[-1]), layer.w_q)
    y = y.reshape(x.shape[:-1] + (layer.w_q.shape[0],))
    return y.to(torch.float32) * a_scale * layer.w_scale + layer.b


def conv_int8(layer: QuantConv2d, x):
    """VALID conv of x (B, C, H, W) float -> (B, O, Ho, Wo) float32, with x
    quantized per sample (over C, H, W)."""
    x = x.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(x), dim=(1, 2, 3), keepdim=True))
    x_q = _to_int8(x, scale)
    o, c, kh, kw = layer.w_q.shape
    s = layer.stride
    patches = x_q.unfold(2, kh, s).unfold(3, kw, s)  # (B, C, Ho, Wo, kh, kw)
    b, _, ho, wo = patches.shape[:4]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * kh * kw)
    y = int_mm(cols, layer.w_q.reshape(o, c * kh * kw))
    y = y.reshape(b, ho, wo, o).permute(0, 3, 1, 2)
    return (y.to(torch.float32) * scale * layer.w_scale[:, None, None]
            + layer.b[:, None, None])


def is_quantized(layer) -> bool:
    return isinstance(layer, (QuantLinear, QuantConv2d))
