"""Spatial transformer as separable hat-weight matmuls (counterpart of
``spair_pytorch_tpu/ops/stn.py``).

Semantics are ``F.grid_sample(align_corners=True)``: the crop uses border
padding (source coordinates clamped to the image), the paste zeros padding
(hat weights vanish outside the glimpse). Boxes are the reference's
normalized z_where = [xt, yt, xs, ys], (xt, yt) the box centre in [0, 1].
"""

from __future__ import annotations

import torch


def _source_coords_crop(t, s, out_size: int, in_size: int):
    """Input-image coordinate of each crop output pixel: (...,) -> (..., out)."""
    j = torch.arange(out_size, dtype=torch.float32, device=t.device)
    u_out = 2.0 * j / (out_size - 1) - 1.0
    x = s[..., None] * u_out + (2.0 * t[..., None] - 1.0)
    return (x + 1.0) * (in_size - 1) / 2.0


def _source_coords_paste(t, s, out_size: int, in_size: int):
    """Glimpse coordinate sampled by each canvas pixel of a paste: the
    inverse affine of the crop, u = (u' - (2t - 1)) / s.

    The divisor is a tensor: CUDA divides by a Python scalar as a multiply
    by its reciprocal, an ulp off the correctly rounded quotient the
    compositor kernels take, and at an integer coordinate an ulp flips the
    sign of the hat derivative in the box gradient."""
    i = torch.arange(out_size, dtype=torch.float32, device=t.device)
    u_out = 2.0 * i / torch.full_like(i, out_size - 1) - 1.0
    u = (u_out - (2.0 * t[..., None] - 1.0)) / s[..., None]
    return (u + 1.0) * (in_size - 1) / 2.0


def _hat(src, in_size: int):
    """Bilinear weights w[..., j, a] = max(0, 1 - |src_j - a|)."""
    a = torch.arange(in_size, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - a), min=0.0)


def crop_weights(boxes, object_shape, image_hw):
    """(wy (..., oh, H), wx (..., ow, W)), border padding."""
    oh, ow = object_shape
    ih, iw = image_hw
    xt, yt, xs, ys = boxes.unbind(-1)
    sy = torch.clamp(_source_coords_crop(yt, ys, oh, ih), 0.0, ih - 1)
    sx = torch.clamp(_source_coords_crop(xt, xs, ow, iw), 0.0, iw - 1)
    return _hat(sy, ih), _hat(sx, iw)


def paste_weights(boxes, object_shape, image_hw):
    """(py (..., H, oh), px (..., W, ow)), zeros padding."""
    oh, ow = object_shape
    ih, iw = image_hw
    xt, yt, xs, ys = boxes.unbind(-1)
    sy = _source_coords_paste(yt, ys, ih, oh)
    sx = _source_coords_paste(xt, xs, iw, ow)
    return _hat(sy, oh), _hat(sx, ow)


def crop_glimpses(image, boxes, object_shape, dtype=None):
    """image (B, C, H, W), boxes (B, N, 4) -> glimpses (B, N, C, oh, ow).
    With ``dtype`` (bf16 compute) both einsums run in it."""
    ih, iw = image.shape[-2:]
    wy, wx = crop_weights(boxes, object_shape, (ih, iw))
    if dtype is not None:
        wy, wx = wy.to(dtype), wx.to(dtype)
    return crop_with_weights(image, wy, wx, dtype)


def crop_with_weights(image, wy, wx, dtype=None):
    """The crop's two einsums on its hat weights wy (B, N, oh, H) and wx
    (B, N, ow, W), already in ``dtype``: (B, N, C, oh, ow)."""
    if dtype is not None:
        image = image.to(dtype)
    tmp = torch.einsum("bnyh,bchw->bncyw", wy, image)
    return torch.einsum("bncyw,bnxw->bncyx", tmp, wx)


def paste_glimpses(glimpses, boxes, image_hw, dtype=None):
    """glimpses (B, N, C, oh, ow), boxes (B, N, 4) -> per-object canvases
    (B, N, C, H, W): the inverse-STN paste with ``paste_weights``
    (align_corners=True, zeros padding). It materializes every object's
    canvas, so it is for small inputs and tests; the compositors paste
    chunk by chunk or in the kernels. With ``dtype`` both einsums run in
    it."""
    oh, ow = glimpses.shape[-2:]
    py, px = paste_weights(boxes, (oh, ow), image_hw)
    if dtype is not None:
        glimpses, py, px = glimpses.to(dtype), py.to(dtype), px.to(dtype)
    tmp = torch.einsum("bnhy,bncyx->bnchx", py, glimpses)
    return torch.einsum("bnchx,bnwx->bnchw", tmp, px)
