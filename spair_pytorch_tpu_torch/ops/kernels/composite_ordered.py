"""Depth-ordered alpha-over compositing: the CUDA kernels, their plain
versions, autograd.

``composite_ordered`` is the plain version of ordered mode (the port of
``spair_pytorch_tpu/models/render.py::composite_ordered``, plain ``jnp``
there): objects sorted front to back by depth, pasted ``chunk`` at a time
onto whole canvases and composited one by one under autograd. It is what
``render_backend='xla'`` and CPU tensors run, and the CPU tests' reference.

``composite_over`` is the differentiable entry ``models/render.py`` takes
for every other backend. On CUDA tensors it takes ``ordered_composite``,
which keeps the stable sort by depth and the gather in PyTorch (small, and
autograd's gather returns the gradients to the objects' own slots; depth
gets none) and hands the sorted objects to ``OrderedFunction``: forward
``ordered_forward`` and backward ``ordered_backward``, which on CUDA
tensors launch the kernels of ``csrc/composite_ordered.cu`` or raise, and
on CPU tensors run their plain versions ``ordered_forward_plain`` and
``ordered_backward_plain``, the kernels' algorithm as tensor code (the
front-to-back transmittance, the back-to-front remainder, the inclusive
clip mask, no division). On CPU tensors ``composite_over`` returns
``composite_ordered``'s result; the tests run ``ordered_composite`` there
to hold the plain versions against autograd.

The kernels take only the objects a canvas tile lists: those whose gate is
nonzero and whose support meets the tile, ``composite.py::cull_tiles``
with the kernels' 32x8 tile, in compositing order.
"""

from __future__ import annotations

import functools

import torch

from spair_pytorch_tpu_torch.ops.kernels.composite import (
    MAX_SCENES, _device_of, _raise_on, load_library, paste_vjp, safe_boxes)
from spair_pytorch_tpu_torch.ops.stn import paste_weights

# colour channels the kernels take (csrc/composite_ordered.cu kMaxC)
MAX_CHANNELS = 4
# the kernels' canvas tile, rows and columns (kTileH, kTileW)
TILE = (32, 8)
# support pixels in one dP tile of the object pass, before the shared-memory
# budget
OBJECT_TILE_PX = 2048
_SMEM_MAX = 227 * 1024


def composite_ordered(color, alpha, z_depth_flat, z_where, image_hw,
                      chunk: int):
    """Depth-ordered alpha-over compositing: (B, C, H, W), un-clipped.

    color (B, N, C, oh, ow), alpha (B, N, 1, oh, ow), z_depth_flat
    (B, N, 1), z_where (B, N, 4). Objects are sorted front to back by
    z_depth (higher is nearer; a stable sort, so equal depths keep their
    object order) and composited with the over operator under a running
    per-pixel transmittance:

        out = sum_o T_o a_o c_o,   T_o = prod_{o' nearer} (1 - a_o'),

    with each pasted alpha a_o clipped to [0, 1]. Objects are pasted
    ``chunk`` at a time and composited one by one within a chunk; the last
    chunk is padded with zero glimpses on the safe box [0.5, 0.5, 1, 1] (a
    zero scale would divide 0 by 0), which are identities of the over
    operator."""
    b, n, c = color.shape[:3]
    oh, ow = color.shape[-2:]
    h, w = image_hw
    order = torch.argsort(-z_depth_flat[..., 0], dim=1, stable=True)

    def take(t):
        return torch.take_along_dim(
            t, order.reshape((b, n) + (1,) * (t.ndim - 2)), dim=1)

    color, alpha, z_where = take(color), take(alpha), take(z_where)
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        def padn(t):
            return torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        color, alpha = padn(color), padn(alpha)
        safe = safe_boxes(b, pad, z_where.dtype, z_where.device)
        z_where = torch.cat([z_where, safe], dim=1)
    img = torch.zeros((b, c, h, w), dtype=color.dtype, device=color.device)
    trans = torch.ones((b, 1, h, w), dtype=color.dtype, device=color.device)
    for start in range(0, n + pad, chunk):
        sl = slice(start, start + chunk)
        py, px = paste_weights(z_where[:, sl], (oh, ow), (h, w))
        glimpse = torch.cat([color[:, sl], alpha[:, sl]], dim=2)
        tmp = torch.einsum("bnhy,bncyx->bnchx", py, glimpse)
        pasted = torch.einsum("bnchx,bnwx->bnchw", tmp, px)
        for k in range(pasted.shape[1]):
            a_k = torch.clamp(pasted[:, k, c:], 0.0, 1.0)
            img = img + trans * a_k * pasted[:, k, :c]
            trans = trans * (1.0 - a_k)
    return img


def _pasted(color, alpha, boxes, image_hw):
    """Every object's colour and unclipped alpha pasted onto the whole
    canvas: (B, N, C + 1, H, W)."""
    oh, ow = color.shape[-2:]
    py, px = paste_weights(boxes, (oh, ow), image_hw)
    g = torch.cat([color, alpha], dim=2)
    tmp = torch.einsum("bnhy,bncyx->bnchx", py, g)
    return torch.einsum("bnchx,bnwx->bnchw", tmp, px)


def _gated(alpha, pres_gate):
    if pres_gate is None:
        return alpha
    return alpha * (pres_gate != 0)[:, :, None, None, None].to(alpha.dtype)


def ordered_forward_plain(color, alpha, boxes, image_hw, pres_gate=None):
    """The forward kernel's function in plain PyTorch, objects already in
    compositing order: (B, C, H, W) float32, un-clipped. Objects whose gate
    is 0 take no part (their alpha counts as 0)."""
    c = color.shape[2]
    pasted = _pasted(color, _gated(alpha, pres_gate), boxes, image_hw)
    img = torch.zeros_like(pasted[:, 0, :c])
    trans = torch.ones_like(pasted[:, 0, c:])
    for k in range(pasted.shape[1]):
        a_k = torch.clamp(pasted[:, k, c:], 0.0, 1.0)
        img = img + trans * a_k * pasted[:, k, :c]
        trans = trans * (1.0 - a_k)
    return img


def ordered_backward_plain(color, alpha, boxes, image_hw, dout,
                           pres_gate=None):
    """(dcolor, dalpha, dbox), the VJP of ``ordered_forward_plain`` for the
    cotangent dout (B, C, H, W), as the backward kernels compute it: T of
    each object front to back, the remainder R behind it back to front,

        d/dc_o = g T_o a_o,   d/da_o = T_o sum_c g_c (c_o,c - R_o,c),
        R_o = a_{o+1} c_{o+1} + (1 - a_{o+1}) R_{o+1},

    the alpha term masked to where the unclipped alpha lies in [0, 1]
    (torch.clamp's inclusive rule), with no division by 1 - a; then the
    transposed paste and the box gradient of ``composite.py::paste_vjp``
    with the hat's derivative as autograd takes it (``clamp_rule``: a texel
    at distance exactly 1 counts), as the kernels take it. Objects whose
    gate is 0 get exact zeros."""
    c = color.shape[2]

    def cotangents(planes):
        a = torch.clamp(planes[:, :, c:], 0.0, 1.0)
        live = (planes[:, :, c:] >= 0.0) & (planes[:, :, c:] <= 1.0)
        n = planes.shape[1]
        trans = [torch.ones_like(a[:, 0])]
        for k in range(n - 1):
            trans.append(trans[-1] * (1.0 - a[:, k]))
        rest = torch.zeros_like(planes[:, 0, :c])
        dp = [None] * n
        for k in reversed(range(n)):
            dcol = dout * (trans[k] * a[:, k])
            da = trans[k] * torch.sum(dout * (planes[:, k, :c] - rest),
                                      dim=1, keepdim=True)
            dp[k] = torch.cat([dcol, torch.where(live[:, k], da, 0.0)], 1)
            rest = a[:, k] * planes[:, k, :c] + (1.0 - a[:, k]) * rest
        return torch.stack(dp, dim=1)

    dg, dbox = paste_vjp(torch.cat([color, _gated(alpha, pres_gate)], 2),
                         boxes, image_hw, cotangents, clamp_rule=True)
    if pres_gate is not None:
        live = pres_gate != 0
        dg = torch.where(live[:, :, None, None, None], dg, 0.0)
        dbox = torch.where(live[:, :, None], dbox, 0.0)
    return dg[:, :, :c], dg[:, :, c:], dbox


def _check_inputs(color, alpha, boxes, pres_gate, image_hw):
    if color.dim() != 5:
        raise ValueError(f"color must be (B, N, C, oh, ow), got "
                         f"{tuple(color.shape)}")
    b, n, c, oh, ow = color.shape
    tensors = [color, alpha, boxes] + ([] if pres_gate is None
                                       else [pres_gate])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the ordered composite kernels take float32 "
                        "tensors, got " + ", ".join(str(t.dtype)
                                                    for t in tensors))
    if tuple(alpha.shape) != (b, n, 1, oh, ow):
        raise ValueError(f"alpha shape {tuple(alpha.shape)} != "
                         f"{(b, n, 1, oh, ow)}")
    if tuple(boxes.shape) != (b, n, 4):
        raise ValueError(f"boxes shape {tuple(boxes.shape)} != {(b, n, 4)}")
    if pres_gate is not None and tuple(pres_gate.shape) != (b, n):
        raise ValueError(f"pres_gate shape {tuple(pres_gate.shape)} != "
                         f"{(b, n)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the ordered composite kernels take contiguous "
                         "tensors")
    ih, iw = image_hw
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the ordered composite kernels take 1 to "
                         f"{MAX_CHANNELS} colour channels, got {c}")
    if min(ih, iw, oh, ow) < 2:
        raise ValueError("canvas and glimpse sides must be at least 2")
    if n < 1 or b > MAX_SCENES or b * n >= 2 ** 31 or ih * iw >= 2 ** 31:
        raise ValueError(f"shape out of the kernels' range: B={b}, N={n}, "
                         f"H*W={ih * iw}")
    return b, n, c, oh, ow


def tiles_of(image_hw) -> int:
    """The kernels' canvas tiles: ceil(H / 32) * ceil(W / 8)."""
    (ih, iw), (th, tw) = image_hw, TILE
    return -(-ih // th) * -(-iw // tw)


def ordered_forward(color, alpha, boxes, image_hw, pres_gate=None):
    """(B, C, H, W) float32, the over composite of objects already in
    compositing order; the kernel on CUDA tensors, ``ordered_forward_plain``
    on CPU tensors. The raw forward, outside autograd."""
    device = _device_of([color, alpha, boxes, pres_gate], "ordered_forward")
    if device.type == "cpu":
        return ordered_forward_plain(color, alpha, boxes, image_hw,
                                     pres_gate)
    b, n, c, oh, ow = _check_inputs(color, alpha, boxes, pres_gate,
                                    image_hw)
    ih, iw = image_hw
    lib = load_library("composite_ordered")
    out = torch.empty((b, c, ih, iw), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_ordered_fwd(
            color.data_ptr(), alpha.data_ptr(), boxes.data_ptr(),
            None if pres_gate is None else pres_gate.data_ptr(),
            out.data_ptr(), b, n, c, oh, ow, ih, iw, stream)
    _raise_on(lib, err, "ordered_fwd")
    ordered_forward.launches += 1
    return out


ordered_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _object_tile_px(c: int, oh: int, ow: int, ih: int, iw: int) -> int:
    """Support pixels per dP tile of the object pass: ``OBJECT_TILE_PX``,
    halved until a block's shared memory fits."""
    smem = load_library("composite_ordered").spair_ordered_bwd_smem
    px = OBJECT_TILE_PX
    while px >= 1:
        if smem(c, oh, ow, ih, iw, px) <= _SMEM_MAX:
            return px
        px //= 2
    raise ValueError(f"glimpses of {c + 1} x {oh} x {ow} and a {ih} x {iw} "
                     f"canvas do not fit the object pass's shared memory")


def ordered_backward(color, alpha, boxes, image_hw, dout, pres_gate=None):
    """(dcolor, dalpha, dbox), the VJP of ``ordered_forward`` for the
    cotangent dout (B, C, H, W); the two backward kernels on CUDA tensors,
    ``ordered_backward_plain`` on CPU tensors."""
    device = _device_of([color, alpha, boxes, pres_gate, dout],
                        "ordered_backward")
    if device.type == "cpu":
        return ordered_backward_plain(color, alpha, boxes, image_hw, dout,
                                      pres_gate)
    b, n, c, oh, ow = _check_inputs(color, alpha, boxes, pres_gate,
                                    image_hw)
    ih, iw = image_hw
    if dout.dtype != torch.float32 or tuple(dout.shape) != (b, c, ih, iw) \
            or not dout.is_contiguous():
        raise ValueError(f"dout must be contiguous float32 {(b, c, ih, iw)},"
                         f" got {dout.dtype} {tuple(dout.shape)}")
    lib = load_library("composite_ordered")
    tile_px = _object_tile_px(c, oh, ow, ih, iw)
    scratch = torch.empty((b, n, tiles_of(image_hw), c + 1) + TILE,
                          dtype=torch.float32, device=device)
    dg = torch.empty((b, n, c + 1, oh, ow), dtype=torch.float32,
                     device=device)
    dbox = torch.empty((b, n, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_ordered_bwd(
            color.data_ptr(), alpha.data_ptr(), boxes.data_ptr(),
            None if pres_gate is None else pres_gate.data_ptr(),
            dout.data_ptr(), scratch.data_ptr(), dg.data_ptr(),
            dbox.data_ptr(), b, n, c, oh, ow, ih, iw, tile_px, stream)
    _raise_on(lib, err, "ordered_bwd")
    ordered_backward.launches += 1
    return dg[:, :, :c], dg[:, :, c:], dbox


ordered_backward.launches = 0


class OrderedFunction(torch.autograd.Function):
    """Forward ``ordered_forward``, backward ``ordered_backward``, on
    objects already in compositing order: the kernels on CUDA tensors,
    their plain versions on CPU tensors. Saves the glimpses, boxes and gate;
    the backward recomputes the pasted planes. The gate gets no
    gradient."""

    @staticmethod
    def forward(ctx, color, alpha, boxes, pres_gate, image_hw):
        ctx.image_hw = image_hw
        ctx.save_for_backward(color, alpha, boxes, pres_gate)
        return ordered_forward(color, alpha, boxes, image_hw, pres_gate)

    @staticmethod
    def backward(ctx, dout):
        color, alpha, boxes, pres_gate = ctx.saved_tensors
        grads = ordered_backward(color, alpha, boxes, ctx.image_hw,
                                 dout.contiguous(), pres_gate)
        return (*grads, None, None)


def ordered_composite(color, alpha, z_depth_flat, z_where, image_hw,
                      pres_gate=None):
    """The kernels' path, differentiable: the stable sort of -depth and the
    gather here, then ``OrderedFunction`` on the objects in compositing
    order (the kernels on CUDA tensors, their plain versions on CPU
    tensors). Arguments as ``composite_over`` takes them."""
    b, n = color.shape[:2]
    order = torch.argsort(-z_depth_flat[..., 0], dim=1, stable=True)

    def take(t):
        return torch.take_along_dim(
            t, order.reshape((b, n) + (1,) * (t.ndim - 2)),
            dim=1).contiguous()

    gate = None if pres_gate is None else take(pres_gate)
    return OrderedFunction.apply(take(color), take(alpha), take(z_where),
                                 gate, tuple(image_hw))


def composite_over(color, alpha, z_depth_flat, z_where, image_hw,
                   pres_gate=None, chunk: int = 16):
    """Differentiable depth-ordered composite, (B, C, H, W) un-clipped:
    ``composite_ordered``'s function with the presence gate passed on, so
    the kernels skip gated objects (whose alpha the caller has already
    multiplied by the gate, which makes them identities of the over
    operator). On CUDA tensors ``ordered_composite``, the kernels, float32
    only; ``chunk`` is not used. On CPU tensors ``composite_ordered`` with
    ``chunk``."""
    device = _device_of([color, alpha, z_depth_flat, z_where, pres_gate],
                        "composite_over")
    if device.type == "cpu":
        return composite_ordered(color, alpha, z_depth_flat, z_where,
                                 image_hw, chunk)
    return ordered_composite(color, alpha, z_depth_flat, z_where, image_hw,
                             pres_gate)
