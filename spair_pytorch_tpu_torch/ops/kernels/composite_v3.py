"""Band-clipped paste-and-composite: the CUDA kernels K3 and K4, their plain
versions, autograd.

``composite_v3`` is the port of ``spair_pytorch_tpu/ops/pallas/
composite_v3.py::composite_pallas_v3``, the compositor that
``render_backend='pallas_v3'`` selects. It computes the (num, den) of
``composite.py`` without a gate (the caller masks gated objects' glimpses),
with one difference: the objects of grid row h paste only onto the canvas
rows [starts[h], starts[h] + band), the static band that the model's box
parameterization confines them to (``band_geometry``). For model-generated
boxes that is the same function as ``composite.composite``; a box past its
band is clipped, exactly as the TPU kernel clips it.

For CUDA tensors ``composite_v3_forward`` and ``composite_v3_backward``
launch K3 and K4 or raise: ``composite.py``'s forward and backward kernels
(``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``) with the band, no
gate and a den floor of N * 1e-9. K3 and K4 keep launch counters of their
own. For CPU tensors they run ``composite_v3_plain`` and
``composite_v3_backward_plain``, ``composite.py``'s plain versions with each
object's rows clipped to its band, which are also the kernels' oracles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spair_pytorch_tpu_torch.ops.kernels.composite import (
    _device_of, _launch_backward, _launch_forward, composite_backward_plain,
    composite_plain)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_geometry(image_hw, cell_h: int, min_cy: float, max_cy: float,
                  max_ys: float, oh: int, gh: int):
    """(BAND, starts[gh]) — static per-grid-row paste windows.

    Row h's objects have center yt in cell*(h+[min_cy, max_cy])/ih and
    half-support ys*k/2 with the hat overhang k = 1 + 2/(oh-1)
    (composite.py:_window_start derivation); the union over the row is a
    static interval. BAND = 8-aligned span + 8 slack for the 8-aligned
    start rounding; starts clamped into the canvas.
    """
    ih = image_hw[0]
    khat = 1.0 + 2.0 / (oh - 1)
    half = max_ys * khat * 0.5
    lo = [int(np.floor(((h + min_cy) * cell_h / ih - half) * (ih - 1))) - 1
          for h in range(gh)]
    hi = [int(np.ceil(((h + max_cy) * cell_h / ih + half) * (ih - 1))) + 1
          for h in range(gh)]
    span = max(h2 - l2 + 1 for l2, h2 in zip(lo, hi))
    band = min(_round_up(ih, 8), _round_up(span, 8) + 8)
    if band >= ih:
        return ih, np.zeros(gh, np.int32)
    starts = np.clip([(l2 // 8) * 8 for l2 in lo], 0, ih - band)
    return band, starts.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _geometry(image_hw, cell_h: int, grid_hw, box_bounds, oh: int):
    """(band, starts as a tuple of ints) for one set of static arguments."""
    band, starts = band_geometry(image_hw, cell_h, *box_bounds, oh,
                                 grid_hw[0])
    return int(band), tuple(int(s) for s in starts)


def _bands(n: int, image_hw, cell_h, grid_hw, box_bounds, oh: int):
    """(band, starts as a tuple of ints) for N = gh * gw objects."""
    gh, gw = grid_hw
    if gh * gw != n:
        raise ValueError(f"grid {gh} x {gw} does not hold the {n} objects")
    return _geometry(tuple(image_hw), int(cell_h), tuple(grid_hw),
                     tuple(box_bounds), oh)


def _row_keep(color, image_hw, cell_h, grid_hw, box_bounds):
    """(1, N, H) float32: 1 on the canvas rows of each object's band (the
    band of its grid row), 0 elsewhere."""
    band, starts = _bands(color.shape[1], image_hw, cell_h, grid_hw,
                          box_bounds, color.shape[-2])
    y = torch.arange(image_hw[0], device=color.device)
    lo = torch.as_tensor(starts, device=color.device).repeat_interleave(
        grid_hw[1])
    keep = (y[None, :] >= lo[:, None]) & (y[None, :] < lo[:, None] + band)
    return keep[None].to(torch.float32)


def composite_v3_plain(color, alpha, importance, boxes, image_hw,
                       cell_h: int, grid_hw, box_bounds, chunk_k: int = 4):
    """(num (B, C, H, W), den (B, 1, H, W)) of the band-clipped composite in
    plain PyTorch: ``composite_plain`` with each object's row hat weights
    zeroed outside its grid row's band. Objects are in raster order over
    ``grid_hw``; den's floor is N * 1e-9 for the N objects given.
    ``chunk_k`` is accepted as ``composite_v3`` takes it."""
    return composite_plain(color, alpha, importance, boxes, image_hw,
                           row_keep=_row_keep(color, image_hw, cell_h,
                                              grid_hw, box_bounds))


def composite_v3_backward_plain(color, alpha, importance, boxes, image_hw,
                                cell_h: int, grid_hw, box_bounds, dnum,
                                dden, chunk_k: int = 4):
    """The VJP of ``composite_v3_plain`` in plain PyTorch, K4's formulas as
    tensor code: ``composite_backward_plain`` (the hat derivative
    -sign(src - a) where the weight is positive, sign(0) = 0) with each
    object's rows clipped to its band. Returns (dcolor, dalpha, dimp) in
    the glimpse dtype and dbox (B, N, 4) float32."""
    return composite_backward_plain(
        color, alpha, importance, boxes, image_hw, dnum, dden,
        row_keep=_row_keep(color, image_hw, cell_h, grid_hw, box_bounds))


def _check_chunk_k(chunk_k):
    if int(chunk_k) < 1:
        raise ValueError(f"chunk_k must be positive, got {chunk_k}")


def composite_v3_forward(color, alpha, importance, boxes, image_hw,
                         cell_h: int, grid_hw, box_bounds, chunk_k: int = 4):
    """(num, den) of the band-clipped composite: K3 on CUDA tensors,
    ``composite_v3_plain`` on CPU tensors. This is the raw forward, outside
    autograd: ``composite_v3`` is the differentiable entry."""
    _check_chunk_k(chunk_k)
    device = _device_of([color, alpha, importance, boxes],
                        "composite_v3_forward")
    if device.type == "cpu":
        return composite_v3_plain(color, alpha, importance, boxes, image_hw,
                                  cell_h, grid_hw, box_bounds, chunk_k)

    out = _launch_forward(color, alpha, importance, boxes, image_hw, None,
                          None, device, _kernel_bands(color, image_hw, cell_h,
                                                      grid_hw, box_bounds))
    composite_v3_forward.launches += 1
    return out


composite_v3_forward.launches = 0


def _kernel_bands(color, image_hw, cell_h, grid_hw, box_bounds):
    """(band, starts, gw), the row clip as the kernels take it."""
    band, starts = _bands(color.shape[1], image_hw, cell_h, grid_hw,
                          box_bounds, color.shape[-2])
    return band, starts, grid_hw[1]


def composite_v3_backward(color, alpha, importance, boxes, image_hw,
                          cell_h: int, grid_hw, box_bounds, dnum, dden,
                          chunk_k: int = 4):
    """(dcolor, dalpha, dimp, dbox), the VJP of ``composite_v3_forward`` for
    the cotangents dnum (B, C, H, W) and dden (B, 1, H, W): K4 on CUDA
    tensors, ``composite_v3_backward_plain`` on CPU tensors."""
    _check_chunk_k(chunk_k)
    device = _device_of([color, alpha, importance, boxes, dnum, dden],
                        "composite_v3_backward")
    if device.type == "cpu":
        return composite_v3_backward_plain(color, alpha, importance, boxes,
                                           image_hw, cell_h, grid_hw,
                                           box_bounds, dnum, dden, chunk_k)

    out = _launch_backward(color, alpha, importance, boxes, image_hw, dnum,
                           dden, None, device, _kernel_bands(
                               color, image_hw, cell_h, grid_hw, box_bounds))
    composite_v3_backward.launches += 1
    return out


composite_v3_backward.launches = 0


class CompositeV3Function(torch.autograd.Function):
    """Forward ``composite_v3_forward``, backward ``composite_v3_backward``:
    K3 and K4 on CUDA tensors, their plain versions on CPU tensors. Saves
    the glimpses and boxes and recomputes the pasted planes in the
    backward, as the JAX custom VJP does with its residuals."""

    @staticmethod
    def forward(ctx, color, alpha, importance, boxes, image_hw, cell_h,
                grid_hw, box_bounds, chunk_k):
        ctx.geom = (image_hw, cell_h, grid_hw, box_bounds)
        ctx.chunk_k = chunk_k
        ctx.save_for_backward(color, alpha, importance, boxes)
        return composite_v3_forward(color, alpha, importance, boxes, *ctx.geom,
                                    chunk_k)

    @staticmethod
    def backward(ctx, dnum, dden):
        color, alpha, importance, boxes = ctx.saved_tensors
        grads = composite_v3_backward(color, alpha, importance, boxes,
                                      *ctx.geom, dnum.contiguous(),
                                      dden.contiguous(), ctx.chunk_k)
        return (*grads, None, None, None, None, None)


def composite_v3(color, alpha, importance, boxes, image_hw, cell_h: int,
                 grid_hw, box_bounds, chunk_k: int = 4):
    """Differentiable (num, den) of the band-clipped composite, the entry
    that ``models/render.py::render`` takes for 'pallas_v3'.

    color (B, N, C, oh, ow), alpha and importance (B, N, 1, oh, ow) in
    float32 or bfloat16, boxes (B, N, 4) float32, N = gh * gw objects in
    raster order of ``grid_hw``; ``cell_h`` is the grid's cell height in
    pixels and ``box_bounds`` = (min_cy, max_cy, max_ys) the model's box
    ranges, which fix the bands. ``chunk_k`` is the TPU kernel's
    object-chunk size, a matmul-batching knob that changes only the order
    of its f32 sums: it is checked and otherwise ignored, as ``win_rows``
    is for ``composite.composite``. Gradients reach the glimpses and
    boxes."""
    return CompositeV3Function.apply(color, alpha, importance, boxes,
                                     tuple(image_hw), int(cell_h),
                                     tuple(grid_hw), tuple(box_bounds),
                                     chunk_k)
