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
launch ``csrc/composite_v3_fwd.cu`` (K3) and ``csrc/composite_v3_bwd.cu``
(K4) or raise; for CPU tensors they run ``composite_v3_plain`` and
``composite_v3_backward_plain``, ``composite.py``'s plain versions with each
object's rows clipped to its band, which are also the kernels' oracles.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spair_pytorch_tpu_torch.ops.kernels.composite import (
    _BWD_SMEM_BUDGETS, _EPS, _check_cotangents, _check_cuda_inputs,
    _device_of, _raise_on, composite_backward_plain, composite_plain,
    load_library)


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

    b, n, c, oh, ow = _check_cuda_inputs(color, alpha, importance, boxes,
                                         None, image_hw)
    gh, gw = grid_hw
    ih, iw = image_hw
    band, starts = _bands(n, image_hw, cell_h, grid_hw, box_bounds, oh)
    lib = load_library("composite_v3_fwd")
    num = torch.empty((b, c, ih, iw), dtype=torch.float32, device=device)
    den = torch.empty((b, 1, ih, iw), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_composite_v3_fwd(
            color.data_ptr(), alpha.data_ptr(), importance.data_ptr(),
            boxes.data_ptr(), num.data_ptr(), den.data_ptr(),
            (ctypes.c_int * gh)(*starts), b, gh, gw, c, oh, ow, ih, iw, band,
            n * _EPS, int(color.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "composite_v3_fwd")
    composite_v3_forward.launches += 1
    return num, den


composite_v3_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_tile_rows(c: int, oh: int, ow: int, iw: int, band: int) -> int:
    """Canvas rows per tile of K4: the most (up to 32, and the band) whose
    shared memory fits one block."""
    smem = load_library("composite_v3_bwd").spair_composite_v3_bwd_smem
    for rows in range(min(32, band), 0, -1):
        # the card's per-block limit: the band staging sets the size
        if smem(c, oh, ow, iw, band, rows) <= _BWD_SMEM_BUDGETS[-1]:
            return rows
    raise ValueError(f"a band of {band} x {iw} canvas rows and {c + 2} x "
                     f"{oh} x {ow} glimpses do not fit K4's shared memory")


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

    b, n, c, oh, ow = _check_cuda_inputs(color, alpha, importance, boxes,
                                         None, image_hw)
    gh, gw = grid_hw
    ih, iw = image_hw
    _check_cotangents(dnum, dden, b, c, image_hw)
    band, starts = _bands(n, image_hw, cell_h, grid_hw, box_bounds, oh)
    lib = load_library("composite_v3_bwd")
    tile_rows = _bwd_tile_rows(c, oh, ow, iw, band)
    dg = torch.empty((b, n, c + 2, oh, ow), dtype=color.dtype, device=device)
    dbox = torch.empty((b, n, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_composite_v3_bwd(
            color.data_ptr(), alpha.data_ptr(), importance.data_ptr(),
            boxes.data_ptr(), dnum.data_ptr(), dden.data_ptr(),
            dg.data_ptr(), dbox.data_ptr(), (ctypes.c_int * gh)(*starts), b,
            gh, gw, c, oh, ow, ih, iw, band, tile_rows,
            int(color.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "composite_v3_bwd")
    composite_v3_backward.launches += 1
    return dg[:, :, :c], dg[:, :, c:c + 1], dg[:, :, c + 1:], dbox


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
