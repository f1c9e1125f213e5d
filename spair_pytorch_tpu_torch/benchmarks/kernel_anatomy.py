"""Attribute the windowed matmul paste's forward cost: weight builds against
products against windowed accumulates (counterpart of the JAX package's
``benchmarks/kernel_anatomy.py``).

The JAX script times five variants of an older form of K1's TPU kernel, a
paste by two hat-weight products per object on bf16 operands, at paper
shapes (B=32, N=121, 128x128, win 64, 28x28 glimpses, C=1). Here the
same five variants are one hand-written CUDA kernel,
``csrc/kernel_anatomy.cu``, on Hopper's warpgroup (wgmma) bf16 tensor
cores:

  base      the shipped form: py, pxt built per object in the kernel
  hoisted   py, pxt built outside the kernel (``hoisted_weights``, plain
            tensor code on the device) and read in; the same function
  nobuild   py, pxt of a constant box, built once: base - nobuild is the
            build's share
  nomatmul  nobuild with each plane t's column k ow broadcast (wrong
            result): nobuild - nomatmul is the plane products' share
  noaccum   nobuild adding only 8 rows at a static offset (wrong result):
            nobuild - noaccum is the windowed accumulate's share

``kernel_anatomy`` launches the kernel on CUDA tensors (and raises on what
it does not take) and runs ``kernel_anatomy_plain``, the per-object loop in
plain PyTorch, on CPU tensors; the plain version is also the kernel's
oracle on the card. ``pack`` and ``hoisted_weights`` are the port's copies
of the JAX package's ``_pack`` and of ``run_variant``'s vectorized weights
(``_row_coords``, ``_col_coords`` and ``_window_start`` over (B, N)).
``strips_touched`` is the kernel's per-strip object cull in plain PyTorch;
``kernel_anatomy_listed`` also returns the lists the kernel walked.

Timing is the counterpart of the JAX script's ``lax.scan`` delta timing:
k launches captured as one CUDA graph on the port's capture stream
(``parallel/captured.py``), the graph replayed, CUDA events around one
replay, the best of 3 trials over k. A launch through ``ctypes`` costs
about as much host time as the kernel takes, so uncaptured launches would
time the host. The kernel's launch count is counted over the replays.

Usage:
    python -m spair_pytorch_tpu_torch.benchmarks.kernel_anatomy  # the card
    python -m spair_pytorch_tpu_torch.benchmarks.kernel_anatomy \\
        --batch 2 --k 1 --device cpu        # the plain versions, host clock

It prints the JAX script's five lines (``base      fwd   x.xxx ms``, ...),
then one JSON line: each variant's ms, the shares derived from them, each
variant's bound (the largest of its bytes over 3.35 TB/s, its products
over 989 TFLOP/s bf16 dense and its f32 operations over 67 TFLOP/s, the
H100 SXM's data-sheet peaks), and K1's (``composite_forward``) ms on the same
glimpses in f32 and in bf16. On the CPU every time is a host-clock time of
the plain versions, and the bounds are still the H100's.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from spair_pytorch_tpu_torch.ops.kernels.composite import (
    _device_of, _raise_on, composite_forward, load_library)
from spair_pytorch_tpu_torch.ops.stn import _hat, _source_coords_paste

VARIANTS = ("base", "hoisted", "nobuild", "nomatmul", "noaccum")
_EPS = 1e-9
# the constant box (centre, scale) whose weights the ablations paste with
CONST_T, CONST_S = 0.5, 0.2
# the H100 SXM's data-sheet peaks at 700 W
HBM_BYTES_PER_S, BF16_OPS_PER_S, F32_OPS_PER_S = 3.35e12, 989e12, 67e12
# the most shared memory one block may take
_SMEM_MAX = 227 * 1024
# canvas columns one block owns (csrc/kernel_anatomy.cu kStrip)
STRIP = 32


def pack(color, alpha, importance):
    """(B, N, C, oh, ow), (B, N, 1, oh, ow) x2 -> (B, N, oh, (C + 2) ow):
    plane k (C colours, alpha, importance) on lanes k ow .. (k + 1) ow."""
    g = torch.cat([color, alpha, importance], dim=2)
    return g.movedim(2, 3).reshape(g.shape[0], g.shape[1], g.shape[3], -1)


def window_start(yt, ys, ih: int, win: int, oh: int):
    """The 8-aligned start row of each object's paste window (int64, the
    shape of yt): floor, floor-divide by 8, clip to [0, ih - win]."""
    k = 1.0 + 2.0 / (oh - 1)
    lo = torch.floor((yt - ys * (k * 0.5)) * (ih - 1)).to(torch.int64)
    return torch.clamp(torch.div(lo, 8, rounding_mode="floor") * 8, 0,
                       ih - win)


def _src(index, canvas: int, t, s, glimpse: int):
    """Glimpse coordinate of float canvas indices ``index`` (broadcast
    against t, s), dividing by tensors as the kernel divides."""
    u = 2.0 * index / torch.full_like(index, canvas - 1) - 1.0
    return ((u - (2.0 * t - 1.0)) / s + 1.0) * (glimpse - 1) / 2.0


def row_weights(y0, yt, ys, ih: int, win: int, oh: int):
    """py (..., win, oh) float32: the hat weights of canvas rows y0 .. y0 +
    win (y0, yt, ys of one shape)."""
    rows = torch.arange(win, dtype=torch.float32, device=yt.device)
    index = y0.to(torch.float32)[..., None] + rows
    return _hat(_src(index, ih, yt[..., None], ys[..., None], oh), oh)


def col_weights(xt, xs, iw: int, ow: int):
    """pxt (..., ow, iw) float32: the transposed hat weights of every canvas
    column."""
    return _hat(_source_coords_paste(xt, xs, iw, ow), ow).transpose(-1, -2)


def hoisted_weights(boxes, image_hw, object_hw, win: int):
    """(py (B, N, win, oh), pxt (B, N, ow, W)) in bf16, vectorized over the
    objects: the weights ``hoisted`` reads, as the JAX script's
    ``run_variant`` builds them."""
    ih, iw = image_hw
    oh, ow = object_hw
    xt, yt, xs, ys = boxes.to(torch.float32).unbind(-1)
    y0 = window_start(yt, ys, ih, win, oh)
    py = row_weights(y0, yt, ys, ih, win, oh)
    return (py.to(torch.bfloat16).contiguous(),
            col_weights(xt, xs, iw, ow).to(torch.bfloat16).contiguous())


def constant_weights(image_hw, object_hw, win: int, device):
    """(py (win, oh), pxt (ow, W)) in bf16 of the constant box at window
    start 0: the stand-ins of nobuild, nomatmul and noaccum."""
    ih, iw = image_hw
    oh, ow = object_hw

    def full(v):
        return torch.full((), v, dtype=torch.float32, device=device)
    t, s = full(CONST_T), full(CONST_S)
    return (row_weights(full(0.0), t, s, ih, win, oh).to(torch.bfloat16),
            col_weights(t, s, iw, ow).to(torch.bfloat16))


def strips_touched(variant, boxes, image_hw, object_hw, strip: int = STRIP):
    """(B, N, W // strip) bool: the objects the kernel lists for each strip
    of ``strip`` canvas columns (``csrc/kernel_anatomy.cu::touches``), those
    whose column weights for ``variant`` are nonzero there: the box's for
    base and hoisted, the constant box's for nobuild and noaccum, every
    object for nomatmul (its broadcast plane is nonzero everywhere).

    A column takes a nonzero hat weight where -1 < src < ow. src is monotone
    in the column, so the strip's two end columns decide, unless one
    column's step could leap that open interval (|xs| (W - 1) < 1, or a NaN
    scale): then every column is tested."""
    ih, iw = image_hw
    _, ow = object_hw
    b, n = boxes.shape[:2]
    if variant == "nomatmul":
        return torch.ones((b, n, iw // strip), dtype=torch.bool,
                          device=boxes.device)
    xt, xs = boxes.to(torch.float32)[..., 0], boxes.to(torch.float32)[..., 2]
    if variant != "base" and variant != "hoisted":
        xt, xs = torch.full_like(xt, CONST_T), torch.full_like(xs, CONST_S)
    src = _source_coords_paste(xt, xs, iw, ow)          # (B, N, W)
    ends = src[..., ::strip], src[..., strip - 1::strip]
    by_ends = (torch.maximum(*ends) > -1) & (torch.minimum(*ends) < ow)
    inside = (src > -1) & (src < ow)
    by_columns = inside.reshape(b, n, iw // strip, strip).any(-1)
    steady = (xs.abs() * (iw - 1) >= 1)[..., None]
    return torch.where(steady, by_ends, by_columns)


def _shapes(variant, g, boxes, image_hw, win, py, pxt, channels):
    """(b, n, c, oh, ow) after the checks both routes share."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if g.dim() != 4 or g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16 (B, N, oh, (C + 2) ow), got "
                        f"{g.dtype} {tuple(g.shape)}")
    b, n, oh, lanes = g.shape
    c = int(channels)
    if c < 1 or lanes % (c + 2):
        raise ValueError(f"g's last axis {lanes} is not {c + 2} planes")
    ow = lanes // (c + 2)
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (b, n, 4):
        raise ValueError(f"boxes must be float32 {(b, n, 4)}, got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    ih, iw = image_hw
    if not 8 <= win <= ih or min(oh, ow, iw) < 2:
        raise ValueError(f"window {win} for a canvas of {ih} rows, glimpses "
                         f"{oh} x {ow}: the window takes 8 to {ih} rows")
    given = variant == "hoisted"
    if (py is not None, pxt is not None) != (given, given):
        raise ValueError("py and pxt go with the hoisted variant, and only "
                         "with it")
    if variant == "hoisted":
        for name, t, shape in (("py", py, (b, n, win, oh)),
                               ("pxt", pxt, (b, n, ow, iw))):
            if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be bfloat16 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    return b, n, c, oh, ow


def matmul_toward_zero(a, b):
    """a @ b of float32 tensors, each sum exact and rounded toward zero to
    float32, as the H100's tensor cores round an f32-accumulated product of
    bf16 operands (exact products, the sum truncated). The sums are taken
    in float64, which holds them exactly here: a hat row has at most two
    nonzeros."""
    exact = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    near = exact.to(torch.float32)
    past = near.to(torch.float64).abs() > exact.abs()
    return torch.where(past, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def kernel_anatomy_plain(variant, g, boxes, image_hw, win, py=None,
                         pxt=None, channels: int = 1,
                         t_sum: str = "nearest", round_t: bool = True,
                         cull: bool = False):
    """(num (B, C, H, W), den (B, 1, H, W)) float32 of one variant, in
    plain PyTorch: the objects in index order, each pasted by its two
    products (f32 sums of bf16 operands, t rounded to bf16 between them)
    and added into its window rows with ``scatter_add_``.

    ``t_sum`` rounds t's f32 sums to nearest ('nearest', as the JAX
    package's product on the CPU) or toward zero ('toward_zero', as the
    kernel's tensor cores; ``matmul_toward_zero``): where one rounds up and
    the other down next to a bf16 rounding boundary, t's bf16 rounding
    flips: a few pixels in a million at paper shapes. ``round_t=False`` keeps t
    in f32: not the function, but the control a check of the kernel
    against this version must tell apart from it. ``cull=True`` adds each
    object only on the strips ``strips_touched`` lists for it and leaves
    the other columns as they are, as the kernel skips them."""
    if t_sum not in ("nearest", "toward_zero"):
        raise ValueError(f"t_sum must be 'nearest' or 'toward_zero', got "
                         f"{t_sum!r}")
    b, n, c, oh, ow = _shapes(variant, g, boxes, image_hw, win, py, pxt,
                              channels)
    ih, iw = image_hw
    f32, dev = torch.float32, g.device
    boxes = boxes.to(f32)
    y0 = window_start(boxes[..., 1], boxes[..., 3], ih, win, oh)
    if variant == "base":
        py, pxt = hoisted_weights(boxes, image_hw, (oh, ow), win)
    elif variant != "hoisted":
        cpy, cpxt = constant_weights(image_hw, (oh, ow), win, dev)
        py, pxt = (cpy.expand(b, n, win, oh), cpxt.expand(b, n, ow, iw))
    num = torch.zeros((b, c, ih, iw), dtype=f32, device=dev)
    den = torch.full((b, 1, ih, iw), n * _EPS, dtype=f32, device=dev)
    rows = torch.arange(win, device=dev)
    if cull:  # (B, N, W): the columns each object is added on
        listed = strips_touched(variant, boxes, image_hw, (oh, ow))
        columns = listed.repeat_interleave(STRIP, dim=-1)
    for o in range(n):
        if cull:
            keep_num, keep_den = num.clone(), den.clone()
        t = (torch.matmul if t_sum == "nearest" else matmul_toward_zero)(
            py[:, o].to(f32), g[:, o].to(f32))  # (B, win, (C + 2) ow)
        if variant == "nomatmul":
            planes = [t[:, :, k * ow:k * ow + 1].expand(b, win, iw)
                      for k in range(c + 2)]
        else:
            px = pxt[:, o].to(f32)
            if round_t:
                t = t.to(torch.bfloat16).to(f32)
            planes = [torch.matmul(t[:, :, k * ow:(k + 1) * ow], px)
                      for k in range(c + 2)]
        alp, imp = planes[c], planes[c + 1]
        impe = imp + _EPS
        if variant == "noaccum":
            for k in range(c):
                num[:, k, :8] += (alp * planes[k] * impe)[:, :8]
            den[:, 0, :8] += imp[:, :8]
        else:
            index = (y0[:, o, None] + rows)[:, :, None].expand(b, win, iw)
            for k in range(c):
                num[:, k].scatter_add_(1, index, alp * planes[k] * impe)
            den[:, 0].scatter_add_(1, index, imp)
        if cull:
            on = columns[:, o, None, None, :]
            num = torch.where(on, num, keep_num)
            den = torch.where(on, den, keep_den)
    return num, den


def _check_cuda(g, boxes, py, pxt, image_hw, win, oh, ow, b):
    ih, iw = image_hw
    if oh % 2 or ow % 2 or oh > 32 or ow > 32:
        raise ValueError(f"the kernel takes even glimpse sides up to 32, got "
                         f"{oh} x {ow}")
    if win % 16 or not 16 <= win <= min(ih, 128):
        raise ValueError(f"the kernel takes a window of a multiple of 16 "
                         f"rows in [16, {min(ih, 128)}], got {win}")
    if iw % STRIP or b > 65535:
        raise ValueError(f"the kernel takes a canvas width that is a "
                         f"multiple of {STRIP} and at most 65535 images, got "
                         f"W={iw}, B={b}")
    tensors = [t for t in (g, boxes, py, pxt) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if boxes.data_ptr() % 16 or any(t.data_ptr() % 4 for t in tensors):
        raise ValueError("the kernel takes boxes aligned to 16 bytes and "
                         "bf16 operands aligned to 4")


def kernel_anatomy(variant, g, boxes, image_hw, win, py=None, pxt=None,
                   channels: int = 1):
    """(num (B, C, H, W), den (B, 1, H, W)) float32 of one variant of the
    windowed matmul paste; the kernel (``csrc/kernel_anatomy.cu``) on CUDA
    tensors, ``kernel_anatomy_plain`` on CPU tensors.

    g (B, N, oh, (C + 2) ow) bf16 from ``pack``; boxes (B, N, 4) float32
    [xt, yt, xs, ys]; win the window's rows (``models/render.py::
    paste_window_rows``); py (B, N, win, oh) and pxt (B, N, ow, W) bf16
    from ``hoisted_weights`` for 'hoisted' only; ``channels`` = C."""
    return _run(variant, g, boxes, image_hw, win, py, pxt, channels)[:2]


def kernel_anatomy_listed(variant, g, boxes, image_hw, win, py=None,
                          pxt=None, channels: int = 1):
    """``kernel_anatomy``'s (num, den) and the lists its strips walked,
    (B, N, W // STRIP) bool: on CUDA tensors what the kernel's producer
    fetched, on CPU tensors ``strips_touched``."""
    return _run(variant, g, boxes, image_hw, win, py, pxt, channels,
                listed=True)


def _run(variant, g, boxes, image_hw, win, py, pxt, channels, listed=False):
    image_hw = tuple(image_hw)
    device = _device_of([g, boxes, py, pxt], "kernel_anatomy")
    if device.type == "cpu":
        num, den = kernel_anatomy_plain(variant, g, boxes, image_hw, win, py,
                                        pxt, channels)
        if not listed:
            return num, den, None
        oh, lanes = g.shape[2:]
        return num, den, strips_touched(
            variant, boxes, image_hw, (oh, lanes // (int(channels) + 2)))
    b, n, c, oh, ow = _shapes(variant, g, boxes, image_hw, win, py, pxt,
                              channels)
    _check_cuda(g, boxes, py, pxt, image_hw, win, oh, ow, b)
    ih, iw = image_hw
    index = VARIANTS.index(variant)
    lib = load_library("kernel_anatomy")
    if lib.spair_kernel_anatomy_smem(c, oh, ow, ih, win, index) > _SMEM_MAX:
        raise ValueError(f"a canvas strip of {c + 1} planes of {ih} rows does "
                         f"not fit the kernel's shared memory")
    num = torch.empty((b, c, ih, iw), dtype=torch.float32, device=device)
    den = torch.empty((b, 1, ih, iw), dtype=torch.float32, device=device)
    lists = (torch.zeros((b, iw // STRIP, n), dtype=torch.uint8,
                         device=device) if listed else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_kernel_anatomy(
            g.data_ptr(), boxes.data_ptr(),
            None if py is None else py.data_ptr(),
            None if pxt is None else pxt.data_ptr(), num.data_ptr(),
            den.data_ptr(), None if lists is None else lists.data_ptr(), b,
            n, c, oh, ow, ih, iw, win, index, n * _EPS, stream)
    _raise_on(lib, err, "kernel_anatomy")
    kernel_anatomy.launches += 1
    return num, den, None if lists is None else lists.transpose(1, 2).bool()


kernel_anatomy.launches = 0


def work(variant, b, n, c, object_hw, image_hw, win):
    """(bytes, bf16 tensor-core operations, f32 operations) one call of
    ``variant`` must spend: the glimpses, boxes (and hoisted's weights)
    read once and the canvas written once; the products without padding;
    per combined pixel 3C + 2 f32 operations (imp + 1e-9, alpha * colour,
    times it, the num and den sums); base's build, 4 a hat weight."""
    oh, ow = object_hw
    ih, iw = image_hw
    nc, objects = c + 2, b * n
    moved = objects * (oh * nc * ow * 2 + 16) + b * (c + 1) * ih * iw * 4
    if variant == "hoisted":
        moved += objects * (win * oh + ow * iw) * 2
    products = 2 * win * oh * nc * ow
    if variant != "nomatmul":
        products += 2 * nc * win * ow * iw
    rows = 8 if variant == "noaccum" else win
    f32 = (3 * c + 2) * rows * iw
    if variant == "base":
        f32 += 4 * (win * oh + ow * iw)
    return moved, objects * products, objects * f32


def bound(variant, b, n, c, object_hw, image_hw, win):
    """(least ms on an H100, 'bytes' or 'operations') of one call: the
    largest of the bytes over the HBM rate, the products over the bf16
    dense peak and the f32 operations over the f32 peak (the tensor cores
    and the f32 pipes run at once)."""
    moved, products, f32 = work(variant, b, n, c, object_hw, image_hw, win)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(products / BF16_OPS_PER_S, f32 / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, k: int, device, trials: int = 3) -> float:
    """Device ms a call of ``fn`` (no arguments), on the card: k calls
    captured as one CUDA graph on the capture stream after one eager call,
    the graph replayed once, then the best of ``trials`` replays between
    CUDA events, over k. The compositor wrappers' launches, this module's
    kernel's included, are counted over the replays."""
    from spair_pytorch_tpu_torch.parallel import captured
    counted = captured.COUNTED + (kernel_anatomy,)
    captured._warm_up(device, fn)
    graph = torch.cuda.CUDAGraph()
    _, per_replay = captured._capture(graph, lambda: [fn() for _ in range(k)],
                                      device, counted=counted)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for trial in range(trials + 1):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        captured._replayed(per_replay, counted)
        if trial:  # the first replay warms up
            best = min(best, start.elapsed_time(end) / k)
    return best


def host_ms(fn, k: int, trials: int = 3) -> float:
    """Host ms a call of ``fn`` on the CPU: the best of ``trials`` runs of
    k calls, after one."""
    fn()
    best = math.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / k)
    return best


def call_ms(fn, k: int, device) -> float:
    return graph_ms(fn, k, device) if device.type == "cuda" else \
        host_ms(fn, k)


def run_variant(variant, color, alpha, imp, boxes, image_hw, win, k):
    """Seconds one call of ``variant`` takes on the inputs' device (the
    JAX script's ``run_variant``): the glimpses packed to bf16 and, for
    hoisted, the weights built once, outside the timed calls."""
    c = color.shape[2]
    oh, ow = color.shape[-2:]
    g = pack(color, alpha, imp).to(torch.bfloat16).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    py = pxt = None
    if variant == "hoisted":
        py, pxt = hoisted_weights(boxes, image_hw, (oh, ow), win)
    return call_ms(lambda: kernel_anatomy(variant, g, boxes, image_hw, win,
                                          py, pxt, channels=c),
                   k, color.device) / 1e3


def paper_inputs(batch: int, seed: int, device):
    """The JAX script's inputs at paper shapes: (color, alpha, imp, boxes,
    image_hw, win), glimpses uniform in [0, 1) (importance from 0.01),
    centres in [0.05, 0.95], scales in [0.05, anchor / H], drawn on the CPU
    from ``seed`` and moved to ``device``."""
    from spair_pytorch_tpu_torch.config import paper_config
    from spair_pytorch_tpu_torch.models.render import paste_window_rows
    from spair_pytorch_tpu_torch.ops.backbone import grid_geometry

    cfg = paper_config(batch_size=batch, compute_dtype="bfloat16")
    image_hw = tuple(cfg.image_shape[1:])
    _, (gh, gw), _ = grid_geometry(image_hw, cfg.backbone_topology)
    n, c = gh * gw, cfg.image_shape[0]
    oh, ow = cfg.object_shape
    gen = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo
    color = u(batch, n, c, oh, ow)
    alpha = u(batch, n, 1, oh, ow)
    imp = u(batch, n, 1, oh, ow, lo=0.01)
    centres = u(batch, n, 2, lo=0.05, hi=0.95)
    scales = u(batch, n, 2, lo=0.05, hi=cfg.anchor_shape[0] / image_hw[0])
    boxes = torch.cat([centres, scales], -1)
    moved = [t.to(device) for t in (color, alpha, imp, boxes)]
    return (*moved, image_hw, paste_window_rows(cfg, image_hw))


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--k", type=int, default=30,
                   help="launches a captured graph holds")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel) or cpu (the plain versions)")
    return p


def main(argv=None) -> dict:
    """Times the five variants and K1 on the JAX script's inputs, prints the
    five lines and the JSON line, and returns the JSON line's dict."""
    from spair_pytorch_tpu_torch.bench import card_of

    args = make_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("the anatomy needs a CUDA card (none is "
                             "visible); --device cpu runs the plain versions")
        device = torch.device("cuda", torch.cuda.current_device())
    color, alpha, imp, boxes, image_hw, win = paper_inputs(
        args.batch, args.seed, device)
    b, n, c, oh, ow = color.shape
    ms = {}
    for name in VARIANTS:
        dt = run_variant(name, color, alpha, imp, boxes, image_hw, win,
                         args.k)
        ms[name] = dt * 1e3
        print(f"{name:9s} fwd {dt * 1e3:7.3f} ms", flush=True)
    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        glimpses = [t.to(dtype) for t in (color, alpha, imp)]
        k1[str(dtype).split(".")[1]] = call_ms(
            lambda: composite_forward(*glimpses, boxes, image_hw, win),
            args.k, device)
    bounds = {v: bound(v, b, n, c, (oh, ow), image_hw, win) for v in VARIANTS}
    line = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_of(device), "batch": b, "objects": n, "channels": c,
        "glimpse": [oh, ow], "canvas": list(image_hw), "win": win,
        "k": args.k, "seed": args.seed, "ms": ms,
        "shares_ms": {
            "build": ms["base"] - ms["nobuild"],
            "plane_products": ms["nobuild"] - ms["nomatmul"],
            "accumulate": ms["nobuild"] - ms["noaccum"],
            "build_and_accumulate": ms["base"] - ms["noaccum"],
            "hoisting": ms["base"] - ms["hoisted"]},
        "bound_ms": {v: x[0] for v, x in bounds.items()},
        "bound_by": {v: x[1] for v, x in bounds.items()},
        "composite_forward_ms": k1}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
