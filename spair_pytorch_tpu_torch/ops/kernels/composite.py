"""Paste-and-composite: the CUDA kernels, their plain versions, autograd.

``composite`` is the port of ``spair_pytorch_tpu/ops/pallas/composite.py::
composite_pallas``: a ``torch.autograd.Function`` whose forward is
``composite_forward`` and whose backward is ``composite_backward``. For CUDA
tensors those launch the hand-written kernels in ``csrc/composite_fwd.cu``
and ``csrc/composite_bwd.cu`` or raise; for CPU tensors they run
``composite_plain`` (the chunked PyTorch compositor ported from
``models/render.py::composite_xla``) and ``composite_backward_plain`` (the
Pallas backward's formulas as tensor code), which are also the kernels'
oracles. ``cull_tiles`` is the forward kernel's per-tile culling rule in
plain PyTorch, for the tests; nothing on a path calls it.

The same two kernels, launched with a row band, are ``ops/kernels/
composite_v3.py``'s K3 and K4 (``_launch_forward`` / ``_launch_backward``
take the band). ``csrc/kernel_anatomy.cu``, the windowed matmul paste of
``benchmarks/kernel_anatomy.py`` (K5), is built beside them and launched by
``benchmarks/kernel_anatomy.py::kernel_anatomy``; ``csrc/spans.cu``, the span
mark of ``utils/spans.py``, too, but only when a recorder first needs it.
They are compiled with ``nvcc`` at first use into
the build directory (``utils/compile_cache.py``: the package's ``_build/``
unless ``SPAIR_COMPILE_CACHE`` says otherwise), one library per source,
named by the hash of the source and the shared header (so an edited source
rebuilds), and bound with ``ctypes``. Nothing is built or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from spair_pytorch_tpu_torch.ops.stn import _source_coords_paste, paste_weights
from spair_pytorch_tpu_torch.utils.compile_cache import (
    build_dir as _build_dir)

_EPS = 1e-9
_PKG = Path(__file__).resolve().parents[2]
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("composite_fwd", "composite_bwd", "kernel_anatomy",
                        "spans")}
# built alone at their first load, never with the others: a run without
# span marks compiles no span kernel
ON_DEMAND = ("spans",)
HEADERS = (_PKG / "csrc" / "composite_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the most shared memory one block of the backward kernel may take
_BWD_SMEM_MAX = 227 * 1024
# objects K1 culls per pass (csrc/composite_fwd.cu kChunk)
CULL_CHUNK = 128
# support pixels in one of K2's dP tiles, before the shared-memory budget
BWD_TILE_PX = 2048
# the most images (grid rows) one launch of either kernel takes
MAX_SCENES = 65535
# grid rows whose band starts travel in the launch's parameters (csrc/
# composite_common.cuh kMaxBandRows); a taller grid passes them in device
# memory
PARAM_BAND_ROWS = 64


def safe_boxes(b: int, n: int, dtype, device):
    """(b, n, 4) copies of the safe box [0.5, 0.5, 1, 1] that padding
    objects sit on, made on ``device`` without a copy from the host (a
    captured step may not make one)."""
    return torch.cat([torch.full((b, n, 2), 0.5, dtype=dtype, device=device),
                      torch.ones((b, n, 2), dtype=dtype, device=device)], -1)


def composite_plain(color, alpha, importance, boxes, image_hw,
                    chunk: int = 16, pres_gate=None, den_floor_n=None,
                    row_keep=None):
    """Chunked paste-and-composite in plain PyTorch.

    color (B, N, C, oh, ow), alpha and importance (B, N, 1, oh, ow), boxes
    (B, N, 4) -> (num (B, C, H, W), den (B, 1, H, W)), both float32:
    num = sum_o paste(alpha) paste(color) (paste(imp) + 1e-9) and
    den = sum_o (paste(imp) + 1e-9). Glimpses are widened to float32, as the
    kernel does. ``pres_gate`` (B, N) masks the glimpses of gated-out
    objects (they keep their 1e-9 den floor); ``den_floor_n`` sets the
    number of objects counted in that floor. ``row_keep`` (1 or B, N, H),
    1 or 0, zeroes each object's row hat weights on the canvas rows it may
    not paste onto (the banded compositor's clip). Objects are padded to a
    multiple of ``chunk`` with zero glimpses on the safe box [0.5, 0.5, 1, 1]
    (a zero scale would divide 0 by 0), and the padding's floor is taken
    back out of den."""
    f32 = torch.float32
    color, alpha, importance = (t.to(f32) for t in (color, alpha, importance))
    boxes = boxes.to(f32)
    if pres_gate is not None:
        g = pres_gate.to(f32)[:, :, None, None, None]
        color, alpha, importance = color * g, alpha * g, importance * g
    b, n, c = color.shape[:3]
    oh, ow = color.shape[-2:]
    h, w = image_hw
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        def padn(t):
            return torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        color, alpha, importance = map(padn, (color, alpha, importance))
        safe = safe_boxes(b, pad, f32, boxes.device)
        boxes = torch.cat([boxes, safe], dim=1)
        if row_keep is not None:
            row_keep = torch.cat([row_keep, row_keep.new_zeros(
                row_keep.shape[:1] + (pad, h))], dim=1)
    num = torch.zeros((b, c, h, w), dtype=f32, device=color.device)
    den = torch.zeros((b, 1, h, w), dtype=f32, device=color.device)
    for start in range(0, n + pad, chunk):
        sl = slice(start, start + chunk)
        py, px = paste_weights(boxes[:, sl], (oh, ow), (h, w))
        if row_keep is not None:
            py = py * row_keep[:, sl, :, None]
        glimpse = torch.cat([color[:, sl], alpha[:, sl], importance[:, sl]],
                            dim=2)
        tmp = torch.einsum("bnhy,bncyx->bnchx", py, glimpse)
        pasted = torch.einsum("bnchx,bnwx->bnchw", tmp, px)
        p_col = pasted[:, :, :c]
        p_alp = pasted[:, :, c:c + 1]
        p_imp = pasted[:, :, c + 1:c + 2] + _EPS
        num = num + torch.sum(p_alp * p_col * p_imp, dim=1)
        den = den + torch.sum(p_imp, dim=1)
    if pad:
        den = den - pad * _EPS
    if den_floor_n is not None:
        den = den + (den_floor_n - n) * _EPS
    return num, den


def composite_backward_plain(color, alpha, importance, boxes, image_hw,
                             dnum, dden, pres_gate=None, chunk: int = 16,
                             row_keep=None):
    """The compositor's VJP in plain PyTorch: the formulas of the Pallas
    backward (``_bwd_object``) as tensor code over the full canvas, where
    the hat weights vanish outside each object's support, so no window is
    needed. Not autograd: the box gradient uses the Pallas hat derivative,
    -sign(src - a) where the weight is positive, with sign(0) = 0.

    Inputs as ``composite_plain`` takes them, plus the cotangents dnum
    (B, C, H, W) and dden (B, 1, H, W). Returns (dcolor, dalpha, dimp) in
    the glimpse dtype and dbox (B, N, 4) float32; objects whose gate is 0
    get exact zeros. ``row_keep`` clips each object's rows as
    ``composite_plain`` takes it. Objects are taken ``chunk`` at a time."""
    f32 = torch.float32
    c = color.shape[2]
    g = torch.cat([color, alpha, importance], dim=2).to(f32)
    boxes, dnum, dden = boxes.to(f32), dnum.to(f32), dden.to(f32)
    parts = [_backward_objects(g[:, i:i + chunk], boxes[:, i:i + chunk],
                               dnum, dden, c, image_hw,
                               None if row_keep is None
                               else row_keep[:, i:i + chunk])
             for i in range(0, g.shape[1], chunk)]
    dg = torch.cat([p[0] for p in parts], dim=1)
    dbox = torch.cat([p[1] for p in parts], dim=1)
    if pres_gate is not None:
        live = pres_gate != 0
        dg = torch.where(live[:, :, None, None, None], dg, 0.0)
        dbox = torch.where(live[:, :, None], dbox, 0.0)
    dg = dg.to(color.dtype)
    return dg[:, :, :c], dg[:, :, c:c + 1], dg[:, :, c + 1:], dbox


def _backward_objects(g, boxes, dnum, dden, c: int, image_hw, row_keep=None):
    """dG (B, k, C+2, oh, ow) and dbox (B, k, 4) of k objects' glimpses g;
    ``row_keep`` (1 or B, k, H) clips their canvas rows."""
    oh, ow = g.shape[-2:]
    ih, iw = image_hw
    xt, yt, xs, ys = boxes.unbind(-1)
    src_y = _source_coords_paste(yt, ys, ih, oh)               # (B, k, H)
    src_x = _source_coords_paste(xt, xs, iw, ow)               # (B, k, W)
    dy = src_y[..., None] - torch.arange(oh, dtype=g.dtype, device=g.device)
    dx = src_x[..., None] - torch.arange(ow, dtype=g.dtype, device=g.device)
    py = torch.clamp(1.0 - dy.abs(), min=0.0)                  # (B, k, H, oh)
    px = torch.clamp(1.0 - dx.abs(), min=0.0)                  # (B, k, W, ow)
    if row_keep is not None:
        py = py * row_keep[..., None]

    t = torch.einsum("bnha,bnkaq->bnkhq", py, g)
    planes = torch.einsum("bnkhq,bnwq->bnkhw", t, px)          # (B,k,C+2,H,W)
    col, alp = planes[:, :, :c], planes[:, :, c:c + 1]
    impe = planes[:, :, c + 1:] + _EPS
    dn = dnum[:, None]
    dp = torch.cat([dn * alp * impe,
                    torch.sum(dn * col * impe, dim=2, keepdim=True),
                    torch.sum(dn * alp * col, dim=2, keepdim=True)
                    + dden[:, None]], dim=2)

    dt = torch.einsum("bnkhw,bnwq->bnkhq", dp, px)
    dg = torch.einsum("bnha,bnkhq->bnkaq", py, dt)
    dpy = torch.einsum("bnkhq,bnkaq->bnha", dt, g)
    dpx = torch.einsum("bnkhq,bnkhw->bnwq", t, dp)

    # hat-weight derivatives, dw/dsrc = -sign(src - a) where w > 0
    ey = -torch.sign(dy) * (py > 0)
    ex = -torch.sign(dx) * (px > 0)
    gy = torch.sum(dpy * ey, dim=(-2, -1))
    gys = torch.sum(dpy * ey * (src_y[..., None] - (oh - 1) * 0.5),
                    dim=(-2, -1))
    gx = torch.sum(dpx * ex, dim=(-2, -1))
    gxs = torch.sum(dpx * ex * (src_x[..., None] - (ow - 1) * 0.5),
                    dim=(-2, -1))
    dbox = torch.stack([gx * (-(ow - 1.0) / xs), gy * (-(oh - 1.0) / ys),
                        gxs * (-1.0 / xs), gys * (-1.0 / ys)], dim=-1)
    return dg, dbox


def canvas_range(src_lo: float, src_hi: float, canvas: int, t, s,
                 glimpse: int):
    """``csrc/composite_common.cuh::canvas_range`` in float32, elementwise
    over box centres ``t`` and scales ``s``: (lo, hi) int64, the canvas
    indices whose glimpse coordinate may lie in (src_lo, src_hi), widened by
    two indices against rounding and clamped to the canvas (lo > hi when
    empty). fmin/fmax drop a NaN operand, so a degenerate box scans the
    whole canvas, as in the kernels."""
    f32 = torch.float32
    t, s = t.to(f32), s.to(f32)
    k = torch.tensor(2.0, dtype=f32) / torch.tensor(float(glimpse - 1),
                                                    dtype=f32)
    half = (canvas - 1) / 2.0
    a = ((src_lo * k - 1.0) * s + 2.0 * t) * half
    b = ((src_hi * k - 1.0) * s + 2.0 * t) * half
    zero = torch.zeros((), dtype=f32)
    lo = torch.fmin(torch.fmax(torch.floor(torch.fmin(a, b)) - 2.0, zero),
                    zero + canvas)
    hi = torch.fmax(torch.fmin(torch.ceil(torch.fmax(a, b)) + 2.0,
                               zero + (canvas - 1)), zero - 1.0)
    return lo.to(torch.int64), hi.to(torch.int64)


def cull_tiles(boxes, image_hw, object_hw, tile=(32, 8), pres_gate=None,
               bands=None):
    """K1's culling rule in plain PyTorch: which objects each canvas tile
    lists. Not on any path; the tests hold it against the JAX paste
    weights.

    boxes (B, N, 4) [xt, yt, xs, ys]; ``tile`` (rows, columns), by default
    the kernel's (``csrc/composite_fwd.cu`` kTileH, kTileW). Returns a
    bool mask (B, tiles_y, tiles_x, N): object o is listed for a tile when
    its gate is nonzero and its support (``canvas_range`` over the glimpse
    coordinates (-1, oh) and (-1, ow)) meets the tile. ``mask[b, i, j]
    .nonzero()`` is tile (i, j)'s list, in object order as the kernel sums
    it. ``bands`` = (band, starts, gw) is K3's cull: object o's rows are
    first clipped to [starts[o // gw], starts[o // gw] + band)."""
    ih, iw = image_hw
    oh, ow = object_hw
    th, tw = tile
    xt, yt, xs, ys = boxes.to(torch.float32).unbind(-1)
    ylo, yhi = canvas_range(-1.0, float(oh), ih, yt, ys, oh)
    xlo, xhi = canvas_range(-1.0, float(ow), iw, xt, xs, ow)
    if bands is not None:
        band, starts, gw = bands
        lo = torch.as_tensor(starts, device=boxes.device).repeat_interleave(
            gw)
        ylo, yhi = torch.maximum(ylo, lo), torch.minimum(yhi, lo + band - 1)

    def meets(lo, hi, size, step):
        start = torch.arange(0, size, step, device=boxes.device)
        return torch.maximum(lo[..., None], start) <= \
            torch.minimum(hi[..., None], start + step - 1)

    rows = meets(ylo, yhi, ih, th)                       # (B, N, tiles_y)
    cols = meets(xlo, xhi, iw, tw)                       # (B, N, tiles_x)
    live = rows[..., :, None] & cols[..., None, :]       # (B, N, ty, tx)
    if pres_gate is not None:
        live = live & (pres_gate != 0)[..., None, None]
    return live.permute(0, 2, 3, 1)


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the composite kernels are built "
                           "with the CUDA toolkit's nvcc")
    return path


def library_path(name: str) -> Path:
    """Where the build of ``SOURCES[name]`` lives in the build directory
    (``utils/compile_cache.py::build_dir``): named by the hash of the
    source, the shared header and the nvcc flags."""
    digest = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in HEADERS)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _build_dir() / f"{name}_{digest[:16]}.so"


def build_library(names=None) -> Dict[str, Path]:
    """Compile every source in ``SOURCES`` named in ``names`` (by default
    every one but those ``ON_DEMAND``) that has no build of the same hash in
    the build directory, one nvcc process per source, all started together;
    returns {name: shared library path}. Waits for every nvcc it started,
    then raises with nvcc's output if any build failed."""
    if names is None:
        names = [name for name in SOURCES if name not in ON_DEMAND]
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    _build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
        else:
            todo[name].with_suffix(".log").write_text(err)
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return outs


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``SOURCES[name]`` was built: each
    kernel's registers, shared memory and spills ('' before a build)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    lib = ctypes.CDLL(str(build_library(
        [name] if name in ON_DEMAND else None)[name]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {  # function: (argtypes, restype)
        "composite_fwd": {
            "spair_composite_fwd": ([ptr] * 7 + [i32] * 7 + [f32, ptr, ptr]
                                    + [i32] * 4 + [ptr], i32)},
        "composite_bwd": {
            "spair_composite_bwd": ([ptr] * 9 + [i32] * 8 + [ptr, ptr]
                                    + [i32] * 4 + [ptr], i32),
            "spair_composite_bwd_smem": ([i32] * 7, ctypes.c_size_t)},
        "kernel_anatomy": {
            "spair_kernel_anatomy": ([ptr] * 7 + [i32] * 9 + [f32, ptr], i32),
            "spair_kernel_anatomy_smem": ([i32] * 6, ctypes.c_size_t)},
        "spans": {
            "spair_span_mark_launch": ([ptr] + [i32] * 4 + [ptr], i32),
            "spair_span_host_words": ([i32, ctypes.POINTER(ptr),
                                       ctypes.POINTER(ptr)], i32),
            "spair_span_free_host_words": ([ptr], i32)},
    }
    for fn, (argtypes, restype) in signatures[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.spair_cuda_error_string.argtypes = [i32]
    lib.spair_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(color, alpha, importance, boxes, pres_gate, image_hw):
    if color.dim() != 5:
        raise ValueError(f"color must be (B, N, C, oh, ow), got "
                         f"{tuple(color.shape)}")
    b, n, c, oh, ow = color.shape
    if color.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"color must be float32 or bfloat16, got "
                        f"{color.dtype}")
    for name, t in (("alpha", alpha), ("importance", importance)):
        if t.dtype != color.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != color dtype "
                            f"{color.dtype}")
        if tuple(t.shape) != (b, n, 1, oh, ow):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(b, n, 1, oh, ow)}")
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (b, n, 4):
        raise ValueError(f"boxes must be float32 {(b, n, 4)}, got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    tensors = [color, alpha, importance, boxes]
    if pres_gate is not None:
        if pres_gate.dtype != torch.float32 or \
                tuple(pres_gate.shape) != (b, n):
            raise ValueError(f"pres_gate must be float32 {(b, n)}, got "
                             f"{pres_gate.dtype} {tuple(pres_gate.shape)}")
        tensors.append(pres_gate)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the composite kernels take contiguous tensors")
    ih, iw = image_hw
    if min(ih, iw, oh, ow) < 2:
        raise ValueError("canvas and glimpse sides must be at least 2")
    # grid rows are images; K2 numbers the objects b * n with an int
    if b > MAX_SCENES or b * n >= 2 ** 31 or ih * iw >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: B={b}, N={n}, "
                         f"H*W={ih * iw}")
    return b, n, c, oh, ow


def _check_cotangents(dnum, dden, b: int, c: int, image_hw):
    ih, iw = image_hw
    for name, t, ch in (("dnum", dnum, c), ("dden", dden, 1)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, ch, ih, iw) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{(b, ch, ih, iw)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _device_of(tensors, fn: str):
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cuda or cpu, got {device}")
    return device


def _raise_on(lib, err: int, name: str):
    if err != 0:
        msg = lib.spair_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def composite_forward(color, alpha, importance, boxes, image_hw,
                      win_rows=None, pres_gate=None, den_floor_n=None):
    """(num, den) of the gated reference-mode composite; the kernel on CUDA
    tensors, ``composite_plain`` on CPU tensors. This is the raw forward,
    outside autograd: ``composite`` is the differentiable entry.

    ``win_rows`` is accepted for parity with the TPU kernel's paste window;
    the gather kernel is exact without one. ``pres_gate`` (B, N) float32
    skips objects whose gate is 0; ``den_floor_n`` overrides the number of
    objects in den's 1e-9 floor."""
    if win_rows is not None and int(win_rows) < 1:
        raise ValueError(f"win_rows must be positive, got {win_rows}")
    device = _device_of([color, alpha, importance, boxes, pres_gate],
                        "composite_forward")
    if device.type == "cpu":
        return composite_plain(color, alpha, importance, boxes, image_hw,
                               pres_gate=pres_gate, den_floor_n=den_floor_n)

    out = _launch_forward(color, alpha, importance, boxes, image_hw,
                          pres_gate, den_floor_n, device)
    composite_forward.launches += 1
    return out


composite_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _device_starts(starts, device: torch.device) -> torch.Tensor:
    """The band starts as an int32 tensor on ``device``, made once per
    grid: the kernels read a tall grid's starts from it."""
    return torch.tensor(starts, dtype=torch.int32, device=device)


def _band_args(bands, n: int, device: torch.device):
    """(host starts as a ctypes array or None, device starts pointer or
    None, gh, gw, band) for the C interface; ``bands`` = (band, starts, gw)
    as a tuple of ints, or None for no clip. Up to ``PARAM_BAND_ROWS`` grid
    rows the starts go in the launch's parameters, beyond in device
    memory."""
    if bands is None:
        return None, None, 0, 0, 0
    band, starts, gw = bands
    gh = len(starts)
    if gh < 1 or gh * gw != n:
        raise ValueError(f"bands of {gh} grid rows of {gw} objects for N={n}")
    if gh <= PARAM_BAND_ROWS:
        return (ctypes.c_int * gh)(*starts), None, gh, gw, int(band)
    dev = _device_starts(tuple(starts), device)
    return None, dev.data_ptr(), gh, gw, int(band)


def _launch_forward(color, alpha, importance, boxes, image_hw, pres_gate,
                    den_floor_n, device, bands=None):
    """(num, den) from one launch of ``csrc/composite_fwd.cu``: K1, or K3
    with ``bands`` = (band, starts, gw)."""
    b, n, c, oh, ow = _check_cuda_inputs(color, alpha, importance, boxes,
                                         pres_gate, image_hw)
    ih, iw = image_hw
    floor_n = n if den_floor_n is None else int(den_floor_n)
    band_args = _band_args(bands, n, device)
    lib = load_library("composite_fwd")
    num = torch.empty((b, c, ih, iw), dtype=torch.float32, device=device)
    den = torch.empty((b, 1, ih, iw), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_composite_fwd(
            color.data_ptr(), alpha.data_ptr(), importance.data_ptr(),
            boxes.data_ptr(),
            None if pres_gate is None else pres_gate.data_ptr(),
            num.data_ptr(), den.data_ptr(), b, n, c, oh, ow, ih, iw,
            floor_n * _EPS, *band_args, int(color.dtype == torch.bfloat16),
            stream)
    _raise_on(lib, err, "composite_fwd")
    return num, den


@functools.lru_cache(maxsize=None)
def _bwd_tile_px(c: int, oh: int, ow: int, ih: int, iw: int,
                 is_bf16: int) -> int:
    """Support pixels per dP tile of the backward kernel: ``BWD_TILE_PX``,
    halved until a block's shared memory fits ``_BWD_SMEM_MAX``."""
    smem = load_library("composite_bwd").spair_composite_bwd_smem
    px = BWD_TILE_PX
    while px >= 1:
        if smem(c, oh, ow, ih, iw, px, is_bf16) <= _BWD_SMEM_MAX:
            return px
        px //= 2
    raise ValueError(f"glimpses of {c + 2} x {oh} x {ow} and a {ih} x {iw} "
                     f"canvas do not fit the backward kernel's shared memory")


def composite_backward(color, alpha, importance, boxes, image_hw, dnum, dden,
                       pres_gate=None):
    """(dcolor, dalpha, dimp, dbox), the VJP of ``composite_forward`` for
    the cotangents dnum (B, C, H, W) and dden (B, 1, H, W); the kernel on
    CUDA tensors, ``composite_backward_plain`` on CPU tensors."""
    device = _device_of([color, alpha, importance, boxes, pres_gate, dnum,
                         dden], "composite_backward")
    if device.type == "cpu":
        return composite_backward_plain(color, alpha, importance, boxes,
                                        image_hw, dnum, dden, pres_gate)

    out = _launch_backward(color, alpha, importance, boxes, image_hw, dnum,
                           dden, pres_gate, device)
    composite_backward.launches += 1
    return out


composite_backward.launches = 0


def _launch_backward(color, alpha, importance, boxes, image_hw, dnum, dden,
                     pres_gate, device, bands=None):
    """(dcolor, dalpha, dimp, dbox) from one launch of ``csrc/
    composite_bwd.cu``: K2, or K4 with ``bands`` = (band, starts, gw)."""
    b, n, c, oh, ow = _check_cuda_inputs(color, alpha, importance, boxes,
                                         pres_gate, image_hw)
    ih, iw = image_hw
    _check_cotangents(dnum, dden, b, c, image_hw)
    band_args = _band_args(bands, n, device)
    lib = load_library("composite_bwd")
    is_bf16 = int(color.dtype == torch.bfloat16)
    tile_px = _bwd_tile_px(c, oh, ow, ih, iw, is_bf16)
    dg = torch.empty((b, n, c + 2, oh, ow), dtype=color.dtype, device=device)
    dbox = torch.empty((b, n, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_composite_bwd(
            color.data_ptr(), alpha.data_ptr(), importance.data_ptr(),
            boxes.data_ptr(),
            None if pres_gate is None else pres_gate.data_ptr(),
            dnum.data_ptr(), dden.data_ptr(), dg.data_ptr(), dbox.data_ptr(),
            b, n, c, oh, ow, ih, iw, tile_px, *band_args, is_bf16, stream)
    _raise_on(lib, err, "composite_bwd")
    return dg[:, :, :c], dg[:, :, c:c + 1], dg[:, :, c + 1:], dbox


class CompositeFunction(torch.autograd.Function):
    """Forward ``composite_forward``, backward ``composite_backward``: the
    kernels on CUDA tensors, their plain versions on CPU tensors. Saves the
    glimpses, boxes and gate (not the pasted planes, which the backward
    recomputes, as the TPU kernel does). The gate gets no gradient, as in
    the JAX custom VJP."""

    @staticmethod
    def forward(ctx, color, alpha, importance, boxes, pres_gate, image_hw,
                win_rows, den_floor_n):
        ctx.image_hw = image_hw
        ctx.save_for_backward(color, alpha, importance, boxes, pres_gate)
        return composite_forward(color, alpha, importance, boxes, image_hw,
                                 win_rows, pres_gate, den_floor_n)

    @staticmethod
    def backward(ctx, dnum, dden):
        color, alpha, importance, boxes, pres_gate = ctx.saved_tensors
        grads = composite_backward(color, alpha, importance, boxes,
                                   ctx.image_hw, dnum.contiguous(),
                                   dden.contiguous(), pres_gate)
        return (*grads, None, None, None, None)


def composite(color, alpha, importance, boxes, image_hw, win_rows=None,
              pres_gate=None, den_floor_n=None):
    """Differentiable (num, den) of the gated reference-mode composite: the
    entry ``models/render.py::render`` takes. Arguments as
    ``composite_forward``; gradients reach the glimpses and boxes."""
    return CompositeFunction.apply(color, alpha, importance, boxes,
                                   pres_gate, tuple(image_hw), win_rows,
                                   den_floor_n)
