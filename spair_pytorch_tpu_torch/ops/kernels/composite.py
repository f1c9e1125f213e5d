"""Paste-and-composite: the CUDA forward kernel and its plain version.

``composite_forward`` is the port of ``spair_pytorch_tpu/ops/pallas/
composite.py::composite_pallas`` (forward only). For CUDA tensors it launches
the hand-written kernel in ``csrc/composite_fwd.cu`` or raises; for CPU
tensors it runs ``composite_plain``, the chunked PyTorch compositor ported
from ``models/render.py::composite_xla``, which is also the kernel's oracle.

The kernel is compiled with ``nvcc`` at first use into ``_build/`` (named by
the source's hash, so an edited source rebuilds) and bound with ``ctypes``.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from spair_pytorch_tpu_torch.ops.stn import paste_weights

_EPS = 1e-9
_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "composite_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def composite_plain(color, alpha, importance, boxes, image_hw,
                    chunk: int = 16, pres_gate=None, den_floor_n=None):
    """Chunked paste-and-composite in plain PyTorch.

    color (B, N, C, oh, ow), alpha and importance (B, N, 1, oh, ow), boxes
    (B, N, 4) -> (num (B, C, H, W), den (B, 1, H, W)), both float32:
    num = sum_o paste(alpha) paste(color) (paste(imp) + 1e-9) and
    den = sum_o (paste(imp) + 1e-9). Glimpses are widened to float32, as the
    kernel does. ``pres_gate`` (B, N) masks the glimpses of gated-out
    objects (they keep their 1e-9 den floor); ``den_floor_n`` sets the
    number of objects counted in that floor. Objects are padded to a
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
        safe = torch.tensor([0.5, 0.5, 1.0, 1.0], dtype=f32,
                            device=boxes.device).expand(b, pad, 4)
        boxes = torch.cat([boxes, safe], dim=1)
    num = torch.zeros((b, c, h, w), dtype=f32, device=color.device)
    den = torch.zeros((b, 1, h, w), dtype=f32, device=color.device)
    for start in range(0, n + pad, chunk):
        sl = slice(start, start + chunk)
        py, px = paste_weights(boxes[:, sl], (oh, ow), (h, w))
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


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the composite kernel is built "
                           "with the CUDA toolkit's nvcc")
    return path


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/composite_fwd.cu`` into ``build_dir`` unless a build
    of the same source exists; returns the shared library's path. Raises
    with nvcc's output if the build fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = Path(build_dir) / f"composite_fwd_{digest[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.spair_composite_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.spair_cuda_error_string.argtypes = [ctypes.c_int]
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
        raise ValueError("composite_forward takes contiguous tensors")
    ih, iw = image_hw
    if min(ih, iw, oh, ow) < 2:
        raise ValueError("canvas and glimpse sides must be at least 2")
    if b > 65535 or 5 * n * 4 > 48 * 1024 or ih * iw >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: B={b}, N={n}, "
                         f"H*W={ih * iw}")
    return b, n, c, oh, ow


def composite_forward(color, alpha, importance, boxes, image_hw,
                      win_rows=None, pres_gate=None, den_floor_n=None):
    """(num, den) of the gated reference-mode composite; the kernel on CUDA
    tensors, ``composite_plain`` on CPU tensors.

    ``win_rows`` is accepted for parity with the TPU kernel's paste window;
    the gather kernel is exact without one. ``pres_gate`` (B, N) float32
    skips objects whose gate is 0; ``den_floor_n`` overrides the number of
    objects in den's 1e-9 floor. No backward exists yet, so inputs that
    require grad are refused while grad mode is on."""
    tensors = [color, alpha, importance, boxes]
    if pres_gate is not None:
        tensors.append(pres_gate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("composite_forward has no backward yet; call it "
                           "under torch.no_grad()")
    if win_rows is not None and int(win_rows) < 1:
        raise ValueError(f"win_rows must be positive, got {win_rows}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = color.device
    if device.type == "cpu":
        return composite_plain(color, alpha, importance, boxes, image_hw,
                               pres_gate=pres_gate, den_floor_n=den_floor_n)
    if device.type != "cuda":
        raise ValueError(f"composite_forward runs on cuda or cpu, got "
                         f"{device}")

    b, n, c, oh, ow = _check_cuda_inputs(color, alpha, importance, boxes,
                                         pres_gate, image_hw)
    ih, iw = image_hw
    floor_n = n if den_floor_n is None else int(den_floor_n)
    lib = load_library()
    num = torch.empty((b, c, ih, iw), dtype=torch.float32, device=device)
    den = torch.empty((b, 1, ih, iw), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_composite_fwd(
            color.data_ptr(), alpha.data_ptr(), importance.data_ptr(),
            boxes.data_ptr(),
            None if pres_gate is None else pres_gate.data_ptr(),
            num.data_ptr(), den.data_ptr(), b, n, c, oh, ow, ih, iw,
            floor_n * _EPS, int(color.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.spair_cuda_error_string(err).decode()
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err} "
                           f"({msg})")
    composite_forward.launches += 1
    return num, den


composite_forward.launches = 0
