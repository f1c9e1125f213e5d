"""ctypes binding of the native C++ scattered-digits generator
(counterpart of ``spair_pytorch_tpu/data/native.py``).

``native/scattered_digits.cc`` is multithreaded host C++ that writes batches
into preallocated buffers: the host-side alternative to the on-device
generator. It is built from that source at first use, with one ``g++``
call, into the build directory (``utils/compile_cache.py``: the package's
``_build/`` unless ``SPAIR_COMPILE_CACHE`` says otherwise) under a name
carrying the hash of the source and the flags (an edited source rebuilds);
a failed build raises with g++'s output.
The tracked ``native/libspair_native.so`` is never loaded.

``NativeScatteredDigits`` passes the C++ generator the JAX package's seed
for every batch, so one seed gives the same batches, bit for bit, in both
packages. For a CUDA ``device`` the generator writes into a fresh pinned
host buffer and the batch goes to the card with ``non_blocking`` copies:
the caching host allocator keeps a buffer from reuse until its copy has
run, so no step waits on the card for its data.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from spair_pytorch_tpu_torch.data.scattered_mnist import DataConfig, glyph_bank
from spair_pytorch_tpu_torch.utils.compile_cache import build_dir

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "scattered_digits.cc"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path() -> Path:
    """Where the build of ``SOURCE`` lives: named by the hash of the source
    and the g++ flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return build_dir() / f"spair_native_{digest[:16]}.so"


def build_native() -> Path:
    """Compile ``SOURCE`` unless a build of the same hash exists; returns
    the shared library's path. Raises with g++'s output if the build
    fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {SOURCE}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(build_native()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.spair_generate_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bank, n, ph, pw
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # batch, H, W
        ctypes.c_int, ctypes.c_int,                      # min/max objects
        ctypes.c_uint64, ctypes.c_int,                   # seed, threads
        f32p, f32p, f32p,                                # out buffers
    ]
    lib.spair_generate_batch.restype = None
    return lib


class NativeScatteredDigits:
    """Infinite iterator of (image (B, C, H, W), bbox (B, M, 4), count
    (B, 1)) float32 tensors on ``device`` from the C++ generator: the item
    schema of the on-device generator and of the reference HDF5 file."""

    def __init__(self, dcfg: DataConfig, batch: int, bank=None, seed: int = 0,
                 n_threads: Optional[int] = None, device="cuda"):
        self.dcfg = dcfg
        self.batch = batch
        self.bank = np.ascontiguousarray(
            np.asarray(bank if bank is not None else glyph_bank(dcfg.patch_hw),
                       np.float32))
        # the C++ side indexes the bank and the canvas with these sizes
        if self.bank.ndim != 3 or self.bank.shape[1:] != tuple(
                dcfg.patch_hw) or any(p > i for p, i in zip(dcfg.patch_hw,
                                                            dcfg.image_hw)):
            raise ValueError(f"bank {self.bank.shape} does not hold "
                             f"{dcfg.patch_hw} patches for a "
                             f"{dcfg.image_hw} canvas")
        if not 1 <= dcfg.min_objects <= dcfg.max_objects:
            raise ValueError(f"objects per scene {dcfg.min_objects}.."
                             f"{dcfg.max_objects}")
        self.seed = seed
        self.index = 0
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self.device = torch.device(device)
        self._lib = load_native()

    def __iter__(self):
        return self

    def __next__(self):
        d = self.dcfg
        ih, iw = d.image_hw
        ph, pw = d.patch_hw
        pin = self.device.type == "cuda"
        images = torch.empty((self.batch, ih, iw), pin_memory=pin)
        bboxes = torch.empty((self.batch, d.max_objects, 4), pin_memory=pin)
        counts = torch.empty((self.batch, 1), pin_memory=pin)
        self._lib.spair_generate_batch(
            self.bank, self.bank.shape[0], ph, pw,
            self.batch, ih, iw, d.min_objects, d.max_objects,
            np.uint64(self.seed * 0x9E3779B9 + self.index), self.n_threads,
            images.numpy(), bboxes.numpy(), counts.numpy())
        self.index += 1
        images, bboxes, counts = (t.to(self.device, non_blocking=pin)
                                  for t in (images, bboxes, counts))
        image = images[:, None].expand(-1, d.channels, -1, -1).contiguous()
        return image, bboxes, counts
