"""Digit patch banks: real MNIST (idx/ubyte), real handwriting (sklearn),
or the built-in procedural font (the port's copy of the numpy-only
``spair_pytorch_tpu/data/digits.py``; it searches for MNIST files only in
``$MNIST_DIR``, ``./data`` and the working directory).

The reference trains on scattered MNIST (reference spair/dataloader.py:10-36,
train.py:38), but its dataset file was never published ("Data: Coming
soon...", reference README.md:24) and this environment has no network. Three
sources, best available wins:

  * ``mnist``   — the classic idx/ubyte files (``train-images-idx3-ubyte``
    optionally ``.gz``), read directly when the user has them on disk.
    True MNIST, paper-comparable.
  * ``sklearn`` — scikit-learn's bundled ``load_digits``: 1,797 REAL
    handwritten digits (UCI optical-recognition test set) at 8x8,
    bilinearly resized to the patch size. Real handwriting variability
    without any download; the no-network stand-in for MNIST.
  * ``font``    — the deterministic procedural 5x7 glyph bank
    (data/scattered_mnist.py), always available.

``digit_bank('auto', ...)`` prefers mnist > sklearn > font and reports what
it picked via ``resolve_source``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from spair_pytorch_tpu_torch.data.scattered_mnist import glyph_bank

_IDX_IMAGE_MAGIC = 2051  # 0x00000803: unsigned byte, 3 dims
_MNIST_NAMES = ("train-images-idx3-ubyte", "train-images.idx3-ubyte",
                "t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte")


def load_mnist_idx(path: str) -> np.ndarray:
    """Read an idx3-ubyte image file (plain or .gz) -> (N, H, W) float32
    in [0, 1].

    The idx format (used by the classic MNIST distribution): big-endian
    int32 magic (2051 for 3-D ubyte), then N, H, W, then N*H*W raw bytes.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(16)
        if len(header) < 16:
            raise ValueError(f"{path}: truncated idx header")
        magic, n, h, w = struct.unpack(">iiii", header)
        if magic != _IDX_IMAGE_MAGIC:
            raise ValueError(
                f"{path}: magic {magic} != {_IDX_IMAGE_MAGIC} "
                "(expected an idx3-ubyte image file)")
        data = f.read(n * h * w)
        if len(data) < n * h * w:
            raise ValueError(f"{path}: truncated image data")
    images = np.frombuffer(data, np.uint8).reshape(n, h, w)
    return images.astype(np.float32) / 255.0


def find_mnist_file(search_dirs: Optional[Sequence[str]] = None
                    ) -> Optional[str]:
    """Locate a local MNIST idx image file. Checked, in order: $MNIST_DIR,
    ./data and the cwd, each for the standard train/test image filenames,
    plain or gzipped."""
    dirs = list(search_dirs) if search_dirs is not None else []
    if not dirs:
        env = os.environ.get("MNIST_DIR")
        if env:
            dirs.append(env)
        dirs += ["data", "."]
    for d in dirs:
        for name in _MNIST_NAMES:
            for suffix in ("", ".gz"):
                p = os.path.join(d, name + suffix)
                if os.path.isfile(p):
                    return p
    return None


def resize_bilinear(images: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W) -> (N, oh, ow) bilinear resize (half-pixel centers)."""
    n, h, w = images.shape
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[None, :, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, None, :]
    top = (images[:, y0][:, :, x0] * (1 - fx)
           + images[:, y0][:, :, x1] * fx)
    bot = (images[:, y1][:, :, x0] * (1 - fx)
           + images[:, y1][:, :, x1] * fx)
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def mnist_bank(patch_hw: Tuple[int, int], path: Optional[str] = None,
               limit: Optional[int] = None) -> np.ndarray:
    """Patch bank from a local MNIST idx file, resized to ``patch_hw``."""
    path = path or find_mnist_file()
    if path is None:
        raise FileNotFoundError(
            "no MNIST idx file found (set $MNIST_DIR or place "
            "train-images-idx3-ubyte[.gz] in ./data); this environment "
            "cannot download it")
    images = load_mnist_idx(path)
    if limit:
        images = images[:limit]
    return resize_bilinear(images, patch_hw)


def sklearn_digit_bank(patch_hw: Tuple[int, int]) -> np.ndarray:
    """Patch bank of real handwritten digits from sklearn's bundled
    load_digits (1,797 samples, UCI optical-recognition test set, 8x8 with
    17 gray levels), resized to ``patch_hw`` and normalized to [0, 1]."""
    from sklearn.datasets import load_digits
    images = load_digits().images.astype(np.float32) / 16.0
    return resize_bilinear(np.clip(images, 0.0, 1.0), patch_hw)


def resolve_source(source: str = "auto") -> str:
    """'auto' -> the best available concrete source name."""
    if source != "auto":
        return source
    if find_mnist_file() is not None:
        return "mnist"
    try:
        import sklearn.datasets  # noqa: F401
        return "sklearn"
    except ImportError:
        return "font"


def digit_bank(source: str, patch_hw: Tuple[int, int],
               mnist_path: Optional[str] = None,
               limit: Optional[int] = None) -> np.ndarray:
    """(N, ph, pw) float32 patch bank for the requested source
    ('auto' | 'mnist' | 'sklearn' | 'font')."""
    source = resolve_source(source)
    if source == "mnist":
        return mnist_bank(patch_hw, path=mnist_path, limit=limit)
    if source == "sklearn":
        bank = sklearn_digit_bank(patch_hw)
        return bank[:limit] if limit else bank
    if source == "font":
        return glyph_bank(patch_hw)
    raise ValueError(f"unknown digit source {source!r}")
