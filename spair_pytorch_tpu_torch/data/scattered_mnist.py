"""Scattered-digit scenes generated on the device (counterpart of the
generator in ``spair_pytorch_tpu/data/scattered_mnist.py``).

Items follow the JAX package's schema: image (C, H, W) in [0, 1], bbox
(max_objects, 4) pixel [x, y, w, h] with the top-left corner (inactive
slots all zero), count (1,). The random draws (``draw_scenes``) are kept
apart from the deterministic placement (``place_patches``), so the
placement can be held against the JAX generator on the same draws.
``OnDeviceScatteredDigits`` is the infinite iterator the training and
evaluation loops draw from. ``ScatteredMNISTFile`` reads the same schema
from a reference-layout HDF5 file (h5py, imported when a file is opened).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# 5x7 bitmap font for digits 0-9 (rows of 5 bits, MSB left).
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def glyph_bank(patch_hw: Tuple[int, int] = (14, 14),
               variants_per_digit: int = 16, seed: int = 0) -> np.ndarray:
    """Procedural digit patch bank (n, ph, pw) float32 in [0, 1]: each
    variant upsamples the 5x7 glyph (nearest neighbour) to a random
    sub-size of the patch at a random offset, with brightness jitter."""
    ph, pw = patch_hw
    rng = np.random.RandomState(seed)
    bank = np.zeros((10 * variants_per_digit, ph, pw), np.float32)
    for d in range(10):
        glyph = np.array([[int(c) for c in row] for row in _FONT[d]],
                         np.float32)
        for v in range(variants_per_digit):
            th = rng.randint(max(7, ph - 5), ph + 1)
            tw = rng.randint(max(5, pw - 5), pw + 1)
            ys = np.clip((np.arange(th) * 7 / th).astype(int), 0, 6)
            xs = np.clip((np.arange(tw) * 5 / tw).astype(int), 0, 4)
            patch = glyph[np.ix_(ys, xs)]
            patch = patch * rng.uniform(0.7, 1.0)
            oy = rng.randint(0, ph - th + 1)
            ox = rng.randint(0, pw - tw + 1)
            out = np.zeros((ph, pw), np.float32)
            out[oy:oy + th, ox:ox + tw] = patch
            bank[d * variants_per_digit + v] = out
    return bank


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_hw: Tuple[int, int] = (128, 128)
    patch_hw: Tuple[int, int] = (14, 14)
    min_objects: int = 1
    max_objects: int = 6
    channels: int = 1


def draw_scenes(generator: torch.Generator, bank_size: int, batch: int,
                dcfg: DataConfig):
    """Random scene layout on the generator's device: (picks (B, M),
    oys (B, M), oxs (B, M), count (B,)), all int64."""
    ih, iw = dcfg.image_hw
    ph, pw = dcfg.patch_hw
    m = dcfg.max_objects
    kw = dict(generator=generator, device=generator.device)
    count = torch.randint(dcfg.min_objects, m + 1, (batch,), **kw)
    picks = torch.randint(0, bank_size, (batch, m), **kw)
    oys = torch.randint(0, ih - ph + 1, (batch, m), **kw)
    oxs = torch.randint(0, iw - pw + 1, (batch, m), **kw)
    return picks, oys, oxs, count


def place_patches(bank, picks, oys, oxs, count, dcfg: DataConfig):
    """Max-composite the picked patches at integer offsets.

    bank (n, ph, pw); picks, oys, oxs (B, M); count (B,) -> image
    (B, C, H, W), bbox (B, M, 4), count (B, 1) float32. Slots at or past
    ``count`` are inactive: they place nothing and their bbox is zero."""
    ih, iw = dcfg.image_hw
    ph, pw = bank.shape[1:]
    b, m = picks.shape
    device = bank.device
    active = torch.arange(m, device=device)[None, :] < count[:, None]
    patches = bank[picks] * active[..., None, None].to(bank.dtype)
    rows = oys[..., None] + torch.arange(ph, device=device)   # (B, M, ph)
    cols = oxs[..., None] + torch.arange(pw, device=device)   # (B, M, pw)
    flat = (rows[..., :, None] * iw + cols[..., None, :]).reshape(b, -1)
    canvas = torch.zeros((b, ih * iw), dtype=bank.dtype, device=device)
    canvas.scatter_reduce_(1, flat, patches.reshape(b, -1), reduce="amax")
    image = canvas.reshape(b, 1, ih, iw).expand(b, dcfg.channels, ih, iw)
    bbox = torch.stack([oxs.to(torch.float32), oys.to(torch.float32),
                        torch.full((b, m), float(pw), device=device),
                        torch.full((b, m), float(ph), device=device)],
                       dim=-1) * active[..., None]
    return image.contiguous(), bbox, count[:, None].to(torch.float32)


def generate_batch(generator: torch.Generator, bank, batch: int,
                   dcfg: DataConfig):
    """A batch of scenes on the bank's device: (image, bbox, count)."""
    picks, oys, oxs, count = draw_scenes(generator, bank.shape[0], batch,
                                         dcfg)
    return place_patches(bank, picks, oys, oxs, count, dcfg)


class OnDeviceScatteredDigits:
    """Infinite iterator of scene batches (image, bbox, count) generated on
    ``device`` from a ``torch.Generator`` that lives there, seeded with
    ``seed``; ``bank`` (n, ph, pw) defaults to the glyph bank."""

    def __init__(self, dcfg: DataConfig, batch: int, bank=None, seed: int = 0,
                 device="cuda"):
        self.dcfg = dcfg
        self.batch = batch
        self.bank = torch.as_tensor(
            bank if bank is not None else glyph_bank(dcfg.patch_hw),
            dtype=torch.float32, device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def __iter__(self):
        return self

    def __next__(self):
        return generate_batch(self.generator, self.bank, self.batch,
                              self.dcfg)


class ScatteredMNISTFile:
    """Reader for the reference HDF5 schema: file[group] with datasets
    image (N, H, W), bbox (N, M, 4) and digit_count (N, 1). Yields numpy
    float32 batches (image (B, 1, H, W), bbox, count), as the JAX package's
    reader does."""

    def __init__(self, path: str, group: str = "train/full"):
        import h5py  # only file-backed data needs it
        self._h5 = h5py.File(path, "r")[group]

    def __len__(self):
        return self._h5["image"].shape[0]

    def close(self):
        self._h5.file.close()

    def __getitem__(self, index):
        image = np.asarray(self._h5["image"][index], np.float32)[None]
        bbox = np.asarray(self._h5["bbox"][index], np.float32)
        count = np.asarray(self._h5["digit_count"][index], np.float32)
        return image, bbox, count

    def batches(self, batch_size: int, drop_last: bool = True):
        n = len(self)
        for start in range(0, n - (batch_size if drop_last else 1) + 1,
                           batch_size):
            idx = slice(start, min(start + batch_size, n))
            image = np.asarray(self._h5["image"][idx], np.float32)[:, None]
            bbox = np.asarray(self._h5["bbox"][idx], np.float32)
            count = np.asarray(self._h5["digit_count"][idx], np.float32)
            yield image, bbox, count
