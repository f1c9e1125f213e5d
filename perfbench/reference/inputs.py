"""What the benchmark hands to both sides, made from the seed: weights,
the digit bank, scenes and the noise of a training step.

A frozen copy of the scene generator's arithmetic (the procedural 5x7 digit
font, the random layout and the max-composite placement) and of the noise
a training step draws, issued as the same torch random calls in the same
order on the same device, so a generator in the state that the program's
step found gives the reference the scenes and noise the step drew.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from perfbench.reference.spair import Config, SpairReference

FONT = {
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

PATCH_HW = (14, 14)


def digit_bank(patch_hw=PATCH_HW, variants: int = 16, seed: int = 0):
    """(10 * variants, ph, pw) float32 in [0, 1]: each variant scales a 5x7
    glyph (nearest neighbour) to a random sub-size of the patch at a random
    offset, with a random brightness."""
    ph, pw = patch_hw
    rng = np.random.RandomState(seed)
    bank = np.zeros((10 * variants, ph, pw), np.float32)
    for d in range(10):
        glyph = np.array([[int(c) for c in row] for row in FONT[d]],
                         np.float32)
        for v in range(variants):
            th = rng.randint(max(7, ph - 5), ph + 1)
            tw = rng.randint(max(5, pw - 5), pw + 1)
            ys = np.clip((np.arange(th) * 7 / th).astype(int), 0, 6)
            xs = np.clip((np.arange(tw) * 5 / tw).astype(int), 0, 4)
            patch = glyph[np.ix_(ys, xs)] * rng.uniform(0.7, 1.0)
            oy = rng.randint(0, ph - th + 1)
            ox = rng.randint(0, pw - tw + 1)
            bank[d * variants + v, oy:oy + th, ox:ox + tw] = patch
    return bank


def scenes(generator, bank, batch: int, image_hw, min_objects: int,
           max_objects: int, channels: int = 1):
    """A batch of scenes on the generator's device: image (B, C, H, W) in
    [0, 1], the patches' boxes (B, M, 4) pixel [x, y, w, h] (zero past the
    count) and the counts (B, 1)."""
    ih, iw = image_hw
    n, ph, pw = bank.shape
    m = max_objects
    kw = dict(generator=generator, device=generator.device)
    count = torch.randint(min_objects, m + 1, (batch,), **kw)
    picks = torch.randint(0, n, (batch, m), **kw)
    oys = torch.randint(0, ih - ph + 1, (batch, m), **kw)
    oxs = torch.randint(0, iw - pw + 1, (batch, m), **kw)
    device = bank.device
    active = torch.arange(m, device=device)[None, :] < count[:, None]
    patches = bank[picks] * active[..., None, None].float()
    rows = oys[..., None] + torch.arange(ph, device=device)
    cols = oxs[..., None] + torch.arange(pw, device=device)
    flat = (rows[..., :, None] * iw + cols[..., None, :]).reshape(batch, -1)
    canvas = torch.zeros((batch, ih * iw), device=device)
    canvas.scatter_reduce_(1, flat, patches.reshape(batch, -1),
                           reduce="amax")
    image = canvas.reshape(batch, 1, ih, iw).expand(batch, channels, ih, iw)
    boxes = torch.stack([oxs.float(), oys.float(),
                         torch.full((batch, m), float(pw), device=device),
                         torch.full((batch, m), float(ph), device=device)],
                        -1) * active[..., None]
    return image.contiguous(), boxes, count[:, None].float()


def step_noise(generator, batch: int, cfg: Config) -> Dict[str, torch.Tensor]:
    """The draws of one training forward, in the program's order: normals
    for the box, attribute and depth latents, then logistic noise for
    presence, log(u + 1e-9) - log(1 - u + 1e-9)."""
    _, (gh, gw), _ = cfg.geometry
    kw = dict(generator=generator, device=generator.device)
    out = {k: torch.randn((batch, gh, gw, d), **kw)
           for k, d in (("box", 4), ("attr", cfg.n_attributes),
                        ("depth", 1))}
    u = torch.rand((batch, gh, gw, 1), **kw)
    out["pres"] = torch.log(u + 1e-9) - torch.log(1.0 - u + 1e-9)
    return out


def weight_seed(seed: int) -> int:
    """The weights' own seed, so that their stream is not the data's."""
    return (seed * 0x9E3779B97F4A7C15 + 0x5EED) % (2 ** 63)


def init_weights(cfg: Config, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter under the program's names, drawn on ``device`` in
    two calls: one uniform draw cut into the weights and biases of every
    linear and conv layer, each scaled to U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch's default), and one normal draw for the edge element, with a
    sigmoid on its box, depth and presence slices."""
    shapes = {k: tuple(v.shape) for k, v in
              SpairReference(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    layers = [k for k in shapes if k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) + shapes[k][0] for k in layers)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for w in layers:
        bound = 1.0 / math.sqrt(math.prod(shapes[w][1:]))
        for key in (w, w[:-len("weight")] + "bias"):
            size = math.prod(shapes[key])
            out[key] = (u[at:at + size] * bound).reshape(shapes[key])
            at += size
    a = cfg.n_attributes
    e = torch.randn(shapes["virtual_edge_element"], generator=gen,
                    device=device)
    out["virtual_edge_element"] = torch.cat(
        [torch.sigmoid(e[:4]), e[4:4 + a], torch.sigmoid(e[4 + a:])])
    return out


def reference_model(cfg: Config, weights: Dict[str, torch.Tensor], device):
    """A ``SpairReference`` on ``device`` holding copies of ``weights``."""
    model = SpairReference(cfg).to(device)
    model.load_state_dict({k: v.clone() for k, v in weights.items()})
    return model
