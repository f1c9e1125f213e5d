"""Operations the benchmark divides by, counted from shapes.

``train_step_flops`` counts the products and convolutions of one training
step of the reference's formulation (``perfbench/reference/spair.py``),
forward and backward, each once: every linear layer of every head over
every cell (no padded lanes), the backbone's convolutions, the glimpse
crop's two contractions and the compositor's paste as the hat-weight
contractions the reference writes. Elementwise work, reductions, the
count-prior chain and Adam add nothing. The count follows from the
configuration and the batch alone, so what implements the step cannot
move it. A backward product is counted where the reference's autograd
computes it: the gradient of an operand that needs one (the image needs
none).
"""

from __future__ import annotations

from typing import Dict, Sequence

from perfbench.reference.spair import Config


def _linear(rows: int, n_in: int, n_out: int, grad_input: bool = True):
    fwd = 2 * rows * n_in * n_out
    return fwd * (3 if grad_input else 2)


def _mlp(rows: int, n_in: int, hidden: Sequence[int],
         heads: Sequence[int]) -> int:
    total, prev = 0, n_in
    for h in hidden:
        total += _linear(rows, prev, h)
        prev = h
    return total + sum(_linear(rows, prev, h) for h in heads)


def backbone_flops(cfg: Config, batch: int) -> int:
    (pt, pb, pl, pr), _, _ = cfg.geometry
    c, h, w = cfg.image_shape
    h, w = h + pt + pb, w + pl + pr
    total, first = 0, True
    layers = [tuple(t) for t in cfg.backbone_topology]
    layers.append((cfg.n_backbone_features, 1, 1))
    for f, k, s in layers:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        fwd = 2 * batch * f * h * w * c * k * k
        total += fwd * (2 if first else 3)  # the image needs no gradient
        c, first = f, False
    return total


def train_step_flops(fields: Dict, batch: int) -> int:
    """FLOPs of one training step of the configuration ``fields`` at
    ``batch`` images (module docstring)."""
    cfg = Config(fields)
    c, ih, iw = cfg.image_shape
    oh, ow = cfg.object_shape
    a, n_feat = cfg.n_attributes, cfg.n_backbone_features
    n_pass = cfg.n_passthrough_features
    ctx = 4 * (4 + a + 1 + 1)
    rows = batch * cfg.n_cells
    z_in = 4 + a + n_pass + ctx + n_feat
    total = backbone_flops(cfg, batch)
    total += _mlp(rows, n_feat + ctx, cfg.mlp_hidden, (8, n_pass))
    total += _mlp(rows, c * oh * ow, cfg.encoder_hidden, (2 * a,))
    total += _mlp(rows, z_in, cfg.mlp_hidden, (2, n_pass))
    total += _mlp(rows, z_in + 1, cfg.mlp_hidden, (1,))
    total += _mlp(rows, a, cfg.decoder_hidden, (oh * ow * (c + 1),))
    # the crop: rows of the image (no gradient), then columns
    total += 2 * (2 * rows * oh * ih * c * iw)
    total += 3 * (2 * rows * c * oh * iw * ow)
    # the paste of colour, alpha (and importance in the blend)
    d = c + 1 if cfg.render_mode == "ordered" else c + 2
    total += 3 * (2 * rows * d * ih * oh * ow)
    total += 3 * (2 * rows * d * ih * ow * iw)
    return total
