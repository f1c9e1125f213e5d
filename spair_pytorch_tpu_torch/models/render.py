"""Object decoder and compositing renderer (counterpart of
``spair_pytorch_tpu/models/render.py``, reference compositing mode).

The composite is the reference's importance-normalized blend, out =
num / den clipped to [0, 1], with num and den from
``ops/kernels/composite.py``: ``composite``, the autograd Function over the
CUDA forward and backward kernels (``render_backend`` 'pallas' or 'auto';
on CPU tensors their plain versions), or the plain chunked compositor under
autograd ('xla').
"""

from __future__ import annotations

import numpy as np
import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.ops.kernels.composite import (composite,
                                                           composite_plain)
from spair_pytorch_tpu_torch.ops.math import clamped_sigmoid


def decode_objects(params, cfg: SpairConfig, z_attr, z_pres, z_depth,
                   dtype=None):
    """z_attr (B, N, A) -> (color, alpha, importance), each (B, N, ·, oh, ow).

    The decoder MLP computes in ``dtype`` and returns float32 logits. They
    are scaled (color x obj_logit_scale, alpha x alpha_logit_scale +
    alpha_logit_bias) and squashed with the analytical sigmoid; alpha is
    gated by z_pres and importance = clamp(alpha * depth, min=0.01)."""
    c = cfg.n_channels
    oh, ow = cfg.object_shape
    logits = params.object_decoder(z_attr, dtype=dtype)[0]
    b, n = logits.shape[:2]
    logits = logits.reshape(b, n, oh, ow, c + 1)
    color_logits = logits[..., :c] * cfg.obj_logit_scale
    alpha_logits = (logits[..., c:] * cfg.alpha_logit_scale
                    + cfg.alpha_logit_bias)
    color = clamped_sigmoid(color_logits, use_analytical=True)
    alpha = clamped_sigmoid(alpha_logits, use_analytical=True)
    alpha = alpha * z_pres[..., None, None, :]               # (B,N,oh,ow,1)
    importance = torch.clamp(alpha * z_depth[..., None, None, :], min=0.01)
    # to the channel-first glimpse layout (B, N, C, oh, ow)
    return tuple(torch.movedim(t, -1, 2).contiguous()
                 for t in (color, alpha, importance))


def paste_window_rows(cfg: SpairConfig, image_hw):
    """Paste-window height the TPU kernel would use: the widest paste
    support, ceil(max_ys * (1 + 2/(oh-1)) * (H-1)) + 2 rows, rounded up to
    8 plus 8 rows of alignment slack. The CUDA kernel needs no window and
    takes it for interface parity."""
    ih = image_hw[0]
    oh = cfg.object_shape[0]
    max_ys = cfg.max_hw * cfg.anchor_shape[0] / cfg.image_shape[1]
    k = 1.0 + 2.0 / (oh - 1)
    span = int(np.ceil(max_ys * k * (ih - 1))) + 2
    return min(ih, -(-(span + 7) // 8) * 8)


def render(params, cfg: SpairConfig, z_attr, z_where, z_depth, z_pres,
           image_hw, dtype=None):
    """Latent grids (B, gh, gw, ·) -> reconstruction (B, C, H, W) in [0, 1].

    ``dtype`` is the decoder's compute dtype; its outputs, and so the
    glimpses the compositor sees, are float32 either way. With
    ``pres_gate_threshold`` > 0, objects whose z_pres is not above it are
    left out of the composite (den keeps their 1e-9 floor) and get no
    reconstruction gradient: the kernels skip them, the plain compositor
    masks their glimpses."""
    if cfg.render_mode != "reference":
        raise NotImplementedError(
            f"render_mode {cfg.render_mode!r} is not ported yet")
    if cfg.render_topk > 0:
        raise NotImplementedError("render_topk is not ported yet")
    b, gh, gw = z_attr.shape[:3]
    n = gh * gw

    def flat(t):
        return t.reshape(b, n, t.shape[-1])

    color, alpha, importance = decode_objects(
        params, cfg, flat(z_attr), flat(z_pres), flat(z_depth), dtype)
    boxes = flat(z_where).contiguous()
    gate = None
    if cfg.pres_gate_threshold > 0.0:
        gate = (flat(z_pres)[..., 0] > cfg.pres_gate_threshold).to(
            torch.float32).contiguous()                     # (B, N)

    backend = cfg.render_backend
    if backend in ("pallas", "auto"):
        num, den = composite(color, alpha, importance, boxes, image_hw,
                             paste_window_rows(cfg, image_hw), pres_gate=gate)
    elif backend == "xla":
        num, den = composite_plain(color, alpha, importance, boxes, image_hw,
                                   cfg.render_chunk, pres_gate=gate)
    else:
        raise NotImplementedError(
            f"render_backend {backend!r} is not ported yet")
    return torch.clamp(num / den, 0.0, 1.0)
