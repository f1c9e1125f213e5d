"""Object decoder and compositing renderer (counterpart of
``spair_pytorch_tpu/models/render.py``).

``render_mode='reference'`` is the reference's importance-normalized blend,
out = num / den clipped to [0, 1], with num and den from
``ops/kernels/composite.py``: ``composite``, the autograd Function over the
CUDA forward and backward kernels K1 and K2 (``render_backend`` 'pallas' or
'auto'; on CPU tensors their plain versions), or the plain chunked
compositor under autograd ('xla'); or, for 'pallas_v3', from
``ops/kernels/composite_v3.py::composite_v3``, the band-clipped kernels K3
and K4, which compute the same function for the model's boxes.
``render_mode='ordered'`` is true depth-ordered alpha-over compositing,
from ``ops/kernels/composite_ordered.py``: ``composite_over``, the sort and
gather in PyTorch and the autograd Function over the CUDA forward and
backward kernels of ``csrc/composite_ordered.cu`` on CUDA tensors, for
every ``render_backend`` but 'xla'; ``composite_ordered``, the plain scan
under autograd, for 'xla' and on CPU tensors.
``composite_ungated`` is the same choice for the paths that composite
outside ``render`` (split refinement, the figures' gradient views).

With the presence gate on, ``render_topk`` = K composites only the K
objects of highest presence when no image has more than K live objects,
which is exact, and the full grid otherwise: in ordered mode on every
backend, in reference mode on the kernel backends ('pallas', 'auto'),
where K1 and K2 then run on B x K objects; 'xla' and 'pallas_v3' ignore
it, as in the JAX package (``topk_branches``). The K are taken in
``jax.lax.top_k``'s order, tied scores to the lower index: presence
saturates at exactly 1.0, and in ordered mode the gathered order decides
the compositing order of objects at equal depth.

The JAX package branches on the device (``lax.cond``). Here ``render`` is
three functions, so that a captured program can put its segments around
the branch (``parallel/captured.py``): ``render_objects``, the part before
it (the decoder, the gate and the branch's predicate, a 0-d bool tensor on
the device); ``takes_topk``, which reads the predicate on the host, one
device sync; and ``composite_objects``, one branch's composite.
"""

from __future__ import annotations

import numpy as np
import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.ops.backbone import grid_geometry
from spair_pytorch_tpu_torch.ops.kernels.composite import (
    composite, composite_forward, composite_plain)
from spair_pytorch_tpu_torch.ops.kernels.composite_ordered import (
    composite_ordered, composite_over)
from spair_pytorch_tpu_torch.ops.kernels.composite_v3 import composite_v3
from spair_pytorch_tpu_torch.ops.math import clamped_sigmoid

_TOPK_NEEDS_GATE = (
    "render_topk requires pres_gate_threshold > 0: without the gate, "
    "dropped objects have small-but-nonzero alpha and top-K selection would "
    "change the composite")


def decode_objects(params, cfg: SpairConfig, z_attr, z_pres, z_depth,
                   dtype=None, logit_tap=None):
    """z_attr (B, N, A) -> (color, alpha, importance), each (B, N, ·, oh, ow).

    The decoder (the MLP, or the conv decoder with ``object_codec='conv'``)
    computes in ``dtype`` and returns float32 logits. They are scaled
    (color x obj_logit_scale, alpha x alpha_logit_scale + alpha_logit_bias)
    and squashed with the analytical sigmoid; alpha is gated by z_pres and
    importance = clamp(alpha * depth, min=0.01).

    ``logit_tap``: optional zeros (B, N, oh, ow, C+1) added to the scaled
    and biased logits; its gradient is the gradient at the tensor the
    reference's decoder-output hook watched (``utils/debug.py::
    generative_grad_views``)."""
    c = cfg.n_channels
    oh, ow = cfg.object_shape
    if cfg.object_codec == "conv":
        logits = params.object_decoder(z_attr, dtype=dtype)
    else:
        logits = params.object_decoder(z_attr, dtype=dtype)[0]
        b, n = logits.shape[:2]
        logits = logits.reshape(b, n, oh, ow, c + 1)
    color_logits = logits[..., :c] * cfg.obj_logit_scale
    alpha_logits = (logits[..., c:] * cfg.alpha_logit_scale
                    + cfg.alpha_logit_bias)
    if logit_tap is not None:
        color_logits = color_logits + logit_tap[..., :c]
        alpha_logits = alpha_logits + logit_tap[..., c:]
    color = clamped_sigmoid(color_logits, use_analytical=True)
    alpha = clamped_sigmoid(alpha_logits, use_analytical=True)
    alpha = alpha * z_pres[..., None, None, :]               # (B,N,oh,ow,1)
    importance = torch.clamp(alpha * z_depth[..., None, None, :], min=0.01)
    # to the channel-first glimpse layout (B, N, C, oh, ow)
    return tuple(torch.movedim(t, -1, 2).contiguous()
                 for t in (color, alpha, importance))


def _top_k(scores, k: int):
    """A gather of the K objects of highest score, in descending order of
    score and tied scores to the lower index, as ``jax.lax.top_k`` returns
    them (``torch.topk`` promises no order among ties): take(t) maps
    (B, N, ...) to (B, K, ...). A stable sort of the N scores, on the
    device."""
    b = scores.shape[0]
    idx = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :k]                  # (B, K)

    def take(t):
        return torch.take_along_dim(
            t, idx.reshape((b, k) + (1,) * (t.ndim - 2)), dim=1)
    return take


def topk_branches(cfg: SpairConfig) -> bool:
    """Whether ``render`` of ``cfg`` branches on the live count: a
    ``render_topk`` K below the grid's object count, in ordered mode or on
    the kernel backends ('pallas', 'auto'). Read from the configuration
    alone, so a program can be laid out before it runs."""
    _, (gh, gw), _ = grid_geometry(cfg.image_shape[1:], cfg.backbone_topology)
    return _branches(cfg, gh * gw * cfg.n_object_slots)


def _branches(cfg: SpairConfig, n: int) -> bool:
    return 0 < cfg.render_topk < n and (
        cfg.render_mode == "ordered"
        or cfg.render_backend in ("pallas", "auto"))


def takes_topk(live_at_most_k) -> bool:
    """The branch ``render`` takes on the predicate of ``render_objects``:
    the top-K composite when it holds (reading it is one host sync); the
    full composite when it does not, or is None (no branch)."""
    return live_at_most_k is not None and bool(live_at_most_k)


def composite_ungated(cfg: SpairConfig, color, alpha, importance, boxes,
                      image_hw, chunk=None, grad: bool = True):
    """(num, den) of the reference-blend composite with no presence gate,
    the function of the JAX package's ``composite_xla``, for the paths that
    composite outside ``render``. 'xla' takes the plain compositor
    (``chunk`` objects at a time, ``cfg.render_chunk`` by default) on any
    device. Every other backend takes K1, and K2 under autograd when
    ``grad``, on CUDA tensors and their plain versions on CPU tensors;
    'pallas_v3' too, since without a gate K3 computes K1's function.
    ``grad=False`` is the forward alone, for use outside autograd."""
    if cfg.render_backend == "xla":
        return composite_plain(color, alpha, importance, boxes, image_hw,
                               chunk or cfg.render_chunk)
    if grad:
        return composite(color, alpha, importance, boxes, image_hw)
    return composite_forward(color, alpha, importance, boxes, image_hw)


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


def render_objects(params, cfg: SpairConfig, z_attr, z_where, z_depth,
                   z_pres, dtype=None, reduce_live=None):
    """The part of ``render`` before its top-K branch: (objects,
    live_at_most_k).

    ``objects`` holds the decoded glimpses (``decode_objects``; in ordered
    mode alpha already gated), the boxes, depths and presence scores
    flattened to (B, N, ·), the gate (B, N) or None, and the grid (gh, gw).
    ``live_at_most_k`` is the branch's predicate where ``topk_branches``
    says render branches: a 0-d bool tensor on the device, whether no image
    has more than K live objects, counted in int32 (exact for any grid; the
    compute dtype's integers are exact only so far: bf16 to 256); None
    otherwise. ``reduce_live``, for a data-parallel step, takes the 0-d
    int32 largest live count of this process's images to the largest over
    the ranks (``parallel/mesh.py::global_max``), so every rank reads the
    global batch's predicate, as the JAX step's sharded max does."""
    b, gh, gw = z_attr.shape[:3]
    n = gh * gw

    def flat(t):
        return t.reshape(b, n, t.shape[-1])

    color, alpha, importance = decode_objects(
        params, cfg, flat(z_attr), flat(z_pres), flat(z_depth), dtype)
    gate = None
    if cfg.pres_gate_threshold > 0.0:
        gate = (flat(z_pres)[..., 0] > cfg.pres_gate_threshold).to(
            torch.float32).contiguous()                     # (B, N)
    branches = _branches(cfg, n)
    if branches and gate is None:
        raise ValueError(_TOPK_NEEDS_GATE)
    if cfg.render_mode == "ordered" and gate is not None:
        alpha = alpha * gate[:, :, None, None, None]
    objects = {"color": color, "alpha": alpha, "importance": importance,
               "boxes": flat(z_where).contiguous(), "depth": flat(z_depth),
               "scores": flat(z_pres)[..., 0], "gate": gate, "grid": (gh, gw)}
    live_at_most_k = None
    if branches:
        most = torch.max(torch.sum((gate > 0).to(torch.int32), dim=1))
        if reduce_live is not None:
            most = reduce_live(most)
        live_at_most_k = most <= cfg.render_topk
    return objects, live_at_most_k


def composite_objects(cfg: SpairConfig, objects, image_hw, topk: bool):
    """The part of ``render`` after its branch: the reconstruction (B, C,
    H, W) in [0, 1] of ``render_objects``' objects, composited from the K
    of highest presence when ``topk`` and from all of them otherwise.

    The top-K composite is exact when no image has more than K live
    objects: gated objects have alpha exactly 0 in ordered mode, identities
    of the over operator (and the ordered kernels skip them, given the
    gate), and the kernels skip them in reference mode,
    where den keeps the floor of all n objects (``den_floor_n``); the
    objects left out get exact zero gradients through the gather, as the
    gate gave them."""
    color, alpha, importance = (objects[k] for k in ("color", "alpha",
                                                     "importance"))
    boxes, gate = objects["boxes"], objects["gate"]
    n = color.shape[1]
    take = _top_k(objects["scores"], cfg.render_topk) if topk else None

    if cfg.render_mode == "ordered":
        args = (color, alpha, objects["depth"], boxes)
        if take is not None:
            args = tuple(map(take, args))
            gate = None if gate is None else take(gate)
        if cfg.render_backend == "xla":
            out = composite_ordered(*args, image_hw, cfg.render_chunk)
        else:
            out = composite_over(*args, image_hw, pres_gate=gate,
                                 chunk=cfg.render_chunk)
        return torch.clamp(out, 0.0, 1.0)

    backend = cfg.render_backend
    if backend in ("pallas", "auto"):
        win = paste_window_rows(cfg, image_hw)
        if take is not None:
            num, den = composite(take(color), take(alpha), take(importance),
                                 take(boxes), image_hw, win,
                                 pres_gate=take(gate), den_floor_n=n)
        else:
            num, den = composite(color, alpha, importance, boxes, image_hw,
                                 win, pres_gate=gate)
    elif backend == "xla":
        num, den = composite_plain(color, alpha, importance, boxes, image_hw,
                                   cfg.render_chunk, pres_gate=gate)
    elif backend == "pallas_v3":
        if gate is not None:
            g = gate[:, :, None, None, None]
            color, alpha, importance = color * g, alpha * g, importance * g
        gh, gw = objects["grid"]
        _, _, (cell_h, _) = grid_geometry(image_hw, cfg.backbone_topology)
        max_ys = cfg.max_hw * cfg.anchor_shape[0] / cfg.image_shape[1]
        num, den = composite_v3(color, alpha, importance, boxes, image_hw,
                                cell_h, (gh, gw),
                                (cfg.min_yx, cfg.max_yx, max_ys),
                                cfg.render_chunk_k)
    else:
        raise NotImplementedError(
            f"render_backend {backend!r} is not ported yet")
    return torch.clamp(num / den, 0.0, 1.0)


def render(params, cfg: SpairConfig, z_attr, z_where, z_depth, z_pres,
           image_hw, dtype=None):
    """Latent grids (B, gh, gw, ·) -> reconstruction (B, C, H, W) in [0, 1].

    ``dtype`` is the decoder's compute dtype; its outputs, and so the
    glimpses the compositor sees, are float32 either way. With
    ``pres_gate_threshold`` > 0, objects whose z_pres is not above it are
    left out of the composite (den keeps their 1e-9 floor) and get no
    reconstruction gradient: K1 and K2 skip them; the plain compositor and
    'pallas_v3' mask their glimpses, as the JAX package does; ordered mode
    zeroes their alpha, and its kernels (every backend but 'xla', on CUDA
    tensors) skip them. ``render_topk`` as the module docstring says:
    ``render_objects``, the predicate read on the host (``takes_topk``),
    then ``composite_objects``."""
    objects, live_at_most_k = render_objects(params, cfg, z_attr, z_where,
                                             z_depth, z_pres, dtype)
    return composite_objects(cfg, objects, image_hw,
                             takes_topk(live_at_most_k))
