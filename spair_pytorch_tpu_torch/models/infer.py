"""Serving-path detector: images -> boxes, scores, counts (counterpart of
``spair_pytorch_tpu/models/infer.py``).

A deterministic inference pass (zero noise, so samples are posterior means;
no KL, no rendering, no loss) returning pixel-space detections:

    detect = make_detector(cfg)
    out = detect(params, images)          # images (B, C, H, W) in [0, 1]
    out["boxes"]   # (B, N, 4) pixel [x0, y0, x1, y1], centre-based
    out["scores"]  # (B, N) presence probabilities
    out["count"]   # (B,) number of scores at or above the threshold

On a CUDA device ``make_detector`` returns the detector as one captured
CUDA graph for each batch size (``parallel/captured.py::
CapturedForward``), the counterpart of the JAX package's ``jax.jit`` of
``detect``; its NMS runs a fixed number of sweeps on the device in place
of the eager path's early exit, which reads the host once a sweep.
"""

from __future__ import annotations

from functools import lru_cache, partial

import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.models.latents import geometry, noise_shapes
from spair_pytorch_tpu_torch.models.spair import infer_latents


def pairwise_iou(boxes):
    """IoU matrices (..., N, N) for corner boxes (..., N, 4)."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) \
        * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_keep(boxes, scores, iou_threshold: float):
    """Greedy NMS for one image: boxes (N, 4), scores (N,) -> keep (N,).
    A box is suppressed iff a KEPT higher-scoring box overlaps it above the
    threshold."""
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = pairwise_iou(boxes[order])
    idx = torch.arange(n, device=scores.device)
    keep = torch.ones(n, dtype=torch.bool, device=scores.device)
    for i in range(n):
        keep = keep & ~((iou[i] > iou_threshold) & (idx > i) & keep[i])
    inv = torch.argsort(order)
    return keep[inv]


def nms_keep_batch(boxes, scores, iou_threshold: float,
                   early_exit: bool = True):
    """Batched greedy NMS: (B, N, 4), (B, N) -> keep (B, N), the same keep
    set as ``nms_keep`` per image.

    Greedy NMS is the unique fixpoint of keep_i = not any(keep_j and
    iou(j, i) > t for j < i) in score order, so sweeps from all-ones
    converge in (suppression-chain depth + 1) sweeps, at most N: each sweep
    fixes the next box in score order, and a sweep after convergence
    changes nothing. ``early_exit`` stops at the first sweep that changes
    nothing, which reads the host once a sweep; without it the N sweeps
    run on the device with no host read (the captured detector), and give
    the same keep set."""
    b, n = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    sorted_boxes = torch.take_along_dim(boxes, order[..., None], dim=1)
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                  device=scores.device), diagonal=-1)
    edge = (pairwise_iou(sorted_boxes) > iou_threshold) & lower
    keep = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    for _ in range(n):
        new = ~torch.any(edge & keep[:, None, :], dim=-1)
        if early_exit and not bool(torch.any(new != keep)):
            break
        keep = new
    return torch.take_along_dim(keep, torch.argsort(order, dim=-1), dim=1)


@lru_cache(maxsize=None)
def _wheel_off_step(device: torch.device):
    """The step the detector runs at, far past the training-wheel cliff
    (the wheel is value-neutral anyway): a device tensor made once, at the
    first eager call, so a capture copies nothing from the host."""
    return torch.full((), 10 ** 6, dtype=torch.int64, device=device)


@torch.no_grad()
def detect(params, x, cfg: SpairConfig, pres_threshold: float = 0.5,
           nms_iou=None, early_exit: bool = True):
    """Deterministic detection on a batch of images. With ``nms_iou``,
    greedy NMS zeroes the scores of suppressed boxes (``early_exit``: see
    ``nms_keep_batch``)."""
    b = x.shape[0]
    _, (gh, gw), _ = geometry(cfg)
    noise = {name: torch.zeros(shape, device=x.device)
             for name, shape in noise_shapes(b, (gh, gw), cfg).items()}
    z = infer_latents(params, cfg, x, _wheel_off_step(x.device), noise=noise)

    n = gh * gw * cfg.n_object_slots
    img_h, img_w = cfg.image_shape[1:]
    zw = z["z_where"].reshape(b, n, 4)  # [xt, yt, xs, ys] normalized
    cx, cy = zw[..., 0] * img_w, zw[..., 1] * img_h
    bw, bh = zw[..., 2] * img_w, zw[..., 3] * img_h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        dim=-1)
    scores = z["z_pres_prob"].reshape(b, n)
    if nms_iou is not None:
        scores = scores * nms_keep_batch(boxes, scores, nms_iou,
                                         early_exit=early_exit)
    count = torch.sum(scores >= pres_threshold, dim=-1)
    return {"boxes": boxes, "scores": scores, "count": count,
            "z_depth": z["z_depth"].reshape(b, n)}


def make_detector(cfg: SpairConfig, pres_threshold: float = 0.5,
                  nms_iou=None, eager: bool = False):
    """detect_fn(params, images) -> dict, with the config bound.

    On a CUDA device it is captured: one CUDA graph for each batch size,
    the first call of a size run eagerly and captured, every later one a
    replay, bound to the parameters of the first call (``parallel/
    captured.py``). The CPU and the NaN hunter keep it eager, decided at
    the first call, as does ``eager``: the A/B of the two forms."""
    kw = dict(cfg=cfg, pres_threshold=pres_threshold, nms_iou=nms_iou)
    run = None  # chosen at the first call, from the images' device

    def detect_fn(params, x):
        nonlocal run
        if run is None:
            from spair_pytorch_tpu_torch.parallel import captured
            if eager or captured.forward_eager_reason(
                    cfg, x.device) is not None:
                run = partial(detect, **kw)
            else:
                run = captured.CapturedForward(
                    partial(detect, early_exit=False, **kw))
        return run(params, x)
    return detect_fn
