"""Split refinement: a test-time second pass on merged detections
(counterpart of ``spair_pytorch_tpu/models/refine.py``).

The model is one object per cell, so two digits whose centres share a cell
come out as one detection. This pass uses the generative model as the
judge, with no retraining and no new parameters:

  1. take the top-M detections of the (post-NMS) detector;
  2. for each, propose ``N_CANDIDATES`` splits into two child boxes (side
     by side, stacked, both diagonals, at two separations);
  3. score the one-object hypothesis against each two-object one by
     reconstruction: crop each hypothesis' glimpses, encode them (posterior
     mean), decode them, composite them onto a ``window_px`` square window
     around the parent box, and take the squared error against the image
     resampled to that window;
  4. accept a split when the best two-object reconstruction beats the
     one-object one by more than a relative ``margin`` (``apply_splits``).

It is opt-in and in no preset: on scattered-MNIST clutter the JAX package
measured it as no better than leaving it off. Boxes are the codebase's
normalized z_where [xt, yt, xs, ys] (centre, size as image fractions) or
the detector's pixel corners [x0, y0, x1, y1].

The windows are composited by ``models/render.py::composite_ungated``, the
reference-blend compositor, outside autograd: on CUDA tensors kernel K1, on
CPU tensors ``composite_plain``; with ``render_backend='xla'`` the plain
compositor on any device. One call
composites the B*M parents (one object a scene) and one call all B*M*6
candidates (two objects a scene), each split into calls of at most
``MAX_SCENES`` scenes, the kernel's limit.

The JAX package jits the refiner; on a CUDA device ``make_refiner``'s
program is a captured CUDA graph, one per batch size (``parallel/
captured.py::CapturedForward``), so nothing in it reads the host: the
candidate table is a device tensor made once per device and dtype, and the
margin and the presence threshold are 0-d tensors the graph reads.

Decisions that follow the JAX package, the reference:
- top-M ties go to the lower detection index (``jax.lax.top_k``), by a
  stable descending sort; best-candidate ties to the first candidate;
- the degenerate-box floor is 2 / max(H, W) of the image on both axes,
  also for a non-square image (ROADMAP queue 3 records this);
- the object round trip computes in float32 whatever the model's compute
  dtype, as the JAX package's does.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict

import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.models.render import (composite_ungated,
                                                   decode_objects)
from spair_pytorch_tpu_torch.ops.kernels.composite import MAX_SCENES
from spair_pytorch_tpu_torch.ops.math import latent_to_mean_std
from spair_pytorch_tpu_torch.ops.stn import crop_glimpses


def corner_to_zwhere(boxes, image_hw):
    """Pixel corner boxes (..., 4) [x0, y0, x1, y1] -> normalized z_where
    [xt, yt, xs, ys] (the detector's inverse)."""
    h, w = image_hw
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / (2.0 * w), (y0 + y1) / (2.0 * h),
                        (x1 - x0) / w, (y1 - y0) / h], dim=-1)


def zwhere_to_corner(zw, image_hw):
    """Normalized z_where (..., 4) -> pixel corner boxes [x0, y0, x1, y1]."""
    h, w = image_hw
    cx, cy = zw[..., 0] * w, zw[..., 1] * h
    bw, bh = zw[..., 2] * w, zw[..., 3] * h
    return torch.stack([cx - bw / 2, cy - bh / 2,
                        cx + bw / 2, cy + bh / 2], dim=-1)


# Candidate splits relative to the parent box: (dx_a, dy_a, dx_b, dy_b, sx,
# sy), child centres at parent centre + d * parent size, child size s *
# parent size. Two separations along each axis, one on each diagonal.
_CANDIDATES = (
    # side by side along x
    (-0.25, 0.0, +0.25, 0.0, 0.62, 1.00),
    (-0.32, 0.0, +0.32, 0.0, 0.55, 1.00),
    # stacked along y
    (0.0, -0.25, 0.0, +0.25, 1.00, 0.62),
    (0.0, -0.32, 0.0, +0.32, 1.00, 0.55),
    # diagonals
    (-0.20, -0.20, +0.20, +0.20, 0.70, 0.70),
    (-0.20, +0.20, +0.20, -0.20, 0.70, 0.70),
)
N_CANDIDATES = len(_CANDIDATES)


@lru_cache(maxsize=None)
def candidate_table(device: torch.device, dtype: torch.dtype):
    """``_CANDIDATES`` as a (C, 6) tensor on ``device``, made once per
    device and dtype: the first call copies it from the host, outside any
    capture (a captured program's first run is eager)."""
    return torch.tensor(_CANDIDATES, dtype=dtype, device=device)


def split_candidates(parent_zw):
    """Child-box pairs of every candidate split of every parent: (..., 4)
    normalized -> (..., N_CANDIDATES, 2, 4) normalized."""
    t = candidate_table(parent_zw.device, parent_zw.dtype)     # (C, 6)
    xt, yt, xs, ys = (parent_zw[..., None, i] for i in range(4))
    ax = torch.stack([xt + t[:, 0] * xs, yt + t[:, 1] * ys,
                      t[:, 4] * xs, t[:, 5] * ys], dim=-1)
    bx = torch.stack([xt + t[:, 2] * xs, yt + t[:, 3] * ys,
                      t[:, 4] * xs, t[:, 5] * ys], dim=-1)
    return torch.stack([ax, bx], dim=-2)


def _encode_decode(params, cfg: SpairConfig, image, boxes_zw):
    """The deterministic object round trip at arbitrary boxes, in float32:
    image (B, C, H, W), boxes_zw (B, N, 4) -> (color, alpha) glimpses
    (B, N, ·, oh, ow): crop, encoder posterior mean, decoder with z_pres =
    z_depth = 1."""
    b, n = boxes_zw.shape[:2]
    glimpses = crop_glimpses(image, boxes_zw, cfg.object_shape)
    if cfg.object_codec == "conv":
        attr_latent = params.object_encoder(glimpses)
    else:
        attr_latent = params.object_encoder(glimpses.reshape(b, n, -1))[0]
    attr_mean, _ = latent_to_mean_std(attr_latent)
    ones = torch.ones((b, n, 1), dtype=attr_mean.dtype,
                      device=attr_mean.device)
    color, alpha, _ = decode_objects(params, cfg, attr_mean, ones, ones)
    return color, alpha


def _window_box(parent_zw, grow: float, min_frac: float):
    """The scoring window: the parent box grown by ``grow``, each side at
    least ``min_frac`` of the image, centred on the parent."""
    xt, yt, xs, ys = parent_zw.unbind(-1)
    ws = torch.clamp(xs * grow, min=min_frac)
    hs = torch.clamp(ys * grow, min=min_frac)
    return torch.stack([xt, yt, ws, hs], dim=-1)


def _to_window_frame(boxes_zw, window_zw):
    """Image-normalized boxes in the window's own normalized frame."""
    wx, wy, ws, hs = window_zw.unbind(-1)
    x0, y0 = wx - ws / 2, wy - hs / 2
    return torch.stack([(boxes_zw[..., 0] - x0) / ws,
                        (boxes_zw[..., 1] - y0) / hs,
                        boxes_zw[..., 2] / ws,
                        boxes_zw[..., 3] / hs], dim=-1)


def _composite_window(cfg, color, alpha, boxes_win, window_hw):
    """Reference-blend composite of K objects a scene onto window canvases:
    color/alpha (S, K, ·, oh, ow), boxes_win (S, K, 4) window-frame ->
    (S, C, wh, ww) in [0, 1]. z_depth = 1, so importance = clamp(alpha,
    0.01) as ``decode_objects`` builds it. Calls of at most ``MAX_SCENES``
    scenes to ``models/render.py::composite_ungated``, forward only."""
    importance = torch.clamp(alpha, min=0.01)
    outs = []
    for s in range(0, color.shape[0], MAX_SCENES):
        part = tuple(t[s:s + MAX_SCENES].contiguous()
                     for t in (color, alpha, importance, boxes_win))
        num, den = composite_ungated(cfg, *part, window_hw,
                                     chunk=color.shape[1], grad=False)
        outs.append(torch.clamp(num / torch.clamp(den, min=1e-6), 0.0, 1.0))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _box_mask_1d(box_win, size: int):
    """Axis masks of a window-frame box: (S, 4) -> (S, size) y and x
    indicators of the window pixels inside the box."""
    j = (torch.arange(size, dtype=torch.float32, device=box_win.device)
         + 0.5) / size
    x0 = box_win[:, 0] - box_win[:, 2] / 2
    x1 = box_win[:, 0] + box_win[:, 2] / 2
    y0 = box_win[:, 1] - box_win[:, 3] / 2
    y1 = box_win[:, 1] + box_win[:, 3] / 2
    my = (j[None] >= y0[:, None]) & (j[None] <= y1[:, None])
    mx = (j[None] >= x0[:, None]) & (j[None] <= x1[:, None])
    return my.to(torch.float32), mx.to(torch.float32)


def _corner_iou(a, b):
    """IoU of corner boxes a (..., 4) and b (..., 4), broadcasting."""
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(
        a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(
        b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def _stable_top_k(scores, m: int):
    """(values, indices) of the ``m`` largest scores of each row, in
    descending order, ties to the lower index as ``jax.lax.top_k`` breaks
    them (``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :m], idx[..., :m]


@torch.no_grad()
def split_gains(params, cfg: SpairConfig, x, boxes, scores, *,
                top_m: int = 12, window_px: int = 32,
                window_grow: float = 1.5, window_min_frac: float = 0.14,
                pres_threshold=0.5) -> Dict[str, torch.Tensor]:
    """Score the split hypothesis of the top-M detections of a batch.

    x (B, C, H, W) images in [0, 1]; boxes (B, N, 4) pixel corner boxes
    and scores (B, N) presence scores, as ``detect`` returns them
    (post-NMS: suppressed boxes score 0). Returns (B, M) tensors, the
    JAX package's keys: ``idx`` (detection index), ``score``, ``rel_gain``
    ((err_parent - err_child) / (err_parent + 1e-6)), ``err_parent``,
    ``err_child`` (best candidate), ``ink`` (image ink inside the parent
    box, in image pixels), ``neighbor_iou`` (the best split's worst child
    IoU with another live detection) and ``best_child`` (B, M, 2, 4) pixel
    corner boxes."""
    b, n = scores.shape
    m = min(top_m, n)
    image_hw = tuple(x.shape[-2:])
    c_img = x.shape[1]

    top_scores, idx = _stable_top_k(scores, m)                # (B, M)
    boxes_m = torch.take_along_dim(boxes, idx[..., None], dim=1)
    parent_zw = corner_to_zwhere(boxes_m, image_hw)           # (B, M, 4)
    # degenerate guard: scoring needs a non-empty window; a 2 px floor, in
    # the JAX package's units (see the module docstring)
    parent_zw = torch.cat([parent_zw[..., :2], torch.clamp(
        parent_zw[..., 2:], min=2.0 / max(image_hw))], dim=-1)

    window_zw = _window_box(parent_zw, window_grow, window_min_frac)
    children_zw = split_candidates(parent_zw)                 # (B,M,C,2,4)

    # one encoder/decoder pass over the parents and every child:
    # (B, M * (1 + 2C), 4)
    all_zw = torch.cat([parent_zw[:, :, None],
                        children_zw.reshape(b, m, -1, 4)],
                       dim=2).reshape(b, -1, 4)
    color, alpha = _encode_decode(params, cfg, x, all_zw)
    oh, ow = cfg.object_shape
    per_det = 1 + 2 * N_CANDIDATES
    color = color.reshape(b * m, per_det, c_img, oh, ow)
    alpha = alpha.reshape(b * m, per_det, 1, oh, ow)

    # window-frame geometry, as (B*M, ...) scenes
    par_win = _to_window_frame(parent_zw, window_zw).reshape(b * m, 1, 4)
    chd_win = _to_window_frame(children_zw, window_zw[:, :, None, None])

    # the scoring target: the image resampled to each window
    target = crop_glimpses(x, window_zw, (window_px, window_px))
    target = target.reshape(b * m, c_img, window_px, window_px)

    wpx = (window_px, window_px)
    recon_p = _composite_window(cfg, color[:, :1], alpha[:, :1], par_win,
                                wpx)
    err_parent = torch.sum((recon_p - target) ** 2, dim=(1, 2, 3))
    # ink inside the parent box, window pixels weighted to image pixels
    pm_y, pm_x = _box_mask_1d(par_win[:, 0], window_px)
    ink = torch.sum(target * pm_y[:, None, :, None] * pm_x[:, None, None, :],
                    dim=(1, 2, 3))
    win_area_px = (window_zw[..., 2] * image_hw[1]
                   * window_zw[..., 3] * image_hw[0]).reshape(b * m)
    ink = ink * win_area_px / float(window_px * window_px)

    # every candidate of every detection in one call: B*M*C scenes of 2
    recon_c = _composite_window(
        cfg, color[:, 1:].reshape(b * m * N_CANDIDATES, 2, c_img, oh, ow),
        alpha[:, 1:].reshape(b * m * N_CANDIDATES, 2, 1, oh, ow),
        chd_win.reshape(b * m * N_CANDIDATES, 2, 4), wpx)
    err_children = torch.sum(
        (recon_c.reshape(b * m, N_CANDIDATES, c_img, window_px, window_px)
         - target[:, None]) ** 2, dim=(2, 3, 4))              # (B*M, C)
    # torch.min/argmin take the first index of a tie, as jnp.argmin does
    err_child, best_k = torch.min(err_children, dim=1)
    rel_gain = (err_parent - err_child) / (err_parent + 1e-6)

    best_child_zw = torch.take_along_dim(
        children_zw.reshape(b * m, N_CANDIDATES, 2, 4),
        best_k[:, None, None, None], dim=1)[:, 0]              # (B*M, 2, 4)
    best_child = zwhere_to_corner(best_child_zw, image_hw).reshape(
        b, m, 2, 4)

    # duplicate guard: the best split's worst overlap with ANOTHER live
    # detection (a second object that is already detected)
    other_live = scores >= pres_threshold                     # (B, N)
    not_self = (torch.arange(n, device=idx.device)[None, None, :]
                != idx[..., None])                            # (B, M, N)
    iou_cn = _corner_iou(best_child[:, :, :, None, :],
                         boxes[:, None, None, :, :])          # (B, M, 2, N)
    masked = torch.where(other_live[:, None, None, :] & not_self[:, :, None],
                         iou_cn, 0.0)
    neighbor_iou = torch.amax(masked, dim=(2, 3))             # (B, M)

    return {
        "idx": idx,
        "score": top_scores,
        "rel_gain": rel_gain.reshape(b, m),
        "err_parent": err_parent.reshape(b, m),
        "err_child": err_child.reshape(b, m),
        "ink": ink.reshape(b, m),
        "neighbor_iou": neighbor_iou,
        "best_child": best_child,
    }


def apply_splits(det: Dict, gains: Dict, margin, pres_threshold,
                 max_neighbor_iou: float = 0.3, ink_min: float = 0.0):
    """Fold the accepted splits into a ``detect``-style output.

    A detection splits when it is live (score >= pres_threshold), its best
    two-object reconstruction beats the one-object one by more than
    ``margin`` (relative), neither child mostly re-covers another live
    detection (neighbor_iou <= max_neighbor_iou) and its parent region
    holds at least ``ink_min`` ink. Child A takes the parent's slot; child
    B lands in one of M extension slots with the parent's score. ``margin``
    and ``pres_threshold`` may be floats or 0-d tensors.

    Returns {boxes (B, N+M, 4), scores (B, N+M), count (B,), n_split
    (B,)}."""
    boxes, scores = det["boxes"], det["scores"]
    b = scores.shape[0]
    accept = ((gains["score"] >= pres_threshold)
              & (gains["rel_gain"] > margin)
              & (gains["neighbor_iou"] <= max_neighbor_iou)
              & (gains["ink"] >= ink_min))                    # (B, M)

    child_a = gains["best_child"][:, :, 0]                    # (B, M, 4)
    child_b = gains["best_child"][:, :, 1]
    idx = gains["idx"]
    upd = torch.where(accept[..., None], child_a,
                      torch.take_along_dim(boxes, idx[..., None], dim=1))
    boxes = boxes.clone()
    boxes[torch.arange(b, device=idx.device)[:, None], idx] = upd
    ext_scores = torch.where(accept, gains["score"], 0.0)
    out_boxes = torch.cat([boxes, child_b], dim=1)
    out_scores = torch.cat([scores, ext_scores], dim=1)
    count = torch.sum(out_scores >= pres_threshold, dim=-1)
    return {"boxes": out_boxes, "scores": out_scores, "count": count,
            "n_split": torch.sum(accept, dim=-1)}


def make_refiner(cfg: SpairConfig, *, top_m: int = 12, window_px: int = 32,
                 window_grow: float = 1.5, window_min_frac: float = 0.14,
                 max_neighbor_iou: float = 0.3, ink_min: float = 0.0,
                 eager: bool = False):
    """refine(params, x, det, margin, pres_threshold) -> det', composing
    with the detector:

        det = make_detector(cfg, nms_iou=...)(params, x)
        det = make_refiner(cfg)(params, x, det, margin, threshold)

    On a CUDA device it is captured, as the JAX package jits it: one CUDA
    graph for each batch size, bound to the parameters of the first call
    (``parallel/captured.py::CapturedForward``), with x, ``det``'s boxes
    and scores, ``margin`` and ``pres_threshold`` as static inputs. The two
    numbers, floats or 0-d tensors (``±inf`` too), become 0-d float32
    tensors on the card, filled before each replay, as the comparisons
    with float32 gains read them either way. The CPU and the NaN hunter
    keep it eager, decided at the first call, as does ``eager``: the A/B of
    the two forms."""
    gains_fn = partial(split_gains, cfg=cfg, top_m=top_m,
                       window_px=window_px, window_grow=window_grow,
                       window_min_frac=window_min_frac)

    @torch.no_grad()
    def program(params, x, boxes, scores, margin, pres_threshold):
        gains = gains_fn(params, x=x, boxes=boxes, scores=scores,
                         pres_threshold=pres_threshold)
        return apply_splits({"boxes": boxes, "scores": scores}, gains,
                            margin, pres_threshold,
                            max_neighbor_iou=max_neighbor_iou,
                            ink_min=ink_min)

    run = None  # chosen at the first call, from the images' device

    def refine(params, x, det, margin, pres_threshold):
        nonlocal run
        if run is None:
            from spair_pytorch_tpu_torch.parallel import captured
            run = program
            if not eager and captured.forward_eager_reason(
                    cfg, x.device) is None:
                run = captured.CapturedForward(program)
        if run is program:
            return program(params, x, det["boxes"], det["scores"], margin,
                           pres_threshold)
        return run(params, x, det["boxes"], det["scores"],
                   _f32_scalar(margin, x.device),
                   _f32_scalar(pres_threshold, x.device))

    return refine


def _f32_scalar(v, device):
    """A float or a 0-d tensor as a 0-d float32 tensor on ``device``: one
    static input of the captured refiner for either."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=device)
