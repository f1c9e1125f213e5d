"""Detection metrics (counterpart of ``spair_pytorch_tpu/metrics.py``): the
four the training step logs, and the standard AP that evaluation pools.

The reference's math is kept with its quirks: ``mAP`` treats z_where's
(xt, yt) as a top-left corner although the renderer treats it as the box
centre, soft-thresholds each ground-truth box's best IoU over 0.1..0.9, and
does not mask predictions by z_pres; ``object_count_error`` is the
reference's signed mean count error (truth - predicted). ``mAP_center`` and
``count_accuracy`` are the corrected forms; all four are tensor code with no
host sync. ``match_predictions`` / ``match_boxes`` do the Pascal-VOC/COCO
greedy matching on the device, and ``average_precision`` integrates the
pooled matches on the host, with numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten_grid(t):
    """(B, D, gh, gw) -> (B, gh*gw, D)."""
    b, d = t.shape[:2]
    return t.permute(0, 2, 3, 1).reshape(b, -1, d)


def _corners(xy, wh):
    return torch.cat([xy, xy + wh], dim=-1)


def intersect(box_a, box_b):
    """Pairwise intersection areas of corner boxes: (B, A, 4), (B, M, 4)
    -> (B, A, M)."""
    max_xy = torch.minimum(box_a[:, :, None, 2:], box_b[:, None, :, 2:])
    min_xy = torch.maximum(box_a[:, :, None, :2], box_b[:, None, :, :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    return wh[..., 0] * wh[..., 1]


def _areas(box_a, box_b):
    area_a = ((box_a[..., 2] - box_a[..., 0])
              * (box_a[..., 3] - box_a[..., 1]))[:, :, None]
    area_b = ((box_b[..., 2] - box_b[..., 0])
              * (box_b[..., 3] - box_b[..., 1]))[:, None, :]
    return area_a, area_b


def batch_jaccard(box_a, box_b):
    """Pairwise IoU of corner boxes, unguarded as in the reference."""
    inter = intersect(box_a, box_b)
    area_a, area_b = _areas(box_a, box_b)
    return inter / (area_a + area_b - inter)


def _soft_ap(best_iou, gt_count):
    """Soft-thresholded AP over 0.1:0.1:0.9, normalized by the GT count.
    best_iou (B, M), gt_count (B, 1)."""
    thresholds = torch.arange(1, 10, dtype=torch.float32,
                              device=best_iou.device) / 10.0
    scaled = torch.clamp((best_iou[..., None] - thresholds)
                         / (1.0 - thresholds), 0.0, 1.0)
    ap = torch.mean(scaled, dim=-1)
    return torch.mean(torch.sum(ap, dim=-1, keepdim=True) / gt_count)


def mAP(z_where, z_pres, gt_bbox, gt_count, image_size: int):
    """Reference-compatible AP. z_where (B, 4, gh, gw) normalized
    [xt, yt, xs, ys]; gt_bbox (B, M, 4) pixel [x, y, w, h]; gt_count
    (B, 1). (xt, yt) is taken as the top-left corner (the reference's
    quirk), and z_pres is unused, as in the reference."""
    del z_pres
    pred = _flatten_grid(z_where) * image_size
    pred = _corners(pred[..., :2], pred[..., 2:])
    gt = _corners(gt_bbox[..., :2], gt_bbox[..., 2:])
    return _soft_ap(torch.amax(batch_jaccard(pred, gt), dim=1), gt_count)


def mAP_center(z_where, z_pres, gt_bbox, gt_count, image_size: int,
               pres_threshold: float = 0.5):
    """Corrected AP: (xt, yt) is the box centre and predictions are gated
    by z_pres >= pres_threshold; the IoU's union is floored at 1e-9 for the
    zero-area boxes that masking and GT padding leave."""
    pred = _flatten_grid(z_where) * image_size
    half = pred[..., 2:] / 2.0
    pred = torch.cat([pred[..., :2] - half, pred[..., :2] + half], dim=-1)
    pres = _flatten_grid(z_pres)[..., 0]
    pred = pred * (pres >= pres_threshold)[..., None]
    gt = _corners(gt_bbox[..., :2], gt_bbox[..., 2:])
    return _soft_ap(torch.amax(_safe_iou(pred, gt), dim=1), gt_count)


def _safe_iou(pred, gt):
    """IoU with the union floored at 1e-9, for zero-area boxes."""
    inter = intersect(pred, gt)
    area_a, area_b = _areas(pred, gt)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def _pred_count(z_pres):
    return torch.sum(torch.round(_flatten_grid(z_pres)), dim=1)


def object_count_error(z_pres, gt_count):
    """The reference's 'object_count_accuracy': the signed mean of
    truth - sum(round(z_pres))."""
    return torch.mean(gt_count - _pred_count(z_pres))


def count_accuracy(z_pres, gt_count):
    """Fraction of images whose rounded object count is exactly right."""
    return torch.mean((_pred_count(z_pres) == gt_count).to(torch.float32))


def match_predictions(z_where, z_pres, gt_bbox, gt_count, image_size: int,
                      iou_threshold: float = 0.5):
    """Greedy score-ordered prediction/GT matching for standard AP: the
    Pascal-VOC/COCO rule, predictions sorted by z_pres, each matched to the
    highest-IoU unmatched GT, a true positive at IoU >= threshold. Boxes
    take the renderer's centre semantics. Returns (scores (B, N), tp (B, N)
    float 0/1, n_gt (B,)), to pool across a set for
    ``average_precision``."""
    pred = _flatten_grid(z_where) * image_size
    half = pred[..., 2:] / 2.0
    pred = torch.cat([pred[..., :2] - half, pred[..., :2] + half], dim=-1)
    scores = _flatten_grid(z_pres)[..., 0]
    return match_boxes(pred, scores, gt_bbox, gt_count, iou_threshold)


def match_boxes(pred, scores, gt_bbox, gt_count, iou_threshold: float = 0.5):
    """``match_predictions`` for detector outputs: pixel corner boxes
    (B, N, 4) [x0, y0, x1, y1] and scores (B, N). Boxes with score 0 (NMS
    suppressed) are left out of the matching: they neither score a true
    positive nor claim a GT. Predictions are visited in score order, all
    images at once; ties in IoU go to the first GT, as ``argmax`` takes
    them."""
    gt = _corners(gt_bbox[..., :2], gt_bbox[..., 2:])
    b, n = scores.shape
    m = gt.shape[1]
    gt_valid = (torch.arange(m, device=scores.device)[None]
                < gt_count).to(torch.float32)                     # (B, M)
    pred_valid = (scores > 0.0).to(torch.float32)                 # (B, N)
    ious = _safe_iou(pred, gt)                                    # (B, N, M)
    order = torch.argsort(-scores, dim=1, stable=True)            # (B, N)
    rows = torch.arange(b, device=scores.device)
    matched = torch.zeros((b, m), device=scores.device)
    tp_ordered = []
    for i in range(n):
        idx = order[:, i]
        cand = (ious[rows, idx] * gt_valid * (1.0 - matched)
                * pred_valid[rows, idx][:, None])
        j = torch.argmax(cand, dim=1)
        hit = (cand[rows, j] >= iou_threshold).to(torch.float32)
        matched[rows, j] = torch.maximum(matched[rows, j], hit)
        tp_ordered.append(hit)
    tp = torch.empty((b, n), device=scores.device)
    tp.scatter_(1, order, torch.stack(tp_ordered, dim=1))
    return scores, tp, torch.sum(gt_valid, dim=1)


def average_precision(scores, tp, n_gt) -> float:
    """Dataset-level AP from pooled ``match_predictions`` outputs (numpy
    arrays or host tensors): all predictions sorted by score, the
    precision/recall curve, all-point interpolation (Pascal VOC 2010+).
    Suppressed predictions (score 0) are dropped."""
    scores = np.asarray(scores).reshape(-1)
    tp = np.asarray(tp).reshape(-1)
    total_gt = float(np.sum(np.asarray(n_gt)))
    if total_gt == 0:
        return 0.0
    live = scores > 0.0
    scores, tp = scores[live], tp[live]
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # envelope: precision at recall r = max precision at recall >= r
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    recall = np.concatenate([[0.0], recall])
    return float(np.sum((recall[1:] - recall[:-1]) * precision))
