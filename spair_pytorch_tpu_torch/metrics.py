"""The detection metrics the training step logs (counterpart of the first
four functions of ``spair_pytorch_tpu/metrics.py``).

The reference's math is kept with its quirks: ``mAP`` treats z_where's
(xt, yt) as a top-left corner although the renderer treats it as the box
centre, soft-thresholds each ground-truth box's best IoU over 0.1..0.9, and
does not mask predictions by z_pres; ``object_count_error`` is the
reference's signed mean count error (truth - predicted). ``mAP_center`` and
``count_accuracy`` are the corrected forms. All are tensor code with no host
sync.
"""

from __future__ import annotations

import torch


def _flatten_grid(t):
    """(B, D, gh, gw) -> (B, gh*gw, D)."""
    b, d = t.shape[:2]
    return t.permute(0, 2, 3, 1).reshape(b, -1, d)


def _corners(xy, wh):
    return torch.cat([xy, xy + wh], dim=-1)


def _intersect(box_a, box_b):
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
    inter = _intersect(pred, gt)
    area_a, area_b = _areas(pred, gt)
    ious = inter / (area_a + area_b - inter)
    return _soft_ap(torch.amax(ious, dim=1), gt_count)


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
    inter = _intersect(pred, gt)
    area_a, area_b = _areas(pred, gt)
    iou = inter / torch.clamp(area_a + area_b - inter, min=1e-9)
    return _soft_ap(torch.amax(iou, dim=1), gt_count)


def _pred_count(z_pres):
    return torch.sum(torch.round(_flatten_grid(z_pres)), dim=1)


def object_count_error(z_pres, gt_count):
    """The reference's 'object_count_accuracy': the signed mean of
    truth - sum(round(z_pres))."""
    return torch.mean(gt_count - _pred_count(z_pres))


def count_accuracy(z_pres, gt_count):
    """Fraction of images whose rounded object count is exactly right."""
    return torch.mean((_pred_count(z_pres) == gt_count).to(torch.float32))
