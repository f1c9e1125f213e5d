"""Evaluation CLI: restore a checkpoint, measure detection metrics
(counterpart of ``spair_pytorch_tpu/eval.py``).

Evaluates a trained checkpoint on freshly generated scenes:
reference-compatible AP and signed count error, the corrected centre-based
AP and exact count accuracy, standard AP pooled at IoU 0.3-0.6, and the
deterministic detector's count accuracy, averaged over --batches batches.
``calibrate`` picks the detector's operating point (presence threshold x
NMS IoU) and stores it as <logdir>/calibration.json, which the server
reads.

Usage, on a machine with a CUDA card:
    python -m spair_pytorch_tpu_torch.eval --logdir runs/paper128 --batches 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from spair_pytorch_tpu_torch import metrics as metric
from spair_pytorch_tpu_torch.config import PRESETS, config_from_json
from spair_pytorch_tpu_torch.models.infer import detect, nms_keep_batch
from spair_pytorch_tpu_torch.models.spair import forward
from spair_pytorch_tpu_torch.parallel.train_step import create_train_state

AP_THRESHOLDS = (0.3, 0.4, 0.5, 0.6)
# calibration grids: presence threshold 0.30 .. 0.90 by 0.05, and greedy
# NMS off or mild (the JAX package's nms_sweep benchmark found NMS below
# 0.5 removes true overlapping neighbours)
CALIB_THRESHOLDS = tuple(round(0.30 + 0.05 * i, 2) for i in range(13))
CALIB_NMS = (None, 0.5, 0.6, 0.7)


def _data(cfg, data, seed, digits, device):
    if data is not None:
        return iter(data)
    from spair_pytorch_tpu_torch.train import make_data
    return iter(make_data(cfg, seed=seed, digits=digits, device=device))


@torch.no_grad()
def evaluate(cfg, state, batches: int = 32, data=None, seed: int = 1234,
             digits: str = "auto", det_threshold=None, det_nms=None):
    """Metrics of ``state`` over ``batches`` batches of ``data`` (an
    iterable of (x, gt_bbox, gt_count) on the state's device; scenes from
    ``seed`` when omitted). The forward draws its noise from a generator
    seeded with ``seed``. Returns (result, aux of the last batch, x of the
    last batch); result has the JAX package's keys."""
    device = state.step.device
    data = _data(cfg, data, seed, digits, device)
    img_size = cfg.image_shape[-1]
    gen = torch.Generator(device=device).manual_seed(seed)
    sums, aux, x = None, None, None
    pooled = {t: [] for t in AP_THRESHOLDS}  # (scores, tp, n_gt) per t
    for _ in range(batches):
        x, gt_bbox, gt_count = next(data)
        _, aux = forward(state.model, cfg, x, state.step, gen)
        for t in AP_THRESHOLDS:
            pooled[t].append(metric.match_predictions(
                aux["z_where"], aux["z_pres"], gt_bbox, gt_count, img_size,
                iou_threshold=t))
        det = detect(state.model, x, cfg)
        gt = gt_count[:, 0]
        m = {
            "bbox_average_precision": metric.mAP(
                aux["z_where"], aux["z_pres"], gt_bbox, gt_count, img_size),
            "bbox_ap_center": metric.mAP_center(
                aux["z_where"], aux["z_pres"], gt_bbox, gt_count, img_size),
            "object_count_error": metric.object_count_error(
                aux["z_pres"], gt_count),
            "count_exact_accuracy": metric.count_accuracy(
                aux["z_pres"], gt_count),
            "det_count_acc_50": torch.mean(
                (det["count"] == gt).to(torch.float32)),
            "det_count_acc_70": torch.mean(
                (torch.sum(det["scores"] >= 0.7, dim=-1) == gt)
                .to(torch.float32)),
        }
        if det_threshold is not None:
            # the calibrated operating point, measured on other scenes than
            # the calibration's (the seeds differ)
            scores = det["scores"]
            if det_nms is not None:
                scores = scores * nms_keep_batch(det["boxes"], scores,
                                                 det_nms)
            m["det_count_acc_cal"] = torch.mean(
                (torch.sum(scores >= det_threshold, dim=-1) == gt)
                .to(torch.float32))
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    keys = list(sums)
    host = torch.stack([sums[k] for k in keys]).cpu()
    result = {k: float(v) / batches for k, v in zip(keys, host)}
    for t in AP_THRESHOLDS:
        parts = [torch.cat([p[i].reshape(-1).cpu() for p in pooled[t]])
                 for i in range(3)]
        result[f"ap_at_{int(t * 100)}"] = metric.average_precision(
            *(p.numpy() for p in parts))
    result["step"] = int(state.step)
    return result, aux, x


@torch.no_grad()
def calibrate(cfg, state, batches: int = 8, data=None, seed: int = 4321,
              digits: str = "auto", thresholds=CALIB_THRESHOLDS,
              nms_grid=CALIB_NMS, target: str = "count"):
    """Pick the detector's operating point (presence threshold x NMS IoU)
    on held-out scenes, as the JAX package's ``calibrate`` does.

    target='count' maximizes exact count accuracy jointly over the grid;
    target='ap50' picks the NMS setting by pooled AP@0.5 and then the
    threshold by count accuracy within that NMS row. Ties prefer no NMS
    and the threshold closest to 0.5. Uses its own seed, disjoint from
    ``evaluate``'s."""
    device = state.step.device
    data = _data(cfg, data, seed, digits, device)
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=device)
    hits = {g: np.zeros(len(thresholds)) for g in nms_grid}
    pooled = {g: [] for g in nms_grid}  # (scores, tp, n_gt) per batch
    scenes = 0
    for _ in range(batches):
        x, gt_bbox, gt_count = next(data)
        for g in nms_grid:
            det = detect(state.model, x, cfg, nms_iou=g)
            counts = torch.sum(det["scores"][:, None, :] >= th[None, :, None],
                               dim=-1)                             # (B, T)
            hits[g] += torch.sum((counts == gt_count[:, :1]).to(
                torch.float32), dim=0).cpu().numpy()
            pooled[g].append([t.reshape(-1).cpu().numpy() for t in
                              metric.match_boxes(det["boxes"], det["scores"],
                                                 gt_bbox, gt_count, 0.5)])
        scenes += x.shape[0]

    ap50 = {g: metric.average_precision(
        *(np.concatenate([p[i] for p in pooled[g]]) for i in range(3)))
        for g in nms_grid}
    if target == "ap50":
        best_g = max(nms_grid, key=lambda g: ap50[g])
        grid_for_threshold = (best_g,)
    elif target == "count":
        grid_for_threshold = nms_grid
    else:
        raise ValueError(f"unknown calibration target {target!r}")

    table = {}
    best = (-1.0, None, 0.5)  # (acc, nms, threshold)
    for g in nms_grid:  # None first: ties prefer the simpler serving graph
        acc = hits[g] / scenes
        key = "none" if g is None else f"{g:.1f}"
        table[key] = {f"{t:.2f}": float(a) for t, a in zip(thresholds, acc)}
        if g not in grid_for_threshold:
            continue
        order = np.lexsort((np.abs(np.asarray(thresholds) - 0.5), -acc))
        if acc[order[0]] > best[0]:
            best = (float(acc[order[0]]), g, thresholds[order[0]])
    return {
        "pres_threshold": float(best[2]),
        "nms_iou": best[1],
        "target": target,
        "count_accuracy": table,
        "ap_at_50": {("none" if g is None else f"{g:.1f}"): float(ap50[g])
                     for g in nms_grid},
        "scenes": scenes,
        "seed": seed,
        "step": int(state.step),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logdir", required=True)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--mode", default=None,
                   choices=[None, "independent", "raster", "wavefront",
                            "rowscan"],
                   help="override inference mode (match how it was trained)")
    p.add_argument("--batches", type=int, default=32,
                   help="batches to pool for dataset-level AP@0.5")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--figure", default=None,
                   help="write a renderer-analysis PNG here")
    p.add_argument("--digits", default="auto",
                   choices=["auto", "mnist", "sklearn", "font"],
                   help="digit patch source for the eval scenes (match "
                        "what training used)")
    p.add_argument("--calibrate", action="store_true",
                   help="sweep the detector presence threshold on held-out "
                        "scenes and store the best one in "
                        "<logdir>/calibration.json; serve.py then uses it")
    p.add_argument("--calib-batches", type=int, default=8,
                   help="batches for the calibration sweep")
    p.add_argument("--calib-target", default="count",
                   choices=["count", "ap50"],
                   help="calibration objective: exact count accuracy "
                        "(joint threshold x NMS) or pooled AP@0.5")
    args = p.parse_args(argv)
    if args.figure:
        raise NotImplementedError(
            "--figure needs utils/viz.py, which is not ported yet "
            "(ROADMAP queue 1, 'The rest': utils/viz.py)")

    from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager

    overrides = {"inference_mode": args.mode} if args.mode else {}
    saved = os.path.join(args.logdir, "config.json")
    if os.path.exists(saved):
        # the run's own config, so the forward matches how it was trained
        with open(saved) as f:
            cfg = config_from_json(f.read())
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    else:
        cfg = PRESETS[args.preset](**overrides)
    state = CheckpointManager(os.path.join(args.logdir, "checkpoints")
                              ).restore(create_train_state(cfg),
                                        step=args.step)
    if state is None:
        raise SystemExit(f"no checkpoint under {args.logdir}")

    cal_path = os.path.join(args.logdir, "calibration.json")
    cal = None
    if args.calibrate:
        cal = calibrate(cfg, state, batches=args.calib_batches,
                        digits=args.digits, target=args.calib_target)
        with open(cal_path, "w") as f:
            json.dump(cal, f, indent=2)
        print(f"calibrated pres_threshold = {cal['pres_threshold']}, "
              f"nms_iou = {cal['nms_iou']} ({cal['scenes']} scenes) -> "
              f"wrote {cal_path}")
    elif os.path.exists(cal_path):
        with open(cal_path) as f:
            cal = json.load(f)

    result, _, _ = evaluate(
        cfg, state, batches=args.batches, digits=args.digits,
        det_threshold=cal["pres_threshold"] if cal else None,
        det_nms=cal.get("nms_iou") if cal else None)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
