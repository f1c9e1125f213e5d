"""Batched-request serving harness for the SPAIR detector (counterpart of
``spair_pytorch_tpu/serve.py``).

Requests of any size are packed into fixed-size batches (buckets), run
through ``models.infer.make_detector``'s detector, thresholded and unpadded
per request. On a CUDA device the server keeps one captured CUDA graph per
bucket, as the JAX package keeps one compiled program per bucket: ``warmup``
captures every bucket, the buckets' graphs share one memory pool, and each
chunk of a request is copied into its bucket's static input and replayed:

    server = DetectorServer(cfg, params, batch_sizes=(1, 8, 32))
    dets = server.detect(images)        # (N, C, H, W) any N
    dets[i]["boxes"]   # (k_i, 4) pixel [x0, y0, x1, y1] above threshold
    dets[i]["scores"]  # (k_i,)
    dets[i]["count"]   # int

CLI (the checkpoint under --logdir, else fresh seeded params; requests
from the font glyph bank; ``--quantize int8`` serves int8 weights and
activations, ``ops/quant.py``):
    python -m spair_pytorch_tpu_torch.serve --requests 64 --batch 32
    python -m spair_pytorch_tpu_torch.serve --logdir runs/paper128
    python -m spair_pytorch_tpu_torch.serve --quantize int8 --batch 32
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spair_pytorch_tpu_torch.config import PRESETS, SpairConfig
from spair_pytorch_tpu_torch.models.infer import make_detector


class DetectorServer:
    """Fixed-bucket batched detector with per-request unpadding. Runs on
    the device that holds ``params``."""

    def __init__(self, cfg: SpairConfig, params,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 pres_threshold: float = 0.5,
                 nms_iou: Optional[float] = None):
        self.cfg = cfg
        self.params = params
        self.threshold = pres_threshold
        self.buckets = tuple(sorted(batch_sizes))
        self.device = next(params.parameters()).device
        self._fn = make_detector(cfg, pres_threshold, nms_iou=nms_iou)

    def warmup(self) -> Dict[int, float]:
        """Run every bucket once so no request pays first-call costs: on a
        CUDA device that call captures the bucket's graph. Returns each
        bucket's seconds on the host clock, to the end of its call."""
        c, h, w = self.cfg.image_shape
        seconds = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            self._fn(self.params, torch.zeros((b, c, h, w),
                                              device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds[b] = time.perf_counter() - t0
        return seconds

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def detect(self, images) -> List[Dict]:
        """images (N, C, H, W) in [0, 1], numpy or tensor -> N per-request
        detection dicts of numpy arrays."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        n = images.shape[0]
        out: List[Dict] = []
        i = 0
        while i < n:
            b = self._bucket(n - i)
            take = min(b, n - i)
            chunk = images[i:i + take]
            if take < b:  # pad the final partial batch
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (b - take,) + tuple(images.shape[1:]))])
            res = self._fn(self.params, chunk)
            boxes = res["boxes"].cpu().numpy()
            scores = res["scores"].cpu().numpy()
            for j in range(take):
                keep = scores[j] >= self.threshold
                out.append({"boxes": boxes[j][keep],
                            "scores": scores[j][keep],
                            "count": int(keep.sum())})
            i += take
        return out


def _load_calibration(logdir: Optional[str]) -> Optional[dict]:
    if not logdir:
        return None
    path = os.path.join(logdir, "calibration.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def resolve_threshold(cli_value: Optional[float], logdir: Optional[str],
                      default: float = 0.5) -> float:
    """Presence threshold: explicit CLI value > <logdir>/calibration.json >
    0.5 (the reference operating point)."""
    if cli_value is not None:
        return cli_value
    cal = _load_calibration(logdir)
    if cal is not None:
        return float(cal["pres_threshold"])
    return default


def resolve_nms(cli_value: Optional[float],
                logdir: Optional[str]) -> Optional[float]:
    """NMS IoU: explicit CLI value (0 disables) > calibration > off."""
    if cli_value is not None:
        return None if cli_value == 0 else cli_value
    cal = _load_calibration(logdir)
    if cal is not None:
        return cal.get("nms_iou")
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--threshold", type=float, default=None,
                   help="presence threshold (default: the calibration in "
                        "--logdir if any, else 0.5)")
    p.add_argument("--nms", type=float, default=None,
                   help="greedy NMS IoU threshold (0 forces off; default: "
                        "the calibration in --logdir if any, else off)")
    p.add_argument("--logdir", default=None,
                   help="run directory to serve: its latest checkpoint "
                        "(default: fresh params) and the operating point "
                        "in its calibration.json")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="post-training int8 quantization of every MLP and "
                        "backbone layer (ops/quant.py): int8 products with "
                        "int32 accumulation")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from spair_pytorch_tpu_torch.data import (DataConfig, generate_batch,
                                              glyph_bank)
    from spair_pytorch_tpu_torch.parallel import create_train_state

    device = torch.device(args.device)
    cfg = PRESETS[args.preset]()
    state = create_train_state(cfg, device=device)
    if args.logdir:
        from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager
        state = CheckpointManager(os.path.join(args.logdir, "checkpoints")
                                  ).restore(state)
        if state is None:
            raise SystemExit(f"no checkpoint under {args.logdir}")
    params = state.model
    if args.quantize == "int8":
        from spair_pytorch_tpu_torch.ops.quant import quantize_params_int8
        params = quantize_params_int8(params)
    threshold = resolve_threshold(args.threshold, args.logdir)
    nms_iou = resolve_nms(args.nms, args.logdir)
    print(f"presence threshold {threshold}, nms {nms_iou}")
    server = DetectorServer(cfg, params, batch_sizes=(args.batch,),
                            pres_threshold=threshold, nms_iou=nms_iou)
    for b, sec in server.warmup().items():
        print(f"bucket {b}: first call (capture on a card) {sec:.3f} s")

    bank = torch.as_tensor(glyph_bank((14, 14)), device=device)
    dcfg = DataConfig(image_hw=cfg.image_shape[1:],
                      max_objects=cfg.max_scene_objects)
    gen = torch.Generator(device=device).manual_seed(0)
    x, _, counts = generate_batch(gen, bank, args.requests, dcfg)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dets = server.detect(x)
    dt = time.perf_counter() - t0
    pred = np.array([d["count"] for d in dets])
    true = counts[:, 0].cpu().numpy()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"served {args.requests} requests in {dt * 1e3:.1f} ms "
          f"({args.requests / dt:.0f} img/s, bucket {args.batch}, "
          f"{args.quantize or 'float'} weights, {name})")
    print(f"count accuracy vs generator labels: "
          f"{float((pred == true).mean()):.3f}")
    return dets


if __name__ == "__main__":
    main()
