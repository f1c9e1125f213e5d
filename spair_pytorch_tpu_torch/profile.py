"""Profiling CLI: a ``torch.profiler`` trace of training steps
(counterpart of ``spair_pytorch_tpu/profile.py``).

Runs ``--warmup`` steps, then ``--steps`` steps under ``torch.profiler``
(the CPU and, on a card, the device's kernels), and writes the trace as
chrome JSON (``<out>/trace.json``, for Perfetto or chrome://tracing) beside
the per-step times of ``utils/debug.py::Benchmark`` (CUDA events on the
card). Each step's scenes are generated on the device inside its span.
On the card the step is a captured CUDA graph (``parallel/captured.py``):
the first warm-up step captures it, and the profiled steps are replays,
whose trace holds the graph's kernels and no host-side operators.

Usage:
    python -m spair_pytorch_tpu_torch.profile --preset paper128 --steps 5 \\
        --out runs/profile
"""

from __future__ import annotations

import argparse
import os

import torch
from torch.profiler import ProfilerActivity

from spair_pytorch_tpu_torch.config import PRESETS
from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_train_step)
from spair_pytorch_tpu_torch.train import data_config
from spair_pytorch_tpu_torch.utils.debug import Benchmark


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--out", default=os.path.join("runs", "profile"))
    p.add_argument("--mode", default=None,
                   choices=[None, "independent", "raster", "wavefront",
                            "rowscan"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    overrides = {"inference_mode": args.mode} if args.mode else {}
    cfg = PRESETS[args.preset](**overrides)
    state = create_train_state(cfg, device=device)
    step_fn = make_train_step(cfg)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        x = generate_batch(gen, bank, cfg.batch_size, dcfg)[0]
        step_fn(state, x)

    bench = Benchmark(device)
    for _ in range(args.warmup):
        with bench.span("warmup"):
            step()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            with bench.span("train_step"):
                step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(path)

    print(bench.report())
    print(f"trace written to {path} (open in Perfetto or chrome://tracing)")
    return bench, path


if __name__ == "__main__":
    main()
