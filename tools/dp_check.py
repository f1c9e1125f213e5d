#!/usr/bin/env python3
"""Data-parallel training across ranks against one process.

Run once under ``torchrun``: every rank trains the ROADMAP main path
(``--preset`` paper128, wavefront, gate 0.01, global batch ``--batch``)
through
``train(use_mesh=True)`` for ``--steps`` steps, one step a call, and rank 0
writes its final parameters, its logged losses and its ms/step to
``--out``. Then run it with ``--compare``: one process trains the same
steps without a mesh and holds itself against that file: each step's loss
(the ranks' losses summed, as the mesh logs it) and each parameter tensor,
as max |mesh - one| / max |one|, and prints both ms/step (host clock
around train(), set-up included). On the card the one-process run's step
is a captured CUDA graph (``parallel/captured.py``) and the mesh run's is
eager.

TF32 is off. ``--dtype float32`` (the default) makes the comparison tight;
``--dtype bfloat16`` is the main path's compute type.

    torchrun --nproc-per-node 4 tools/dp_check.py --out runs/dp4.pt
    python tools/dp_check.py --compare runs/dp4.pt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spair_pytorch_tpu_torch.config import PRESETS  # noqa: E402
from spair_pytorch_tpu_torch.train import train  # noqa: E402


def run(cfg, steps, use_mesh, device):
    """(state, logged losses, ms/step by the host clock around train(),
    which ends with its metrics on the host)."""
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        state = train(cfg, steps=steps, logdir=logdir, use_mesh=use_mesh,
                      checkpoint_every=0, log_flush_every=steps,
                      digits="font", verbose=False, device=device)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        losses = []
        path = os.path.join(logdir, "metrics.jsonl")
        if os.path.exists(path):  # rank 0 alone logs
            with open(path) as f:
                losses = [r["losses/total"] for r in map(json.loads, f)
                          if "losses/total" in r]
    return state, losses, ms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--out", help="rank 0 writes the mesh run here")
    p.add_argument("--compare", help="a file --out wrote")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PRESETS[args.preset](batch_size=args.batch,
                              inference_mode="wavefront",
                              compute_dtype=args.dtype,
                              pres_gate_threshold=0.01)
    if args.compare is None:
        state, losses, ms = run(cfg, args.steps, True, args.device)
        if int(os.environ.get("RANK", "0")) == 0:
            torch.save({"params": [t.detach().cpu()
                                   for t in state.model.parameters()],
                        "losses": losses, "ms": ms,
                        "world": int(os.environ.get("WORLD_SIZE", "1"))},
                       args.out)
        return 0
    got = torch.load(args.compare)
    state, losses, ms = run(cfg, args.steps, False, args.device)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       losses))
    param_err = max(float((g - w.detach().cpu()).abs().max())
                    / float(w.detach().abs().max())
                    for g, w in zip(got["params"], state.model.parameters()))
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else args.device)
    print(f"{args.steps} steps of {args.preset} ({args.dtype}, global batch "
          f"{args.batch}): world {got['world']} {got['ms']:.3f} ms/step "
          f"({args.batch / got['ms'] * 1e3:.1f} img/s) against one process "
          f"{ms:.3f} ms/step ({args.batch / ms * 1e3:.1f} img/s); losses "
          f"{got['losses'][0]:.3f} -> {got['losses'][-1]:.3f} against "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}, worst step rel diff "
          f"{loss_err:.3e}; worst parameter tensor rel diff {param_err:.3e} "
          f"({name}, host clock around train(), set-up included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
