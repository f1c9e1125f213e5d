"""Quickstart: train a small SPAIR and draw its detections (the port's
counterpart of the JAX package's ``examples/quickstart.py``).

Trains ``small_config`` for ``--steps`` steps, evaluates it on four batches
of fresh scenes and writes the renderer-analysis panel of the last one to
``<out>/analysis.png`` (needs matplotlib). Runs on the card by default;
``--device cpu`` takes a few minutes.

    python -m spair_pytorch_tpu_torch.examples.quickstart --steps 300 \\
        --out runs/spair_demo
"""

import argparse
import os

from spair_pytorch_tpu_torch.config import small_config
from spair_pytorch_tpu_torch.eval import evaluate
from spair_pytorch_tpu_torch.train import make_data, train
from spair_pytorch_tpu_torch.utils.viz import render_analysis_figure


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default="runs/spair_demo")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = small_config(batch_size=16, learning_rate=3e-4)
    state = train(cfg, steps=args.steps, logdir=args.out,
                  checkpoint_every=0, metrics_every=0, device=args.device)

    result, aux, x = evaluate(cfg, state, batches=4,
                              data=make_data(cfg, seed=99,
                                             device=args.device))
    print("metrics:", {k: round(v, 4) for k, v in result.items()})

    fig = render_analysis_figure(*(t.cpu().numpy() for t in (
        x, aux["recon"], aux["z_where"], aux["z_pres"], aux["z_depth"])))
    path = os.path.join(args.out, "analysis.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)
    return result


if __name__ == "__main__":
    main()
