#!/usr/bin/env python3
"""The top-K compositor's end-to-end effect on the benchmark's step: the
port's benchmark entry point (``python -m spair_pytorch_tpu_torch.bench``)
run in one process with each ``--topk`` value given, in that order, with
the same other flags (by default ``--check --render-mode ordered`` after
the bench's default 2500 steps of pretraining), each run's JSON line
printed with the branches its steps took: how many of its steps
(pretraining and timed) composited the K objects of highest presence
('topk') and how many the full grid ('full'), and the branch of each step
of its last call (1 for top-K), the last timed one.

    python tools/topk_ab.py                       # --topk 32, then --topk 0
    python tools/topk_ab.py --topk 32 0 32 -- --check --render-mode ordered

``--topk 0`` turns top-K off: the step has no branch and no counts.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spair_pytorch_tpu_torch import bench  # noqa: E402


def run(topk: int, flags):
    """One bench run with ``--topk topk``: (its JSON line, the branch
    counts of each step function it made, in order)."""
    made, real = [], bench.make_train_step

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    bench.make_train_step = keep
    try:
        line = bench.main([*flags, "--topk", str(topk)])
    finally:
        bench.make_train_step = real
    return line, [None if fn.branches is None else dict(
        fn.branches.counts, last_call=[int(t) for t in fn.branches.last])
        for fn in made]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--topk", type=int, nargs="+", default=[32, 0])
    p.add_argument("flags", nargs="*", default=["--check", "--render-mode",
                                                "ordered"],
                   help="the bench's other flags, after --")
    args = p.parse_args(argv)
    for topk in args.topk:
        line, branches = run(topk, args.flags)
        # the first step function trains and is timed; the second counts
        # the step's FLOPs (one eager step)
        print(json.dumps({"topk": topk, "branches": branches,
                          "bench": line}), flush=True)


if __name__ == "__main__":
    main()
