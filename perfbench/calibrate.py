"""The readings that a cell's limits are set from, on the card.

    python3 -m perfbench.calibrate --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed, in one process: the cell's program through set-up and a
short window at the cell's own load, then the numbers of
``perfbench/judge.py`` against the float32 reference (the program's
readings). For each control seed, also the reference in the program's
place computed one precision below the configuration's (float8 products
for a bfloat16 configuration, TF32 for a float32 one: the control), and
for a training cell the reference with half of each batch left out and the
mean taken over the rest (a fault). A line of JSON a reading, on standard
output and in ``--out``. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from perfbench import run as bench_run


def control_precision(fields) -> str:
    return "fp8" if fields["compute_dtype"] == "bfloat16" else "tf32"


@contextlib.contextmanager
def half_batch_fault():
    """The reference's loss over the first half of each batch: the
    reconstruction sum doubled, the batch means over that half."""
    from perfbench.reference import spair
    plain = spair.loss

    def half(model, cfg, image, noise, step, prec=spair.F32):
        b = image.shape[0] // 2
        total, terms = plain(model, cfg, image[:b],
                             {k: v[:b] for k, v in noise.items()}, step, prec)
        total = total + terms["reconst"]
        return total, dict(terms, total=total)
    spair.loss = half
    try:
        yield
    finally:
        spair.loss = plain


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from perfbench.registry import Registry
    registry = Registry()
    workload = registry.workload(args.workload)
    cfg = registry.config(workload["config"])
    # the readings come from the first steps; the window's warm-up is
    # left out
    traffic = dict(registry.traffic(workload["traffic"]), warmup_calls=2)
    bench_run.set_cache_dirs()

    import torch

    from perfbench import common, device
    from perfbench.judge import leaves
    from perfbench.reference.spair import F32, Precision
    device.require_cards(workload["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    fields = dict(cfg["config"], **traffic.get("overrides", {}))
    driver = registry.driver(traffic["kind"])
    out_file = open(args.out, "a") if args.out else None
    card = device.card_of(0)
    for seed in list(args.seeds) + [s for s in args.control_seeds
                                    if s not in args.seeds]:
        r = common.Run(cell=workload["name"], fields=fields, traffic=traffic,
                       seed=seed, seconds=args.seconds, trace=False,
                       device=cuda, t_process=time.perf_counter())
        out = driver.run(r)
        ref = driver.reference(r, out, F32)
        line = {"cell": r.cell, "seed": seed, "card": card,
                "program": driver.numbers(r, out["program"], ref),
                "leaves": leaves(out["program"], ref),
                "failed": out["failed"], "attempted": out["attempted"]}
        if seed in args.control_seeds:
            prec = Precision(control_precision(fields))
            ctrl = driver.as_program(driver.reference(r, out, prec), out)
            line["control"] = driver.numbers(r, ctrl, ref)
            line["control_precision"] = prec.name
            line["control_leaves"] = leaves(ctrl, ref)
            with half_batch_fault():
                fault = driver.reference(r, out, F32)
            line["fault_half_batch"] = driver.numbers(
                r, driver.as_program(fault, out), ref)
        del out, ref
        common.free(cuda)
        text = json.dumps(line)
        print(text, flush=True)
        if out_file is not None:
            out_file.write(text + "\n")
            out_file.flush()
    if out_file is not None:
        out_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
