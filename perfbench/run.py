"""Runs one cell of ``BENCHMARK.json`` once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads and warms up the cell's program, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error.

It exits with a code other than 0, and prints no result, where no CUDA card
(or fewer than the cell asks for) is visible, and where the process has
loaded jax, jaxlib, flax or the JAX package by the time the window has
closed. Builds and kernel caches go to fixed directories inside the
checkout (``perfbench/.cache/``).
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = T_IMPORT - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spair_pytorch_tpu")
CACHE = Path(__file__).resolve().parent / ".cache"


def set_cache_dirs():
    """The program's nvcc builds and any Triton or CUDA kernel cache, in
    fixed directories of the checkout."""
    os.environ["SPAIR_COMPILE_CACHE"] = str(CACHE / "nvcc")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def forbidden_modules():
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (whole names: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(registry, r, limits):
    """Runs the cell and judges it: the result object, without ``device``'s
    card fields, and the rows (name, number, limit) compared."""
    from perfbench.judge import verdict
    from perfbench.reference.spair import F32
    driver = registry.driver(r.traffic["kind"])
    out = driver.run(r)
    ref = driver.reference(r, out, F32)
    numbers = driver.numbers(r, out["program"], ref)
    correct, rows = verdict(numbers, limits)
    correct = correct and out["failed"] == 0
    metrics = {}
    record = out["record"]
    if not r.trace:
        for m in registry.end_to_end(r.cell):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in registry.per_layer(r.cell):
            value = registry.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    if r.trace:
        from perfbench import device as dev
        tr = record["trace"]
        recs, t0, t1 = tr["records"], tr["t0"], tr["t1"]
        result["device"]["busy_s"] = dev.busy_us(recs, t0, t1) / 1e6
        result["device"]["window_s"] = (t1 - t0) / 1e6
        result["breakdown"] = {"device_ops": dev.top_device_ops(recs, t0, t1),
                               "idle_gaps": dev.idle_gaps(recs, t0, t1)}
    clocks = record.get("clocks")
    if clocks:
        print("# clocks during the window: " + json.dumps(clocks),
              file=sys.stderr)
    return result, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench.registry import Registry
    registry = Registry()
    workload = registry.workload(args.workload)
    cfg = registry.config(workload["config"])
    traffic = registry.traffic(workload["traffic"])
    limits = registry.limits(workload["name"])
    set_cache_dirs()

    import torch

    from perfbench import common, device
    device.require_cards(workload["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    fields = dict(cfg["config"], **traffic.get("overrides", {}))
    r = common.Run(cell=workload["name"], fields=fields, traffic=traffic,
                   seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=cuda, t_process=T_PROCESS)
    common.stage(r, "torch imported, card ready")
    result, rows = execute(registry, r, limits)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    name, limit = device.card_of(0)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(cuda),
                        "count": workload["chips"], **result["device"]}
    print(f"# card: {name}, power limit {limit}", file=sys.stderr)
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
