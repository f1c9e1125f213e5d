#!/usr/bin/env python3
"""One run of a benchmark cell (``python3 -m perfbench.run``), with the
train step's span recorder on or off, and the recorder read over the
cell's own window.

    python tools/spans_window.py --spans 1 --out runs/spans/a.json \\
        -- --workload train.paper128.b128 --seed 7 --seconds 40 --trace 0

Everything after ``--`` goes to ``perfbench.run`` as it is. With ``--spans
1`` the harness's ``make_train_step`` is built with ``spans=True``; the
recorder is reset when the harness's window opens (its clock sampler starts)
and read once when the window has closed after its final synchronise. The
file ``--out`` holds the run's result line (as ``perfbench.run`` prints
it), the window's host seconds and steps, and with spans on the tiles
(``Spans.summary``), the tiles in 5-s slices of the window
(``Spans.slices``), the time before the window's first mark, the clock
offset and, in a traced run, each ``spair_span_mark`` kernel's mean device
microseconds. With ``--spans 0`` it is the plain run, through the same
code, so the two arms differ by the recorder alone. The tile table and the
slices go to standard error too.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import common  # noqa: E402
from perfbench import run as bench_run  # noqa: E402


def instrument(spans: bool):
    """Patches the harness's step builder, window and profiler for one run;
    returns the dict that the window's readings go into."""
    import spair_pytorch_tpu_torch.parallel as par

    made = []
    real_make = par.make_train_step

    def make(*a, **kw):
        made.append(real_make(*a, spans=spans, **kw))
        return made[-1]
    par.make_train_step = make

    window = {}
    real_clocks = common.Clocks

    class Clocks(real_clocks):
        """The harness's window: reset on entry, read after its final
        synchronise (the sampler stops after it)."""

        def __enter__(self):
            for fn in made:
                if fn.spans is not None:
                    fn.spans.reset()
            window["t0"] = time.perf_counter_ns()
            return super().__enter__()

        def __exit__(self, *exc):
            window["t1"] = time.perf_counter_ns()
            rec = made[-1].spans
            if rec is not None:
                reading = rec.read()
                window["summary"] = rec.summary(reading)
                window["slices"] = rec.slices(window["t0"], 5.0, reading)
                rows = reading.rows()
                if rows:
                    first = min(int(v) for v in rows[0][1] if v)
                    window["before_first_mark_s"] = (
                        first + reading.offset_ns - window["t0"]) / 1e9
                window["offset_ns"] = reading.offset_ns
            return super().__exit__(*exc)
    common.Clocks = Clocks

    real_profiled = common.profiled

    @functools.wraps(real_profiled)
    def profiled(device, fn):
        tr = real_profiled(device, fn)
        marks = [r["end"] - r["start"] for r in tr["records"]
                 if r["name"] == "spair_span_mark" and r["kind"] == "kernel"]
        window["mark_kernels"] = len(marks)
        if marks:
            window["mark_us"] = sum(marks) / len(marks)
        return tr
    common.profiled = profiled
    return window


def report(window, spans: bool, rest, rc, result):
    """The record of one run (module docstring); prints the tile table and
    the slices on standard error."""
    from spair_pytorch_tpu_torch.utils.spans import table

    record = {"spans": int(spans), "argv": rest, "rc": rc, "result": result,
              "window_s": (window["t1"] - window["t0"]) / 1e9
              if "t1" in window else None}
    record.update({k: v for k, v in window.items() if k not in ("t0", "t1")})
    if "summary" in window:
        tiles = sum(t["ms"] for t in window["summary"]["tiles"].values())
        record["tiles_s"] = tiles * window["summary"]["steps"] / 1e3
        print(table(window["summary"]), file=sys.stderr)
        for j, s in enumerate(window["slices"]):
            ms = " ".join(f"{k}={v:.3f}" for k, v in s["ms"].items())
            print(f"# slice {j} ({s['steps']} steps): {ms}", file=sys.stderr)
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spans", type=int, choices=(0, 1), required=True)
    p.add_argument("--out", required=True)
    p.add_argument("rest", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    window = instrument(bool(args.spans))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(rest)
    text = out.getvalue()
    sys.stdout.write(text)
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    record = report(window, bool(args.spans), rest, rc,
                    json.loads(lines[-1]) if lines else None)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
