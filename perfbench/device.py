"""The card: the check for enough of them, clock and power samples beside
a window, and the reduction of a profiler trace to device time.

A trace is reduced from plain records, {'name', 'kind', 'start', 'end'}
in microseconds, with ``kind`` 'kernel', 'memcpy' or 'memset' for the
device's own work and 'cpu' or 'annotation' for the host's, so the
arithmetic is tested on synthetic records. Device-side user annotations
(the optimizer's range, for one) repeat the time of the kernels under them
and are left out, the rule ``chip_smoke.py`` settled on.
"""

from __future__ import annotations

import bisect
import subprocess
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_KINDS = ("kernel", "memcpy", "memset")


def require_cards(n: int):
    """Raises SystemExit unless torch sees ``n`` CUDA cards or more."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA card is visible")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"perfbench: this cell needs {n} cards, "
                         f"{torch.cuda.device_count()} are visible")


def card_of(index: int = 0) -> Tuple[str, str]:
    """(name, power limit) as nvidia-smi gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = (s.strip() for s in res.stdout.strip().split(",", 1))
    return name, limit


class ClockSampler:
    """nvidia-smi's SM and memory clocks, power draw, power limit and
    temperature, sampled every ``period_ms`` while the window runs."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu")

    def __init__(self, index: int = 0, period_ms: int = 500):
        self.cmd = ["nvidia-smi", "--query-gpu=" + ",".join(self.FIELDS),
                    "--format=csv,noheader,nounits", "-lms", str(period_ms),
                    "-i", str(index)]
        self.proc = None
        self.samples: List[Dict[str, float]] = []

    def __enter__(self):
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = parse_samples(out, self.FIELDS)

    def summary(self) -> Dict[str, float]:
        """Mean, least and most of each field over the samples."""
        out = {"samples": len(self.samples)}
        for f in self.FIELDS:
            vals = [s[f] for s in self.samples if f in s]
            if vals:
                out[f + ".mean"] = sum(vals) / len(vals)
                out[f + ".min"] = min(vals)
                out[f + ".max"] = max(vals)
        return out


def parse_samples(text: str, fields: Sequence[str]):
    samples = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != len(fields):
            continue
        sample = {}
        for f, p in zip(fields, parts):
            try:
                sample[f] = float(p)
            except ValueError:
                pass
        if sample:
            samples.append(sample)
    return samples


def profiler_records(prof) -> List[Dict]:
    """The records of a ``torch.profiler.profile``: every event, the
    device's own (kernels, copies, fills) and the host's, user annotations
    marked; device-side annotations dropped."""
    from torch.autograd import DeviceType
    records = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation:
                continue
            if e.name.startswith("Memcpy"):
                kind = "memcpy"
            elif e.name.startswith("Memset"):
                kind = "memset"
            else:
                kind = "kernel"
        else:
            kind = "annotation" if e.is_user_annotation else "cpu"
        records.append({"name": e.name, "kind": kind, "start": start,
                        "end": end})
    return records


def window_of(records: Iterable[Dict], name: str) -> Tuple[float, float]:
    """The span of the host annotation ``name`` (its first to its last)."""
    spans = [(r["start"], r["end"]) for r in records
             if r["kind"] == "annotation" and r["name"] == name]
    if not spans:
        raise ValueError(f"no annotation {name!r} in the trace")
    return min(s for s, _ in spans), max(e for _, e in spans)


def device_intervals(records: Iterable[Dict], t0: float, t1: float):
    """The device's busy intervals inside [t0, t1], merged and sorted."""
    spans = sorted((max(r["start"], t0), min(r["end"], t1))
                   for r in records if r["kind"] in DEVICE_KINDS
                   and r["end"] > t0 and r["start"] < t1)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(records, t0: float, t1: float) -> float:
    """Microseconds inside [t0, t1] in which the device ran something."""
    return sum(e - s for s, e in device_intervals(records, t0, t1))


def count_kernels(records, t0: float, t1: float) -> int:
    """Kernels started inside [t0, t1]."""
    return sum(1 for r in records if r["kind"] == "kernel"
               and t0 <= r["start"] < t1)


def kernel_time_us(records, match: str, t0: float, t1: float):
    """(launches, summed microseconds) of kernels whose name holds
    ``match``, started inside [t0, t1]."""
    hits = [r["end"] - r["start"] for r in records if r["kind"] == "kernel"
            and match in r["name"] and t0 <= r["start"] < t1]
    return len(hits), sum(hits)


def top_device_ops(records, t0: float, t1: float, n: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    by_name: Dict[str, float] = defaultdict(float)
    for r in records:
        if r["kind"] in DEVICE_KINDS and t0 <= r["start"] < t1:
            by_name[r["name"]] += r["end"] - r["start"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in top]


def idle_gaps(records, t0: float, t1: float, n: int = 10,
              longest: int = 500):
    """[[what the host was doing, seconds]]: the device's idle gaps inside
    [t0, t1] summed by the innermost host event at each gap's middle
    ('host idle' where none), over the ``longest`` gaps; the ``n``
    largest sums."""
    merged = device_intervals(records, t0, t1)
    edges = [t0] + [x for se in merged for x in se] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    host = sorted((r["start"], r["end"], r["name"]) for r in records
                  if r["kind"] in ("cpu", "annotation"))
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        label = "host idle"
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        for j in range(i, max(-1, i - 2000), -1):
            if host[j][1] >= mid:
                best = host[j]
                break
        if best is not None:
            label = best[2]
        by_label[label] += e - s
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
    return [[label, us / 1e6] for label, us in top]
