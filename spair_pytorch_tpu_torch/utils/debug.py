"""Training diagnostics (counterpart of ``spair_pytorch_tpu/utils/
debug.py``): per-head gradient norms, the NaN hunter and scoped timers.

``nan_hunter`` checks the tensors named at the forward's three sites (after
inference, after the KL terms, after the render) once
``enable_nan_hunter(True)`` has run. Off, it is one Python bool test: no
device sync, no kernel. On, it syncs once per call and raises naming the
location and the tensors that hold a NaN, after printing every watched
tensor, as the reference's hunter does.

``Benchmark`` accumulates named spans: CUDA events on a CUDA device (the
device's time between the span's ends, read when the totals are), the host
clock on the CPU. Each span is also a ``torch.profiler`` range.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

# the JAX package's top-level parameter groups, by the port's module names
HEAD_NAMES = {
    "backbone": "backbone",
    "box_network": "box_net",
    "object_encoder": "object_encoder",
    "z_network": "z_net",
    "obj_network": "obj_net",
    "object_decoder": "object_decoder",
    "virtual_edge_element": "edge",
    "self_attn": "self_attn",
}

_NAN_HUNTING = False


def enable_nan_hunter(on: bool = True):
    global _NAN_HUNTING
    _NAN_HUNTING = on


def nan_hunter(location: str, **tensors):
    """If the hunter is on and any watched tensor holds a NaN, print every
    watched tensor and raise FloatingPointError naming ``location`` and
    the tensors at fault."""
    if not _NAN_HUNTING:
        return
    names = list(tensors)
    flags = torch.stack([torch.isnan(t).any() for t in tensors.values()])
    bad = [n for n, f in zip(names, flags.cpu().tolist()) if f]
    if bad:
        print(f"============== NaN HUNTER ({location}) ==============")
        for n, t in tensors.items():
            print(f"  {n}: {t!r}")
        raise FloatingPointError(f"NaN detected at {location} in {bad}")


class Benchmark:
    """Named spans timed on ``device``: CUDA events on a CUDA device, the
    host clock on the CPU."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self._spans: Dict[str, List] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(name):
            start = self._mark()
            yield
            end = self._mark()
        self._spans.setdefault(name, []).append((start, end))

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def times(self, name: str) -> List[float]:
        """Seconds of each span named ``name``, in order."""
        if not self.cuda:
            return [end - start for start, end in self._spans[name]]
        out = []
        for start, end in self._spans[name]:
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        return out

    @property
    def counts(self) -> Dict[str, int]:
        return {name: len(s) for name, s in self._spans.items()}

    @property
    def totals(self) -> Dict[str, float]:
        return {name: sum(self.times(name)) for name in self._spans}

    def report(self) -> str:
        lines = []
        counts = self.counts
        for name, total in sorted(self.totals.items()):
            n = counts[name]
            lines.append(f"{name}: total {total:.4f}s over {n} "
                         f"(avg {total / n * 1e3:.2f} ms)")
        return "\n".join(lines)


def grad_norms_by_head(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{'grad_norm/<head>': global norm of that group's gradients}, keyed
    by the JAX package's group names so the logged tags match. Parameters
    without a gradient count as zero. Stays on the device."""
    sq = {}
    for name, p in model.named_parameters():
        head = HEAD_NAMES[name.split(".")[0]]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        sq[head] = sq.get(head, 0.0) + torch.sum(torch.square(g.float()))
    return {f"grad_norm/{head}": torch.sqrt(v) for head, v in sq.items()}
