"""Training diagnostics (counterpart of ``spair_pytorch_tpu/utils/
debug.py``): per-head gradient norms, the NaN hunter, the whole-program NaN
check, scoped timers and the gradient views the figures plot.

``nan_hunter`` checks the tensors named at the forward's three sites (after
inference, after the KL terms, after the render) once
``enable_nan_hunter(True)`` has run. Off, it is one Python bool test: no
device sync, no kernel. On, it syncs once per call and raises naming the
location and the tensors that hold a NaN, after printing every watched
tensor, as the reference's hunter does.

``enable_debug_nans(True)`` is the counterpart of JAX's ``jax_debug_nans``:
it pushes a ``TorchDispatchMode`` that raises FloatingPointError at the
first op, forward or backward, whose floating output holds a NaN (one
device sync per op); ``enable_debug_nans(False)`` pops it. While off it
costs nothing: no mode is on the stack.

``Benchmark`` accumulates named spans: CUDA events on a CUDA device (the
device's time between the span's ends, read when the totals are), the host
clock on the CPU. Each span is also a ``torch.profiler`` range.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


class _NaNCheck(TorchDispatchMode):
    """Raises at the first op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


_DEBUG_NANS = None  # the pushed _NaNCheck, while on


def enable_debug_nans(on: bool = True):
    """Turn the whole-program NaN check on (push the mode) or off (pop
    it); a second call with the same value does nothing."""
    global _DEBUG_NANS
    if on and _DEBUG_NANS is None:
        _DEBUG_NANS = _NaNCheck()
        _DEBUG_NANS.__enter__()
    elif not on and _DEBUG_NANS is not None:
        _DEBUG_NANS.__exit__(None, None, None)
        _DEBUG_NANS = None


def host_checks_on() -> bool:
    """Whether the NaN hunter or the whole-program NaN check is on: both
    read flags on the host, so a step with either on is not captured
    (``parallel/captured.py``)."""
    return _NAN_HUNTING or _DEBUG_NANS is not None


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


def generative_grad_views(params, cfg, x, z_attr, z_where, z_depth, z_pres):
    """Gradients of the reconstruction loss through the generative path,
    the counterpart of the reference's two backward hooks: with respect to
    the decoder's scaled output logits (``decoder_output_grad_hook``) and
    to z_attr (``z_attr_grad_hook``, the render path's share).

    A zero ``logit_tap`` is added at the logits (``models/render.py::
    decode_objects``) and the decode -> composite -> pixel-sum BCE path is
    differentiated with respect to (z_attr, tap). The composite is
    ``models/render.py::composite_ungated``: K1 forward and K2 backward on
    CUDA tensors and their plain pair on CPU tensors; with
    ``render_backend='xla'`` autograd through the plain compositor.

    Inputs are ``forward``'s aux grids in NCHW and x (B, C, H, W). Returns
    (dec_grad (B, N, C+1, oh, ow), attr_grad (B, A, gh, gw))."""
    from spair_pytorch_tpu_torch.models.render import (composite_ungated,
                                                       decode_objects)
    from spair_pytorch_tpu_torch.ops.math import binary_cross_entropy_sum

    b, _, gh, gw = z_attr.shape
    n = gh * gw
    oh, ow = cfg.object_shape
    c = cfg.n_channels
    image_hw = tuple(cfg.image_shape[1:])

    def flat(t):  # NCHW grid -> (B, N, D)
        return t.detach().permute(0, 2, 3, 1).reshape(b, n, t.shape[1])

    attr = flat(z_attr).float().requires_grad_(True)
    tap = torch.zeros((b, n, oh, ow, c + 1), device=attr.device,
                      requires_grad=True)
    boxes = flat(z_where).float().contiguous()
    with torch.enable_grad():
        color, alpha, importance = decode_objects(
            params, cfg, attr, flat(z_pres).float(), flat(z_depth).float(),
            logit_tap=tap)
        num, den = composite_ungated(cfg, color, alpha, importance, boxes,
                                     image_hw)
        recon = torch.clamp(num / den, 0.0, 1.0)
        loss = binary_cross_entropy_sum(recon, x.detach().float())
        g_attr, g_tap = torch.autograd.grad(loss, (attr, tap))
    dec_grad = torch.movedim(g_tap, -1, 2)             # (B, N, C+1, oh, ow)
    attr_grad = g_attr.reshape(b, gh, gw, -1).permute(0, 3, 1, 2)
    return dec_grad, attr_grad
