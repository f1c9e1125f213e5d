"""Span marks and host spans: where a train step's time goes, read from
inside the program. This is the port's one span recorder; ``profile.py``,
``train.py --spans`` and ``make_train_step(..., spans=True)`` read it.

Tiles. A *mark* is a timestamp of a point of the step's work, named by the
*tile* it opens: the stretch of time from that mark to the next one. So the
tiles of one step sum exactly to that step's span (first mark to the next
step's first mark), and the tiles of a window sum to the window less the
time before its first mark. ``TILES`` lists them in step order:

- forward: ``scenes`` (the step's start: scenes, zeroed gradients),
  ``backbone``, ``fronts`` (the wavefront loop or the independent
  ``cell_step``, with the noise draws), ``kl`` (``independent_kl``),
  ``count_prior`` (either form), ``decoder`` (``render_objects``: the
  decoder, the gate and the branch's predicate), ``composite``
  (``composite_objects``: K1 or K3 in reference mode, the ordered scan in
  ordered mode, either branch), ``loss``;
- backward: ``composite.bwd``, ``decoder.bwd``, ``count_prior.bwd``,
  ``kl.bwd``, ``fronts.bwd``, ``backbone.bwd``;
- ``optimizer``: the zero-filled gradients, the gradient norms and metrics,
  clipping, Adam and ``step += 1``;
- gaps: ``gap.replay``, opened by the step's last mark and closed by the
  next step's first (the step's metrics stacked, the copy out of the graph
  and whatever the host does between replays); in a segmented step
  (``parallel/captured.py::SegmentedStep``) ``gap.branch``, from segment
  A's last mark to B's first: the host's read of the predicate and B's
  launch.

On a CUDA device a mark is ``spair_span_mark`` (``csrc/spans.cu``), a
one-thread kernel launched on the current stream, so a capture holds it as
it holds K1/K2 and every replay runs it: it reads ``%globaltimer``. On the
CPU the same bookkeeping runs on the host with ``time.perf_counter_ns``
(``_mark_host``, the kernel's plain version), inside a profiler range named
``spair_span_mark``. Both keep one int64 state buffer:

    [0] the previous mark's time   [1] the tile it opened
    [2] the ring's step            [3] spare
    [4, 4 + T)       nanoseconds accumulated in each tile
    [4 + T, 4 + 2T)  how many times each tile closed
    [4 + 2T, ...)    the ring: RING_STEPS rows of T timestamps, one row a
                     step (the step's last mark, ``LAST``, advances it)

Backward marks come from ``boundary``: an identity ``autograd.Function``
applied to the tensors that cross from one layer into the next. Its
forward returns views and marks the tile its forward opens; its backward
passes the gradients through and marks the tile the backward opens, so a
backward tile starts where the gradients of those tensors are complete.
Autograd runs ready nodes in the reverse order of their creation, which is
the layers' reverse order, but it may run a few kernels of one layer's
backward across a boundary (a loss term computed after the composite, for
one, runs in ``loss``'s tile).

Turned on. The model code marks through the recorder the step activates
(``active``) during its eager step and its captures; a replay runs no
Python for marks. With no recorder active each mark site is one ``is
None`` test, no Function is applied and no mark is launched: the captured
graph and the autograd graph are exactly those of a step without spans.

Clocks. Host spans (``host``) take ``time.perf_counter_ns``, the monotonic
clock the profiler's host events use, and are ``torch.profiler`` ranges
while a profiler runs. Device marks read the card's ``%globaltimer``;
``bind`` measures the offset to the host clock with eager marks written
into pinned host memory that the host polls (``calibrate``), and
``offset_ns`` added to a device timestamp gives the host clock's reading,
so tiles, host spans and a profiler trace lie on one timeline (within
~10 us of the profiler's kernel starts on an H100). ``%globaltimer`` is
not the host's clock: against it, it ran some 10-30 parts per million
fast and stepped back by ~0.55 ms about every 20 s, so one tile of
one step in a few hundred carries such a step, and a window's tiles sum to
its host seconds within ~2e-5; ``calibrate`` measures the offset again.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

TILES = ("scenes", "backbone", "fronts", "kl", "count_prior", "decoder",
         "gap.branch", "composite", "loss", "composite.bwd", "decoder.bwd",
         "count_prior.bwd", "kl.bwd", "fronts.bwd", "backbone.bwd",
         "optimizer", "gap.replay")
LAST = "gap.replay"  # the step's last mark: it advances the ring
RING_STEPS = 4096
HOST_SPANS = 65536   # the host spans kept, the newest
_HEAD = 4
_T = len(TILES)
_INDEX = {name: i for i, name in enumerate(TILES)}

_ACTIVE: Optional["Spans"] = None  # the recorder the model code marks into


def mark(tile: str):
    """Marks the start of ``tile`` in the active recorder, if any."""
    if _ACTIVE is not None:
        _ACTIVE.mark(tile)


def boundary(tree, fwd: str, bwd: str):
    """``tree`` (tensors, or dicts and tuples of them) passed through a
    layer boundary of the active recorder: the forward marks ``fwd``, and
    the backward marks ``bwd`` once the gradients of the tree's tensors
    are complete. Without an active recorder, ``tree`` itself."""
    if _ACTIVE is None:
        return tree
    return _ACTIVE.boundary(tree, fwd, bwd)


@contextlib.contextmanager
def active(recorder: Optional["Spans"]):
    """The model code marks into ``recorder`` inside the block."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, recorder
    try:
        yield recorder
    finally:
        _ACTIVE = before


_NULL = contextlib.nullcontext()


def _profiled(name: str):
    """A profiler range ``name`` while a profiler runs; otherwise nothing,
    since a range costs ~15 us of host time even with no profiler."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class _Boundary(torch.autograd.Function):
    """Identity on tensors: the forward marks one tile, the backward
    another."""

    @staticmethod
    def forward(ctx, recorder, fwd, bwd, *tensors):
        ctx.recorder, ctx.bwd = recorder, bwd
        ctx.set_materialize_grads(False)
        recorder.mark(fwd)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.recorder.mark(ctx.bwd)
        return (None, None, None) + grads


@dataclasses.dataclass
class HostSpan:
    """A host span: its id, name, start and end (``perf_counter_ns``), the
    id of the span it ran inside (0: none, the recorder itself) and the
    step it ran at (the steps finished before it began)."""
    id: int
    name: str
    start: int
    end: int
    parent: int
    step: int


class _Off:
    """The host spans of a step without a recorder: nothing."""

    def host(self, name):
        return _NULL

    def next_step(self):
        pass


OFF = _Off()


@dataclasses.dataclass
class Reading:
    """The state buffer read once: ``steps`` finished since the last reset,
    each tile's accumulated nanoseconds and closing count, the ring's rows
    of the steps it still holds (device clock) and the offset to the host
    clock."""
    steps: int
    acc_ns: np.ndarray
    count: np.ndarray
    ring: np.ndarray
    offset_ns: int

    def rows(self):
        """(step index, ring row) of each finished step the ring holds."""
        first = max(0, self.steps - RING_STEPS)
        return [(k, self.ring[k % RING_STEPS]) for k in range(first,
                                                               self.steps)]

    def step_tiles(self):
        """Each finished step in the ring: (its first mark on the host
        clock, {tile: ns}). A step's last tile is closed by the next step's
        first mark; the last step's, where no next step began, is left
        out."""
        out = []
        for k, row in self.rows():
            opened = [i for i in range(_T) if row[i] != 0]
            opened.sort(key=lambda i: row[i])
            times = [int(row[i]) for i in opened]
            nxt = self.ring[(k + 1) % RING_STEPS]
            first_next = min((int(v) for v in nxt if v != 0), default=0)
            if first_next > times[-1]:
                times.append(first_next)
            tiles = {TILES[i]: times[j + 1] - times[j]
                     for j, i in enumerate(opened) if j + 1 < len(times)}
            out.append((times[0] + self.offset_ns, tiles))
        return out


class Spans:
    """The span recorder of one train step (module docstring). ``bind``
    gives it its device at the step's first call; ``mark`` and ``boundary``
    record tiles, ``host`` host spans; ``reset`` starts a window, ``read``
    and ``summary`` read it once."""

    def __init__(self):
        self.device = None
        self.state = None        # the int64 state buffer, on the device
        self.lib = None          # csrc/spans.cu on a card
        self.offset_ns = 0       # host clock - device clock
        self.host_spans: Deque[HostSpan] = collections.deque(
            maxlen=HOST_SPANS)
        self.steps = 0           # steps finished, on the host
        self._stack: List[int] = []
        self._next_id = 1
        self._words = None       # the CPU buffer as numpy, for _mark_host

    # -- device marks -------------------------------------------------------

    def bind(self, device):
        """Allocates the state buffer on ``device`` (once); on a card,
        loads the mark kernel (built at its first load) and measures the
        clock offset."""
        device = torch.device(device)
        if self.state is not None:
            if device != self.device:
                raise RuntimeError(f"this recorder is bound to "
                                   f"{self.device}, not {device}")
            return
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"span marks run on cuda or cpu, got {device}")
        self.device = device
        self.state = torch.zeros(_HEAD + 2 * _T + RING_STEPS * _T,
                                 dtype=torch.int64, device=device)
        if device.type == "cuda":
            from spair_pytorch_tpu_torch.ops.kernels.composite import \
                load_library
            self.lib = load_library("spans")
            self.calibrate()
        else:
            self._words = self.state.numpy()

    def mark(self, tile: str):
        """Marks the start of ``tile``: a ``spair_span_mark`` kernel on the
        current stream on a card, the host clock on the CPU."""
        i = _INDEX[tile]
        last = int(tile == LAST)
        if self.lib is None:
            self._mark_host(i, last)
            return
        self._check(self.lib.spair_span_mark_launch(
            self.state.data_ptr(), i, _T, RING_STEPS, last,
            torch.cuda.current_stream(self.device).cuda_stream))

    def _mark_host(self, i: int, last: int):
        """``spair_span_mark`` on the host: the same words, the host's
        clock."""
        with _profiled("spair_span_mark"):
            now = time.perf_counter_ns()
            s = self._words
            prev, opened = int(s[0]), int(s[1])
            if prev != 0 and 0 <= opened < _T:
                s[_HEAD + opened] += now - prev
                s[_HEAD + _T + opened] += 1
            s[0], s[1] = now, i
            step = int(s[2])
            s[_HEAD + 2 * _T + (step % RING_STEPS) * _T + i] = now
            if last:
                s[2] = step + 1

    def boundary(self, tree, fwd: str, bwd: str):
        """``boundary`` (the module function) in this recorder."""
        leaves, spec = tree_flatten(tree)
        at = [j for j, t in enumerate(leaves)
              if torch.is_tensor(t) and t.requires_grad]
        if not at or not torch.is_grad_enabled():
            self.mark(fwd)
            return tree
        outs = _Boundary.apply(self, fwd, bwd, *(leaves[j] for j in at))
        for j, t in zip(at, outs):
            leaves[j] = t
        return tree_unflatten(leaves, spec)

    def activates(self, fn):
        """``fn`` with this recorder active while it runs."""
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with active(self):
                return fn(*args, **kwargs)
        return run

    def calibrate(self, tries: int = 16):
        """Measures ``offset_ns``, the host clock less the card's
        ``%globaltimer``: a mark written into pinned host memory, which the
        host polls and stamps with its own clock as soon as the mark lands.
        The host sees the write no sooner than it happens, so the least
        difference over ``tries`` is the offset, late by the write's trip
        and one poll (~1-2 us). Returns the differences seen."""
        n = _HEAD + 3
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        self._check(self.lib.spair_span_host_words(n, ctypes.byref(host),
                                                   ctypes.byref(dev)))
        words = np.ctypeslib.as_array((ctypes.c_longlong * n).from_address(
            host.value))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        seen = []
        try:
            for _ in range(tries):
                torch.cuda.synchronize(self.device)
                words[:] = 0
                self._check(self.lib.spair_span_mark_launch(
                    dev.value, 0, 1, 1, 0, stream))
                deadline = time.perf_counter_ns() + 10 ** 9
                now = time.perf_counter_ns()
                while words[0] == 0 and now < deadline:
                    now = time.perf_counter_ns()
                if words[0] == 0:
                    raise RuntimeError("a span mark did not land in 1 s")
                seen.append(now - int(words[0]))
            torch.cuda.synchronize(self.device)
        finally:
            self._check(self.lib.spair_span_free_host_words(host.value))
        self.offset_ns = min(seen)
        return seen

    def _check(self, err: int):
        if err != 0:
            msg = self.lib.spair_cuda_error_string(err).decode()
            raise RuntimeError(f"span marks: CUDA error {err} ({msg})")

    def reset(self):
        """Starts a window: zeroes the accumulators, the counts, the ring
        and the previous mark, in stream order (the time before the next
        mark belongs to no tile). Host spans are kept."""
        if self.state is not None:
            self.state.zero_()

    def read(self) -> Reading:
        """One copy of the state buffer to the host; call it after the
        caller's synchronise, which the copy would wait for anyway."""
        w = self.state.cpu().numpy().copy()
        return Reading(steps=int(w[2]), acc_ns=w[_HEAD:_HEAD + _T],
                       count=w[_HEAD + _T:_HEAD + 2 * _T],
                       ring=w[_HEAD + 2 * _T:].reshape(RING_STEPS, _T),
                       offset_ns=self.offset_ns)

    # -- host spans ---------------------------------------------------------

    @contextlib.contextmanager
    def host(self, name: str):
        """A host span ``name`` around the block (and a profiler range)."""
        sid, self._next_id = self._next_id, self._next_id + 1
        parent = self._stack[-1] if self._stack else 0
        step = self.steps
        self._stack.append(sid)
        start = time.perf_counter_ns()
        try:
            with _profiled(name):
                yield
        finally:
            self._stack.pop()
            self.host_spans.append(HostSpan(sid, name, start,
                                            time.perf_counter_ns(), parent,
                                            step))

    def next_step(self):
        """One more step finished, for the step ids of host spans."""
        self.steps += 1

    def host_seconds(self, prefix: str) -> float:
        """Seconds of the kept host spans whose name starts with
        ``prefix``."""
        return sum(s.end - s.start for s in self.host_spans
                   if s.name.startswith(prefix)) / 1e9

    # -- reading a window ---------------------------------------------------

    def summary(self, reading: Optional[Reading] = None) -> Dict:
        """The window since the last reset: ``steps``; for each tile that
        opened, in step order, ``ms`` (its mean a step: accumulated time
        over the finished steps), ``p50_ms`` and ``p95_ms`` over the steps
        the ring holds, and ``count`` (times it closed); ``graph_capture_s``,
        the seconds of the ``spair.capture.*`` host spans."""
        r = self.read() if reading is None else reading
        per_step = r.step_tiles()
        order = list(per_step[-1][1]) if per_step else []
        order += [t for t in TILES if r.count[_INDEX[t]] and t not in order]
        tiles = {}
        for t in order:
            vals = np.array([d[t] for _, d in per_step if t in d], float)
            tiles[t] = {
                "ms": float(r.acc_ns[_INDEX[t]]) / max(r.steps, 1) / 1e6,
                "p50_ms": float(np.percentile(vals, 50)) / 1e6
                if vals.size else None,
                "p95_ms": float(np.percentile(vals, 95)) / 1e6
                if vals.size else None,
                "count": int(r.count[_INDEX[t]])}
        return {"steps": r.steps, "tiles": tiles,
                "graph_capture_s": self.host_seconds("spair.capture.")}

    def slices(self, t0_ns: int, seconds: float = 5.0,
               reading: Optional[Reading] = None) -> List[Dict]:
        """The ring's steps in slices of ``seconds`` from ``t0_ns`` (host
        clock), by each step's first mark: for each slice, ``steps`` and
        each tile's mean ms a step over them."""
        r = self.read() if reading is None else reading
        width = int(seconds * 1e9)
        out: Dict[int, Dict] = {}
        for start, tiles in r.step_tiles():
            s = out.setdefault(max(0, (start - t0_ns) // width),
                               {"steps": 0, "ns": collections.Counter()})
            s["steps"] += 1
            s["ns"].update(tiles)
        return [{"steps": out[j]["steps"],
                 "ms": {t: v / out[j]["steps"] / 1e6
                        for t, v in out[j]["ns"].items()}}
                if j in out else {"steps": 0, "ms": {}}
                for j in range(max(out) + 1 if out else 0)]


def table(summary: Dict) -> str:
    """The tiles of ``Spans.summary`` as text: ms a step, p50, p95."""
    lines = [f"{'tile':<16} {'ms/step':>9} {'p50 ms':>9} {'p95 ms':>9}"]
    total = 0.0
    for name, t in summary["tiles"].items():
        total += t["ms"]
        p50, p95 = (f"{t[k]:9.3f}" if t[k] is not None else f"{'-':>9}"
                    for k in ("p50_ms", "p95_ms"))
        lines.append(f"{name:<16} {t['ms']:9.3f} {p50} {p95}")
    lines.append(f"{'all tiles':<16} {total:9.3f}  over "
                 f"{summary['steps']} steps")
    return "\n".join(lines)
