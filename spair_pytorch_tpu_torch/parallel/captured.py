"""The train step as one captured CUDA graph, replayed K times a call (the
counterpart of the JAX step's single device program: ``jax.jit`` of the
step, with ``lax.scan`` over ``steps_per_call`` steps inside it).

``make_train_step`` hands its one-step function to ``CapturedStep`` on a
CUDA device. The first call runs one real step eagerly on a side stream:
it creates every ``.grad``, Adam's moments and the cuBLAS/cuDNN
workspaces, and it is the call's first step. It then captures one whole
step into a ``torch.cuda.CUDAGraph`` on that stream: scene generation from
the state's generator (or the batch, read from a static input buffer),
forward with the compositor kernels inside, backward, clipping, Adam and
``state.step += 1``. Every other step is a replay: the rest of the first
call, and K steps of every later call, on the caller's stream.

Randomness. The state's generator is registered with the graph, so each
replay draws from the Philox offset the previous step left, as an eager
step does: the replays draw the same scenes and noise as eager steps, step
for step, and the generator's state after a call is the eager one.

Metrics. Each call returns fresh tensors, copied out of the graph's static
output after each replay into a buffer made for the call, so metrics held
across calls are never overwritten: a dict of 0-d tensors for K = 1, of
(K,) tensors for K > 1, as the eager step returns them.

Binding. The graph holds the addresses of the parameters, their
``.grad``s, Adam's state, ``state.step`` and the generator's Philox state,
and Adam's learning rate as it was at capture. A call with another state,
or after a ``load_state_dict`` replaced any of those tensors, raises: the
step was captured for the tensors it writes. A restore therefore comes
before the first call (``train.py`` restores, then calls).

Spans. With a recorder (``utils/spans.py``, ``make_train_step(...,
spans=True)``) the eager step and the captures mark the step's tiles on
the card, so every replay runs those marks, and the step records its host
spans: ``spair.warm_up`` and one ``spair.capture.<graph>`` a graph at the
first call, then for each step ``spair.replay`` (a segmented step's
``spair.replay.A``, ``spair.branch_read`` and ``spair.replay.B``) and
``spair.metrics_out``, and ``spair.load`` for a batch. Without one they
are no-op contexts and the graphs hold no mark.

Launch counts. The kernel wrappers count Python calls, so the capture
counts once and a replay never. ``CapturedStep`` takes back what the
capture counted and adds each wrapper's launches of one step on every
replay, so the counts read what the card launched.

The top-K branch. With ``render_topk`` the JAX step branches on the
device (``lax.cond``); torch exposes no conditional graph node to Python,
so ``SegmentedStep`` does what XLA's GPU backend long did for a
``lax.cond``: it captures the step as segments around the branch. Segment
A is the step up to the branch (scenes, the forward up to the decoder, the
gate and the predicate, ``models/render.py::render_objects``); segment B
is one branch's composite, the loss, the backward, clipping, Adam and
``state.step += 1``, captured once for each branch. A step replays A,
copies the 0-d predicate to the host (one read a step, outside every
graph) and replays the B it names, so the branch not taken does no device
work. B's backward runs through A's autograd graph, whose saved tensors
are A's static outputs: the first B capture keeps that graph
(``retain_graph=True``) for the second, and all three graphs share one
memory pool. Both Bs write the same gradients and the same static metrics.
The state's generator is registered with A alone: B draws nothing (a draw
there would raise at its capture, and the warm-up checks it). Which branch
each step took is counted on the host (``Branches``). Without
``render_topk`` the step is one graph, as above.

The data-parallel step (``mesh``, ``parallel/mesh.py``) is captured as
the plain step is: its collectives (the flat gradient all-reduce, the
metrics' all-gather and, with ``render_topk``, the MAX all-reduce of the
live count in segment A) are NCCL kernels inside the graphs. Every rank
captures at its first call and replays the same graphs in the same order:
the branch's predicate is the global batch's, so every rank replays the
same B. NCCL's communicator exists before the capture (``make_mesh``).
The captures keep torch's default 'global' capture-error mode, in which a
CUDA call another thread makes mid-capture can invalidate it: torch
2.11's ProcessGroupNCCL watchdog thread, which polls the events of eager
collectives, did not (``chip_smoke.py`` phase 20(a): a fresh group's
first collective captured, then ten captures, each after 30 eager
collectives, replayed 200 times each; the mesh steps on one and four
cards). 'thread_local' would only stop catching such calls from other
threads, so no capture asks for it.

What stays eager (``eager_reason``) is decided from the configuration
before any capture, never on a failure; a capture that fails (of any
segment) raises, and the step is not retried:

- the CPU: no CUDA graphs there; every CPU caller keeps the eager step;
- the NaN hunter and the whole-program NaN check (``utils/debug.py``): they
  read flags on the host every call, by design.

The forward programs. ``CapturedForward`` is the no-grad counterpart of
the JAX package's jitted forward programs: the detector
(``models/infer.py::make_detector``, one graph per batch size, which the
server's buckets share a memory pool through), the eval step
(``train_step.py::make_eval_step``) and the per-batch programs of
``eval.py::evaluate`` and ``calibrate``. It keeps one graph for each
shape of its inputs, captured at the first call of that shape after one
eager run of the program on the side stream, which is that call's result;
every later call copies its inputs into the graph's static buffers,
replays, and returns copies of the outputs. It is bound to the addresses
of the parameters and buffers it was first called with (loading a state
dict copies in place and passes) and to the generator registered with it.
``SegmentedForward`` is its form for a program that renders with
``render_topk`` (the eval step and ``evaluate``'s batch program): for each
shape a graph of the program up to the branch and one of each branch's
rest, replayed around the host's read of the predicate, as the step's
segments are. The split refiner (``models/refine.py::make_refiner``) is a
``CapturedForward`` too, one graph per batch size. ``forward_eager_reason``
keeps these programs eager on the CPU and under the NaN hunter.
"""

from __future__ import annotations

import functools
import gc
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.models.render import takes_topk
from spair_pytorch_tpu_torch.ops.kernels import cell_glue as _glue
from spair_pytorch_tpu_torch.ops.kernels import composite as _k12
from spair_pytorch_tpu_torch.ops.kernels import composite_ordered as _over
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as _k34
from spair_pytorch_tpu_torch.utils import spans as _spans
from spair_pytorch_tpu_torch.utils.debug import host_checks_on

# the wrappers that count their kernels' launches: K1, K2, K3, K4,
# ordered mode's forward and backward, and cell_step's ten glue kernels
COUNTED = (_k12.composite_forward, _k12.composite_backward,
           _k34.composite_v3_forward, _k34.composite_v3_backward,
           _over.ordered_forward, _over.ordered_backward) + _glue.COUNTED


def eager_reason(cfg: SpairConfig, device, mesh=None) -> Optional[str]:
    """Why a train step of ``cfg`` on ``device`` runs eagerly, or None
    when it is captured; with a ``mesh`` or without, alike."""
    return forward_eager_reason(cfg, device)


def forward_eager_reason(cfg: SpairConfig, device) -> Optional[str]:
    """Why a program of ``cfg`` on ``device`` runs eagerly, or None when it
    is captured."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type} device: CUDA graphs need a CUDA device"
    if host_checks_on():
        return "the NaN hunter reads its flags on the host"
    return None


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream a device, shared by every captured
    step: cuBLAS keeps a workspace for each stream it has run on, for the
    life of the process."""
    return torch.cuda.Stream(device)


def _warm_up(device, fn):
    """``fn()`` run eagerly on the side stream, after the work the caller's
    stream has queued; the caller's stream waits for it, and the tensors
    of its result (a tree) are recorded on that stream."""
    stream = _side_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in tree_flatten(out)[0]:
        t.record_stream(current)
    return out


def _capture(graph, fn, device, generator=None, pool=None, counted=COUNTED):
    """``fn()`` captured into ``graph`` on the side stream, ``generator``
    registered with it: (fn's result, the graph's static outputs; the
    launches of one replay, per wrapper of ``counted``). The wrappers
    count Python calls, so what the capture counted is taken back: it
    launched nothing on the card. A capture that raises is not retried.

    The garbage collector is off during the capture (``torch.cuda.graph``
    collects just before it): a graph it freed mid-capture, one left in a
    reference cycle, would invalidate the capture."""
    before = [w.launches for w in counted]
    if generator is not None:
        graph.register_generator_state(generator)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=_side_stream(device)):
            out = fn()
    finally:
        if collecting:
            gc.enable()
        per_replay = [w.launches - n for w, n in zip(counted, before)]
        for w, n in zip(counted, before):
            w.launches = n
    return out, per_replay


def _replayed(per_replay, counted=COUNTED):
    """Counts one replay's launches on each wrapper of ``counted``."""
    for w, n in zip(counted, per_replay):
        w.launches += n


class Branches:
    """The render branch each step of a segmented program took, counted on
    the host: ``counts`` over every call ('topk', 'full'), and ``last``,
    the branches of the last call's steps in order (True for top-K); a
    forward program's call is one step."""

    def __init__(self):
        self.counts = {"topk": 0, "full": 0}
        self.last = []

    def new_call(self):
        self.last = []

    def took(self, topk: bool):
        self.counts["topk" if topk else "full"] += 1
        self.last.append(topk)


def _draws_nothing(generator, fn):
    """``fn()``, checked to leave ``generator`` where it was: a segment
    after the branch must draw nothing, since the generator is registered
    with the segment before it alone."""
    before = generator.get_state()
    out = fn()
    if not torch.equal(before, generator.get_state()):
        raise RuntimeError("the segment after the render's branch drew from "
                           "the generator; only the segment before it may")
    return out


def _state_tensors(state):
    """The step, the parameters, their gradients and Adam's state tensors:
    what a step writes in place."""
    out = [state.step]
    for p in state.model.parameters():
        out += [p] if p.grad is None else [p, p.grad]
    for s in state.optimizer.state.values():
        out += [v for v in s.values() if torch.is_tensor(v)]
    return tuple(out)


def _addresses(state):
    """What the graph is bound to: the generator and the addresses of the
    step, the parameters, their gradients and Adam's state tensors."""
    return id(state.generator), tuple(t.data_ptr()
                                      for t in _state_tensors(state))


class CapturedStep:
    """``step(state, *batch) -> (state, metrics)``: ``steps_per_call``
    steps of ``one_step(state, *batch) -> metrics`` a call, the first
    call's first step eager and every other one a replay of one captured
    step (module docstring)."""

    def __init__(self, one_step, steps_per_call: int = 1, spans=None):
        self.one_step = one_step
        self.k = steps_per_call
        self.spans = spans      # a utils/spans.py recorder, or None
        self.graph = None       # set before the capture: never retried
        self.ready = False      # set when every capture has succeeded
        self.static_in = ()     # the batch buffers the graph reads
        self.static_out = None  # the step's metrics, stacked, (M,)
        self.keys = None
        self.per_replay = None  # launches of one step, per COUNTED wrapper
        self.bound = None

    def __call__(self, state, *batch):
        host = self.spans or _spans.OFF
        first = None
        if self.graph is None:
            first = self._warm_up_and_capture(state, batch, host)
        elif not self.ready:
            raise RuntimeError("this step's capture failed; build a new "
                               "step with make_train_step")
        else:
            if _addresses(state) != self.bound:
                raise RuntimeError(
                    "this captured step is bound to the state it was "
                    "captured with (its generator, and its parameters, "
                    "gradients, Adam state and step at their addresses "
                    "then); build a new step with make_train_step")
            if host_checks_on():
                raise RuntimeError("the NaN hunter is on: a captured step "
                                   "cannot run it; build a new step")
            with host.host("spair.load"):
                self._load(batch)
        out = torch.empty((len(self.keys), self.k), device=state.step.device)
        if first is not None:
            out[:, 0].copy_(first)
        for i in range(0 if first is None else 1, self.k):
            self._replay(host)
            with host.host("spair.metrics_out"):
                out[:, i].copy_(self.static_out)
            host.next_step()
        if self.k == 1:
            return state, {k: out[j, 0] for j, k in enumerate(self.keys)}
        return state, {k: out[j] for j, k in enumerate(self.keys)}

    def _replay(self, host):
        with host.host("spair.replay"):
            self.graph.replay()
            _replayed(self.per_replay)

    def _load(self, batch):
        if len(batch) != len(self.static_in) or any(
                b.shape != s.shape or b.dtype != s.dtype
                or b.device != s.device
                for b, s in zip(batch, self.static_in)):
            raise ValueError(
                "a captured step takes batches of the shapes, dtypes and "
                "device it was captured with: "
                f"{[(tuple(s.shape), s.dtype) for s in self.static_in]}")
        for b, s in zip(batch, self.static_in):
            s.copy_(b)

    def _stacked(self, state, batch):
        """One step's metrics, stacked in ``self.keys``' order."""
        metrics = self.one_step(state, *batch)
        self.keys = list(metrics)
        return torch.stack([metrics[k] for k in self.keys])

    def _warm_up_and_capture(self, state, batch, host):
        """One eager step on a side stream, then the capture on it; returns
        the eager step's metrics, stacked."""
        device = state.step.device
        with host.host("spair.warm_up"):
            first = _warm_up(device, lambda: self._stacked(state, batch))
        host.next_step()
        self.static_in = tuple(b.clone() for b in batch)
        self.graph = torch.cuda.CUDAGraph()
        with host.host("spair.capture.step"):
            self.static_out, self.per_replay = _capture(
                self.graph, lambda: self._stacked(state, self.static_in),
                device, state.generator)
        self.bound = _addresses(state)
        self.ready = True
        return first


class SegmentedStep(CapturedStep):
    """``CapturedStep`` for a step with the render's top-K branch (module
    docstring): ``head(state, *batch) -> carry`` up to the branch,
    ``predicate(carry)`` its 0-d bool tensor, ``tail(state, carry, topk,
    retain_graph) -> metrics`` the rest; ``branches`` (a ``Branches``)
    counts the branch of every step, the first call's eager one too."""

    def __init__(self, head, tail, predicate, steps_per_call: int = 1,
                 branches: Optional[Branches] = None, spans=None):
        super().__init__(None, steps_per_call, spans)
        self.head, self.tail, self.predicate = head, tail, predicate
        self.branches = Branches() if branches is None else branches
        self.pred = None   # A's static predicate
        self.carry = None  # A's static outputs, which the Bs read
        self.tails = {}    # topk -> (B's graph, launches of one replay)

    def _replay(self, host):
        with host.host("spair.replay.A"):
            self.graph.replay()
            _replayed(self.per_replay)
        with host.host("spair.branch_read"):
            topk = takes_topk(self.pred)  # the one host read of a step
        self.branches.took(topk)
        graph, per_replay = self.tails[topk]
        with host.host("spair.replay.B"):
            graph.replay()
            _replayed(per_replay)

    def _tail_stacked(self, state, carry, topk, retain_graph=False):
        metrics = self.tail(state, carry, topk, retain_graph)
        if list(metrics) != self.keys:
            raise RuntimeError("the two branches return other metrics")
        return torch.stack([metrics[k] for k in self.keys])

    def _eager_step(self, state, batch):
        carry = self.head(state, *batch)
        topk = takes_topk(self.predicate(carry))
        self.branches.took(topk)
        metrics = _draws_nothing(state.generator,
                                 lambda: self.tail(state, carry, topk))
        self.keys = list(metrics)
        return torch.stack([metrics[k] for k in self.keys])

    def _warm_up_and_capture(self, state, batch, host):
        """One eager step on the side stream, then A and both Bs captured
        on it into one pool; returns the eager step's metrics, stacked."""
        device = state.step.device
        with host.host("spair.warm_up"):
            first = _warm_up(device, lambda: self._eager_step(state, batch))
        host.next_step()
        self.static_in = tuple(b.clone() for b in batch)
        self.static_out = torch.empty_like(first)
        pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        with host.host("spair.capture.A"):
            self.carry, self.per_replay = _capture(
                self.graph, lambda: self.head(state, *self.static_in),
                device, state.generator, pool)
        self.pred = self.predicate(self.carry)
        # the top-K B first: its backward keeps A's autograd graph, and so
        # A's saved tensors, for the full B's backward, which frees it. A
        # capture runs nothing, but autograd counts the in-place updates it
        # records (Adam's of the parameters, which A's graph saved): their
        # version counters are put back, as a replay of A and the full B
        # finds the state
        for topk in (True, False):
            graph = torch.cuda.CUDAGraph()
            with torch.autograd._unsafe_preserve_version_counter(
                    _state_tensors(state)), host.host(
                        "spair.capture.B." + ("topk" if topk else "full")):
                _, per_replay = _capture(
                    graph, lambda t=topk: self.static_out.copy_(
                        self._tail_stacked(state, self.carry, t,
                                           retain_graph=t)), device,
                    pool=pool)
            self.tails[topk] = (graph, per_replay)
        # the Bs read A's outputs at their addresses: keep the storage, not
        # A's autograd graph, whose gradient accumulators would otherwise
        # stay the parameters' in a later eager backward, on the capture's
        # stream
        self.carry = tree_map(
            lambda t: t.detach() if torch.is_tensor(t) else t, self.carry)
        self.bound = _addresses(state)
        self.ready = True
        return first


def static_input(value, device):
    """A graph's static buffer for an input: a copy of a tensor, or a 0-d
    tensor on ``device`` filled with a Python number (int64 for an int,
    float32 otherwise), never a copy from the host."""
    if torch.is_tensor(value):
        return value.clone()
    dtype = torch.int64 if isinstance(value, int) else torch.float32
    return torch.full((), value, dtype=dtype, device=device)


def _module_addresses(params):
    """What a forward graph is bound to: the addresses of the parameters'
    and buffers' storage."""
    return tuple(t.data_ptr() for t in (*params.parameters(),
                                        *params.buffers()))


class _Graph:
    """One captured shape: the graph, its static inputs and outputs (the
    outputs flat, with their tree) and the launches of one replay."""

    def __init__(self):
        self.graph = None
        self.ready = False
        self.static_in = ()
        self.static_out = None
        self.tree = None
        self.per_replay = None


class CapturedForward:
    """``run(params, *inputs) -> program(params, *inputs)``, a tree of
    tensors, with one captured CUDA graph for each shape of the inputs
    (module docstring). Inputs are tensors on the card, or Python numbers,
    which become 0-d static tensors filled before each replay.
    ``generator``: the generator the program draws from, registered with
    every graph; ``pool``: a memory pool to share (one for all of this
    program's graphs by default)."""

    def __init__(self, program, generator: Optional[torch.Generator] = None,
                 pool=None):
        self.program = program
        self.generator = generator
        self.pool = pool
        self.graphs = {}
        self.bound = None

    def __call__(self, params, *inputs):
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    if torch.is_tensor(t) else type(t) for t in inputs)
        entry = self.graphs.get(key)
        if self.bound is not None and _module_addresses(params) != self.bound:
            raise RuntimeError(
                "this captured program is bound to the parameters it was "
                "captured with (their addresses then); load new values in "
                "place, or build a new program")
        if host_checks_on():
            raise RuntimeError("the NaN hunter is on: a captured program "
                               "cannot run it; build a new one")
        if entry is None:
            return self._warm_up_and_capture(key, params, inputs)
        if not entry.ready:
            raise RuntimeError("this program's capture failed for these "
                               "shapes; build a new program")
        for s, t in zip(entry.static_in, inputs):
            if torch.is_tensor(t):
                s.copy_(t)
            else:
                s.fill_(t)
        out = self._replay(entry)
        return tree_unflatten([t.clone() for t in out.static_out], out.tree)

    def _replay(self, entry):
        """Replays ``entry``; returns the _Graph whose outputs hold the
        result."""
        entry.graph.replay()
        _replayed(entry.per_replay)
        return entry

    def _warm_up_and_capture(self, key, params, inputs):
        """One eager run on the side stream, from the static inputs, which
        is this call's result; then the capture on that stream."""
        device = next(t.device for t in inputs if torch.is_tensor(t))
        entry = _Graph()
        entry.static_in = tuple(static_input(t, device) for t in inputs)
        first = _warm_up(device, lambda: self.program(params,
                                                      *entry.static_in))
        self.graphs[key] = entry  # from here on, never retried
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        entry.graph = torch.cuda.CUDAGraph()
        out, entry.per_replay = _capture(
            entry.graph, lambda: self.program(params, *entry.static_in),
            device, self.generator, self.pool)
        entry.static_out, entry.tree = tree_flatten(out)
        self.bound = _module_addresses(params)
        entry.ready = True
        return first


class SegmentedForward(CapturedForward):
    """``CapturedForward`` for a program with the render's top-K branch
    (module docstring): ``head(params, *inputs) -> carry`` up to the
    branch, ``predicate(carry)`` its 0-d bool tensor and ``tail(params,
    carry, topk)`` the rest, a tree of tensors. Each input shape has three
    graphs in the program's pool: A (head) and a B for each branch;
    ``branches`` counts the branch of every call."""

    def __init__(self, head, tail, predicate,
                 generator: Optional[torch.Generator] = None, pool=None,
                 branches: Optional[Branches] = None):
        # no program of its own: a bound method there would make a cycle
        # that only the garbage collector frees, with the graphs in it
        super().__init__(None, generator, pool)
        self.head, self.tail, self.predicate = head, tail, predicate
        self.branches = Branches() if branches is None else branches

    def _eager(self, params, *inputs):
        carry = self.head(params, *inputs)
        topk = takes_topk(self.predicate(carry))
        self.branches.new_call()
        self.branches.took(topk)
        if self.generator is None:
            return self.tail(params, carry, topk)
        return _draws_nothing(self.generator,
                              lambda: self.tail(params, carry, topk))

    def _replay(self, entry):
        entry.graph.replay()
        _replayed(entry.per_replay)
        topk = takes_topk(entry.pred)  # the one host read of a call
        self.branches.new_call()
        self.branches.took(topk)
        tail = entry.tails[topk]
        tail.graph.replay()
        _replayed(tail.per_replay)
        return tail

    def _warm_up_and_capture(self, key, params, inputs):
        """One eager run on the side stream, from the static inputs, which
        is this call's result; then A and both Bs captured on it."""
        device = next(t.device for t in inputs if torch.is_tensor(t))
        entry = _Graph()
        entry.static_in = tuple(static_input(t, device) for t in inputs)
        first = _warm_up(device, lambda: self._eager(params,
                                                     *entry.static_in))
        self.graphs[key] = entry  # from here on, never retried
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        entry.graph = torch.cuda.CUDAGraph()
        entry.carry, entry.per_replay = _capture(
            entry.graph, lambda: self.head(params, *entry.static_in),
            device, self.generator, self.pool)
        entry.pred = self.predicate(entry.carry)
        entry.tails = {}
        for topk in (True, False):
            tail = entry.tails[topk] = _Graph()
            tail.graph = torch.cuda.CUDAGraph()
            out, tail.per_replay = _capture(
                tail.graph, lambda t=topk: self.tail(params, entry.carry, t),
                device, pool=self.pool)
            tail.static_out, tail.tree = tree_flatten(out)
        self.bound = _module_addresses(params)
        entry.ready = True
        return first
