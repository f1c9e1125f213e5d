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

Launch counts. The kernel wrappers count Python calls, so the capture
counts once and a replay never. ``CapturedStep`` takes back what the
capture counted and adds each wrapper's launches of one step on every
replay, so the counts read what the card launched.

What stays eager (``eager_reason``) is decided from the configuration
before any capture, never on a failure; a capture that fails raises, and
the step is not retried. These are the next captures, in this order:

- the CPU: no CUDA graphs there; every CPU caller keeps the eager step;
- ``mesh``: NCCL's all-reduce inside a capture is a later slice;
- ``render_topk``: ``models/render.py::_live_at_most`` branches on the host
  where the JAX package uses ``lax.cond``;
- the NaN hunter and the whole-program NaN check (``utils/debug.py``): they
  read flags on the host every call.

``make_eval_step`` and the detector are not train steps and stay eager; the
detector's NMS sweeps end on a host read (``models/infer.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.ops.kernels import composite as _k12
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as _k34
from spair_pytorch_tpu_torch.utils.debug import host_checks_on

# the wrappers that count their kernels' launches: K1, K2, K3, K4
COUNTED = (_k12.composite_forward, _k12.composite_backward,
           _k34.composite_v3_forward, _k34.composite_v3_backward)


def eager_reason(cfg: SpairConfig, device, mesh=None) -> Optional[str]:
    """Why a train step of ``cfg`` on ``device`` runs eagerly, or None
    when it is captured."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type} device: CUDA graphs need a CUDA device"
    if mesh is not None:
        return "mesh: the gradient all-reduce (NCCL) is not captured"
    if cfg.render_topk:
        return ("render_topk: models/render.py::_live_at_most reads the "
                "live count on the host")
    if host_checks_on():
        return "the NaN hunter reads its flags on the host"
    return None


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream a device, shared by every captured
    step: cuBLAS keeps a workspace for each stream it has run on, for the
    life of the process."""
    return torch.cuda.Stream(device)


def _addresses(state):
    """What the graph is bound to: the generator and the addresses of the
    step, the parameters, their gradients and Adam's state tensors."""
    ptrs = [state.step.data_ptr()]
    for p in state.model.parameters():
        ptrs += [p.data_ptr(), 0 if p.grad is None else p.grad.data_ptr()]
    for s in state.optimizer.state.values():
        ptrs += [v.data_ptr() for v in s.values() if torch.is_tensor(v)]
    return id(state.generator), tuple(ptrs)


class CapturedStep:
    """``step(state, *batch) -> (state, metrics)``: ``steps_per_call``
    steps of ``one_step(state, *batch) -> metrics`` a call, the first
    call's first step eager and every other one a replay of one captured
    step (module docstring)."""

    def __init__(self, one_step, steps_per_call: int = 1):
        self.one_step = one_step
        self.k = steps_per_call
        self.graph = None       # set before the capture: never retried
        self.static_in = ()     # the batch buffers the graph reads
        self.static_out = None  # the step's metrics, stacked, (M,)
        self.keys = None
        self.per_replay = None  # launches of one step, per COUNTED wrapper
        self.bound = None

    def __call__(self, state, *batch):
        first = None
        if self.graph is None:
            first = self._warm_up_and_capture(state, batch)
        elif self.static_out is None:
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
            self._load(batch)
        out = torch.empty((len(self.keys), self.k), device=state.step.device)
        if first is not None:
            out[:, 0].copy_(first)
        for i in range(0 if first is None else 1, self.k):
            self.graph.replay()
            for fn, n in zip(COUNTED, self.per_replay):
                fn.launches += n
            out[:, i].copy_(self.static_out)
        if self.k == 1:
            return state, {k: out[j, 0] for j, k in enumerate(self.keys)}
        return state, {k: out[j] for j, k in enumerate(self.keys)}

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

    def _warm_up_and_capture(self, state, batch):
        """One eager step on a side stream, then the capture on it; returns
        the eager step's metrics, stacked."""
        device = state.step.device
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            metrics = self.one_step(state, *batch)
            self.keys = list(metrics)
            first = torch.stack([metrics[k] for k in self.keys])
        torch.cuda.current_stream(device).wait_stream(stream)
        first.record_stream(torch.cuda.current_stream(device))
        self.static_in = tuple(b.clone() for b in batch)

        before = [fn.launches for fn in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                metrics = self.one_step(state, *self.static_in)
                static_out = torch.stack([metrics[k] for k in self.keys])
        finally:
            # the capture launched nothing on the card
            self.per_replay = [fn.launches - n
                               for fn, n in zip(COUNTED, before)]
            for fn, n in zip(COUNTED, before):
                fn.launches = n
        self.static_out = static_out
        self.bound = _addresses(state)
        return first
