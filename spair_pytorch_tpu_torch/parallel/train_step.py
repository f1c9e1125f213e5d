"""Training and eval steps (counterpart of ``spair_pytorch_tpu/parallel/
train_step.py``, single device).

A step is forward, backward, optional global-norm clipping and Adam with
the reference's settings (lr from the config, betas (0.9, 0.999), eps 1e-8).
It updates the ``TrainState`` in place and returns it with its metrics,
which stay on the device: a step makes no host sync. ``scan_remat`` and
``scan_remat_policy`` change memory, not values, and are ignored here.

On a CUDA device the step ``make_train_step`` returns is one captured CUDA
graph, replayed once a step: K steps a call are K replays of it, as the JAX
step is one device program with K steps scanned inside
(``parallel/captured.py``, which also lists the configurations that stay
eager: the CPU and the NaN hunter). With ``render_topk`` it is
two segments around the render's top-K branch, the JAX step's
``lax.cond``: ``train_step_head`` up to it and ``train_step_tail`` after
it, with the branch's predicate read on the host between them
(``captured.SegmentedStep``). The CPU runs the eager step.

With a ``mesh`` (``parallel/mesh.py``) the step is data parallel:
``cfg.batch_size`` is the global batch and each rank trains on its slice.
Every rank draws the global batch's scenes and noise from a generator in
the same state and keeps its slice, so the ranks together compute the
one-process step. Each rank's loss is its share of the global loss (the
reconstruction sum over its slice plus the batch-mean terms over the global
batch, ``forward(batch_share=)``); the gradients are summed over the ranks
before clipping and Adam, and the metrics are reduced. With
``render_topk`` the branch's predicate is the global batch's: the largest
live count is reduced over the ranks first, so every rank takes the branch
the one-process step takes. At world size 1 the step is the step without a
mesh, bit for bit. On the card it is captured as the plain step is, with
NCCL's collectives inside the graph.

With a mesh whose 'model' axis has M > 1 ranks (``make_mesh(n_model=M)``)
the batch slice is the data rank's, the inference's cells are split over
the ranks of each model group (``parallel/constraints.py``), each rank's
loss is scaled by 1 / M before the backward, and the gradients are summed
over the world as above: the constraints module says why that is the
one-process gradient. ``make_eval_step(cfg, mesh)`` evaluates over a mesh
alike and returns the global batch's loss and outputs on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from spair_pytorch_tpu_torch import metrics as metric
from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.data import generate_batch
from spair_pytorch_tpu_torch.data.sharded import generate_host_local
from spair_pytorch_tpu_torch.models.latents import (SpairModel, geometry,
                                                    init_params, sample_noise)
from spair_pytorch_tpu_torch.models.render import takes_topk, topk_branches
from spair_pytorch_tpu_torch.models.spair import forward_head, forward_tail
from spair_pytorch_tpu_torch.parallel.captured import (Branches,
                                                       CapturedForward,
                                                       CapturedStep,
                                                       SegmentedForward,
                                                       SegmentedStep,
                                                       eager_reason,
                                                       forward_eager_reason)
from spair_pytorch_tpu_torch.parallel.mesh import (Mesh, all_reduce_,
                                                   gather_batch, global_max,
                                                   reduce_metrics)
from spair_pytorch_tpu_torch.utils.debug import grad_norms_by_head


@dataclasses.dataclass
class TrainState:
    """step: 0-d int64 tensor on the model's device; model: the parameters;
    optimizer: Adam over them; generator: the device generator every draw
    of the step (scenes, noise) comes from."""
    step: torch.Tensor
    model: SpairModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def optimizer(cfg: SpairConfig, model: torch.nn.Module):
    """Adam with torch's defaults as the reference sets them (lr from the
    config, betas (0.9, 0.999), eps 1e-8). Clipping is done by the step.
    On CUDA it is ``capturable``: its step count lives on the device, so a
    CUDA graph can hold the update (a checkpoint's host step count moves
    there on load)."""
    capturable = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def create_train_state(cfg: SpairConfig, seed: Optional[int] = None,
                       device="cuda") -> TrainState:
    """Fresh parameters from ``cfg.seed`` (see ``init_params``), a fresh
    Adam, step 0 and a generator on ``device`` seeded with ``seed``
    (``cfg.seed`` when omitted)."""
    device = torch.device(device)
    model = init_params(cfg, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed if seed is None else seed)
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=device),
                      model=model, optimizer=optimizer(cfg, model),
                      generator=generator)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm_(grads, norm, max_norm: float):
    """optax's rule: where norm >= max_norm, g <- g / norm * max_norm;
    otherwise g is left as it is (no epsilon)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def train_step(cfg: SpairConfig, state: TrainState, x, gt_bbox=None,
               gt_count=None, noise=None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One step on images x (B, C, H, W): forward with the state's
    generator (or the given ``noise``), backward, Adam. Updates ``state``
    in place; returns the metric dict of the JAX step: the loss terms,
    ``training_wheel``, the presence-count and gradient-norm diagnostics,
    and with ``gt_bbox``/``gt_count`` the four ``accuracy/*`` tags.

    With ``mesh``, x is this rank's slice of the global batch (its data
    rank's) and ``noise``, when given, its slice of the global noise; the
    metrics come back reduced over the ranks.

    It is ``train_step_head``, the render's branch read on the host
    (``render.py::takes_topk``; no read without ``render_topk``), then
    ``train_step_tail``."""
    head = train_step_head(cfg, state, x, noise, mesh)
    return train_step_tail(cfg, state, head,
                           takes_topk(head["live_at_most_k"]), gt_bbox,
                           gt_count, mesh)


def train_step_head(cfg: SpairConfig, state: TrainState, x, noise=None,
                    mesh: Optional[Mesh] = None):
    """``train_step`` up to the render's top-K branch: the gradients
    zeroed and ``forward_head`` (with ``mesh``, the branch's predicate over
    the global batch); returns its carry, with the batch share the tail's
    loss needs."""
    state.optimizer.zero_grad(set_to_none=False)
    return _head(state.model, cfg, x, state.step, state.generator, noise,
                 mesh)


def _head(params, cfg, x, step, generator, noise, mesh):
    """``forward_head`` of this rank's x, with the batch share of the loss
    it sets: with ``mesh``, noise drawn for the global batch and sliced to
    this data rank's share, and the branch's predicate and the inference's
    model axis over the mesh."""
    batch_share, reduce_live = 1.0, None
    if mesh is not None:
        reduce_live = global_max
        global_b = x.shape[0] * mesh.n_data
        batch_share = x.shape[0] / global_b
        if noise is None:
            start, stop = mesh.slice(global_b)
            full = sample_noise(generator, global_b, geometry(cfg)[1], cfg,
                                x.device)
            noise = {k: v[start:stop] for k, v in full.items()}
    head = forward_head(params, cfg, x, step, generator, noise, reduce_live,
                        mesh)
    head["batch_share"] = batch_share
    return head


def train_step_tail(cfg: SpairConfig, state: TrainState, head, topk: bool,
                    gt_bbox=None, gt_count=None, mesh: Optional[Mesh] = None,
                    retain_graph: bool = False) -> Dict[str, torch.Tensor]:
    """``train_step`` from the render's branch on (the top-K composite when
    ``topk``): ``forward_tail``, backward, clipping, Adam and the step
    count; the metrics. ``retain_graph`` keeps the head's autograd graph
    for another tail (the first of a segmented step's two captures)."""
    model, opt = state.model, state.optimizer
    loss, aux = forward_tail(model, cfg, head, topk, head["batch_share"])
    if mesh is not None and mesh.n_model > 1:
        # the gradient rule of parallel/constraints.py: the gradients are
        # summed over the model group's M ranks by all_reduce_ below
        (loss * (1.0 / mesh.n_model)).backward(retain_graph=retain_graph)
    else:
        loss.backward(retain_graph=retain_graph)
    # a parameter the loss does not reach has a zero gradient, as in JAX:
    # Adam still decays its moments
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if mesh is not None:
        all_reduce_(grads)

    out = dict(aux["losses"])
    out["training_wheel"] = aux["training_wheel"]
    with torch.no_grad():
        counts = torch.sum(torch.round(aux["z_pres"]), dim=(1, 2, 3))
        out["debug/pres_count_max"] = torch.amax(counts)
        out["debug/pres_count_mean"] = torch.mean(counts)
        norm = global_norm(grads)
        out["debug/grad_global_norm"] = norm
        out.update(grad_norms_by_head(model))
        if gt_bbox is not None:
            size = cfg.image_shape[-1]
            z_where, z_pres = aux["z_where"], aux["z_pres"]
            out["accuracy/bbox_average_precision"] = metric.mAP(
                z_where, z_pres, gt_bbox, gt_count, size)
            out["accuracy/object_count_accuracy"] = \
                metric.object_count_error(z_pres, gt_count)
            out["accuracy/count_exact"] = metric.count_accuracy(z_pres,
                                                                gt_count)
            out["accuracy/bbox_ap_center"] = metric.mAP_center(
                z_where, z_pres, gt_bbox, gt_count, size)
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            clip_by_global_norm_(grads, norm, cfg.grad_clip_norm)
        if mesh is not None:
            out = reduce_metrics(mesh, out)
    opt.step()
    state.step += 1
    return {k: v.detach() for k, v in out.items()}


def make_train_step(cfg: SpairConfig, mesh: Optional[Mesh] = None,
                    with_detection: bool = False, datagen=None,
                    steps_per_call: int = 1, eager: bool = False):
    """Returns step(state[, batch]) -> (state, metrics).

    ``batch`` is the image tensor, or (x, gt_bbox, gt_count) with
    ``with_detection``, which adds the detection metrics of the training
    forward's own latents; with ``mesh``, this rank's slice of the global
    batch (``parallel.mesh.shard_batch``). With ``datagen`` = (DataConfig, bank) the
    step takes no batch: it draws its scenes on the device from the state's
    generator (``data.generate_batch``, cfg.batch_size images; with
    ``mesh`` this rank's slice of them, ``data.sharded.generate_host_local``)
    and logs the detection metrics against them. ``steps_per_call`` = K
    (datagen only) runs K steps per call, with the metrics stacked on a
    leading (K,) axis; it equals K calls of one step.

    On a CUDA device the first call runs one step eagerly and captures one
    step as a CUDA graph; every other step, K a call, is a replay of it,
    bound to that call's state (``parallel/captured.py``). With
    ``render_topk`` (``render.py::topk_branches``) the step is captured as
    segments around the render's branch, A replayed, the branch read on the
    host, then the branch's B (``captured.SegmentedStep``). With ``mesh``
    the collectives are inside the graphs: every rank captures at its
    first call and replays in step with the others. The step stays eager
    where ``captured.eager_reason`` gives a reason (the CPU, the NaN
    hunter), decided at the first call, or when ``eager`` is set: the A/B
    of the two forms in ``chip_smoke.py``, ``tools/dp_check.py`` and the
    tests.

    With ``render_topk`` the returned function's ``branches`` (a
    ``captured.Branches``) counts the branch each step took, eager or
    captured; it is None otherwise."""
    if steps_per_call > 1 and datagen is None:
        raise ValueError("steps_per_call > 1 needs datagen")

    # a step is head(state, *batch) -> carry, the predicate, then
    # tail(state, carry, topk); carry = (train_step_head's, (gt_bbox,
    # gt_count))
    if datagen is not None:
        dcfg, bank = datagen

        def head(state):
            if mesh is None:
                x, gt_bbox, gt_count = generate_batch(
                    state.generator, bank, cfg.batch_size, dcfg)
            else:
                x, gt_bbox, gt_count = generate_host_local(
                    state.generator, bank, dcfg, cfg.batch_size,
                    mesh.n_data, mesh.data_rank)
            return train_step_head(cfg, state, x, mesh=mesh), (gt_bbox,
                                                               gt_count)
    elif with_detection:
        def head(state, x, gt_bbox, gt_count):
            return train_step_head(cfg, state, x, mesh=mesh), (gt_bbox,
                                                               gt_count)
    else:
        def head(state, x):
            return train_step_head(cfg, state, x, mesh=mesh), (None, None)

    def tail(state, carry, topk, retain_graph=False):
        return train_step_tail(cfg, state, carry[0], topk, *carry[1],
                               mesh=mesh, retain_graph=retain_graph)

    def predicate(carry):
        return carry[0]["live_at_most_k"]

    branches = Branches() if topk_branches(cfg) else None

    def one_step(state, *batch):
        carry = head(state, *batch)
        topk = takes_topk(predicate(carry))
        if branches is not None:
            branches.took(topk)
        return tail(state, carry, topk)

    def eager_steps(state, *batch):
        if steps_per_call == 1:
            return state, one_step(state, *batch)
        ms = [one_step(state) for _ in range(steps_per_call)]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    run = None  # chosen at the first call, from the state's device

    def step_fn(state, batch=None):
        nonlocal run
        if run is None:
            captured = not eager and eager_reason(
                cfg, state.step.device, mesh) is None
            if not captured:
                run = eager_steps
            elif branches is not None:
                run = SegmentedStep(head, tail, predicate, steps_per_call,
                                    branches)
            else:
                run = CapturedStep(one_step, steps_per_call)
        if branches is not None:
            branches.new_call()
        if batch is None:
            return run(state)
        return run(state, *(batch if with_detection else (batch,)))
    step_fn.branches = branches
    return step_fn


def make_eval_step(cfg: SpairConfig, mesh: Optional[Mesh] = None,
                   eager: bool = False):
    """Returns eval(params, x, step, generator) -> (loss, aux): ``forward``
    without gradients.

    With ``mesh`` (the JAX ``make_eval_step(cfg, mesh)``), x is this rank's
    slice of the global batch (its data rank's, ``shard_batch``) and the
    generator is in the same state on every rank: each rank draws the
    global batch's noise and keeps its slice, runs the inference's model
    axis as the train step does, and returns what one process returns for
    the global batch: the loss and the loss terms summed over the data
    ranks (``reduce_metrics``' rule) and every batched output gathered
    over them, in one all-gather each.

    On a CUDA device it is captured, as the JAX package jits it: one CUDA
    graph for each shape of x, with x and the step (a tensor, or a number
    filled into the graph's step before each replay) as static inputs and
    the generator of the first call registered with the graph
    (``parallel/captured.py``; with ``mesh`` the collectives inside it);
    with ``render_topk``, segments around the render's branch
    (``captured.SegmentedForward``), and the returned function's
    ``branches`` counts the branch each call took (None otherwise). A call
    with another generator, or other parameters, raises. It stays eager
    where ``forward_eager_reason`` gives a reason (the CPU, the NaN hunter),
    decided at the first call, or when ``eager`` is set."""
    branches = Branches() if topk_branches(cfg) else None

    @torch.no_grad()
    def head(params, x, step, generator):
        return _head(params, cfg, x, step, generator, None, mesh)

    @torch.no_grad()
    def tail(params, carry, topk):
        loss, aux = forward_tail(params, cfg, carry, topk,
                                 carry["batch_share"])
        return (loss, aux) if mesh is None else _gather_eval(mesh, aux)

    def predicate(carry):
        return carry["live_at_most_k"]

    def eval_fn(params, x, step, generator):
        carry = head(params, x, step, generator)
        topk = takes_topk(predicate(carry))
        if branches is not None:
            branches.new_call()
            branches.took(topk)
        return tail(params, carry, topk)

    program = None  # chosen at the first call, from x's device

    def step_fn(params, x, step, generator):
        nonlocal program
        if program is None:
            program = eval_fn
            if not eager and forward_eager_reason(cfg, x.device) is None:
                if branches is not None:
                    program = SegmentedForward(
                        lambda p, x, s: head(p, x, s, generator), tail,
                        predicate, generator=generator, branches=branches)
                else:
                    program = CapturedForward(
                        lambda p, x, s: eval_fn(p, x, s, generator),
                        generator=generator)
        if program is eval_fn:
            return eval_fn(params, x, step, generator)
        if generator is not program.generator:
            raise RuntimeError("this captured eval step draws from the "
                               "generator of its first call; build a new "
                               "step with make_eval_step")
        return program(params, x, step)
    step_fn.branches = branches
    return step_fn


def _gather_eval(mesh: Mesh, aux):
    """(loss, aux) of the global batch from this data rank's ``aux``: the
    loss terms reduced as the train step's metrics are (``losses/*``
    summed), the loss their total, every batched output gathered."""
    terms = reduce_metrics(mesh, aux["losses"])
    batched = [k for k, v in aux.items() if torch.is_tensor(v) and v.ndim]
    out = dict(aux, losses=terms)
    out.update(zip(batched, gather_batch(mesh, [aux[k] for k in batched])))
    return terms["losses/total"], out
