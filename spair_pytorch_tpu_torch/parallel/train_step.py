"""Training and eval steps (counterpart of ``spair_pytorch_tpu/parallel/
train_step.py``, single device).

A step is forward, backward, optional global-norm clipping and Adam with
the reference's settings (lr from the config, betas (0.9, 0.999), eps 1e-8).
It updates the ``TrainState`` in place and returns it with its metrics,
which stay on the device: a step makes no host sync. Data parallelism and
the JAX package's mesh arguments belong to a later slice. ``scan_remat`` and
``scan_remat_policy`` change memory, not values, and are ignored here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from spair_pytorch_tpu_torch import metrics as metric
from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.data import generate_batch
from spair_pytorch_tpu_torch.models.latents import SpairModel, init_params
from spair_pytorch_tpu_torch.models.spair import forward
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
    config, betas (0.9, 0.999), eps 1e-8). Clipping is done by the step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


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
               gt_count=None, noise=None) -> Dict[str, torch.Tensor]:
    """One step on images x (B, C, H, W): forward with the state's
    generator (or the given ``noise``), backward, Adam. Updates ``state``
    in place; returns the metric dict of the JAX step: the loss terms,
    ``training_wheel``, the presence-count and gradient-norm diagnostics,
    and with ``gt_bbox``/``gt_count`` the four ``accuracy/*`` tags."""
    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=False)
    loss, aux = forward(model, cfg, x, state.step, state.generator, noise)
    loss.backward()
    # a parameter the loss does not reach has a zero gradient, as in JAX:
    # Adam still decays its moments
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)

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
    opt.step()
    state.step += 1
    return {k: v.detach() for k, v in out.items()}


def make_train_step(cfg: SpairConfig, with_detection: bool = False,
                    datagen=None, steps_per_call: int = 1):
    """Returns step(state[, batch]) -> (state, metrics).

    ``batch`` is the image tensor, or (x, gt_bbox, gt_count) with
    ``with_detection``, which adds the detection metrics of the training
    forward's own latents. With ``datagen`` = (DataConfig, bank) the step
    takes no batch: it draws its scenes on the device from the state's
    generator (``data.generate_batch``, cfg.batch_size images) and logs the
    detection metrics against them. ``steps_per_call`` = K (datagen only)
    runs K steps per call, with the metrics stacked on a leading (K,) axis;
    it equals K calls of one step."""
    if steps_per_call > 1 and datagen is None:
        raise ValueError("steps_per_call > 1 needs datagen")

    if datagen is not None:
        dcfg, bank = datagen

        def one_step(state):
            x, gt_bbox, gt_count = generate_batch(
                state.generator, bank, cfg.batch_size, dcfg)
            return train_step(cfg, state, x, gt_bbox, gt_count)

        def step_fn(state):
            if steps_per_call == 1:
                return state, one_step(state)
            ms = [one_step(state) for _ in range(steps_per_call)]
            return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    elif with_detection:
        def step_fn(state, batch):
            x, gt_bbox, gt_count = batch
            return state, train_step(cfg, state, x, gt_bbox, gt_count)
    else:
        def step_fn(state, x):
            return state, train_step(cfg, state, x)
    return step_fn


def make_eval_step(cfg: SpairConfig):
    """Returns eval(params, x, step, generator) -> (loss, aux): ``forward``
    without gradients."""

    def eval_fn(params, x, step, generator):
        with torch.no_grad():
            return forward(params, cfg, x, step, generator)

    return eval_fn
