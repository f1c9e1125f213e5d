"""The reference's own runs: the first training steps from the program's
starting point, in a given precision."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from perfbench.reference import spair
from perfbench.reference.inputs import reference_model, scenes, step_noise


@contextlib.contextmanager
def products_in(prec: spair.Precision):
    """TF32 for the products while 'tf32' is asked for, off otherwise."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = prec.name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def train_steps(cfg: spair.Config, weights: Dict[str, torch.Tensor],
                generator_state, bank, batch: int, n_steps: int, device,
                prec: spair.Precision = spair.F32, first_step: int = 0):
    """``n_steps`` training steps from ``weights``, the first numbered
    ``first_step`` (the schedules read it), drawing scenes and noise from a
    generator in ``generator_state``, as a training step does:
    forward, backward, the global-norm clip (optax's rule) when the
    configuration sets one, Adam (lr from the configuration, betas (0.9,
    0.999), eps 1e-8). Returns {'losses': [float] * n_steps, 'grad1': the
    first step's clipped gradients, 'params': the parameters after the
    last step}, every tensor by parameter name."""
    model = reference_model(cfg, weights, device)
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=device)
    gen.set_state(generator_state)
    hw = tuple(cfg.image_shape[1:])
    out = {"losses": []}
    with products_in(prec):
        for step in range(n_steps):
            x, _, _ = scenes(gen, bank, batch, hw, cfg.min_scene_objects,
                             cfg.max_scene_objects, cfg.image_shape[0])
            noise = step_noise(gen, batch, cfg)
            opt.zero_grad(set_to_none=False)
            total, _ = spair.loss(model, cfg, x, noise, first_step + step,
                                  prec)
            total.backward()
            grads = []
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
                with torch.no_grad():
                    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                    if float(norm) >= cfg.grad_clip_norm:
                        for g in grads:
                            g.mul_(cfg.grad_clip_norm / norm)
            if step == 0:
                out["grad1"] = {k: p.grad.detach().clone()
                                for k, p in params.items()}
            opt.step()
            out["losses"].append(float(total.detach()))
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    return out
