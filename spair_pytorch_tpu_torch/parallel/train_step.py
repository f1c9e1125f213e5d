"""Eval step (counterpart of ``spair_pytorch_tpu/parallel/
train_step.py::make_eval_step``). The train step, Adam and data
parallelism belong to the training slice."""

from __future__ import annotations

import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.models.spair import forward


def make_eval_step(cfg: SpairConfig):
    """Returns eval(params, x, step, generator) -> (loss, aux): ``forward``
    without gradients."""

    def eval_fn(params, x, step, generator):
        with torch.no_grad():
            return forward(params, cfg, x, step, generator)

    return eval_fn
