"""Annealing schedules (counterpart of ``spair_pytorch_tpu/ops/schedules.py``)."""

from __future__ import annotations

import torch

from spair_pytorch_tpu_torch.config import Schedule


def exponential_decay(step, sched: Schedule, device=None):
    """value = (start - end) * rate**t + end with t = step / decay_step,
    computed in float32 as a 0-d tensor on ``device``.

    ``staircase`` floors t (rate 0 gives exactly 1.0 before decay_step,
    because 0**0 == 1, and 0.0 from there on: the training-wheel cliff);
    ``log_space`` returns log(value + 1e-6)."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    if sched.staircase:
        t = torch.div(step, sched.decay_step, rounding_mode="floor")
    else:
        t = step / sched.decay_step
    # a fill, not a copy from the host: the step is captured as a CUDA graph
    rate = torch.full((), sched.decay_rate, dtype=torch.float32,
                      device=device)
    value = (sched.start - sched.end) * torch.pow(rate, t) + sched.end
    if sched.log_space:
        value = torch.log(value + 1e-6)
    return value
