"""Latent-math primitives (counterpart of ``spair_pytorch_tpu/ops/math.py``).

Forward semantics only: the custom gradients the JAX package attaches to the
analytical sigmoid and the BCE belong to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def latent_to_mean_std(latent):
    """Split the last axis in half: (mean, 2 * sigmoid(clamp(log_std, ±10)))."""
    mean, log_std = torch.chunk(latent, 2, dim=-1)
    return mean, 2.0 * torch.sigmoid(torch.clamp(log_std, -10.0, 10.0))


def clamped_sigmoid(logit, use_analytical: bool = False):
    """sigmoid(clamp(logit, -10, 10)); with ``use_analytical`` the unclamped
    1 / (exp(-x) + 1) the decoder output path uses."""
    if use_analytical:
        return 1.0 / (torch.exp(-logit) + 1.0)
    return torch.sigmoid(torch.clamp(logit, -10.0, 10.0))


def safe_log(t):
    """log(t + 1e-9), with the argument clamped at 1e-9 so that a compiler
    reassociating ``(1 - p) + 1e-9`` cannot produce log(0) at p == 1."""
    return torch.log(torch.clamp(t + 1e-9, min=1e-9))


def gaussian_kl(mean_q, std_q, mean_p, std_p):
    """KL(N(mean_q, std_q) || N(mean_p, std_p)), elementwise."""
    var_ratio = torch.square(std_q / std_p)
    t1 = torch.square((mean_q - mean_p) / std_p)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def bernoulli_kl(prob_q, prob_p):
    """KL(Bern(prob_q) || Bern(prob_p)) with safe_log on every term."""
    return (prob_q * (safe_log(prob_q) - safe_log(prob_p))
            + (1.0 - prob_q) * (safe_log(1.0 - prob_q)
                                - safe_log(1.0 - prob_p)))


def binary_cross_entropy_sum(recon, target):
    """Sum-reduced BCE. ``F.binary_cross_entropy`` clamps each log term at
    -100, which is the semantics the JAX package emulates, and its native
    backward is the one that package's custom VJP reproduces."""
    return F.binary_cross_entropy(recon, target, reduction="sum")
