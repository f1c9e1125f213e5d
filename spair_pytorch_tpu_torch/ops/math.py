"""Latent-math primitives (counterpart of ``spair_pytorch_tpu/ops/math.py``).

The analytical sigmoid carries the JAX package's custom derivative as an
``autograd.Function``; the BCE keeps ``F.binary_cross_entropy``, whose
native backward is the one the JAX package's custom VJP reproduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def latent_to_mean_std(latent):
    """Split the last axis in half: (mean, 2 * sigmoid(clamp(log_std, ±10)))."""
    mean, log_std = torch.chunk(latent, 2, dim=-1)
    return mean, 2.0 * torch.sigmoid(torch.clamp(log_std, -10.0, 10.0))


def freeze_learning(v, tw):
    """tw * v.detach() + (1 - tw) * v: the value of v, with gradients
    blocked while the training wheel is on."""
    return tw * v.detach() + (1.0 - tw) * v


class AnalyticalSigmoid(torch.autograd.Function):
    """1 / (exp(-x) + 1) with the derivative s * (1 - s).

    Autograd through the expression gives exp(-x) / (exp(-x) + 1)^2, which
    is inf / inf = NaN once x < ~-88 in f32; the decoder's colour logits
    drift that negative for black pixels during training. s * (1 - s) is
    the same derivative without the overflow (the JAX package's custom
    JVP, ``spair_pytorch_tpu/ops/math.py::_analytical_sigmoid``)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (torch.exp(-x) + 1.0)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return s * (1.0 - s) * g


def clamped_sigmoid(logit, use_analytical: bool = False):
    """sigmoid(clamp(logit, -10, 10)); with ``use_analytical`` the unclamped
    1 / (exp(-x) + 1) the decoder output path uses."""
    if use_analytical:
        return AnalyticalSigmoid.apply(logit)
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
    backward, (r - t) / max(r (1 - r), 1e-12), is the one that package's
    custom VJP reproduces: finite at recon values of exactly 0 and 1."""
    return F.binary_cross_entropy(recon, target, reduction="sum")


def logistic_noise(generator: torch.Generator, shape, eps: float = 1e-9,
                   device=None):
    """log(u + eps) - log(1 - u + eps), u ~ U(0, 1) drawn from
    ``generator`` on ``device`` (by default the generator's): the
    relaxed-Bernoulli noise of the reference's presence sample (its eps,
    10e-10, is 1e-9)."""
    if device is None:
        device = generator.device
    u = torch.rand(shape, generator=generator, device=device)
    return torch.log(u + eps) - torch.log(1.0 - u + eps)
