"""KL terms (counterpart of ``spair_pytorch_tpu/models/kl.py``): the
independent Gaussian latents and the sequential count-prior chain."""

from __future__ import annotations

from typing import Dict

import torch

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.ops.math import bernoulli_kl, gaussian_kl
from spair_pytorch_tpu_torch.ops.schedules import exponential_decay


def independent_kl(posterior: Dict, z_pres, cfg: SpairConfig) -> Dict:
    """{name: z_pres * KL(posterior || prior)}, arrays (B, gh, gw, D)."""
    priors = dict(cfg.priors)
    out = {}
    for name, (mean, std) in posterior.items():
        p_mean, p_std = priors[name]
        out[name] = z_pres * gaussian_kl(mean, std, p_mean, p_std)
    return out


def count_prior_kl(z_pres_prob, z_pres, step, cfg: SpairConfig):
    """Presence KL against the annealed geometric count prior, chained over
    the cells in raster order. (B, gh, gw, 1) -> (B, gh, gw, 1).

    The chain's count updates use the ROUNDED relaxed samples, which carry
    no gradient, so p_z has none either: the chain runs under no_grad, and
    gradients reach the KL through z_pres_prob only. Kept from the JAX
    package: the p_z clip to [0, 1] (float summation can overshoot 1) and
    the 1e-6 floor on the count-distribution normalizer."""
    b, gh, gw, _ = z_pres_prob.shape
    hw = gh * gw
    device = z_pres_prob.device
    with torch.no_grad():
        support = torch.arange(hw + 1, dtype=torch.float32, device=device)
        log_odds = exponential_decay(step, cfg.count_prior, device)
        prior_prob = 1.0 / (torch.exp(-log_odds) + 1.0)
        count_dist = (1.0 - prior_prob) * torch.pow(prior_prob, support)
        count_dist = (count_dist / torch.sum(count_dist)).expand(b, hw + 1)
        samples = torch.round(z_pres.reshape(b, hw))
        count_so_far = torch.zeros((b, 1), dtype=torch.float32,
                                   device=device)
        p_zs = []
        for i in range(hw):
            remaining = float(hw - i)
            p_z_given_c = torch.clamp(support[None, :] - count_so_far,
                                      0.0, remaining) / remaining
            p_zs.append(torch.clamp(
                torch.sum(count_dist * p_z_given_c, dim=-1), 0.0, 1.0))
            sample = samples[:, i:i + 1]
            mult = (sample * p_z_given_c
                    + (1.0 - sample) * (1.0 - p_z_given_c))
            new_dist = mult * count_dist
            normalizer = torch.clamp(
                torch.sum(new_dist, dim=-1, keepdim=True), min=1e-6)
            count_dist = new_dist / normalizer
            count_so_far = count_so_far + sample
        p_z = torch.stack(p_zs, dim=1)                      # (B, HW)
    kls = bernoulli_kl(z_pres_prob.reshape(b, hw), p_z)
    return kls.reshape(b, gh, gw, 1)
