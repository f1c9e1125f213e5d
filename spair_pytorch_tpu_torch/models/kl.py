"""KL terms (counterpart of ``spair_pytorch_tpu/models/kl.py``): the
independent Gaussian latents and the count prior, as the sequential chain
or in its parallel (telescoped) form."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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


def count_prior_kl_parallel(z_pres_prob, z_pres, step, cfg: SpairConfig):
    """The count-prior KL of ``count_prior_kl`` without the sequential
    chain. (B, gh, gw, 1) -> (B, gh, gw, 1).

    The chain's count updates use the rounded samples, known up front, so
    the count distribution telescopes: cd_i is proportional to cd_0 times
    the exclusive cumulative product M_i of the per-cell factors, and
    p_z_i = sum_k cd_0[k] M_i[k] p_i[k] / sum_k cd_0[k] M_i[k], computed in
    log space with a per-cell max shift over one (B, HW, HW + 1) block. It
    equals the chain wherever the chain's 1e-6 normalizer clamp does not
    bind; where it binds, this is the exact telescoped value.

    Kept from the JAX package: log cd_0[k] = k log sigmoid(log_odds)
    (cd_0 itself underflows f32), taken with ``logsigmoid``, which is exact
    where ``softplus`` turns into the identity above its threshold; the
    clip of each factor to [0, 1] and the -1e30 floor on its log, so a
    zero factor adds no -inf to the cumulative sums. p_z is computed under
    no_grad, the counterpart of JAX's stop_gradient: it has no parameter
    gradient, and the log(0) intermediates would give 0 * inf = NaN in a
    naive backward. Gradients reach the KL through z_pres_prob only."""
    b, gh, gw, _ = z_pres_prob.shape
    hw = gh * gw
    device = z_pres_prob.device
    f32 = torch.float32
    with torch.no_grad():
        support = torch.arange(hw + 1, dtype=f32, device=device)
        log_odds = exponential_decay(step, cfg.count_prior, device)
        log_cd0 = support * F.logsigmoid(log_odds)
        samples = torch.round(z_pres.reshape(b, hw))
        csf = torch.cumsum(samples, dim=1) - samples  # exclusive prefix
        rem = (hw - torch.arange(hw, dtype=f32, device=device))[None, :, None]
        p = torch.minimum(torch.clamp(support - csf[..., None], min=0.0),
                          rem) / rem                        # (B, HW, HW+1)
        s = samples[..., None]
        mult = torch.clamp(s * p + (1.0 - s) * (1.0 - p), 0.0, 1.0)
        log_mult = torch.clamp(torch.log(mult), min=-1e30)
        l_incl = torch.cumsum(log_mult, dim=1)
        l_excl = torch.cat([torch.zeros((b, 1, hw + 1), dtype=f32,
                                        device=device), l_incl[:, :-1]],
                           dim=1)
        logits = log_cd0 + l_excl
        w = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
        p_z = torch.clamp(torch.sum(w * p, dim=-1) / torch.sum(w, dim=-1),
                          0.0, 1.0)
    kls = bernoulli_kl(z_pres_prob.reshape(b, hw), p_z)
    return kls.reshape(b, gh, gw, 1)
