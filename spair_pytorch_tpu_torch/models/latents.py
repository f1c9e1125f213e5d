"""SPAIR latent heads: parameters and the per-cell inference step
(counterpart of ``spair_pytorch_tpu/models/latents.py``).

``cell_step`` runs every head for a batch of K cells at once; all draws are
made up front (``sample_noise``) so every inference order computes the same
function of (params, x, noise).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.ops.backbone import (Backbone, grid_geometry,
                                                  reset_fan_in_)
from spair_pytorch_tpu_torch.ops.convcodec import ConvDecoder, ConvEncoder
from spair_pytorch_tpu_torch.ops.math import (clamped_sigmoid,
                                              latent_to_mean_std,
                                              logistic_noise)
from spair_pytorch_tpu_torch.ops.mlp import MLP
from spair_pytorch_tpu_torch.ops.stn import crop_glimpses


def geometry(cfg: SpairConfig):
    """(pads, (grid_h, grid_w), (cell_h, cell_w)) for the configured image."""
    return grid_geometry(cfg.image_shape[1:], cfg.backbone_topology)


class SelfAttention(nn.Module):
    """The reference's discarded SAGAN block: per-cell linear ``query``,
    ``key`` (d -> d // 8) and ``value`` (d -> d) maps and a ``gamma`` that
    its forward never applies."""

    def __init__(self, d: int):
        super().__init__()
        self.query = MLP(d, (), (d // 8,))
        self.key = MLP(d, (), (d // 8,))
        self.value = MLP(d, (), (d,))
        self.gamma = nn.Parameter(torch.zeros(1))


class SpairModel(nn.Module):
    """Every network of the model, named after the reference state_dict:
    ``backbone``, ``box_network``, ``object_encoder``, ``z_network``,
    ``obj_network``, ``object_decoder`` and ``virtual_edge_element``; with
    ``vestigial_self_attn`` also ``self_attn``. With ``object_codec='conv'``
    the encoder and decoder are ``ops/convcodec.py``'s."""

    def __init__(self, cfg: SpairConfig):
        super().__init__()
        c, oh, ow = cfg.n_channels, cfg.object_shape[0], cfg.object_shape[1]
        n_feat, n_pass = cfg.n_backbone_features, cfg.n_passthrough_features
        ctx, a = cfg.context_dim, cfg.n_attributes
        z_in = 4 + a + n_pass + ctx + n_feat
        pads = geometry(cfg)[0]
        self.backbone = Backbone(c, n_feat, cfg.backbone_topology, pads)
        # the box head widens to 8 per slot: slot-specific head weights
        self.box_network = MLP(n_feat + ctx, cfg.mlp_hidden,
                               (8 * cfg.n_object_slots, n_pass))
        if cfg.object_codec == "conv":
            self.object_encoder = ConvEncoder(c, 2 * a, (oh, ow))
        else:
            self.object_encoder = MLP(c * oh * ow, cfg.encoder_hidden,
                                      (2 * a,))
        self.z_network = MLP(z_in, cfg.mlp_hidden, (2, n_pass))
        self.obj_network = MLP(z_in + 1, cfg.mlp_hidden, (1,))
        if cfg.object_codec == "conv":
            self.object_decoder = ConvDecoder(a, c + 1, (oh, ow))
        else:
            self.object_decoder = MLP(a, cfg.decoder_hidden,
                                      (oh * ow * (c + 1),))
        self.virtual_edge_element = nn.Parameter(
            torch.zeros(cfg.context_elem_dim))
        if cfg.vestigial_self_attn:
            # over the 4 + A + 1 (box, attr, depth) dims of a cell's context
            self.self_attn = SelfAttention(4 + a + 1)


def init_params(cfg: SpairConfig, generator: torch.Generator = None,
                device="cuda") -> SpairModel:
    """A freshly initialized model on ``device``.

    Weights are drawn on the CPU from ``generator`` (a CPU generator seeded
    with ``cfg.seed`` when omitted), so a seed gives the same parameters on
    every device. Linear and conv layers take torch's default fan-in
    uniform init; the edge element is the reference's random normal with
    sigmoid applied once to its loc/depth/pres slices."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = SpairModel(cfg)
    reset_fan_in_(model, generator)
    with torch.no_grad():
        model.virtual_edge_element.copy_(_init_edge_element(cfg, generator))
    return model.to(device)


def _init_edge_element(cfg: SpairConfig, generator: torch.Generator):
    t = torch.randn(cfg.context_elem_dim, generator=generator)
    t = t.reshape(cfg.n_object_slots, -1)  # (S, 56): one pattern per slot
    a = cfg.n_attributes
    loc, attr, depth, pres = torch.split(t, [4, a, 1, 1], dim=-1)
    out = torch.cat([torch.sigmoid(loc), attr, torch.sigmoid(depth),
                     torch.sigmoid(pres)], dim=-1)
    return out.reshape(-1)


def noise_shapes(batch: int, grid_hw: Tuple[int, int], cfg: SpairConfig):
    """Shape of each per-cell draw of one forward pass (slot-major)."""
    gh, gw = grid_hw
    s = cfg.n_object_slots
    return {"box": (batch, gh, gw, 4 * s),
            "attr": (batch, gh, gw, cfg.n_attributes * s),
            "depth": (batch, gh, gw, s),
            "pres_noise": (batch, gh, gw, s)}


def sample_noise(generator: torch.Generator, batch: int,
                 grid_hw: Tuple[int, int], cfg: SpairConfig, device=None):
    """Every stochastic draw of one forward pass: standard normals for the
    box, attr and depth latents and ``logistic_noise`` for presence, on
    ``device`` (by default the generator's, where it must live)."""
    if device is None:
        device = generator.device
    shapes = noise_shapes(batch, grid_hw, cfg)
    out = {name: torch.randn(shapes[name], generator=generator, device=device)
           for name in ("box", "attr", "depth")}
    out["pres_noise"] = logistic_noise(generator, shapes["pres_noise"],
                                       device=device)
    return out


def apply_self_attn(params: SelfAttention, ctx):
    """The reference's Self_Attn over the grid of (box, attr, depth) cell
    vectors, which it computes every forward and discards: ctx (B, N, d)
    -> softmax(q k^T) v, (B, N, d). 1x1 convs over the grid are per-cell
    linears here; gamma and the residual are not applied, as in the
    reference's forward."""
    q = params.query(ctx)[0]                            # (B, N, d // 8)
    k = params.key(ctx)[0]                              # (B, N, d // 8)
    v = params.value(ctx)[0]                            # (B, N, d)
    attn = torch.softmax(torch.einsum("bid,bjd->bij", q, k), dim=-1)
    return torch.einsum("bij,bjd->bid", attn, v)


def freeze_learning(v, tw):
    """tw * v.detach() + (1 - tw) * v: the value of v, with gradients
    blocked while the training wheel is on."""
    return tw * v.detach() + (1.0 - tw) * v


def cell_step(params: SpairModel, cfg: SpairConfig, geom, image, feat_cells,
              context, noise: Dict, cell_hw, tw, dtype=None):
    """Run every head for a set of K cells in parallel.

    image (B, C, H, W); feat_cells (B, K, F); context (B, K, context_dim);
    noise {name: (B, K, ·)}; cell_hw (K, 2) long cell coordinates; tw the
    training-wheel scalar; ``dtype`` the compute dtype of the MLPs and the
    glimpse crop (None for float32); the MLP outputs return in float32.
    With S = n_object_slots > 1 every per-object quantity carries a slot
    axis inside and is folded slot-major into the last dim on return.
    Returns the sampled latents, the posterior (mean, std) pairs under the
    reference's names, the presence probability and the S*56-dim context
    vector each cell shows its neighbours."""
    _, _, cell_px = geom
    img_h, img_w = cfg.image_shape[1:]
    s = cfg.n_object_slots
    b, k = feat_cells.shape[:2]

    def per_slot(t):  # (B, K, S*d) -> (B, K, S, d)
        return t.reshape(b, k, s, -1)

    def fold(t):  # (B, K, S, d) -> (B, K, S*d)
        return t.reshape(b, k, -1)

    def shared(t):  # (B, K, D) -> (B, K, S, D)
        return t[:, :, None].expand(b, k, s, t.shape[-1])

    # --- z_where ---
    box_latent, passthru = params.box_network(
        torch.cat([feat_cells, context], dim=-1), packed=cfg.packed_heads,
        dtype=dtype)
    mean, std = latent_to_mean_std(per_slot(box_latent))    # (B, K, S, 4)
    mean, std = freeze_learning(mean, tw), freeze_learning(std, tw)
    box_logits = mean + std * per_slot(noise["box"])  # order (cy, cx, h, w)
    cy_l, cx_l, h_l, w_l = torch.split(box_logits, 1, dim=-1)

    yx_range = cfg.max_yx - cfg.min_yx
    cell_y = yx_range * clamped_sigmoid(cy_l) + cfg.min_yx
    cell_x = yx_range * clamped_sigmoid(cx_l) + cfg.min_yx
    hw_range = cfg.max_hw - cfg.min_hw
    height = hw_range * clamped_sigmoid(h_l) + cfg.min_hw
    width = hw_range * clamped_sigmoid(w_l) + cfg.min_hw

    box = torch.cat([cell_x, cell_y, width, height], dim=-1)  # x-first

    ys = height * cfg.anchor_shape[0] / img_h
    xs = width * cfg.anchor_shape[1] / img_w
    h_idx = cell_hw[:, 0].to(torch.float32)[None, :, None, None]
    w_idx = cell_hw[:, 1].to(torch.float32)[None, :, None, None]
    yt = (cell_px[0] / img_h) * (cell_y + h_idx)
    xt = (cell_px[1] / img_w) * (cell_x + w_idx)
    z_where = torch.cat([xt, yt, xs, ys], dim=-1)            # (B, K, S, 4)

    # --- z_what ---
    glimpses = crop_glimpses(image, z_where.reshape(b, k * s, 4),
                             cfg.object_shape, dtype)      # (B, K*S, C, oh, ow)
    if cfg.object_codec == "conv":
        attr_latent = params.object_encoder(glimpses, dtype=dtype)
    else:
        attr_latent = params.object_encoder(glimpses.reshape(b, k * s, -1),
                                            dtype=dtype)[0]
    attr_mean, attr_std = latent_to_mean_std(attr_latent.reshape(b, k, s, -1))
    attr = attr_mean + attr_std * per_slot(noise["attr"])

    # --- z_depth ---
    z_in = torch.cat([shared(feat_cells), shared(context), shared(passthru),
                      box, attr], dim=-1)
    depth_latent, passthru2 = params.z_network(z_in, packed=cfg.packed_heads,
                                               dtype=dtype)
    depth_mean, depth_std = latent_to_mean_std(depth_latent)
    depth_mean = freeze_learning(depth_mean, tw)
    depth_std = freeze_learning(depth_std, tw)
    depth = 4.0 * clamped_sigmoid(depth_mean
                                  + depth_std * per_slot(noise["depth"]))

    # --- z_pres ---
    obj_in = torch.cat([shared(feat_cells), shared(context), passthru2, box,
                        attr, depth], dim=-1)
    pres_logit = freeze_learning(params.obj_network(obj_in, dtype=dtype)[0],
                                 tw)
    stick = s > 1 and cfg.slot_coupling == "stick"
    if stick:
        # ordered stick-breaking: later slots start biased off
        offset = -2.0 * torch.arange(s, dtype=pres_logit.dtype,
                                     device=pres_logit.device)
        pres_logit = pres_logit + offset[None, None, :, None]
    log_odds = torch.clamp(pres_logit, -10.0, 10.0)
    pres_prob = torch.sigmoid(log_odds + per_slot(noise["pres_noise"]))
    if stick:
        pres_prob = torch.cumprod(pres_prob, dim=2)
    pres = pres_prob  # the relaxed sample is the probability itself

    ctx_vec = fold(torch.cat([box, attr, depth, pres], dim=-1))

    cy_m, cx_m, h_m, w_m = torch.split(mean, 1, dim=-1)
    cy_s, cx_s, h_s, w_s = torch.split(std, 1, dim=-1)
    posterior = {
        "cy_logit": (fold(cy_m), fold(cy_s)),
        "cx_logit": (fold(cx_m), fold(cx_s)),
        "height_logit": (fold(h_m), fold(h_s)),
        "width_logit": (fold(w_m), fold(w_s)),
        "attr": (fold(attr_mean), fold(attr_std)),
        "depth_logit": (fold(depth_mean), fold(depth_std)),
    }
    return {
        "z_where": fold(z_where),
        "z_attr": fold(attr),
        "z_depth": fold(depth),
        "z_pres": fold(pres),
        "z_pres_prob": fold(pres_prob),
        "posterior": posterior,
        "context_vec": ctx_vec,
    }
