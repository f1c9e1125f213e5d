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
from spair_pytorch_tpu_torch.ops.kernels import cell_glue as glue
from spair_pytorch_tpu_torch.ops.math import logistic_noise
from spair_pytorch_tpu_torch.ops.mlp import MLP
from spair_pytorch_tpu_torch.ops.stn import crop_with_weights


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


def cell_step(params: SpairModel, cfg: SpairConfig, geom, image, feat_cells,
              context, noise: Dict, cell_hw, tw, dtype=None):
    """Run every head for a set of K cells in parallel.

    image (B, C, H, W); feat_cells (B, K, F); context (B, K, context_dim);
    noise {name: (B, K, ·)}; cell_hw (K, 2) long cell coordinates; tw the
    training-wheel scalar (a 0-d float32 tensor on the inputs' device);
    ``dtype`` the compute dtype of the MLPs and the glimpse crop (None for
    float32). With S = n_object_slots > 1 every per-object quantity carries
    a slot axis inside and is folded slot-major into the last dim on
    return. Returns the sampled latents, the posterior (mean, std) pairs
    under the reference's names, the presence probability and the S*56-dim
    context vector each cell shows its neighbours.

    The products (the four MLPs and the crop's two einsums) run here; the
    elementwise chains between them are the five segments of
    ``ops/kernels/cell_glue.py``, each one kernel forward and one backward
    on CUDA tensors and its plain version on CPU tensors. The MLPs' head
    outputs go to the segments as the products made them (bf16 with bf16
    compute); every latent is float32. A tensor that several segments read
    sums its cotangents in autograd in the order of the segments' creation,
    latest first, and the segment that made it adds its own use last: the
    order in which autograd summed them when this was one composition."""
    s = cfg.n_object_slots
    g = glue.geometry_of(cfg, geom)
    stick = s > 1 and cfg.slot_coupling == "stick"

    def fold(t):  # (B, K, S, d) -> (B, K, S*d)
        return t.reshape(t.shape[0], t.shape[1], -1)

    # --- z_where ---
    x_box, fc = glue.BoxIn.apply(feat_cells, context, dtype)
    box_head, passthru = params.box_network(
        x_box, packed=cfg.packed_heads, dtype=dtype, promote=False)
    out = glue.Box.apply(box_head, noise["box"], tw, cell_hw, g, s, dtype)
    (cy_m, cx_m, h_m, w_m), (cy_s, cx_s, h_s, w_s) = out[:4], out[4:8]
    box, z_where, wy, wx = out[8:]

    # --- z_what ---
    glimpses = crop_with_weights(image, wy, wx, dtype)  # (B, K*S, C, oh, ow)
    b, n = glimpses.shape[:2]
    if cfg.object_codec == "conv":
        attr_latent = params.object_encoder(glimpses, dtype=dtype)
    else:
        attr_latent = params.object_encoder(glimpses.reshape(b, n, -1),
                                            dtype=dtype, promote=False)[0]
    attr_mean, attr_std, attr, z_in, fc3 = glue.AttrZ.apply(
        attr_latent, noise["attr"], fc, passthru, box, dtype)

    # --- z_depth ---
    depth_head, passthru2 = params.z_network(
        z_in, packed=cfg.packed_heads, dtype=dtype, promote=False)
    depth_mean, depth_std, depth, obj_in = glue.DepthObj.apply(
        depth_head, passthru2, noise["depth"], tw, fc3, box, attr, dtype)

    # --- z_pres ---
    pres_head = params.obj_network(obj_in, dtype=dtype, promote=False)[0]
    pres, ctx_vec = glue.Pres.apply(pres_head, noise["pres_noise"], tw, box,
                                    attr, depth, stick)

    posterior = {
        "cy_logit": (cy_m, cy_s),
        "cx_logit": (cx_m, cx_s),
        "height_logit": (h_m, h_s),
        "width_logit": (w_m, w_s),
        "attr": (fold(attr_mean), fold(attr_std)),
        "depth_logit": (depth_mean, depth_std),
    }
    return {
        "z_where": fold(z_where),
        "z_attr": fold(attr),
        "z_depth": depth,
        "z_pres": fold(pres),
        "z_pres_prob": fold(pres),
        "posterior": posterior,
        "context_vec": ctx_vec,
    }
