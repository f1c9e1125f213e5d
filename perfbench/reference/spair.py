"""SPAIR in plain PyTorch, float32: the benchmark's frozen reference.

A copy of the model's mathematics as the benchmark holds the program to it
(Crawford & Pineau, AAAI 2019, and the repository's recipe on top of it):
the conv backbone, the per-cell heads (box, glimpse encoder, depth,
presence), the lateral-context scan over fronts of independent cells, the
Gaussian KLs and the count-prior chain, the object decoder, the
importance-weighted and the depth-ordered compositors and the pixel-sum
BCE. Written as the plainest
form of each operation: every front holds only its own cells, every
composite pastes each object over the whole canvas with hat weights, the
chain walks the cells one by one. It imports nothing of the program under
test, and takes nothing the program made: weights, scenes and noise come
from ``perfbench/reference/inputs.py``, which draws them from the seed.

Parameters carry the names of the program's ``state_dict`` so one dict of
tensors loads into both. Only the options the benchmark's configurations
use are here (one object a cell, the MLP codec, the sequential count
prior); any other option raises.

``Precision`` says how the products (linear layers, convolutions and the
glimpse crop's two contractions) round their operands: 'float32' not at all;
'fp8' to float8 with one scale a tensor, e4m3 forward and e5m2 for the
gradients the backward's products take (the control for a bfloat16
configuration); 'tf32' leaves the operands alone and the caller turns
TF32 on around the run (the control for a float32 configuration).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS_DEN = 1e-9


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient flowing back rounded by ``fn``."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _fp8(t, dtype):
    """t rounded to the float8 ``dtype`` with one scale a tensor (its
    largest magnitude at the format's largest value)."""
    top = torch.finfo(dtype).max
    amax = torch.clamp(torch.amax(torch.abs(t)), min=1e-30)
    return (t * (top / amax)).to(dtype).to(t.dtype) * (amax / top)


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, t):
        """'fp8': the operand rounded to e4m3 (its gradient passes
        unchanged); otherwise t itself."""
        if self.name != "fp8":
            return t
        d = t.detach()
        return t + (_fp8(d, torch.float8_e4m3fn) - d)

    def out(self, t):
        """'fp8': the product's gradient rounded to e5m2 on its way back,
        so the backward's products take float8 operands too."""
        if self.name != "fp8":
            return t
        return _RoundGrad.apply(
            t, lambda g: _fp8(g, torch.float8_e5m2))

    def linear(self, x, w, b):
        return self.out(F.linear(self.round(x), self.round(w),
                                 self.round(b)))

    def conv2d(self, x, w, b, stride):
        return self.out(F.conv2d(self.round(x), self.round(w),
                                 self.round(b), stride))

    def einsum(self, eq, a, b):
        return self.out(torch.einsum(eq, self.round(a), self.round(b)))


F32 = Precision("float32")


# --------------------------------------------------------------- modules

class MLP(nn.Module):
    """Linear trunk with ReLUs and linear heads, named as the program names
    them: a net of several heads keeps ``body.dense<i>`` and
    ``output_layers.<j>``, a net of one ``dense<i>`` and ``out``."""

    def __init__(self, n_in: int, hidden: Sequence[int],
                 heads: Sequence[int]):
        super().__init__()
        self.multi = len(heads) > 1
        self.n_hidden = len(hidden)
        trunk = nn.Module() if self.multi else self
        n_prev = n_in
        for i, h in enumerate(hidden):
            trunk.add_module(f"dense{i}", nn.Linear(n_prev, h))
            n_prev = h
        if self.multi:
            self.body = trunk
            self.output_layers = nn.ModuleList(
                nn.Linear(n_prev, out) for out in heads)
        else:
            self.out = nn.Linear(n_prev, heads[0])

    def heads(self):
        return list(self.output_layers) if self.multi else [self.out]

    def run(self, x, prec: Precision) -> List[torch.Tensor]:
        trunk = self.body if self.multi else self
        for i in range(self.n_hidden):
            layer = getattr(trunk, f"dense{i}")
            x = torch.relu(prec.linear(x, layer.weight, layer.bias))
        return [prec.linear(x, h.weight, h.bias) for h in self.heads()]


def grid_geometry(image_hw, topology):
    """(pads (top, bottom, left, right), (grid_h, grid_w), (cell_h,
    cell_w)): the receptive-field-aligned padding of the backbone."""
    j, r = [1, 1], [1, 1]
    for (_, k, s) in topology:
        r = [r[i] + (k - 1) * j[i] for i in range(2)]
        j = [j[i] * s for i in range(2)]
    pre = [int(math.floor(r[i] / 2 - j[i] / 2)) for i in range(2)]
    cells = [int(math.ceil(image_hw[i] / j[i])) for i in range(2)]
    post = [r[i] + (cells[i] - 1) * j[i] - image_hw[i] - pre[i]
            for i in range(2)]
    return (pre[0], post[0], pre[1], post[1]), tuple(cells), tuple(j)


class Backbone(nn.Module):
    def __init__(self, c: int, n_out: int, topology, pads):
        super().__init__()
        self.net = nn.Module()
        c_prev = c
        self.strides = []
        for i, (f, k, s) in enumerate(topology):
            self.net.add_module(f"conv_{i}", nn.Conv2d(c_prev, f, k, stride=s))
            self.strides.append(s)
            c_prev = f
        self.net.add_module("conv_out", nn.Conv2d(c_prev, n_out, 1))
        self.pads = pads

    def run(self, x, prec: Precision):
        """(B, C, H, W) -> (B, grid_h, grid_w, n_out)."""
        pt, pb, pl, pr = self.pads
        x = F.pad(x, (pl, pr, pt, pb))
        for i, s in enumerate(self.strides):
            conv = getattr(self.net, f"conv_{i}")
            x = torch.relu(prec.conv2d(x, conv.weight, conv.bias, s))
        out = self.net.conv_out
        x = prec.conv2d(x, out.weight, out.bias, 1)
        return x.permute(0, 2, 3, 1)


class Config:
    """The configuration as the reference reads it: the configuration
    file's ``config`` dict (every field of the preset as run)."""

    def __init__(self, fields: Dict):
        self.f = dict(fields)
        unsupported = {"n_object_slots": 1, "object_codec": "mlp",
                       "count_prior_parallel": False,
                       "vestigial_self_attn": False,
                       "pres_entropy_weight": 0.0, "n_lookback": 1}
        for key, want in unsupported.items():
            if self.f[key] != want:
                raise ValueError(f"the reference has no {key}="
                                 f"{self.f[key]!r}")
        if self.f["inference_mode"] not in ("independent", "raster",
                                            "wavefront"):
            raise ValueError(f"the reference has no inference_mode "
                             f"{self.f['inference_mode']!r}")

    def __getattr__(self, key):
        try:
            return self.__dict__["f"][key]
        except KeyError as e:
            raise AttributeError(key) from e

    @property
    def geometry(self):
        return grid_geometry(tuple(self.image_shape[1:]),
                             [tuple(t) for t in self.backbone_topology])

    @property
    def n_cells(self):
        gh, gw = self.geometry[1]
        return gh * gw


class SpairReference(nn.Module):
    """Every network of the model, under the program's parameter names."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg.image_shape[0]
        oh, ow = cfg.object_shape
        a, n_feat = cfg.n_attributes, cfg.n_backbone_features
        n_pass = cfg.n_passthrough_features
        elem = 4 + a + 1 + 1
        ctx = 4 * elem
        z_in = 4 + a + n_pass + ctx + n_feat
        self.backbone = Backbone(c, n_feat, cfg.backbone_topology,
                                 cfg.geometry[0])
        self.box_network = MLP(n_feat + ctx, cfg.mlp_hidden, (8, n_pass))
        self.object_encoder = MLP(c * oh * ow, cfg.encoder_hidden, (2 * a,))
        self.z_network = MLP(z_in, cfg.mlp_hidden, (2, n_pass))
        self.obj_network = MLP(z_in + 1, cfg.mlp_hidden, (1,))
        self.object_decoder = MLP(a, cfg.decoder_hidden,
                                  (oh * ow * (c + 1),))
        self.virtual_edge_element = nn.Parameter(torch.zeros(elem))


# ----------------------------------------------------------------- maths

def decay(step, sched: Dict, device):
    """(start - end) * rate ** t + end, t = step / decay_step (floored when
    staircase); log(value + 1e-6) when log_space."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    t = step / sched["decay_step"]
    if sched["staircase"]:
        t = torch.floor(t)
    rate = torch.full((), sched["decay_rate"], dtype=torch.float32,
                      device=device)
    value = (sched["start"] - sched["end"]) * torch.pow(rate, t) \
        + sched["end"]
    return torch.log(value + 1e-6) if sched["log_space"] else value


def squash(logit):
    return torch.sigmoid(torch.clamp(logit, -10.0, 10.0))


def mean_std(latent):
    mean, log_std = torch.chunk(latent, 2, dim=-1)
    return mean, 2.0 * torch.sigmoid(torch.clamp(log_std, -10.0, 10.0))


def freeze(v, tw):
    """The value of v; its gradient blocked while the wheel is on."""
    return tw * v.detach() + (1.0 - tw) * v


def hat(src, size: int):
    a = torch.arange(size, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - a), min=0.0)


def crop(image, boxes, object_shape, prec: Precision):
    """Bilinear crop with border clamping (grid_sample, align_corners):
    image (B, C, H, W), boxes (B, K, 4) [xt, yt, xs, ys] -> (B, K, C, oh,
    ow)."""
    oh, ow = object_shape
    ih, iw = image.shape[-2:]
    xt, yt, xs, ys = boxes.unbind(-1)

    def coords(t, s, n_out, n_in):
        j = torch.arange(n_out, dtype=torch.float32, device=t.device)
        u = 2.0 * j / (n_out - 1) - 1.0
        x = s[..., None] * u + (2.0 * t[..., None] - 1.0)
        return torch.clamp((x + 1.0) * (n_in - 1) / 2.0, 0.0, n_in - 1)

    wy = hat(coords(yt, ys, oh, ih), ih)
    wx = hat(coords(xt, xs, ow, iw), iw)
    tmp = prec.einsum("bkyh,bchw->bkcyw", wy, image)
    return prec.einsum("bkcyw,bkxw->bkcyx", tmp, wx)


def paste(glimpse, boxes, image_hw):
    """Inverse crop, zeros outside the glimpse: glimpse (B, K, D, oh, ow),
    boxes (B, K, 4) -> (B, K, D, H, W)."""
    oh, ow = glimpse.shape[-2:]
    h, w = image_hw
    xt, yt, xs, ys = boxes.unbind(-1)

    def coords(t, s, n_out, n_in):
        i = torch.arange(n_out, dtype=torch.float32, device=t.device)
        u = 2.0 * i / torch.full_like(i, n_out - 1) - 1.0
        v = (u - (2.0 * t[..., None] - 1.0)) / s[..., None]
        return (v + 1.0) * (n_in - 1) / 2.0

    py = hat(coords(yt, ys, h, oh), oh)   # (B, K, H, oh)
    px = hat(coords(xt, xs, w, ow), ow)   # (B, K, W, ow)
    tmp = torch.einsum("bkhy,bkdyx->bkdhx", py, glimpse)
    return torch.einsum("bkdhx,bkwx->bkdhw", tmp, px)


def fronts(mode: str, gh: int, gw: int) -> List[List[Tuple[int, int]]]:
    """Groups of cells the heads visit together, in order: every cell at
    once, one cell at a time in raster order, or the fronts of constant
    2h + w (every neighbour of a cell lies on an earlier front)."""
    if mode == "independent":
        return [[(h, w) for h in range(gh) for w in range(gw)]]
    if mode == "raster":
        return [[(h, w)] for h in range(gh) for w in range(gw)]
    by_d: Dict[int, List[Tuple[int, int]]] = {}
    for h in range(gh):
        for w in range(gw):
            by_d.setdefault(2 * h + w, []).append((h, w))
    return [by_d[d] for d in sorted(by_d)]


NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1))


def heads(model, cfg: Config, image, feat, ctx, noise, cells, tw,
          prec: Precision):
    """Every head for K cells: feat (B, K, F), ctx (B, K, 4 * 56), noise
    {name: (B, K, d)}, cells [(h, w)] * K."""
    ih, iw = cfg.image_shape[1:]
    cell_h, cell_w = cfg.geometry[2]
    box_latent, passthru = model.box_network.run(
        torch.cat([feat, ctx], dim=-1), prec)
    mean, std = mean_std(box_latent)
    mean, std = freeze(mean, tw), freeze(std, tw)
    cy_l, cx_l, h_l, w_l = torch.split(mean + std * noise["box"], 1, dim=-1)
    yx = cfg.max_yx - cfg.min_yx
    hw = cfg.max_hw - cfg.min_hw
    cell_y = yx * squash(cy_l) + cfg.min_yx
    cell_x = yx * squash(cx_l) + cfg.min_yx
    height = hw * squash(h_l) + cfg.min_hw
    width = hw * squash(w_l) + cfg.min_hw
    box = torch.cat([cell_x, cell_y, width, height], dim=-1)
    ys = height * cfg.anchor_shape[0] / ih
    xs = width * cfg.anchor_shape[1] / iw
    idx = torch.tensor(cells, dtype=torch.float32, device=feat.device)
    yt = (cell_h / ih) * (cell_y + idx[None, :, 0:1])
    xt = (cell_w / iw) * (cell_x + idx[None, :, 1:2])
    z_where = torch.cat([xt, yt, xs, ys], dim=-1)

    b, k = feat.shape[:2]
    glimpses = crop(image, z_where, cfg.object_shape, prec)
    attr_mean, attr_std = mean_std(
        model.object_encoder.run(glimpses.reshape(b, k, -1), prec)[0])
    attr = attr_mean + attr_std * noise["attr"]

    depth_latent, passthru2 = model.z_network.run(
        torch.cat([feat, ctx, passthru, box, attr], dim=-1), prec)
    d_mean, d_std = mean_std(depth_latent)
    d_mean, d_std = freeze(d_mean, tw), freeze(d_std, tw)
    depth = 4.0 * squash(d_mean + d_std * noise["depth"])

    pres_logit = freeze(model.obj_network.run(
        torch.cat([feat, ctx, passthru2, box, attr, depth], dim=-1),
        prec)[0], tw)
    pres = torch.sigmoid(torch.clamp(pres_logit, -10.0, 10.0)
                         + noise["pres"])
    cy_m, cx_m, h_m, w_m = torch.split(mean, 1, dim=-1)
    cy_s, cx_s, h_s, w_s = torch.split(std, 1, dim=-1)
    return {
        "z_where": z_where, "z_attr": attr, "z_depth": depth, "z_pres": pres,
        "context": torch.cat([box, attr, depth, pres], dim=-1),
        "post": {"cy_logit": (cy_m, cy_s), "cx_logit": (cx_m, cx_s),
                 "height_logit": (h_m, h_s), "width_logit": (w_m, w_s),
                 "attr": (attr_mean, attr_std),
                 "depth_logit": (d_mean, d_std)},
    }


def infer(model, cfg: Config, image, noise, step, prec: Precision = F32):
    """Image (B, C, H, W) -> the latents of every cell in raster order,
    (B, N, d) each, and the posterior pairs; noise {box, attr, depth,
    pres}: (B, gh, gw, d) each (pres: logistic noise)."""
    _, (gh, gw), _ = cfg.geometry
    b = image.shape[0]
    n = gh * gw
    feat = model.backbone.run(image, prec).reshape(b, n, -1).float()
    flat_noise = {k: v.reshape(b, n, -1) for k, v in noise.items()}
    tw = decay(step, cfg.training_wheel, image.device)
    edge = model.virtual_edge_element[None].expand(b, -1)
    context = {}  # (h, w) -> (B, 56), the cells visited so far

    def ctx_of(h, w):
        return context.get((h, w), edge)

    outs, order = [], []
    for front in fronts(cfg.inference_mode, gh, gw):
        raster = torch.tensor([h * gw + w for h, w in front],
                              device=image.device)
        if cfg.inference_mode == "independent":
            ctx = edge.repeat(1, 4)[:, None].expand(b, len(front), -1)
        else:
            ctx = torch.stack([torch.cat([ctx_of(h + dh, w + dw)
                                          for dh, dw in NEIGHBOURS], -1)
                               for h, w in front], dim=1)
        out = heads(model, cfg, image, feat[:, raster], ctx,
                    {k: v[:, raster] for k, v in flat_noise.items()},
                    front, tw, prec)
        for i, cell in enumerate(front):
            context[cell] = out["context"][:, i]
        outs.append(out)
        order += [h * gw + w for h, w in front]
    inverse = torch.argsort(torch.tensor(order, device=image.device))

    def gather(*parts):
        return torch.cat(parts, dim=1)[:, inverse]

    z = {k: gather(*(o[k] for o in outs))
         for k in ("z_where", "z_attr", "z_depth", "z_pres")}
    z["post"] = {k: tuple(gather(*(o["post"][k][i] for o in outs))
                          for i in range(2)) for k in outs[0]["post"]}
    z["tw"] = tw
    return z


def gaussian_kl(mq, sq, mp, sp):
    ratio = torch.square(sq / sp)
    return 0.5 * (ratio + torch.square((mq - mp) / sp) - 1.0
                  - torch.log(ratio))


def safe_log(t):
    return torch.log(torch.clamp(t + 1e-9, min=1e-9))


def bernoulli_kl(q, p):
    return (q * (safe_log(q) - safe_log(p))
            + (1.0 - q) * (safe_log(1.0 - q) - safe_log(1.0 - p)))


def count_prior_kl(z_pres, step, cfg: Config):
    """Presence KL against the annealed geometric count prior, the chain
    over the cells in raster order; z_pres (B, N, 1) -> (B, N)."""
    b, n = z_pres.shape[:2]
    device = z_pres.device
    with torch.no_grad():
        support = torch.arange(n + 1, dtype=torch.float32, device=device)
        log_odds = decay(step, cfg.count_prior, device)
        prior = 1.0 / (torch.exp(-log_odds) + 1.0)
        dist = (1.0 - prior) * torch.pow(prior, support)
        dist = (dist / torch.sum(dist)).expand(b, n + 1)
        samples = torch.round(z_pres[..., 0])
        so_far = torch.zeros((b, 1), dtype=torch.float32, device=device)
        p_z = []
        for i in range(n):
            left = float(n - i)
            p_given = torch.clamp(support[None] - so_far, 0.0, left) / left
            p_z.append(torch.clamp(torch.sum(dist * p_given, -1), 0.0, 1.0))
            s = samples[:, i:i + 1]
            new = (s * p_given + (1.0 - s) * (1.0 - p_given)) * dist
            dist = new / torch.clamp(torch.sum(new, -1, keepdim=True),
                                     min=1e-6)
            so_far = so_far + s
        p_z = torch.stack(p_z, dim=1)
    return bernoulli_kl(z_pres[..., 0], p_z)


def decode(model, cfg: Config, z, prec: Precision):
    """(color (B, N, C, oh, ow), alpha (B, N, 1, oh, ow), importance)."""
    c = cfg.image_shape[0]
    oh, ow = cfg.object_shape
    b, n = z["z_attr"].shape[:2]
    logits = model.object_decoder.run(z["z_attr"], prec)[0]
    logits = logits.reshape(b, n, oh, ow, c + 1)
    color = torch.sigmoid(logits[..., :c] * cfg.obj_logit_scale)
    alpha = torch.sigmoid(logits[..., c:] * cfg.alpha_logit_scale
                          + cfg.alpha_logit_bias)
    alpha = alpha * z["z_pres"][:, :, None, None, :]
    importance = torch.clamp(alpha * z["z_depth"][:, :, None, None, :],
                             min=0.01)
    return tuple(torch.movedim(t, -1, 2) for t in (color, alpha, importance))


def composite_blend(color, alpha, importance, boxes, image_hw, gate,
                    chunk: int = 16):
    """The importance-weighted blend, num / den clipped to [0, 1]: num =
    sum_o paste(alpha) paste(color) (paste(imp) + 1e-9), den = sum_o
    (paste(imp) + 1e-9); a gated-out object pastes nothing and keeps its
    1e-9 in den."""
    if gate is not None:
        g = gate[:, :, None, None, None]
        color, alpha, importance = color * g, alpha * g, importance * g
    c = color.shape[2]
    num = den = 0.0
    for s in range(0, color.shape[1], chunk):
        sl = slice(s, s + chunk)
        p = paste(torch.cat([color[:, sl], alpha[:, sl], importance[:, sl]],
                            dim=2), boxes[:, sl], image_hw)
        imp = p[:, :, c + 1:c + 2] + EPS_DEN
        num = num + torch.sum(p[:, :, c:c + 1] * p[:, :, :c] * imp, dim=1)
        den = den + torch.sum(imp, dim=1)
    return torch.clamp(num / den, 0.0, 1.0)


def composite_ordered(color, alpha, depth, boxes, image_hw, gate,
                      chunk: int = 16):
    """Depth-ordered alpha-over: objects front to back by depth (higher is
    nearer, a stable sort), out = sum_o T_o a_o c_o with T_o the product of
    (1 - a) of the objects in front, each pasted alpha clipped to [0, 1];
    a gated-out object has alpha 0. Clipped to [0, 1]."""
    if gate is not None:
        alpha = alpha * gate[:, :, None, None, None]
    b, n, c = color.shape[:3]
    order = torch.argsort(-depth[..., 0], dim=1, stable=True)

    def take(t):
        return torch.take_along_dim(
            t, order.reshape((b, n) + (1,) * (t.ndim - 2)), dim=1)

    color, alpha, boxes = take(color), take(alpha), take(boxes)
    img = trans = None
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        p = paste(torch.cat([color[:, sl], alpha[:, sl]], dim=2),
                  boxes[:, sl], image_hw)
        for k in range(p.shape[1]):
            a = torch.clamp(p[:, k, c:], 0.0, 1.0)
            layer = a * p[:, k, :c]
            img = layer if img is None else img + trans * layer
            trans = (1.0 - a) if trans is None else trans * (1.0 - a)
    return torch.clamp(img, 0.0, 1.0)


def loss(model, cfg: Config, image, noise, step, prec: Precision = F32):
    """(loss, {name: term}) of one training forward: the pixel-sum BCE plus
    vae_beta times the batch mean of each KL's per-image sum."""
    z = infer(model, cfg, image, noise, step, prec)
    priors = {k: v for k, v in cfg.priors}
    kls = {name: z["z_pres"] * gaussian_kl(m, s, *priors[name])
           for name, (m, s) in z["post"].items()}
    kls["pres_dist"] = count_prior_kl(z["z_pres"], step, cfg)[..., None]
    color, alpha, importance = decode(model, cfg, z, prec)
    gate = None
    if cfg.pres_gate_threshold > 0.0:
        gate = (z["z_pres"][..., 0] > cfg.pres_gate_threshold).float()
    hw = tuple(cfg.image_shape[1:])
    if cfg.render_mode == "ordered":
        recon = composite_ordered(color, alpha, z["z_depth"], z["z_where"],
                                  hw, gate, cfg.render_chunk)
    else:
        recon = composite_blend(color, alpha, importance, z["z_where"], hw,
                                gate, cfg.render_chunk)
    terms = {"reconst": F.binary_cross_entropy(recon, image,
                                               reduction="sum")}
    total = terms["reconst"]
    for name, kl in kls.items():
        terms[f"KL{name}"] = torch.mean(torch.sum(kl, dim=(1, 2)))
        total = total + cfg.vae_beta * terms[f"KL{name}"]
    terms["total"] = total
    return total, terms
