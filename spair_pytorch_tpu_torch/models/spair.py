"""The SPAIR model: inference orders, forward pass and loss (counterpart of
``spair_pytorch_tpu/models/spair.py``).

The lateral-context inference visits groups of mutually independent cells
(``inference_schedule``): every cell at once ('independent'), one cell at a
time in raster order ('raster'), the 31 fronts of constant d = 2h + w on an
11x11 grid ('wavefront', the same function as raster), or whole rows
('rowscan', a relaxed context). Context lives on a halo board, a flat
(gh + 2n) x (gw + 2n) + 1 grid of context vectors initialized with the edge
element; each front reads its neighbours' slots and writes its own, and a
trash slot absorbs the writes of padded lanes. Here the scan over fronts is
a Python loop, and the board is written in place: a front reads it by
gathers, whose backward needs only the indices, so autograd keeps none of
the overwritten values.

``cfg.compute_dtype='bfloat16'`` runs the backbone, the MLPs and the glimpse
crop in bf16 (float32 master weights); features, MLP outputs and the
reconstruction come back in float32, so the latent math, the KLs, the
compositor and the loss are float32, as in the JAX package.

The forward marks its layers' tiles for a span recorder that a train step
activates (``utils/spans.py``: ``spans.mark`` and ``spans.boundary``);
with none active each site is one ``is None`` test.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from spair_pytorch_tpu_torch.config import SpairConfig
from spair_pytorch_tpu_torch.models.kl import (count_prior_kl,
                                               count_prior_kl_parallel,
                                               independent_kl)
from spair_pytorch_tpu_torch.models.latents import (apply_self_attn,
                                                    cell_step, geometry,
                                                    init_params, sample_noise)
from spair_pytorch_tpu_torch.models.render import (composite_objects,
                                                   render_objects, takes_topk)
from spair_pytorch_tpu_torch.ops.math import binary_cross_entropy_sum, safe_log
from spair_pytorch_tpu_torch.ops.schedules import exponential_decay
from spair_pytorch_tpu_torch.utils import spans
from spair_pytorch_tpu_torch.utils.debug import nan_hunter

__all__ = ["init_params", "forward", "forward_head", "forward_tail",
           "infer_latents", "loss_and_metrics", "geometry",
           "inference_schedule", "neighbor_offsets"]


def neighbor_offsets(n_lookback: int = 1):
    """Already-visited cells of the lookback window, row-major; for n = 1
    [(-1, -1), (-1, 0), (-1, 1), (0, -1)]."""
    n = n_lookback
    offs = [(dh, dw) for dh in range(-n, 1) for dw in range(-n, n + 1)]
    return tuple(offs[:-(n + 1)])


def inference_schedule(mode: str, gh: int, gw: int, n_lookback: int = 1):
    """Static schedule: fronts of mutually independent cells, as numpy.

    cell_idx (S, K) raster index per lane (0 for padded lanes); cell_hw
    (S, K, 2); mask (S, K); nbr_idx (S, K, n_neighbors) halo-board read
    slots; write_idx (S, K) write slot (the trash slot for padded lanes);
    perm (N,) lane position s*K + k of each raster cell. The wavefront index
    d = (n_lookback + 1) h + w strictly decreases along every neighbour
    offset, so equal-d cells are independent."""
    offsets = neighbor_offsets(n_lookback)
    if mode == "raster":
        fronts: List[List[Tuple[int, int]]] = [
            [(h, w)] for h in range(gh) for w in range(gw)]
    elif mode == "wavefront":
        by_d: Dict[int, List[Tuple[int, int]]] = {}
        for h in range(gh):
            for w in range(gw):
                by_d.setdefault((n_lookback + 1) * h + w, []).append((h, w))
        fronts = [by_d[d] for d in sorted(by_d)]
    elif mode == "rowscan":
        # relaxed: same-row west neighbours read the edge element
        fronts = [[(h, w) for w in range(gw)] for h in range(gh)]
    else:
        raise ValueError(f"unknown scan mode {mode!r}")

    s = len(fronts)
    k = max(len(f) for f in fronts)
    halo = n_lookback
    pw = gw + 2 * halo
    board_size = (gh + 2 * halo) * pw
    trash = board_size

    cell_idx = np.zeros((s, k), np.int64)
    cell_hw = np.zeros((s, k, 2), np.int64)
    mask = np.zeros((s, k), bool)
    nbr_idx = np.zeros((s, k, len(offsets)), np.int64)
    write_idx = np.full((s, k), trash, np.int64)
    perm = np.zeros(gh * gw, np.int64)
    for si, front in enumerate(fronts):
        for ki, (h, w) in enumerate(front):
            cell_idx[si, ki] = h * gw + w
            cell_hw[si, ki] = (h, w)
            mask[si, ki] = True
            write_idx[si, ki] = (h + halo) * pw + (w + halo)
            for ni, (dh, dw) in enumerate(offsets):
                nbr_idx[si, ki, ni] = (h + halo + dh) * pw + (w + halo + dw)
            perm[h * gw + w] = si * k + ki
    return dict(cell_idx=cell_idx, cell_hw=cell_hw, mask=mask,
                nbr_idx=nbr_idx, write_idx=write_idx, perm=perm,
                board_size=board_size, steps=s, lanes=k)


@functools.lru_cache(maxsize=None)
def _schedule_tensors(mode: str, gh: int, gw: int, n_lookback: int,
                      device: torch.device):
    sched = inference_schedule(mode, gh, gw, n_lookback)
    tensors = {key: torch.as_tensor(sched[key], device=device)
               for key in ("cell_idx", "cell_hw", "nbr_idx", "write_idx",
                           "perm")}
    return sched, tensors


def compute_dtype(cfg: SpairConfig):
    """The MLP/backbone/crop compute dtype: None for float32."""
    if cfg.compute_dtype == "float32":
        return None
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


def _tree_map(fn, *trees):
    """Apply ``fn`` leafwise over matching nested dicts/tuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in t0}
    if isinstance(t0, tuple):
        return tuple(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def infer_latents(params, cfg: SpairConfig, x, step, generator=None,
                  noise=None, mesh=None):
    """The inference pass only: image -> latent grids (B, gh, gw, D),
    posterior (mean, std) pairs and presence probabilities. Shared by
    ``forward`` and the serving detector (models/infer.py).

    ``noise`` (see sample_noise) overrides draws from ``generator``. With
    a ``mesh`` whose 'model' axis has M > 1 ranks (``parallel/
    constraints.py``) each rank of a model group runs the heads on its
    block of the cells (independent mode) or of each front's lanes (the
    scans, where M divides the lanes), and the blocks are gathered after
    each: every rank returns the whole grid."""
    geom = geometry(cfg)
    _, (gh, gw), _ = geom
    n = gh * gw
    b = x.shape[0]
    device = x.device
    dtype = compute_dtype(cfg)

    spans.mark("backbone")
    feat_flat = params.backbone(x, dtype).reshape(b, n, -1).to(torch.float32)
    feat_flat = spans.boundary(feat_flat, "fronts", "backbone.bwd")
    if noise is None:
        noise = sample_noise(generator, b, (gh, gw), cfg, device)
    noise_flat = {name: v.reshape(b, n, v.shape[-1])
                  for name, v in noise.items()}
    tw = exponential_decay(step, cfg.training_wheel, device)

    if cfg.inference_mode == "independent":
        context = params.virtual_edge_element.repeat(
            cfg.context_neighbors).expand(b, n, cfg.context_dim)
        cells = torch.arange(n, device=device)  # made on the device: the
        hw = torch.stack([cells // gw, cells % gw], -1)  # step is captured
        if mesh is not None and mesh.n_model > 1:
            from spair_pytorch_tpu_torch.parallel.constraints import \
                shard_cells

            def shard(t, dim=1):
                return shard_cells(t, mesh, dim)
            flat = _gathered(cell_step(
                params, cfg, geom, x, shard(feat_flat), shard(context),
                {name: shard(v) for name, v in noise_flat.items()},
                shard(hw, 0), tw, dtype), mesh, n)
        else:
            flat = cell_step(params, cfg, geom, x, feat_flat, context,
                             noise_flat, hw, tw, dtype)
    else:
        flat = _scan_inference(params, cfg, geom, x, feat_flat, noise_flat,
                               tw, dtype, b, gh, gw, mesh)

    def grid(t):
        # slot-major unfold into the virtual (gh, gw*S) grid
        slots = cfg.n_object_slots
        return t.reshape(b, gh, gw * slots, t.shape[-1] // slots)

    out = _tree_map(grid, {key: flat[key] for key in (
        "z_where", "z_attr", "z_depth", "z_pres", "z_pres_prob", "posterior",
        "context_vec")})
    out["training_wheel"] = tw
    out["feat_flat"] = feat_flat
    return out


def _gathered(out, mesh, n):
    """``cell_step``'s outputs for this rank's block of cells, gathered
    over the model group into the outputs of all ``n`` cells: packed into
    one buffer, as the JAX scan packs a front's outputs, so that a block
    costs one all-gather (and its backward one reduce-scatter)."""
    from spair_pytorch_tpu_torch.parallel.constraints import gather_cells
    leaves, tree = tree_flatten(out)
    whole = gather_cells(torch.cat(leaves, dim=-1), mesh, n)
    return tree_unflatten(list(torch.split(
        whole, [t.shape[-1] for t in leaves], dim=-1)), tree)


def _scan_inference(params, cfg, geom, x, feat_flat, noise_flat, tw, dtype,
                    b, gh, gw, mesh=None):
    """Lateral-context inference over the schedule's fronts, as a loop.

    Features and noise are gathered for all fronts up front; each front
    reads its context from the halo board and writes its context vectors
    back in place (the reads are gathers, so autograd needs none of the
    overwritten values). Outputs are put back in raster order at the end.
    With a ``mesh`` whose model axis M divides the lanes K, each rank runs
    its block of K / M lanes of every front and the front's outputs are
    gathered before its context vectors are written: the board stays
    replicated, as in the JAX scan."""
    sched, idx = _schedule_tensors(cfg.inference_mode, gh, gw,
                                   cfg.n_lookback, x.device)
    s, k = sched["steps"], sched["lanes"]
    shard = _lane_shard(k, mesh)
    board = params.virtual_edge_element.expand(
        b, sched["board_size"] + 1, cfg.context_elem_dim).clone()

    flat_idx = idx["cell_idx"].reshape(-1)

    def pregather(t):  # (B, N, D) -> (B, S, K, D)
        return t[:, flat_idx].reshape(b, s, k, t.shape[-1])

    feats = pregather(feat_flat)
    noise = {name: pregather(v) for name, v in noise_flat.items()}
    outs = []
    for si in range(s):
        nbr = shard(idx["nbr_idx"][si], 0)
        ctx = board[:, nbr.reshape(-1)].reshape(b, nbr.shape[0],
                                                cfg.context_dim)
        out = cell_step(params, cfg, geom, x, shard(feats[:, si]), ctx,
                        {name: shard(v[:, si]) for name, v in noise.items()},
                        shard(idx["cell_hw"][si], 0), tw, dtype)
        if shard is not _whole:
            out = _gathered(out, mesh, k)
        board[:, idx["write_idx"][si]] = out["context_vec"]
        outs.append(out)
    perm = idx["perm"]
    return _tree_map(lambda *steps: torch.cat(steps, dim=1)[:, perm], *outs)


def _whole(t, dim=1):
    return t


def _lane_shard(k: int, mesh):
    """shard(t, dim) -> this rank's block of a front's ``k`` lanes on axis
    ``dim`` when the mesh's model axis splits them, else t itself."""
    if mesh is None:
        return _whole
    from spair_pytorch_tpu_torch.parallel.constraints import (lanes_split,
                                                              shard_cells)
    if not lanes_split(k, mesh):
        return _whole
    return lambda t, dim=1: shard_cells(t, mesh, dim)


def forward(params, cfg: SpairConfig, x, step, generator=None, noise=None,
            batch_share: float = 1.0):
    """Full inference and generation pass.

    x (B, C, H, W) in [0, 1]; step drives the schedules; ``generator``
    draws this pass's noise unless ``noise`` is given. Returns (loss, aux)
    with the reconstruction, the latent grids in NCHW, the training-wheel
    value and every logged loss term.

    ``batch_share``: the share of a global batch that x is (data
    parallelism): the batch-mean terms are scaled by it, so the losses of
    the ranks' slices sum to the global batch's loss (the reconstruction
    term is already a sum over the batch).

    It is ``forward_head``, the render's branch read on the host
    (``render.py::takes_topk``; no read without ``render_topk``), then
    ``forward_tail``: the two segments a captured program puts around the
    branch."""
    head = forward_head(params, cfg, x, step, generator, noise)
    return forward_tail(params, cfg, head, takes_topk(head["live_at_most_k"]),
                        batch_share)


def forward_head(params, cfg: SpairConfig, x, step, generator=None,
                 noise=None, reduce_live=None, mesh=None):
    """``forward`` up to the render's top-K branch: inference, the KLs, the
    object decoder and the gate (``render.py::render_objects``). Returns
    what ``forward_tail`` takes: x, the latents ``z``, the ``kls``, the
    decoded ``objects`` and the branch's predicate ``live_at_most_k`` (a
    0-d bool tensor on the device, or None when render does not branch;
    ``reduce_live`` as ``render_objects`` takes it). ``mesh``: the
    inference's model axis (``infer_latents``); what follows it is
    replicated on the ranks of a model group."""
    z = spans.boundary(infer_latents(params, cfg, x, step, generator, noise,
                                     mesh), "kl", "fronts.bwd")
    nan_hunter("after inference", z_where=z["z_where"], z_pres=z["z_pres"],
               z_depth=z["z_depth"], feat=z["feat_flat"])

    kls = spans.boundary(independent_kl(z["posterior"], z["z_pres"], cfg),
                         "count_prior", "kl.bwd")
    count_kl = (count_prior_kl_parallel if cfg.count_prior_parallel
                else count_prior_kl)
    kls["pres_dist"] = spans.boundary(
        count_kl(z["z_pres_prob"], z["z_pres"], step, cfg), "decoder",
        "count_prior.bwd")
    nan_hunter("KL divergence", **kls)
    objects, live_at_most_k = render_objects(
        params, cfg, z["z_attr"], z["z_where"], z["z_depth"], z["z_pres"],
        compute_dtype(cfg), reduce_live)
    return {"x": x, "z": z, "kls": kls, "objects": objects,
            "live_at_most_k": live_at_most_k}


def forward_tail(params, cfg: SpairConfig, head, topk: bool,
                 batch_share: float = 1.0):
    """``forward`` from the render's branch on: one branch's composite
    (the top-K one when ``topk``, ``render.py::composite_objects``), the
    loss and its terms; (loss, aux) as ``forward`` returns them."""
    x, z, kls = head["x"], head["z"], head["kls"]
    z_where, z_attr = z["z_where"], z["z_attr"]
    z_depth, z_pres = z["z_depth"], z["z_pres"]
    z_pres_prob, tw = z["z_pres_prob"], z["training_wheel"]
    objects = spans.boundary(head["objects"], "composite", "decoder.bwd")
    recon = spans.boundary(
        composite_objects(cfg, objects, cfg.image_shape[1:],
                          topk).to(torch.float32), "loss", "composite.bwd")
    nan_hunter("render", recon=recon)
    loss, terms = loss_and_metrics(x, recon, kls, cfg, batch_share)

    if cfg.pres_entropy_weight:
        # borderline-presence penalty, off while the training wheel is on
        p = z_pres_prob
        ent = -(p * safe_log(p) + (1.0 - p) * safe_log(1.0 - p))
        ent_mean = _batch_mean(torch.sum(ent, dim=(1, 2, 3)), batch_share)
        loss = loss + cfg.pres_entropy_weight * (1.0 - tw) * ent_mean
        terms["losses/pres_entropy"] = ent_mean
        terms["losses/total"] = loss

    if cfg.vestigial_self_attn and hasattr(params, "self_attn"):
        # the reference computes its Self_Attn every forward and discards
        # it: the block runs on the detached (box, attr, depth) context
        # grid, and only its mean is surfaced, as a debug term outside the
        # loss, so it has no gradient path
        ctx = z["context_vec"][..., :-1].detach()  # drop z_pres
        attn_out = apply_self_attn(params.self_attn,
                                   ctx.reshape(x.shape[0], -1, ctx.shape[-1]))
        terms["debug/self_attn_mean"] = torch.mean(attn_out)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    aux = {
        "recon": recon,
        "z_where": nchw(z_where),
        "z_pres": nchw(z_pres),
        "z_depth": nchw(z_depth),
        "z_attr": nchw(z_attr),
        "z_pres_prob": nchw(z_pres_prob),
        "training_wheel": tw,
        "losses": terms,
    }
    return loss, aux


def _batch_mean(t, batch_share: float):
    """The batch mean of t (B,), scaled by ``batch_share`` when x is a
    rank's slice of a global batch."""
    mean = torch.mean(t)
    return mean if batch_share == 1.0 else mean * batch_share


def loss_and_metrics(x, recon, kls: Dict, cfg: SpairConfig,
                     batch_share: float = 1.0):
    """Pixel-sum BCE + vae_beta * sum over latents of the batch-mean KL
    sums; (loss, terms under the reference's TensorBoard tags). The batch
    means are scaled by ``batch_share`` (see ``forward``)."""
    recon_loss = binary_cross_entropy_sum(recon, x)
    terms = {"losses/reconst": recon_loss}
    kl_loss = 0.0
    for name, z_kl in kls.items():
        kl_mean = _batch_mean(torch.sum(z_kl, dim=(1, 2, 3)), batch_share)
        kl_loss = kl_loss + kl_mean
        terms[f"losses/KL{name}"] = kl_mean
    loss = recon_loss + cfg.vae_beta * kl_loss
    terms["losses/total"] = loss
    return loss, terms
