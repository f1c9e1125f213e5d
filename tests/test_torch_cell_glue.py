"""``cell_step``'s glue segments (``ops/kernels/cell_glue.py``) on the CPU.

Each segment's plain forward is the PyTorch composition ``cell_step`` ran
before the segments existed, and its hand-written backward must equal
autograd through that composition bit for bit, in float64 and float32 and
with bf16 head outputs; on the edges too: logits at exactly +-10 (the
clamps' closed ranges) and crop source coordinates on whole pixels and on
the clamp's bounds. ``cell_step`` itself, and a whole train forward over
the wavefront, must give the outputs and gradients of ``reference_cell_step``
(the composition, kept here) to the last bit in float32."""

import dataclasses

import pytest
import torch

from spair_pytorch_tpu_torch.config import PRESETS
from spair_pytorch_tpu_torch.models import latents as L
from spair_pytorch_tpu_torch.models import spair as M
from spair_pytorch_tpu_torch.ops.kernels import cell_glue as G
from spair_pytorch_tpu_torch.ops.math import (clamped_sigmoid,
                                              freeze_learning,
                                              latent_to_mean_std)
from spair_pytorch_tpu_torch.ops.stn import _source_coords_crop, crop_glimpses

B = 2
TWS = (0.0, 0.3, 1.0)
PRESET_LANES = {"paper128": 6, "quality": 8}  # the widest front's lanes


def reference_cell_step(params, cfg, geom, image, feat_cells, context, noise,
                        cell_hw, tw, dtype=None):
    """``cell_step`` as one PyTorch composition under autograd: what the
    segments replace, kept as the tests' reference."""
    _, _, cell_px = geom
    img_h, img_w = cfg.image_shape[1:]
    s = cfg.n_object_slots
    b, k = feat_cells.shape[:2]

    def per_slot(t):
        return t.reshape(b, k, s, -1)

    def fold(t):
        return t.reshape(b, k, -1)

    def shared(t):
        return t[:, :, None].expand(b, k, s, t.shape[-1])

    box_latent, passthru = params.box_network(
        torch.cat([feat_cells, context], dim=-1), packed=cfg.packed_heads,
        dtype=dtype)
    mean, std = latent_to_mean_std(per_slot(box_latent))
    mean, std = freeze_learning(mean, tw), freeze_learning(std, tw)
    box_logits = mean + std * per_slot(noise["box"])
    cy_l, cx_l, h_l, w_l = torch.split(box_logits, 1, dim=-1)
    yx_range = cfg.max_yx - cfg.min_yx
    cell_y = yx_range * clamped_sigmoid(cy_l) + cfg.min_yx
    cell_x = yx_range * clamped_sigmoid(cx_l) + cfg.min_yx
    hw_range = cfg.max_hw - cfg.min_hw
    height = hw_range * clamped_sigmoid(h_l) + cfg.min_hw
    width = hw_range * clamped_sigmoid(w_l) + cfg.min_hw
    box = torch.cat([cell_x, cell_y, width, height], dim=-1)
    ys = height * cfg.anchor_shape[0] / img_h
    xs = width * cfg.anchor_shape[1] / img_w
    h_idx = cell_hw[:, 0].to(torch.float32)[None, :, None, None]
    w_idx = cell_hw[:, 1].to(torch.float32)[None, :, None, None]
    yt = (cell_px[0] / img_h) * (cell_y + h_idx)
    xt = (cell_px[1] / img_w) * (cell_x + w_idx)
    z_where = torch.cat([xt, yt, xs, ys], dim=-1)
    glimpses = crop_glimpses(image, z_where.reshape(b, k * s, 4),
                             cfg.object_shape, dtype)
    if cfg.object_codec == "conv":
        attr_latent = params.object_encoder(glimpses, dtype=dtype)
    else:
        attr_latent = params.object_encoder(glimpses.reshape(b, k * s, -1),
                                            dtype=dtype)[0]
    attr_mean, attr_std = latent_to_mean_std(attr_latent.reshape(b, k, s, -1))
    attr = attr_mean + attr_std * per_slot(noise["attr"])
    z_in = torch.cat([shared(feat_cells), shared(context), shared(passthru),
                      box, attr], dim=-1)
    depth_latent, passthru2 = params.z_network(z_in, packed=cfg.packed_heads,
                                               dtype=dtype)
    depth_mean, depth_std = latent_to_mean_std(depth_latent)
    depth_mean = freeze_learning(depth_mean, tw)
    depth_std = freeze_learning(depth_std, tw)
    depth = 4.0 * clamped_sigmoid(depth_mean
                                  + depth_std * per_slot(noise["depth"]))
    obj_in = torch.cat([shared(feat_cells), shared(context), passthru2, box,
                        attr, depth], dim=-1)
    pres_logit = freeze_learning(params.obj_network(obj_in, dtype=dtype)[0],
                                 tw)
    stick = s > 1 and cfg.slot_coupling == "stick"
    if stick:
        offset = -2.0 * torch.arange(s, dtype=pres_logit.dtype,
                                     device=pres_logit.device)
        pres_logit = pres_logit + offset[None, None, :, None]
    log_odds = torch.clamp(pres_logit, -10.0, 10.0)
    pres_prob = torch.sigmoid(log_odds + per_slot(noise["pres_noise"]))
    if stick:
        pres_prob = torch.cumprod(pres_prob, dim=2)
    pres = pres_prob
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
    return {"z_where": fold(z_where), "z_attr": fold(attr),
            "z_depth": fold(depth), "z_pres": fold(pres),
            "z_pres_prob": fold(pres_prob), "posterior": posterior,
            "context_vec": ctx_vec}


def leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def preset(name, slots):
    cfg = PRESETS[name]()
    if slots > 1:
        cfg = dataclasses.replace(cfg, n_object_slots=slots,
                                  slot_coupling="stick")
    return cfg


def widths(cfg):
    """(F, Cc, P, A) of the segments' inputs."""
    return (cfg.n_backbone_features, cfg.context_dim,
            cfg.n_passthrough_features, cfg.n_attributes)


def _rand(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=torch.float64)
            * scale).to(dtype)


def _edges(t, gen, cols, value=10.0):
    """Set a third of the rows' ``cols`` (a slice of the last axis) to
    exactly +-value."""
    rows = t[..., cols]
    pick = torch.rand(rows.shape, generator=gen) < 0.33
    sign = torch.where(torch.rand(rows.shape, generator=gen) < 0.5, -1.0,
                       1.0).to(t.dtype)
    t[..., cols] = torch.where(pick, sign * value, rows)
    return pick


def _cell_hw(k, gen, grid=11):
    return torch.randint(0, grid, (k, 2), generator=gen)


def _check_vjp(outs, inputs, cots, got):
    """``got`` (the hand-written backward's results, one per input) equal
    autograd's through the plain composition bit for bit."""
    pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
    want = torch.autograd.grad([o for o, _ in pairs], inputs,
                               [c for _, c in pairs], allow_unused=True,
                               retain_graph=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None or not bool(g.any()), i
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.shape,
                                                           w.shape)
        assert torch.equal(g, w), (i, float((g - w).abs().max()))


def _cots(outs, gen, drop=()):
    return [None if i in drop else _rand(gen, o.shape, o.dtype)
            for i, o in enumerate(outs)]


# head outputs' dtype and the compute dtype: float64 and float32 compute in
# their own dtype; 'bf16' is bf16 compute with float32 latents
DTYPES = {"float64": (torch.float64, torch.float64, None),
          "float32": (torch.float32, torch.float32, None),
          "bf16": (torch.bfloat16, torch.float32, torch.bfloat16)}
CASES = [(p, s, d) for p in PRESET_LANES for s in (1, 2) for d in DTYPES]
IDS = [f"{p}-s{s}-{d}" for p, s, d in CASES]


def _case(name, slots, dname, seed):
    cfg = preset(name, slots)
    head, lat, compute = DTYPES[dname]
    gen = torch.Generator().manual_seed(seed)
    return cfg, head, lat, compute, gen, PRESET_LANES[name]


@pytest.mark.parametrize("name,slots,dname", CASES, ids=IDS)
def test_box_in_backward_is_autograds(name, slots, dname):
    cfg, _, lat, compute, gen, k = _case(name, slots, dname, 1)
    nf, nc, _, _ = widths(cfg)
    feat = _rand(gen, (B, k, nf), lat).requires_grad_()
    ctx = _rand(gen, (B, k, nc), lat).requires_grad_()
    outs = G.box_in_plain(feat, ctx, compute)
    for drop in ((), (0,), (1,)):
        cots = _cots(outs, gen, drop)
        got = G.box_in_backward_plain(cots[0], cots[1], nf)
        _check_vjp(outs, (feat, ctx), cots, got)


@pytest.mark.parametrize("name,slots,dname", CASES, ids=IDS)
def test_box_backward_is_autograds(name, slots, dname):
    cfg, head, lat, compute, gen, k = _case(name, slots, dname, 2)
    g = G.geometry_of(cfg, L.geometry(cfg))
    s = slots
    for tw_v in TWS:
        tw = torch.tensor(tw_v, dtype=lat)
        hb = _rand(gen, (B, k, s, 8), head, 2.0)
        _edges(hb, gen, slice(0, 8))
        noise = _rand(gen, (B, k, s, 4), lat)
        noise[hb[..., :4].abs() == 10.0] = 0.0   # the logit lands on +-10
        hb = hb.reshape(B, k, 8 * s).requires_grad_()
        noise = noise.reshape(B, k, 4 * s)
        hw = _cell_hw(k, gen)
        means, stds, box, zw, wy, wx = G.box_plain(hb, noise, tw, hw, g, s,
                                                   compute)
        outs = (*means, *stds, box, zw, wy, wx)
        for drop in ((), (0, 2, 5, 7), (8, 9), (10, 11)):
            cots = _cots(outs, gen, drop)
            got = G.box_backward_plain(hb, noise, tw, hw, g, s, cots[:4],
                                       cots[4:8], *cots[8:])
            _check_vjp(outs, (hb,), cots, (got,))


def whole_pixel_heads(g, device, count=8, lanes=1):
    """Box head rows (a (1, n, 8) tensor; with tw = 0 and zero noise) whose
    crop source coordinates land on whole pixels of the image, the clamp's
    bounds 0 and H - 1 among them, found by a sweep of the centre logits
    through the plain chain on ``device``."""
    n = 200001
    logit = torch.linspace(-2.5, 2.5, n, device=device)
    hb = torch.zeros((1, n, 8), device=device)
    hb[0, :, 0], hb[0, :, 1] = logit, logit.flip(0)
    hb[0, :, 2], hb[0, :, 3] = 0.37, -0.61
    tw = torch.zeros((), device=device)
    c = G._box_chain(hb, torch.zeros((1, n, 4), device=device), tw,
                     torch.zeros((n, 2), dtype=torch.int64, device=device),
                     g, 1)
    xt, yt, xs, ys = c["z_where"][0, :, 0].unbind(-1)
    hit = torch.zeros(n, dtype=torch.bool, device=device)
    for t, sc, out, size in ((yt, ys, g.object_hw[0], g.image_hw[0]),
                             (xt, xs, g.object_hw[1], g.image_hw[1])):
        src = _source_coords_crop(t, sc, out, size)
        whole = (src == src.floor()) & (src >= 0) & (src <= size - 1)
        hit |= whole.any(-1)
    rows = hb[:, hit][:, :count * lanes]
    return rows.reshape(-1, lanes, 8)


@pytest.mark.parametrize("name", sorted(PRESET_LANES))
def test_box_backward_on_whole_pixels(name):
    """Source coordinates on whole pixels: the hat's derivative is the
    clamp's (a tap at distance exactly 1 counts) and sgn's (0 at 0)."""
    cfg = PRESETS[name]()
    g = G.geometry_of(cfg, L.geometry(cfg))
    hb = whole_pixel_heads(g, "cpu", count=8).reshape(1, 8, 8)
    assert hb.shape[1] == 8, "the sweep found too few whole pixels"
    hb = hb.requires_grad_()
    gen = torch.Generator().manual_seed(3)
    tw = torch.zeros(())   # the wheel off: the box head gets gradients
    noise = torch.zeros((1, 8, 4))
    hw = torch.zeros((8, 2), dtype=torch.int64)
    outs = G.box_plain(hb, noise, tw, hw, g, 1)
    outs = (*outs[0], *outs[1], *outs[2:])
    cots = _cots(outs, gen)
    got = G.box_backward_plain(hb, noise, tw, hw, g, 1, cots[:4], cots[4:8],
                               *cots[8:])
    _check_vjp(outs, (hb,), cots, (got,))
    assert bool(got.any())


@pytest.mark.parametrize("name,slots,dname", CASES, ids=IDS)
def test_attr_z_backward_is_autograds(name, slots, dname):
    cfg, head, lat, compute, gen, k = _case(name, slots, dname, 4)
    nf, nc, npass, na = widths(cfg)
    s = slots
    latent = _rand(gen, (B, k * s, 2 * na), head, 3.0)
    _edges(latent, gen, slice(na, 2 * na))
    latent.requires_grad_()
    noise = _rand(gen, (B, k, s * na), lat)
    fc = _rand(gen, (B, k, nf + nc), lat).requires_grad_()
    passthru = _rand(gen, (B, k, npass), head).requires_grad_()
    box = _rand(gen, (B, k, s, 4), lat).requires_grad_()
    outs = G.attr_z_plain(latent, noise, fc, passthru, box, compute)
    for drop in ((), (0, 1), (2,), (3,), (4,)):
        cots = _cots(outs, gen, drop)
        got = G.attr_z_backward_plain(latent, noise, *cots, nf + nc, npass,
                                      passthru.dtype)
        _check_vjp(outs, (latent, passthru, fc, box), cots, got)


@pytest.mark.parametrize("name,slots,dname", CASES, ids=IDS)
def test_depth_obj_backward_is_autograds(name, slots, dname):
    cfg, head, lat, compute, gen, k = _case(name, slots, dname, 5)
    nf, nc, npass, na = widths(cfg)
    s = slots
    for tw_v in TWS:
        tw = torch.tensor(tw_v, dtype=lat)
        dl = _rand(gen, (B, k, s, 2), head, 4.0)
        _edges(dl, gen, slice(0, 2))
        noise = _rand(gen, (B, k, s), lat)
        noise[dl[..., 0].abs() == 10.0] = 0.0
        dl.requires_grad_()
        pass2 = _rand(gen, (B, k, s, npass), head).requires_grad_()
        fc3 = _rand(gen, (B, k, nf + nc), lat).requires_grad_()
        box = _rand(gen, (B, k, s, 4), lat).requires_grad_()
        attr = _rand(gen, (B, k, s, na), lat).requires_grad_()
        outs = G.depth_obj_plain(dl, pass2, noise, tw, fc3, box, attr,
                                 compute)
        for drop in ((), (0, 1), (2,), (3,)):
            cots = _cots(outs, gen, drop)
            got = G.depth_obj_backward_plain(dl, pass2.dtype, noise, tw,
                                             *cots, nf + nc, npass, na)
            _check_vjp(outs, (dl, pass2, fc3, box, attr), cots, got)


@pytest.mark.parametrize("name,slots,dname", CASES, ids=IDS)
def test_pres_backward_is_autograds(name, slots, dname):
    cfg, head, lat, _, gen, k = _case(name, slots, dname, 6)
    na = cfg.n_attributes
    s = slots
    stick = s > 1
    for tw_v in TWS:
        tw = torch.tensor(tw_v, dtype=lat)
        po = _rand(gen, (B, k, s, 1), head, 6.0)
        _edges(po, gen, slice(0, 1))
        po.requires_grad_()
        u = torch.rand((B, k, s), generator=gen, dtype=torch.float64)
        noise = (torch.log(u + 1e-9) - torch.log(1 - u + 1e-9)).to(lat)
        box = _rand(gen, (B, k, s, 4), lat).requires_grad_()
        attr = _rand(gen, (B, k, s, na), lat).requires_grad_()
        depth = _rand(gen, (B, k, s), lat).requires_grad_()
        outs = G.pres_plain(po, noise, tw, box, attr, depth, stick)
        for drop in ((), (0,), (1,)):
            cots = _cots(outs, gen, drop)
            got = G.pres_backward_plain(po, noise, tw, *cots, stick, na)
            _check_vjp(outs, (po, box, attr, depth), cots, got)


def _step_inputs(cfg, k, dtype, seed=7):
    gen = torch.Generator().manual_seed(seed)
    nf, nc, _, _ = widths(cfg)
    c, h, w = cfg.image_shape
    image = torch.rand((B, c, h, w), generator=gen)
    feat = torch.randn((B, k, nf), generator=gen).requires_grad_()
    ctx = torch.rand((B, k, nc), generator=gen).requires_grad_()
    noise = {name: v.reshape(B, k, -1) for name, v in L.sample_noise(
        gen, B, (1, k), cfg, "cpu").items()}
    gh, gw = L.geometry(cfg)[1]
    hw = torch.stack([torch.randint(0, gh, (k,), generator=gen),
                      torch.randint(0, gw, (k,), generator=gen)], -1)
    return image, feat, ctx, noise, hw


@pytest.mark.parametrize("name,slots,dname",
                         [(p, s, d) for p in PRESET_LANES for s in (1, 2)
                          for d in ("float32", "bf16")],
                         ids=[f"{p}-s{s}-{d}" for p in PRESET_LANES
                              for s in (1, 2) for d in ("float32", "bf16")])
def test_cell_step_equals_the_composition(name, slots, dname):
    """Outputs and every gradient (parameters, features, context) of
    ``cell_step`` against the composition, to the last bit."""
    cfg = preset(name, slots)
    compute = DTYPES[dname][2]
    k = PRESET_LANES[name]
    model = L.init_params(cfg, device="cpu")
    geom = L.geometry(cfg)
    image, feat, ctx, noise, hw = _step_inputs(cfg, k, compute)
    params = [p for p in model.parameters()]
    for tw_v in TWS:
        tw = torch.tensor(tw_v)
        got = leaves(L.cell_step(model, cfg, geom, image, feat, ctx, noise,
                                 hw, tw, compute))
        want = leaves(reference_cell_step(model, cfg, geom, image, feat, ctx,
                                          noise, hw, tw, compute))
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and torch.equal(a, b), i
        gen = torch.Generator().manual_seed(int(tw_v * 10))
        cots = [torch.randn(t.shape, generator=gen) for t in want]
        wrt = params + [feat, ctx]
        ga = torch.autograd.grad(got, wrt, cots, allow_unused=True)
        gb = torch.autograd.grad(want, wrt, cots, allow_unused=True)
        for i, (a, b) in enumerate(zip(ga, gb)):
            assert (a is None) == (b is None), i
            if a is not None:
                assert torch.equal(a, b), (i, float((a - b).abs().max()))


@pytest.mark.parametrize("slots", [1, 2])
def test_train_forward_over_the_wavefront_equals_the_composition(
        monkeypatch, slots):
    """A whole forward and backward through the wavefront's fronts: the
    loss and every parameter's gradient as with the composition, bit for
    bit (the cotangents of the shared tensors summed in the same order)."""
    cfg = dataclasses.replace(preset("paper128", slots),
                              image_shape=(1, 48, 48), anchor_shape=(24, 24),
                              object_shape=(14, 14))
    model = L.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((B,) + tuple(cfg.image_shape), generator=gen)
    grid = L.geometry(cfg)[1]
    noise = L.sample_noise(torch.Generator().manual_seed(12), B, grid, cfg,
                           "cpu")

    def run():
        loss, _ = M.forward(model, cfg, x, 1500, noise=noise)
        return loss, torch.autograd.grad(loss, list(model.parameters()),
                                         allow_unused=True)
    loss, grads = run()
    monkeypatch.setattr(M, "cell_step", reference_cell_step)
    loss_ref, grads_ref = run()
    assert torch.equal(loss, loss_ref)
    for a, b in zip(grads, grads_ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_wrappers_take_the_plain_versions_on_cpu_and_count_nothing():
    cfg = PRESETS["paper128"]()
    k = 6
    before = [w.launches for w in G.COUNTED]
    model = L.init_params(cfg, device="cpu")
    image, feat, ctx, noise, hw = _step_inputs(cfg, k, None)
    out = L.cell_step(model, cfg, L.geometry(cfg), image, feat, ctx, noise,
                      hw, torch.tensor(0.0))
    out["context_vec"].sum().backward()
    assert [w.launches for w in G.COUNTED] == before
    assert len(G.COUNTED) == 10
