"""The port's model options against the JAX package on the same inputs: the
parallel count prior, paste_glimpses, ordered compositing, top-K in both
render modes, the vestigial self-attention, ``forward`` with each option,
strict loads of converted parameters, and ``train()`` of the three presets
that need them, at reduced width.

Inputs are made with numpy from a seed and handed to both packages. Bars:
f32 forward relative error 1e-4 and gradients 1e-3 (bench.py's gates, max
|port - jax| / max(1, max |jax|)); top-K against the full grid at the JAX
package's own bars (tests/test_render_modes.py: values 1e-6, gradients
rtol 5e-4 / atol 1e-5). The JAX reference-mode top-K runs its Pallas kernel
in interpret mode, as its own tests do; the port's kernels run their plain
versions on these CPU tensors."""

import dataclasses
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.models import forward as jax_forward
from spair_pytorch_tpu.models import geometry as jax_geometry
from spair_pytorch_tpu.models.kl import count_prior_kl as jax_count_kl
from spair_pytorch_tpu.models.kl import \
    count_prior_kl_parallel as jax_count_kl_parallel
from spair_pytorch_tpu.models.latents import apply_self_attn as jax_attn
from spair_pytorch_tpu.models.latents import sample_noise as jax_noise
from spair_pytorch_tpu.ops.stn import paste_glimpses as jax_paste
from spair_pytorch_tpu_torch import train as ttrain
from spair_pytorch_tpu_torch.config import PRESETS
from spair_pytorch_tpu_torch.models import forward, init_params
from spair_pytorch_tpu_torch.models.kl import (count_prior_kl,
                                               count_prior_kl_parallel)
from spair_pytorch_tpu_torch.models.latents import (SpairModel,
                                                    apply_self_attn)
from spair_pytorch_tpu_torch.models.render import composite_ordered, render
from spair_pytorch_tpu_torch.ops.kernels import composite_ordered as O
from spair_pytorch_tpu_torch.ops.kernels.composite import (composite,
                                                           cull_tiles)
from spair_pytorch_tpu_torch.ops.stn import paste_glimpses
from spair_pytorch_tpu_torch.parallel import create_train_state
from spair_pytorch_tpu_torch.parallel.train_step import train_step
from spair_pytorch_tpu_torch.utils.interop import (adam_state_from_jax,
                                                   load_jax_params,
                                                   state_dict_from_jax)
from tests.test_model import tiny_config
from tests.test_render_modes import _topk_setup
from tests.test_torch_ops import (F32_REL, assert_close, jax_params_np,
                                  ported_params, rel_err, t, tcfg)

# the JAX models package exports a function named render
jax_render = importlib.import_module("spair_pytorch_tpu.models.render")
GRAD_REL = 1e-3


def tnoise(noise):
    return {k: t(v) for k, v in noise.items()}


def setup(cfg, seed=0, b=2):
    """(jax params as numpy, port model, x, noise as numpy)."""
    pnp = jax_params_np(cfg, seed)
    c, h, w = cfg.image_shape
    x = np.random.RandomState(seed + 1).rand(b, c, h, w).astype("f")
    _, grid, _ = jax_geometry(cfg)
    noise = jax.tree_util.tree_map(
        np.asarray, jax_noise(jax.random.PRNGKey(seed + 2), b, grid, cfg))
    return pnp, ported_params(cfg, pnp), x, noise


# ------------------------------------------------------------ count prior

def _presence(case):
    """(probabilities (B, gh, gw, 1), step) for one count-prior case."""
    rng = np.random.RandomState(0)
    if case == "dense 4x4 step 0":
        return rng.uniform(0.01, 0.99, (3, 4, 4, 1)).astype("f"), 0
    if case == "dense 11x11 step 1700":
        return rng.uniform(0.01, 0.99, (2, 11, 11, 1)).astype("f"), 1700
    if case == "dense 11x11 step 50000, the sequential clamp binds":
        return rng.uniform(0.01, 0.99, (2, 11, 11, 1)).astype("f"), 50000
    prob = np.full((2, 11, 11, 1), 0.01, "f")  # sparse, as a trained model
    idx = rng.choice(121, 5, replace=False)
    prob[:, idx // 11, idx % 11, 0] = 0.97
    return prob, 50000


@pytest.mark.parametrize("case", [
    "dense 4x4 step 0", "dense 11x11 step 1700",
    "dense 11x11 step 50000, the sequential clamp binds",
    "sparse 11x11 step 50000"])
def test_count_prior_parallel_matches_jax(case):
    cfg = tiny_config()
    prob, step = _presence(case)
    want = np.asarray(jax_count_kl_parallel(jnp.asarray(prob),
                                            jnp.asarray(prob), step, cfg))
    got = count_prior_kl_parallel(t(prob), t(prob), step, tcfg(cfg))
    assert bool(torch.isfinite(got).all())
    assert_close(got, want)
    seq = count_prior_kl(t(prob), t(prob), step, tcfg(cfg))
    if "binds" in case:
        # where the chain's normalizer clamp binds the two forms differ, in
        # the JAX package as in the port
        want_seq = np.asarray(jax_count_kl(jnp.asarray(prob),
                                           jnp.asarray(prob), step, cfg))
        assert rel_err(want, want_seq) > 1e-3
        assert rel_err(got, want_seq) > 1e-3
    else:
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("probs", ["mixed 0.02/0.98", "all 0.999"])
def test_count_prior_parallel_gradients_finite_and_match_jax(probs):
    """Saturated and mixed 0/1-rounding probabilities make zero factors,
    whose log(0) would give 0 * inf = NaN in a naive backward through p_z;
    the gradient reaches the KL through the probabilities only, as the
    sequential chain's does."""
    cfg = tiny_config()
    if probs == "all 0.999":
        prob = np.full((2, 11, 11, 1), 0.999, "f")
    else:
        prob = np.random.RandomState(3).choice(
            [0.02, 0.98], (2, 11, 11, 1)).astype("f")
    want = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_count_kl_parallel(p, p, 10, cfg)))(jnp.asarray(prob)))
    p = t(prob).requires_grad_(True)
    torch.sum(count_prior_kl_parallel(p, p, 10, tcfg(cfg))).backward()
    assert bool(torch.isfinite(p.grad).all())
    assert_close(p.grad, want, rel=GRAD_REL)
    q = t(prob).requires_grad_(True)
    torch.sum(count_prior_kl(q, q, 10, tcfg(cfg))).backward()
    assert_close(p.grad, q.grad.numpy(), rel=GRAD_REL)


# ------------------------------------------------------------- compositing

def test_paste_glimpses_matches_jax():
    rng = np.random.RandomState(1)
    glimpses = rng.rand(2, 5, 3, 7, 9).astype("f")
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (2, 5, 2)),
                            rng.uniform(0.1, 0.6, (2, 5, 2))], -1).astype("f")
    want = np.asarray(jax_paste(jnp.asarray(glimpses), jnp.asarray(boxes),
                                (20, 24)))
    got = paste_glimpses(t(glimpses), t(boxes), (20, 24))
    assert tuple(got.shape) == (2, 5, 3, 20, 24)
    assert_close(got, want)


def _ordered_inputs(ties: bool):
    rng = np.random.RandomState(2)
    b, n, c, o = 2, 7, 2, 8
    color = rng.rand(b, n, c, o, o).astype("f")
    alpha = (rng.rand(b, n, 1, o, o) * 1.2).astype("f")  # some clip at 1
    depth = rng.uniform(0.5, 3.5, (b, n, 1)).astype("f")
    if ties:
        depth[:, 1::2] = depth[:, :1]  # four objects share one depth
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, n, 2)),
                            rng.uniform(0.3, 0.6, (b, n, 2))], -1).astype("f")
    return color, alpha, depth, boxes


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_composite_ordered_matches_jax(ties):
    """Values and gradients (color, alpha, boxes) at chunk 3 over 7
    objects, so the last chunk is padded; with ties in depth the stable
    sort must keep the object order of the JAX package's argsort."""
    color, alpha, depth, boxes = _ordered_inputs(ties)

    def jax_fn(c, a, w):
        return jax_render.composite_ordered(c, a, jnp.asarray(depth), w,
                                            (20, 20), 3)
    want = np.asarray(jax_fn(*map(jnp.asarray, (color, alpha, boxes))))
    jgrads = jax.grad(lambda *args: jnp.sum(jax_fn(*args) ** 2),
                      argnums=(0, 1, 2))(*map(jnp.asarray,
                                              (color, alpha, boxes)))
    args = [t(v).requires_grad_(True) for v in (color, alpha, boxes)]
    got = composite_ordered(args[0], args[1], t(depth), args[2], (20, 20), 3)
    assert_close(got, want)
    torch.sum(got ** 2).backward()
    for a, g in zip(args, jgrads):
        assert_close(a.grad, np.asarray(g), rel=GRAD_REL)


def test_composite_ordered_ties_composite_in_object_order():
    """Two opaque objects at one depth on one box: the first in object
    order is in front, as a stable sort keeps it."""
    color = torch.stack([torch.full((1, 8, 8), 1.0),
                         torch.full((1, 8, 8), 0.25)])[None]
    alpha = torch.ones((1, 2, 1, 8, 8))
    boxes = torch.tensor([[[0.5, 0.5, 0.5, 0.5]] * 2])
    out = composite_ordered(color, alpha, torch.tensor([[[2.0], [2.0]]]),
                            boxes, (32, 32), 2)
    assert float(out[0, 0, 16, 16]) == pytest.approx(1.0, abs=1e-6)


# The ordered kernels' algorithm (ops/kernels/composite_ordered.py's
# plain versions under OrderedFunction, the path the kernels take on a
# card) against autograd of the scan. Bar: 1e-5 of each output's own scale,
# f32 sums of up to N layers in another order (they read ~3e-7).
ORDERED_CASES = {  # name: (B, N, C, chunk, depth ties, gated, alpha max)
    "clip": (2, 7, 2, 3, False, False, 1.2),
    "alpha exactly 1": (2, 6, 2, 4, False, False, 1.0),
    "whole pixels": (2, 6, 1, 4, False, False, 1.0),
    "gated": (2, 9, 1, 4, False, True, 1.0),
    "depth ties": (2, 7, 2, 3, True, False, 1.2),
    "N past the chunk": (1, 37, 1, 16, False, True, 1.0),
    "top-K N=32": (2, 32, 1, 16, True, True, 1.0),
}
# on a 33-px canvas: 17-px glimpses on these boxes sample whole texels
# (sy = i / 2, and sy = i - 16, sx = i), where the hat's derivative jumps
WHOLE_PIXEL_BOXES = [[0.5, 0.5, 1.0, 1.0], [0.25, 0.75, 0.5, 0.5]]


def _ordered_case(name, hw):
    b, n, c, chunk, ties, gated, hi = ORDERED_CASES[name]
    rng = np.random.RandomState(len(name))
    g = 17 if name == "whole pixels" else 8
    color = rng.rand(b, n, c, g, g).astype("f")
    alpha = (rng.rand(b, n, 1, g, g) * hi).astype("f")
    depth = rng.uniform(0.5, 3.5, (b, n, 1)).astype("f")
    if ties:
        depth[:, 1::2] = depth[:, :1]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, n, 2)),
                            rng.uniform(0.2, 0.6, (b, n, 2))], -1).astype("f")
    if name == "alpha exactly 1":
        # opaque glimpses on dyadic source coordinates off the texels
        # (sy = (28 i - 7) / 128 on 33 px, never whole): pasted alpha 1
        alpha[:, ::2] = 1.0
        boxes[:, ::2] = [0.5078125, 0.5078125, 1.0, 1.0]
    if name == "whole pixels":
        boxes[:, 0::3] = WHOLE_PIXEL_BOXES[0]
        boxes[:, 1::3] = WHOLE_PIXEL_BOXES[1]
    gate = (rng.rand(b, n) > 0.4).astype("f") if gated else None
    return color, alpha, depth, boxes, gate, chunk


def _ordered_grads(fn, color, alpha, depth, boxes, gate, hw, cot):
    leaves = [t(v).requires_grad_(True) for v in (color, alpha, boxes)]
    a = leaves[1] if gate is None else leaves[1] * t(gate)[:, :, None, None,
                                                           None]
    out = fn(leaves[0], a, t(depth), leaves[2])
    torch.sum(out * cot).backward()
    return [out.detach()] + [v.grad for v in leaves]


@pytest.mark.parametrize("name", sorted(ORDERED_CASES))
def test_ordered_kernel_algorithm_matches_autograd(name):
    """T front to back, R back to front, the inclusive clip mask, no
    division, the hat's derivative as autograd's clamp passes it (a texel
    at distance exactly 1 counts): values and gradients of colour, alpha
    (before the gate) and boxes equal autograd through
    ``composite_ordered``."""
    hw = (33, 33) if name in ("alpha exactly 1", "whole pixels") \
        else (20, 24)
    color, alpha, depth, boxes, gate, chunk = _ordered_case(name, hw)
    if name == "alpha exactly 1":
        pasted = O._pasted(t(color), t(alpha), t(boxes), hw)[:, ::2, -1]
        assert float(pasted.max()) == 1.0 and int((pasted == 1.0).sum()) > 0
    cot = torch.randn((color.shape[0], color.shape[2]) + hw,
                      generator=torch.Generator().manual_seed(3))
    gt = None if gate is None else t(gate)
    got = _ordered_grads(lambda *a: O.ordered_composite(*a, hw, gt),
                         color, alpha, depth, boxes, gate, hw, cot)
    want = _ordered_grads(lambda *a: composite_ordered(*a, hw, chunk),
                          color, alpha, depth, boxes, gate, hw, cot)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale
    if gate is not None:
        dead = torch.as_tensor(gate) == 0
        assert all(bool((g[dead] == 0).all()) for g in got[1:])


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_cull_tiles_cover_every_pasted_pixel(gated):
    """The kernels' cull (cull_tiles with their 32x8 tile) lists, for every
    tile, every live object whose paste touches one of its pixels, on
    objects in compositing order; gated objects are listed nowhere."""
    rng = np.random.RandomState(4)
    b, n, g, hw = 2, 40, 8, (72, 52)
    boxes = t(np.concatenate([rng.uniform(-0.1, 1.1, (b, n, 2)),
                              rng.uniform(0.02, 0.8, (b, n, 2))],
                             -1).astype("f"))
    depth = t(rng.rand(b, n).astype("f"))
    order = torch.argsort(-depth, dim=1, stable=True)
    boxes = torch.take_along_dim(boxes, order[..., None], dim=1)
    gate = t((rng.rand(b, n) > 0.3).astype("f")) if gated else None
    listed = cull_tiles(boxes, hw, (g, g), O.TILE, gate)
    touched = paste_glimpses(torch.ones(b, n, 1, g, g), boxes, hw)[:, :, 0]
    th, tw = O.TILE
    ty, tx = -(-hw[0] // th), -(-hw[1] // tw)
    pad = torch.zeros(b, n, ty * th, tx * tw)
    pad[:, :, :hw[0], :hw[1]] = touched
    per_tile = pad.reshape(b, n, ty, th, tx, tw).amax(dim=(3, 5)) > 0
    per_tile = per_tile.permute(0, 2, 3, 1)               # (B, ty, tx, N)
    if gate is not None:
        per_tile &= (gate != 0)[:, None, None, :]
        assert not bool(listed[(gate == 0)[:, None, None, :]
                               .expand_as(listed)].any())
    assert bool(per_tile.any())
    assert not bool((per_tile & ~listed).any())


def test_composite_over_on_cpu_is_the_scan():
    """On CPU tensors the entry returns ``composite_ordered``'s result,
    values and gradients, bit for bit."""
    color, alpha, depth, boxes, gate, chunk = _ordered_case("gated",
                                                            (20, 24))
    cot = torch.randn(2, 1, 20, 24, generator=torch.Generator().manual_seed(5))
    got = _ordered_grads(
        lambda *a: O.composite_over(*a, (20, 24), pres_gate=t(gate),
                                    chunk=chunk),
        color, alpha, depth, boxes, gate, (20, 24), cot)
    want = _ordered_grads(lambda *a: composite_ordered(*a, (20, 24), chunk),
                          color, alpha, depth, boxes, gate, (20, 24), cot)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("backend", ["auto", "pallas", "pallas_v3", "xla"])
def test_ordered_render_routes_by_backend(monkeypatch, backend):
    """Ordered mode takes ``composite_over`` (the kernels on a card) on
    every backend but 'xla', which keeps the plain scan, with the gate of
    the branch's objects passed on."""
    import spair_pytorch_tpu_torch.models.render as R
    calls = []
    monkeypatch.setattr(R, "composite_over", lambda *a, **kw: (
        calls.append(("over", kw["pres_gate"].shape)),
        O.composite_over(*a, **kw))[1])
    monkeypatch.setattr(R, "composite_ordered", lambda *a, **kw: (
        calls.append(("scan", None)), O.composite_ordered(*a, **kw))[1])
    base, pnp, model, zs = _render_case(SPARSE, "ordered",
                                        render_backend=backend)
    topk = dataclasses.replace(base, render_topk=8)
    _port_run(topk, model, zs)
    assert calls == ([("scan", None)] if backend == "xla"
                     else [("over", (2, 8))])


def _render_case(pattern, mode, seed=0, **over):
    """JAX's crafted top-K latents (tests/test_render_modes.py) with both
    configs, the JAX params, the port's model and the latents as numpy."""
    base, params, zs = _topk_setup(pattern, seed)
    base = dataclasses.replace(base, render_mode=mode, **over)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return base, pnp, ported_params(base, pnp), [np.asarray(z) for z in zs]


def _jax_run(cfg, pnp, zs, grads=True):
    def f(a, w):
        return jax_render.render(pnp, cfg, a, w, jnp.asarray(zs[2]),
                                 jnp.asarray(zs[3]), (48, 48))
    out = np.asarray(f(jnp.asarray(zs[0]), jnp.asarray(zs[1])))
    if not grads:
        return out, None
    g = jax.grad(lambda a, w: jnp.sum(f(a, w) ** 2), argnums=(0, 1))(
        jnp.asarray(zs[0]), jnp.asarray(zs[1]))
    return out, [np.asarray(v) for v in g]


def _port_run(cfg, model, zs):
    a, w = (t(z).requires_grad_(True) for z in zs[:2])
    out = render(model, tcfg(cfg), a, w, t(zs[2]), t(zs[3]), (48, 48))
    torch.sum(out ** 2).backward()
    return out.detach(), [a.grad, w.grad]


SPARSE = np.full(16, 0.001)
SPARSE[[2, 7, 11]] = [0.9, 0.6, 0.3]  # 3 live objects above the 0.01 gate
MODES = [("ordered", {}), ("reference", {"render_backend": "pallas"}),
         ("reference", {"render_backend": "auto"})]
MODE_IDS = ["ordered", "reference-pallas", "reference-auto"]


@pytest.mark.parametrize("mode,over", MODES, ids=MODE_IDS)
def test_render_topk_exact_when_sparse(mode, over):
    """3 live objects, K=8: the top-K branch equals the full grid (the
    gated kernel's plain version in reference mode), values and gradients
    against z_attr and z_where, and both equal the JAX package's."""
    base, pnp, model, zs = _render_case(SPARSE, mode, **over)
    topk = dataclasses.replace(base, render_topk=8)
    out_full, g_full = _port_run(base, model, zs)
    out_topk, g_topk = _port_run(topk, model, zs)
    np.testing.assert_allclose(out_topk.numpy(), out_full.numpy(),
                               rtol=1e-6, atol=1e-6)
    for gt, gf in zip(g_topk, g_full):
        np.testing.assert_allclose(gt.numpy(), gf.numpy(), rtol=5e-4,
                                   atol=1e-5)
    # the JAX package's ordered gradients are held in
    # test_composite_ordered_matches_jax and the forward-gradient test
    jcfg = topk if mode == "ordered" else dataclasses.replace(
        topk, render_backend="pallas")
    want, jgrads = _jax_run(jcfg, pnp, zs, grads=mode != "ordered")
    assert_close(out_topk, want)
    for g, w in zip(g_topk, jgrads or ()):
        assert_close(g, w, rel=GRAD_REL)


TIED = np.full(16, 0.001)
TIED[[2, 7, 11, 13]] = 1.0  # 4 live objects at presence saturated to 1


def _tied_case(mode, **over):
    """TIED's presence on JAX's crafted top-K latents, every object on one
    box and at one depth: the top-K gather's order among the tied live
    objects is the compositing order of ordered mode."""
    base, pnp, model, zs = _render_case(TIED, mode, **over)
    zs[1] = np.broadcast_to(np.asarray([0.5, 0.5, 0.45, 0.45], "f"),
                            zs[1].shape).copy()
    zs[2] = np.full_like(zs[2], 2.0)
    return base, pnp, model, zs


@pytest.mark.parametrize("mode,over", MODES[:2], ids=MODE_IDS[:2])
def test_render_topk_ties_take_jax_order(mode, over):
    """4 live objects at presence exactly 1.0, on one box at one depth,
    K=8: the top-K render equals the JAX package's, values and gradients
    against z_attr and z_where (1e-4, 1e-3). ``jax.lax.top_k`` puts tied
    scores in index order; ordered mode composites the gathered objects at
    equal depth in that order, so another order changes the image. In
    reference mode the order reorders only K1's sums."""
    base, pnp, model, zs = _tied_case(mode, **over)
    topk = dataclasses.replace(base, render_topk=8)
    jcfg = topk if mode == "ordered" else dataclasses.replace(
        topk, render_backend="pallas")
    got, grads = _port_run(topk, model, zs)
    want, jgrads = _jax_run(jcfg, pnp, zs)
    assert_close(got, want)
    for g, w in zip(grads, jgrads):
        assert_close(g, w, rel=GRAD_REL)


def test_top_k_gathers_ties_in_index_order():
    """The gather itself: tied scores in index order, as jax.lax.top_k
    returns them."""
    scores = t(np.stack([TIED, TIED[::-1]]).astype("f"))
    idx = np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), 8)[1])
    take = importlib.import_module(
        "spair_pytorch_tpu_torch.models.render")._top_k(scores, 8)
    got = take(torch.arange(16).expand(2, 16)[..., None])[..., 0]
    np.testing.assert_array_equal(got.numpy(), idx)
    np.testing.assert_array_equal(got[0, :4].numpy(), [2, 7, 11, 13])


@pytest.mark.parametrize("mode,over", MODES[:2], ids=MODE_IDS[:2])
def test_render_topk_falls_back_when_dense(mode, over):
    """16 live objects, K=8: the full grid runs, and the result equals
    render_topk=0 and the JAX package's top-K render."""
    base, pnp, model, zs = _render_case(np.full(16, 0.9), mode, seed=5,
                                        **over)
    topk = dataclasses.replace(base, render_topk=8)
    with torch.no_grad():
        out_full = render(model, tcfg(base), *map(t, zs), (48, 48))
        out_topk = render(model, tcfg(topk), *map(t, zs), (48, 48))
    np.testing.assert_allclose(out_topk.numpy(), out_full.numpy(),
                               rtol=1e-6, atol=1e-6)
    want, _ = _jax_run(topk, pnp, zs, grads=False)
    assert_close(out_topk, want)


def test_reference_topk_keeps_the_den_floor():
    """The gathered composite keeps den's floor of all n objects
    (den_floor_n=n): equal to the full grid's den, which a floor of K
    objects would not be."""
    b, n, k = 1, 16, 4
    rng = np.random.RandomState(0)
    color, alpha, imp = (t(rng.rand(b, n, ch, 8, 8).astype("f"))
                         for ch in (1, 1, 1))
    boxes = t(np.stack([rng.uniform(0.3, 0.7, (b, n)),
                        rng.uniform(0.3, 0.7, (b, n)),
                        np.full((b, n), 0.3), np.full((b, n), 0.3)],
                       -1).astype("f"))
    gate = torch.zeros((b, n))
    gate[:, [3, 9]] = 1.0
    num_f, den_f = composite(color, alpha, imp, boxes, (48, 48),
                             pres_gate=gate)
    idx = torch.topk(gate, k, dim=1).indices

    def take(v):
        return torch.take_along_dim(
            v, idx.reshape((b, k) + (1,) * (v.ndim - 2)), dim=1)
    args = [take(v) for v in (color, alpha, imp, boxes)]
    num_k, den_k = composite(*args, (48, 48), pres_gate=take(gate),
                             den_floor_n=n)
    np.testing.assert_allclose(num_k.numpy(), num_f.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(den_k.numpy(), den_f.numpy(), rtol=1e-6,
                               atol=0)
    _, den_bad = composite(*args, (48, 48), pres_gate=take(gate))
    assert float((den_bad - den_f).abs().max()) > 0


@pytest.mark.parametrize("mode,over", MODES[:2], ids=MODE_IDS[:2])
def test_render_topk_requires_the_gate(mode, over):
    base, _, model, zs = _render_case(np.full(16, 0.5), mode, **over)
    nogate = dataclasses.replace(base, render_topk=8,
                                 pres_gate_threshold=0.0)
    with pytest.raises(ValueError, match="render_topk"):
        render(model, tcfg(nogate), *map(t, zs), (48, 48))


@pytest.mark.parametrize("backend", ["xla", "pallas_v3"])
def test_render_topk_is_ignored_off_the_kernel_backends(backend):
    """As in the JAX package, 'xla' and 'pallas_v3' composite the full
    grid whatever render_topk says."""
    base, _, model, zs = _render_case(SPARSE, "reference",
                                      render_backend=backend)
    with torch.no_grad():
        full = render(model, tcfg(base), *map(t, zs), (48, 48))
        topk = render(model, tcfg(dataclasses.replace(base, render_topk=8)),
                      *map(t, zs), (48, 48))
    assert torch.equal(full, topk)


# ------------------------------------------------------- self-attention

def test_apply_self_attn_matches_jax():
    cfg = tiny_config(vestigial_self_attn=True)
    pnp = jax_params_np(cfg, 4)
    model = ported_params(cfg, pnp)
    ctx = np.random.RandomState(4).randn(2, 9, 13).astype("f")
    want = np.asarray(jax_attn(pnp["self_attn"], jnp.asarray(ctx)))
    with torch.no_grad():
        got = apply_self_attn(model.self_attn, t(ctx))
    assert_close(got, want)


def test_self_attn_leaves_loss_and_gradients_unchanged():
    """The block runs (its mean is finite and surfaced), the loss equals
    the loss without it bit for bit, its own gradient is exactly zero and
    every other gradient is unchanged, on the same weights, images and
    noise."""
    jcfg = tiny_config(inference_mode="independent",
                       vestigial_self_attn=True)
    _, model, x, noise = setup(jcfg, seed=8)
    cfg_on = tcfg(jcfg)
    cfg_off = dataclasses.replace(cfg_on, vestigial_self_attn=False)
    off = SpairModel(cfg_off)
    off.load_state_dict({k: v for k, v in model.state_dict().items()
                         if not k.startswith("self_attn.")}, strict=True)

    def run(m, c):
        m.zero_grad(set_to_none=True)
        loss, aux = forward(m, c, t(x), 1500, noise=tnoise(noise))
        loss.backward()
        return loss, aux, {k: p.grad for k, p in m.named_parameters()}

    loss_on, aux_on, g_on = run(model, cfg_on)
    loss_off, aux_off, g_off = run(off, cfg_off)
    assert math.isfinite(float(aux_on["losses"]["debug/self_attn_mean"]
                               .detach()))
    assert "debug/self_attn_mean" not in aux_off["losses"]
    assert torch.equal(loss_on, loss_off)
    for k, g in g_on.items():
        if k.startswith("self_attn."):
            assert g is None or not bool(g.any()), k
        else:
            assert torch.equal(g, g_off[k]), k
    # the train step gives the block zero gradients, which Adam takes
    state = create_train_state(cfg_on, device="cpu")
    state.model.load_state_dict(model.state_dict())
    out = train_step(cfg_on, state, t(x), noise=tnoise(noise))
    assert float(out["grad_norm/self_attn"]) == 0.0
    assert float(out["losses/total"]) == float(loss_on)


# ------------------------------------------------- forward with each option

OPTIONS = {  # the conv codec's are in tests/test_torch_convcodec.py
    "self-attention": dict(vestigial_self_attn=True),
    "parallel count prior": dict(count_prior_parallel=True),
    "ordered": dict(render_mode="ordered", render_chunk=4),
    "ordered top-K": dict(render_mode="ordered", render_chunk=4,
                          pres_gate_threshold=0.01, render_topk=8),
    "reference top-K": dict(render_backend="pallas",
                            pres_gate_threshold=0.01, render_topk=8),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_forward_with_each_option_matches_jax(option):
    """Loss, every logged term, the reconstruction and the latents against
    JAX forward on the same params and noise; independent inference at
    step 1500 (the training wheel on) and wavefront at 2500 (off)."""
    for mode, step in (("independent", 1500), ("wavefront", 2500)):
        cfg = tiny_config(inference_mode=mode, **OPTIONS[option])
        pnp, model, x, noise = setup(cfg, seed=21)
        loss_j, aux_j = jax_forward(pnp, cfg, jnp.asarray(x), step, None,
                                    noise)
        with torch.no_grad():
            loss, aux = forward(model, tcfg(cfg), t(x), step,
                                noise=tnoise(noise))
        assert abs(float(loss) - float(loss_j)) < F32_REL * abs(float(loss_j))
        assert sorted(aux["losses"]) == sorted(aux_j["losses"])
        for k, v in aux_j["losses"].items():
            assert abs(float(aux["losses"][k]) - float(v)) \
                < F32_REL * max(1.0, abs(float(v))), k
        for k in ("recon", "z_where", "z_pres", "z_depth", "z_attr"):
            assert_close(aux[k], np.asarray(aux_j[k]))


@pytest.mark.parametrize("option", ["ordered top-K", "reference top-K",
                                    "parallel count prior"])
def test_gradients_with_each_option_match_jax(option):
    """Every parameter's gradient of the loss against jax.grad, per
    parameter, at the gradient bar."""
    cfg = tiny_config(inference_mode="independent", **OPTIONS[option])
    pnp, model, x, noise = setup(cfg, seed=23)
    step = 2500
    jgrads = jax.grad(lambda p: jax_forward(p, cfg, jnp.asarray(x), step,
                                            None, noise)[0])(
        jax.tree_util.tree_map(jnp.asarray, pnp))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, _ = forward(model, tcfg(cfg), t(x), step, noise=tnoise(noise))
    loss.backward()
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_close(g, want[k], rel=GRAD_REL)


# ------------------------------------------------------ weights carried over

def assert_strict_load(cfg, pnp=None):
    """JAX params (``pnp``, else JAX's init from seed 3) and Adam moments
    load with strict=True, every key and shape equal."""
    if pnp is None:
        pnp = jax_params_np(cfg, 3)
    sd = state_dict_from_jax(pnp)
    model = init_params(tcfg(cfg), device="cpu")
    assert sorted(sd) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    load_jax_params(model, pnp)
    moments = adam_state_from_jax(
        type("Adam", (), {"count": np.int32(7), "mu": pnp, "nu": pnp})(),
        model)
    assert len(moments) == len(list(model.parameters()))
    for (name, p), m in zip(model.named_parameters(), moments.values()):
        assert torch.equal(m["exp_avg"], p.detach()), name


def test_strict_load_of_converted_self_attention_params():
    assert_strict_load(tiny_config(vestigial_self_attn=True))


# --------------------------------------------------- the three presets train

TINY = dict(image_shape=(1, 48, 48), batch_size=2, object_shape=(14, 14),
            anchor_shape=(24, 24), n_attributes=8, mlp_hidden=(32, 32),
            encoder_hidden=(32,), decoder_hidden=(32,),
            n_backbone_features=16, n_passthrough_features=16,
            render_chunk=8)


@pytest.mark.parametrize("preset", ["cluttered_fine", "quality",
                                    "tpu_throughput"])
def test_preset_trains_at_reduced_width(preset, tmp_path):
    """train() of a few steps at the preset's options (fine grid and top-K,
    ordered mode, bf16 with the parallel count prior) and the tiny widths:
    finite losses in every logged row, every step logged."""
    cfg = PRESETS[preset](**TINY)
    state = ttrain.train(cfg, steps=2, logdir=str(tmp_path),
                         checkpoint_every=0, metrics_every=1,
                         digits="font", verbose=False, device="cpu")
    assert int(state.step) == 2
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["losses/total"] for r in rows if "losses/total" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)

