"""The port's training step against the JAX package on the CPU.

Same parameters (JAX ``init_params`` through the port's converter), same
injected noise (JAX ``sample_noise`` as numpy), same images. Tolerances,
as max |port - jax| / max(1, max |jax|) per parameter: f32 gradients 1e-3
(bench.py's gradient bar); bf16 compute 3e-2 on the forward and 6e-2 on
each head's gradients (see its test); losses along a trajectory 1e-4
relative; parameters along it 2 * lr * steps absolute, since Adam's first
steps move a parameter by about lr * sign(g) whatever the size of g."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spair_pytorch_tpu import metrics as jmetrics
from spair_pytorch_tpu.models import forward as jax_forward
from spair_pytorch_tpu.models import geometry as jax_geometry
from spair_pytorch_tpu.models.latents import sample_noise as jax_noise
from spair_pytorch_tpu.ops import math as jm
from spair_pytorch_tpu.parallel import train_step as jts
from spair_pytorch_tpu.utils.debug import grad_norms_by_head as jax_norms
from spair_pytorch_tpu_torch import metrics
from spair_pytorch_tpu_torch.data import DataConfig, glyph_bank
from spair_pytorch_tpu_torch.models import forward
from spair_pytorch_tpu_torch.ops import math as tm
from spair_pytorch_tpu_torch.parallel import (TrainState, create_train_state,
                                              make_train_step, optimizer,
                                              train_step)
from spair_pytorch_tpu_torch.parallel.train_step import clip_by_global_norm_
from spair_pytorch_tpu_torch.utils.debug import grad_norms_by_head
from spair_pytorch_tpu_torch.utils.interop import (load_jax_adam_state,
                                                   state_dict_from_jax)
from tests.test_model import tiny_config
from tests.test_torch_ops import (jax_params_np, ported_params, rel_err, t,
                                  tcfg)

B, STEP = 2, 1500
GRAD_REL, BF16_REL, BF16_GRAD_REL, LOSS_REL = 1e-3, 3e-2, 6e-2, 1e-4
CFGS = {  # order: (inference_mode, pres_gate_threshold)
    "independent": ("independent", 0.3),
    "raster": ("raster", 0.0),
    "wavefront": ("wavefront", 0.0),
}


def config(order, **kw):
    mode, gate = CFGS[order]
    return tiny_config(inference_mode=mode, pres_gate_threshold=gate,
                       render_backend="pallas", **kw)


def batch(seed, cfg):
    x = np.random.RandomState(seed).rand(B, *cfg.image_shape).astype("f")
    _, grid, _ = jax_geometry(cfg)
    noise = jax.tree_util.tree_map(
        np.asarray, jax_noise(jax.random.PRNGKey(seed), B, grid, cfg))
    return x, noise


def tnoise(noise):
    return {k: t(v) for k, v in noise.items()}


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(order, compute_dtype="float32"):
    """Jitted ((loss, recon), grads) of JAX forward for one config:
    compiled once per module, shared by the gradient and trajectory
    tests."""
    cfg = config(order, compute_dtype=compute_dtype)

    def loss_recon(p, x, step, noise):
        loss, aux = jax_forward(p, cfg, x, step, None, noise)
        return loss, aux["recon"]

    return jax.jit(jax.value_and_grad(loss_recon, has_aux=True))


def port_value_and_grad(model, cfg, x, noise, step=STEP):
    model.zero_grad(set_to_none=True)
    loss, aux = forward(model, tcfg(cfg), t(x), step, noise=tnoise(noise))
    loss.backward()
    return loss, aux, {k: p.grad for k, p in model.named_parameters()}


def jax_grads_by_name(grads):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


# ----------------------------------------------------- custom backwards

def test_analytical_sigmoid_grad_matches_jax_and_is_finite():
    x = np.float32([-100.0, -50.0, 0.0, 50.0])
    w = np.float32([1.0, 2.0, 3.0, 4.0])
    want = jax.grad(lambda v: jnp.sum(jm.clamped_sigmoid(v, True) * w))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (tm.clamped_sigmoid(xt, use_analytical=True) * t(w)).sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    assert rel_err(xt.grad, np.asarray(want)) < 1e-6
    # the hazard the custom backward removes: autograd through the
    # expression is inf / inf at x = -100
    naive = t(x).requires_grad_(True)
    (1.0 / (torch.exp(-naive) + 1.0)).sum().backward()
    assert bool(torch.isnan(naive.grad[0]))


def test_bce_grad_matches_jax_at_zero_and_one():
    recon = np.float32([0.0, 0.0, 1.0, 1.0, 0.3, 0.9, 1e-7, 0.5])
    target = np.float32([0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.25])
    want = jax.grad(jm.binary_cross_entropy_sum)(jnp.asarray(recon),
                                                 jnp.asarray(target))
    r = t(recon).requires_grad_(True)
    tm.binary_cross_entropy_sum(r, t(target)).backward()
    got, want = r.grad.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_clipping_is_optax_rule():
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype("f"), rng.randn(5).astype("f")]
    for max_norm in (1.0, 100.0):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update([jnp.asarray(g) for g in grads],
                              clip.init(None))
        got = [t(g) for g in grads]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in got))
        clip_by_global_norm_(got, norm, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------- whole-model gradients

@pytest.mark.parametrize("order", sorted(CFGS))
def test_model_gradients_match_jax(order):
    """Loss and every parameter's gradient, with the Pallas compositor in
    interpret mode on the JAX side and the port's autograd Function (its
    plain forward and backward on CPU tensors) on the other; the
    independent order runs gated. The wavefront and raster orders write
    the halo board in place, and their gradients go through it."""
    cfg = config(order)
    pnp = jax_params_np(cfg, seed=1)
    x, noise = batch(2, cfg)
    (loss_j, _), grads_j = jax_value_and_grad(order)(pnp, jnp.asarray(x),
                                                     STEP, noise)
    model = ported_params(cfg, pnp)
    loss, _, grads = port_value_and_grad(model, cfg, x, noise)
    assert abs(loss.item() - float(loss_j)) < LOSS_REL * abs(float(loss_j))
    want = jax_grads_by_name(grads_j)
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        assert rel_err(grads[k], w) < GRAD_REL, k
    norms, norms_j = grad_norms_by_head(model), jax_norms(grads_j)
    assert sorted(norms) == sorted(norms_j)
    for k, v in norms_j.items():
        assert abs(float(norms[k]) - float(v)) <= GRAD_REL * float(v), k


def by_head(grads):
    """Per-parameter gradients -> one float64 vector per head (the first
    component of the parameter's name)."""
    heads = {}
    for k in sorted(grads):
        heads.setdefault(k.split(".")[0], []).append(
            torch.as_tensor(np.asarray(grads[k])).reshape(-1))
    return {h: torch.cat(v).double() for h, v in heads.items()}


def head_err(got, want):
    """(max |got - want| / max |want|, cosine) over one head's gradients."""
    err = float((got - want).abs().max() / want.abs().max())
    return err, float(got @ want / (got.norm() * want.norm()))


def test_bf16_compute_against_f32_truth():
    """compute_dtype='bfloat16' (backbone, MLPs and glimpse crop in bf16;
    f32 master weights, f32 latent math and compositor), wavefront. A
    head's gradient error is max |got - want| / max |want| over all of the
    head's parameters.

    Against the JAX package's own bf16 forward and gradients, from the
    same parameters and noise: forward 3e-2, every head 6e-2 and cosine >
    0.995 (measured <= 5.0e-2 and >= 0.998). A port that ignored the
    compute dtype misses this bar: the JAX bf16 gradients are 8e-2 to
    1.8e-1 from the f32 ones on the inference heads.

    Against the f32 truth: forward 3e-2; the decoder, whose gradients reach
    the loss through the f32 compositor, 6e-2 (measured 3.3e-3). The
    inference heads' gradients run back through the bf16 scan, and there
    the JAX package's own bf16 path is over 6e-2 off (asserted), so each
    head is held to twice the JAX package's own error (measured <= 1.62x)
    and to cosine > 0.97 (both packages measured >= 0.988)."""
    cfg = config("wavefront", compute_dtype="bfloat16")
    pnp = jax_params_np(cfg, seed=1)
    x, noise = batch(2, cfg)
    xj = jnp.asarray(x)
    (loss32, recon32), grads32 = jax_value_and_grad("wavefront")(
        pnp, xj, STEP, noise)
    (loss16, recon16), grads16 = jax_value_and_grad(
        "wavefront", "bfloat16")(pnp, xj, STEP, noise)
    model = ported_params(cfg, pnp)
    seen = []
    model.backbone.register_forward_hook(
        lambda m, i, out: seen.append(out.dtype))
    loss, aux, grads = port_value_and_grad(model, cfg, x, noise)
    assert seen == [torch.bfloat16]
    assert aux["recon"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for loss_j, recon_j in ((loss16, recon16), (loss32, recon32)):
        assert abs(loss.item() - float(loss_j)) < BF16_REL * abs(float(loss_j))
        assert rel_err(aux["recon"], np.asarray(recon_j)) < BF16_REL

    got = by_head({k: g.numpy() for k, g in grads.items()})
    jax16 = by_head(jax_grads_by_name(grads16))
    truth = by_head(jax_grads_by_name(grads32))
    assert sorted(got) == sorted(truth)
    jax_off = {h: head_err(jax16[h], truth[h]) for h in truth}
    assert max(err for err, _ in jax_off.values()) > BF16_GRAD_REL
    for head in truth:
        assert bool(torch.isfinite(got[head]).all()), head
        err, cos = head_err(got[head], jax16[head])
        assert err < BF16_GRAD_REL and cos > 0.995, (head, err, cos)
        err, cos = head_err(got[head], truth[head])
        jax_err, jax_cos = jax_off[head]
        assert jax_cos > 0.97, (head, jax_cos)
        if head == "object_decoder":
            assert err < BF16_GRAD_REL, (head, err)
        assert err <= max(2 * jax_err, BF16_GRAD_REL) and cos > 0.97, (
            head, err, jax_err, cos)


# ---------------------------------------------------------- trajectories

def jax_trajectory(cfg, params, opt_state, batches, step):
    vg, opt = jax_value_and_grad("wavefront"), jts.optimizer(cfg)
    losses = []
    for i, (x, noise) in enumerate(batches):
        (loss, _), grads = vg(params, jnp.asarray(x), step + i, noise)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params, opt_state


def port_state(cfg, pnp, step):
    model = ported_params(cfg, pnp)
    return TrainState(step=torch.tensor(step), model=model,
                      optimizer=optimizer(tcfg(cfg), model),
                      generator=torch.Generator())


def assert_params_close(model, params, tol):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, p in model.named_parameters():
        assert float((p.detach() - t(want[k])).abs().max()) <= tol, k


def test_three_steps_match_jax_then_carry_the_state_across():
    """Three Adam steps of both packages from the same parameters; then the
    JAX state after them (parameters and non-zero Adam moments) loaded into
    a fresh port state, and one more step of each."""
    cfg = config("wavefront")
    pnp = jax_params_np(cfg, seed=3)
    batches = [batch(10 + i, cfg) for i in range(4)]
    opt = jts.optimizer(cfg)
    losses_j, params_j, opt_j = jax_trajectory(
        cfg, pnp, opt.init(pnp), batches[:3], STEP)

    state = port_state(cfg, pnp, STEP)
    losses = [float(train_step(tcfg(cfg), state, t(x), noise=tnoise(noise))
                    ["losses/total"]) for x, noise in batches[:3]]
    for got, want in zip(losses, losses_j):
        assert abs(got - want) < LOSS_REL * abs(want)
    assert int(state.step) == STEP + 3
    assert_params_close(state.model, params_j, 2 * cfg.learning_rate * 3)

    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    opt_np = jax.tree_util.tree_map(np.asarray, opt_j)
    carried = port_state(cfg, params_np, STEP + 3)
    load_jax_adam_state(carried.optimizer, carried.model, opt_np)
    moments = carried.optimizer.state[carried.model.object_decoder.out.weight]
    assert float(moments["step"]) == 3.0
    assert float(moments["exp_avg"].abs().max()) > 0
    (loss_j,), params_j, _ = jax_trajectory(cfg, params_np, opt_np,
                                            batches[3:], STEP + 3)
    x, noise = batches[3]
    loss = float(train_step(tcfg(cfg), carried, t(x), noise=tnoise(noise))
                 ["losses/total"])
    assert abs(loss - loss_j) < LOSS_REL * abs(loss_j)
    assert_params_close(carried.model, params_j, 2 * cfg.learning_rate)


def test_metric_keys_equal_jax():
    cfg = tiny_config(inference_mode="independent", batch_size=B)
    jstate = jts.create_train_state(cfg)
    jbatch = (jnp.zeros((B,) + cfg.image_shape), jnp.zeros((B, 6, 4)),
              jnp.ones((B, 1)))
    _, want = jax.eval_shape(jts.make_train_step(
        cfg, with_detection=True, donate=False), jstate, jbatch)
    state = port_state(cfg, jax_params_np(cfg), 0)
    x, _ = batch(0, cfg)
    got = train_step(tcfg(cfg), state, t(x), torch.zeros(B, 6, 4),
                     torch.ones(B, 1))
    assert sorted(got) == sorted(want)
    assert all(v.dim() == 0 and not v.requires_grad for v in got.values())


def test_detection_metrics_match_jax():
    rng = np.random.RandomState(4)
    z_where = np.concatenate([rng.rand(3, 2, 4, 5),
                              rng.uniform(0.05, 0.4, (3, 2, 4, 5))],
                             axis=1).astype("f")
    z_pres = rng.rand(3, 1, 4, 5).astype("f")
    gt_count = np.float32([[1], [3], [6]])
    gt_bbox = np.concatenate([rng.uniform(0, 100, (3, 6, 2)),
                              rng.uniform(5, 30, (3, 6, 2))], -1)
    gt_bbox = (gt_bbox * (np.arange(6)[None, :, None] < gt_count[:, :, None])
               ).astype("f")
    args = (z_where, z_pres, gt_bbox, gt_count)
    for name in ("mAP", "mAP_center"):
        want = getattr(jmetrics, name)(*map(jnp.asarray, args), 128)
        got = getattr(metrics, name)(*map(t, args), 128)
        assert abs(float(got) - float(want)) < 1e-5, name
    for name in ("object_count_error", "count_accuracy"):
        want = getattr(jmetrics, name)(jnp.asarray(z_pres),
                                       jnp.asarray(gt_count))
        got = getattr(metrics, name)(t(z_pres), t(gt_count))
        assert abs(float(got) - float(want)) < 1e-6, name


def test_steps_per_call_equals_single_steps():
    cfg = tcfg(tiny_config(inference_mode="wavefront", batch_size=B,
                           pres_gate_threshold=0.01))
    bank = torch.as_tensor(glyph_bank((14, 14)))
    dcfg = DataConfig(image_hw=cfg.image_shape[1:],
                      min_objects=cfg.min_scene_objects,
                      max_objects=cfg.max_scene_objects)
    three = make_train_step(cfg, datagen=(dcfg, bank), steps_per_call=3)
    one = make_train_step(cfg, datagen=(dcfg, bank))
    s3, m3 = three(create_train_state(cfg, seed=5, device="cpu"))
    s1 = create_train_state(cfg, seed=5, device="cpu")
    singles = [one(s1)[1] for _ in range(3)]
    assert int(s3.step) == int(s1.step) == 3
    for k, v in m3.items():
        assert v.shape == (3,), k
        assert torch.equal(v, torch.stack([m[k] for m in singles])), k
    for p3, p1 in zip(s3.model.parameters(), s1.model.parameters()):
        assert torch.equal(p3, p1)
    assert bool(torch.isfinite(m3["losses/total"]).all())
