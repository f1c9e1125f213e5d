"""The port's model (inference orders, KLs, forward, eval step) against
the JAX package on the same params and injected noise.

Params come from JAX ``init_params``, converted with the port's converter;
noise from JAX ``sample_noise``, passed to both as numpy. Tolerance: f32
relative error 1e-4 (bench.py's forward gate, max |port - jax| /
max(1, max |jax|)), on losses relative to the loss itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.models import forward as jax_forward
from spair_pytorch_tpu.models import geometry as jax_geometry
from spair_pytorch_tpu.models.kl import count_prior_kl as jax_count_kl
from spair_pytorch_tpu.models.kl import independent_kl as jax_indep_kl
from spair_pytorch_tpu.models.latents import sample_noise as jax_noise
from spair_pytorch_tpu.models.spair import infer_latents as jax_infer
from spair_pytorch_tpu.models.spair import inference_schedule as jax_sched
from spair_pytorch_tpu.config import paper_config
from spair_pytorch_tpu_torch.models import (forward, infer_latents,
                                            inference_schedule, sample_noise)
from spair_pytorch_tpu_torch.models.kl import count_prior_kl, independent_kl
from spair_pytorch_tpu_torch.parallel import make_eval_step
from tests.test_model import tiny_config
from tests.test_torch_ops import (F32_REL, assert_close, jax_params_np,
                                  ported_params, t)

B = 2


def setup(cfg, seed=0, step=1500):
    """(jax params, port model, x, noise) for one parity case."""
    pnp = jax_params_np(cfg, seed)
    model = ported_params(cfg, pnp)
    c, h, w = cfg.image_shape
    x = np.random.RandomState(seed + 1).rand(B, c, h, w).astype("f")
    _, grid, _ = jax_geometry(cfg)
    noise = jax.tree_util.tree_map(
        np.asarray, jax_noise(jax.random.PRNGKey(seed + 2), B, grid, cfg))
    return pnp, model, x, noise


def tnoise(noise):
    return {k: t(v) for k, v in noise.items()}


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in flat_leaves(v)]
    return [tree]


@pytest.mark.parametrize("mode", ["wavefront", "raster", "rowscan"])
def test_inference_schedule_matches_jax(mode):
    for gh, gw, nl in ((11, 11, 1), (4, 4, 1), (5, 7, 2)):
        want = jax_sched(mode, gh, gw, nl)
        got = inference_schedule(mode, gh, gw, nl)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["wavefront", "raster", "independent"])
def test_infer_latents_matches_jax(mode):
    cfg = tiny_config(inference_mode=mode)
    pnp, model, x, noise = setup(cfg)
    want = jax_infer(pnp, cfg, jnp.asarray(x), 1500, None, noise)
    with torch.no_grad():
        got = infer_latents(model, cfg, t(x), 1500, noise=tnoise(noise))
    keys = ("z_where", "z_attr", "z_depth", "z_pres", "z_pres_prob",
            "posterior", "context_vec", "feat_flat", "training_wheel")
    for key in keys:
        g, w = flat_leaves(got[key]), flat_leaves(want[key])
        assert len(g) == len(w) > 0, key
        for gl, wl in zip(g, w):
            assert_close(gl, np.asarray(wl))


def test_raster_equals_wavefront_in_the_port():
    cfg = tiny_config(inference_mode="raster")
    _, model, x, noise = setup(cfg, seed=3)
    with torch.no_grad():
        r = infer_latents(model, cfg, t(x), 0, noise=tnoise(noise))
        w = infer_latents(model, dataclasses.replace(
            cfg, inference_mode="wavefront"), t(x), 0, noise=tnoise(noise))
    for a, b in zip(flat_leaves(r), flat_leaves(w)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_kls_match_jax():
    cfg = tiny_config()
    rng = np.random.RandomState(5)
    shape = (B, 4, 4, 1)
    post = {name: (rng.randn(*shape).astype("f"),
                   (rng.rand(*shape) * 2 + 0.05).astype("f"))
            for name, _ in cfg.priors}
    z_pres = rng.rand(*shape).astype("f")
    want = jax_indep_kl(jax.tree_util.tree_map(jnp.asarray, post),
                        jnp.asarray(z_pres), cfg)
    got = independent_kl({k: (t(m), t(s)) for k, (m, s) in post.items()},
                         t(z_pres), cfg)
    for k in want:
        assert_close(got[k], np.asarray(want[k]))
    for step in (0, 1500, 30000):
        want = jax_count_kl(jnp.asarray(z_pres), jnp.asarray(z_pres), step,
                            cfg)
        got = count_prior_kl(t(z_pres), t(z_pres), step, cfg)
        assert_close(got, np.asarray(want))


@pytest.mark.parametrize("gate", [0.0, 0.3], ids=["ungated", "gated"])
@pytest.mark.parametrize("mode", ["wavefront", "independent"])
def test_forward_matches_jax_pallas(mode, gate):
    """Loss, recon and every KL term against JAX forward with the Pallas
    compositor (interpret mode), gated and ungated."""
    cfg = tiny_config(inference_mode=mode, render_backend="pallas",
                      pres_gate_threshold=gate)
    pnp, model, x, noise = setup(cfg, seed=7)
    loss_j, aux_j = jax_forward(pnp, cfg, jnp.asarray(x), 1500, None, noise)
    with torch.no_grad():
        loss, aux = forward(model, cfg, t(x), 1500, noise=tnoise(noise))
    assert abs(float(loss) - float(loss_j)) < F32_REL * abs(float(loss_j))
    assert_close(aux["recon"], np.asarray(aux_j["recon"]))
    assert sorted(aux["losses"]) == sorted(aux_j["losses"])
    for k, v in aux_j["losses"].items():
        assert abs(float(aux["losses"][k]) - float(v)) \
            < F32_REL * max(1.0, abs(float(v))), k
    for k in ("z_where", "z_pres", "z_depth", "z_attr", "z_pres_prob"):
        assert_close(aux[k], np.asarray(aux_j[k]))


def test_forward_options_match_jax():
    """Slots with stick coupling, the entropy penalty and the 'xla'
    backend, in one configuration."""
    cfg = tiny_config(n_object_slots=2, slot_coupling="stick",
                      pres_entropy_weight=0.5, render_backend="xla")
    pnp, model, x, noise = setup(cfg, seed=11, step=2500)
    loss_j, aux_j = jax_forward(pnp, cfg, jnp.asarray(x), 2500, None, noise)
    with torch.no_grad():
        loss, aux = forward(model, cfg, t(x), 2500, noise=tnoise(noise))
    assert abs(float(loss) - float(loss_j)) < F32_REL * abs(float(loss_j))
    assert_close(aux["recon"], np.asarray(aux_j["recon"]))
    assert abs(float(aux["losses"]["losses/pres_entropy"])
               - float(aux_j["losses"]["losses/pres_entropy"])) < 1e-3


def test_forward_paper128_width_matches_jax():
    """Full paper128 widths (128x128, 11x11 grid, 28x28 glimpses, the
    reference topology), wavefront, B=2, plain compositor on both sides."""
    cfg = paper_config(render_backend="xla")
    pnp, model, x, noise = setup(cfg, seed=13, step=0)
    loss_j, aux_j = jax_forward(pnp, cfg, jnp.asarray(x), 0, None, noise)
    with torch.no_grad():
        loss, aux = forward(model, cfg, t(x), 0, noise=tnoise(noise))
    assert tuple(aux["recon"].shape) == (B, 1, 128, 128)
    assert abs(float(loss) - float(loss_j)) < F32_REL * abs(float(loss_j))
    assert_close(aux["recon"], np.asarray(aux_j["recon"]))


def test_eval_step_is_forward_without_grad():
    cfg = tiny_config(inference_mode="wavefront")
    _, model, x, _ = setup(cfg, seed=17)
    loss, aux = make_eval_step(cfg)(model, t(x), 1500,
                                    torch.Generator().manual_seed(0))
    assert not loss.requires_grad and bool(torch.isfinite(loss))
    with torch.no_grad():
        loss2, _ = forward(model, cfg, t(x), 1500,
                           torch.Generator().manual_seed(0))
    assert float(loss) == float(loss2)  # same generator seed, same draws
    assert tuple(aux["recon"].shape) == (B, 1, 48, 48)


def test_forward_with_grad_refuses_the_kernel_path():
    """Backend 'auto' now trains: its gradients (the kernels' autograd
    Function, here their plain versions) equal autograd's through the
    'xla' compositor. The backend that has no port, 'pallas_v3', is
    refused."""
    cfg = tiny_config(inference_mode="independent", render_backend="auto",
                      pres_gate_threshold=0.3)
    _, model, x, noise = setup(cfg, seed=19)

    def grads(c):
        model.zero_grad(set_to_none=True)
        loss, _ = forward(model, c, t(x), 1500, noise=tnoise(noise))
        loss.backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    got = grads(cfg)
    want = grads(dataclasses.replace(cfg, render_backend="xla"))
    assert model.object_decoder.out.weight.grad is not None
    for k, w in want.items():
        assert_close(got[k], w.numpy(), rel=1e-3)
    with pytest.raises(NotImplementedError, match="pallas_v3"):
        forward(model, dataclasses.replace(cfg, render_backend="pallas_v3"),
                t(x), 0, torch.Generator().manual_seed(0))


def test_sample_noise_shapes_match_jax():
    cfg = tiny_config(n_object_slots=2)
    want = jax_noise(jax.random.PRNGKey(0), 3, (4, 4), cfg)
    got = sample_noise(torch.Generator().manual_seed(0), 3, (4, 4), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    again = sample_noise(torch.Generator().manual_seed(0), 3, (4, 4), cfg)
    assert all(torch.equal(got[k], again[k]) for k in got)
