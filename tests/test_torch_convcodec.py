"""The port's conv object codec (``ops/convcodec.py``, ``object_codec=
'conv'``) against the JAX package's on the same inputs: its topology and
shapes, the encoder and decoder alone at 28x28 (the reference topology) and
14x14 (where ``effective_topology`` drops two layers), forward and
gradients through the model with the codec, and a strict load of the converted
parameters.

Bars: f32 forward relative error 1e-4 and gradients 1e-3 (bench.py's gates,
max |port - jax| / max(1, max |jax|)); both sides compute in full f32
(tests/conftest.py sets JAX's matmul precision to 'highest'; torch's CPU
convs have no TF32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.models import forward as jax_forward
from spair_pytorch_tpu.models import init_params as jax_init_params
from spair_pytorch_tpu.models.latents import sample_noise as jax_noise
from spair_pytorch_tpu.ops import convcodec as jcc
from spair_pytorch_tpu_torch.models import forward
from spair_pytorch_tpu_torch.ops import convcodec as tcc
from spair_pytorch_tpu_torch.utils.interop import state_dict_from_jax
from tests.test_model import tiny_config
from tests.test_torch_ops import assert_close, ported_params, t, tcfg
from tests.test_torch_options import GRAD_REL, assert_strict_load, tnoise

SIZES = [(28, 28), (14, 14), (13, 17)]


def jit_init(cfg, seed):
    """JAX init_params under jit, as numpy: eagerly each conv op compiles
    on its own, which takes twice as long on the CPU."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_init_params, static_argnums=1)(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("hw", SIZES + [(6, 6), (3, 3)])
def test_topology_and_shapes_equal_jaxs(hw):
    assert tcc.effective_topology(hw) == jcc.effective_topology(hw)
    assert tcc.codec_shapes(hw) == jcc.codec_shapes(hw)


def test_fourteen_pixel_glimpses_drop_two_layers():
    assert tcc.effective_topology((14, 14)) == tcc.CONV_CODEC_TOPOLOGY[:2]
    assert tcc.codec_shapes((28, 28))[-1] == (2, 2)


def _sd(prefix, codec):
    """The port's state_dict of one codec module from its JAX params (a
    pytree of numpy arrays), through the model converter: the module is the
    model's ``prefix`` in an otherwise empty model."""
    head = {"trunk": [], "heads": [{"w": np.zeros((1, 1), "f"),
                                    "b": np.zeros(1, "f")}]}
    full = {"backbone": {"layers": []}, "edge": np.zeros(1, "f"),
            "box_net": head, "z_net": head, "obj_net": head,
            "object_encoder": head, "object_decoder": head, prefix: codec}
    return {k[len(prefix) + 1:]: torch.from_numpy(v)
            for k, v in state_dict_from_jax(full).items()
            if k.startswith(prefix + ".")}


def _codec_params(hw, c=2, a=6):
    """JAX encoder and decoder params, under the names the model gives
    them, and the port's modules loaded with them."""
    kd = jax.random.split(jax.random.PRNGKey(hw[0] * 31 + hw[1]))
    jparams = {"object_encoder": jcc.init_conv_encoder(kd[0], c, 2 * a, hw),
               "object_decoder": jcc.init_conv_decoder(kd[1], a, c + 1, hw)}
    pnp = jax.tree_util.tree_map(np.asarray, jparams)
    enc, dec = tcc.ConvEncoder(c, 2 * a, hw), tcc.ConvDecoder(a, c + 1, hw)
    enc.load_state_dict(_sd("object_encoder", pnp["object_encoder"]),
                        strict=True)
    dec.load_state_dict(_sd("object_decoder", pnp["object_decoder"]),
                        strict=True)
    return jparams, enc, dec


@pytest.mark.parametrize("hw", SIZES)
def test_encoder_matches_jax(hw):
    """Values, and gradients against the glimpses and every parameter."""
    jparams, enc, _ = _codec_params(hw)
    g = np.random.RandomState(0).rand(2, 3, 2, *hw).astype("f")

    def f(p, x):
        return jcc.apply_conv_encoder(p, x)
    want = np.asarray(f(jparams["object_encoder"], jnp.asarray(g)))
    w = np.random.RandomState(1).randn(*want.shape).astype("f")
    jg_p, jg_x = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) * w),
                                  argnums=(0, 1)))(
        jparams["object_encoder"], jnp.asarray(g))
    x = t(g).requires_grad_(True)
    got = enc(x)
    assert tuple(got.shape) == (2, 3, 12)
    assert_close(got, want)
    torch.sum(got * t(w)).backward()
    assert_close(x.grad, np.asarray(jg_x), rel=GRAD_REL)
    want_p = _sd("object_encoder",
                 jax.tree_util.tree_map(np.asarray, jg_p))
    for k, p in enc.named_parameters():
        assert_close(p.grad, want_p[k].numpy(), rel=GRAD_REL)


@pytest.mark.parametrize("hw", SIZES)
def test_decoder_matches_jax(hw):
    """Values in the JAX layout (..., oh, ow, C + 1), and gradients against
    z and every parameter: the transposed convs' flipped kernels and the
    (h, w, c) order of the input linear's rows."""
    jparams, _, dec = _codec_params(hw)
    z = np.random.RandomState(2).randn(2, 3, 6).astype("f")

    def f(p, x):
        return jcc.apply_conv_decoder(p, x, hw)
    want = np.asarray(f(jparams["object_decoder"], jnp.asarray(z)))
    w = np.random.RandomState(3).randn(*want.shape).astype("f")
    jg_p, jg_z = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) * w),
                                  argnums=(0, 1)))(
        jparams["object_decoder"], jnp.asarray(z))
    x = t(z).requires_grad_(True)
    got = dec(x)
    assert tuple(got.shape) == (2, 3) + hw + (3,)
    assert_close(got, want)
    torch.sum(got * t(w)).backward()
    assert_close(x.grad, np.asarray(jg_z), rel=GRAD_REL)
    want_p = _sd("object_decoder",
                 jax.tree_util.tree_map(np.asarray, jg_p))
    for k, p in dec.named_parameters():
        assert_close(p.grad, want_p[k].numpy(), rel=GRAD_REL)


def test_transposed_conv_without_the_flip_differs():
    """The flip is needed: the same kernel unflipped gives another map."""
    jparams, _, dec = _codec_params((28, 28))
    z = np.random.RandomState(4).randn(1, 1, 6).astype("f")
    want = np.asarray(jcc.apply_conv_decoder(jparams["object_decoder"],
                                             jnp.asarray(z), (28, 28)))
    with torch.no_grad():
        for m in dec.deconvs:
            m.weight.copy_(torch.flip(m.weight, (2, 3)))
        got = dec(t(z))
    assert float((got - torch.from_numpy(want)).abs().max()) > 1e-2


def test_forward_with_the_conv_codec_matches_jax():
    """Loss, every logged term, the reconstruction and latents against the
    JAX package's, independent inference, step 2500; then the backward
    reaches both codecs with finite gradients (the codecs' gradients are
    held against JAX's module by module above)."""
    cfg = tiny_config(inference_mode="independent", object_codec="conv")
    step = 2500
    pnp = jit_init(cfg, 31)
    model = ported_params(cfg, pnp)
    x = np.random.RandomState(32).rand(2, 1, 48, 48).astype("f")
    noise = jax.tree_util.tree_map(np.asarray, jax_noise(
        jax.random.PRNGKey(33), 2, (4, 4), cfg))
    loss_j, aux_j = jax.jit(lambda p, x, n: jax_forward(
        p, cfg, x, step, None, n))(pnp, x, noise)
    loss, aux = forward(model, tcfg(cfg), t(x), step, noise=tnoise(noise))
    assert abs(float(loss) - float(loss_j)) < 1e-4 * abs(float(loss_j))
    for k, v in aux_j["losses"].items():
        assert abs(float(aux["losses"][k]) - float(v)) \
            < 1e-4 * max(1.0, abs(float(v))), k
    for k in ("recon", "z_where", "z_pres", "z_depth", "z_attr"):
        assert_close(aux[k].detach(), np.asarray(aux_j[k]))
    loss.backward()
    for k, p in model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), k
    assert float(model.object_encoder.convs[0].weight.grad.abs().max()) > 0
    assert float(model.object_decoder.deconvs[-1].weight.grad.abs().max()) \
        > 0


def test_strict_load_of_converted_conv_codec_params():
    cfg = tiny_config(object_codec="conv")
    assert_strict_load(cfg, jit_init(cfg, 3))
