"""The port's int8 serving path (ops/quant.py) against the JAX package's, on
the same numpy weights and inputs, on the CPU.

Tolerances: int8 weights equal exactly and scales bit for bit (the same
true division, the same round half to even); dense and conv products within
1e-6 relative of JAX's (integer products are exact on both sides, the
float32 dequantization may round differently); the quantized detector on
tiny_config: scores within 1e-4, boxes within 1e-2 px. Each port layer's
float input differs from JAX's by float32 rounding, which could move an
activation across a rounding boundary of its int8 grid (a flip changes one
product term by one quantization step). On these inputs none shows: the
detectors agree to 6e-8 in score and 2e-6 px in box (wavefront), exactly
(independent, f32 and bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spair_pytorch_tpu.models import infer as jinfer
from spair_pytorch_tpu.ops import quant as jq
from spair_pytorch_tpu_torch.models import infer as tinfer
from spair_pytorch_tpu_torch.ops import quant as tq
from spair_pytorch_tpu_torch.ops.backbone import Backbone
from spair_pytorch_tpu_torch.ops.mlp import MLP
from tests.test_model import tiny_config
from tests.test_torch_ops import jax_params_np, ported_params, t, tcfg

RNG = np.random.RandomState(0)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(1e-30,
                                                   np.max(np.abs(want))))


def linear(n_in, n_out, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(n_in, n_out) * 0.1).astype("f")
    b = (rng.randn(n_out) * 0.01).astype("f")
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(t(w.T))
        layer.bias.copy_(t(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, layer


def conv(k, c_in, c_out, stride, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, k, c_in, c_out) * 0.1).astype("f")
    b = (rng.randn(c_out) * 0.01).astype("f")
    layer = nn.Conv2d(c_in, c_out, k, stride=stride)
    with torch.no_grad():
        layer.weight.copy_(t(w.transpose(3, 2, 0, 1)))
        layer.bias.copy_(t(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, layer


# (in, out): paper128's widths that _int_mm must pad on the card (100-wide
# inputs, 1- to 8-wide heads) and ones it takes as they are
@pytest.mark.parametrize("n_in,n_out", [(100, 1), (100, 2), (228, 8),
                                        (64, 32), (7, 5), (784, 16)])
def test_linear_weights_and_scales_equal_jax(n_in, n_out):
    jl, tl = linear(n_in, n_out, n_in + n_out)
    want = jq.quantize_linear(jl)
    got = tq.quantize_linear(tl)
    assert got.w_q.dtype == torch.int8
    np.testing.assert_array_equal(got.w_q.numpy().T, np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got.w_scale.numpy(),
                                  np.asarray(want["w_scale"]))


@pytest.mark.parametrize("k,c_in,c_out,stride", [(4, 1, 16, 2), (3, 16, 20, 1),
                                                 (1, 64, 100, 1)])
def test_conv_weights_and_scales_equal_jax(k, c_in, c_out, stride):
    jl, tl = conv(k, c_in, c_out, stride, k + c_out)
    want = jq.quantize_conv(jl)
    got = tq.quantize_conv(tl)
    np.testing.assert_array_equal(got.w_q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got.w_scale.numpy(),
                                  np.asarray(want["w_scale"]))


def test_rows_quantize_bit_for_bit():
    x = (RNG.randn(33, 100) * np.logspace(-3, 2, 33)[:, None]).astype("f")
    jx, js = jq.quantize_rows(jnp.asarray(x))
    tx, ts = tq.quantize_rows(t(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows,n_in,n_out", [(1, 100, 1), (11, 100, 2),
                                             (17, 228, 8), (64, 64, 32),
                                             (5, 7, 5)])
def test_dense_int8_matches_jax(rows, n_in, n_out):
    jl, tl = linear(n_in, n_out, rows)
    x = RNG.randn(rows, n_in).astype("f")
    want = jq.dense_int8(jq.quantize_linear(jl), jnp.asarray(x))
    got = tq.dense_int8(tq.quantize_linear(tl), t(x))
    assert got.dtype == torch.float32
    assert rel(got, want) < 1e-6


@pytest.mark.parametrize("k,c_in,c_out,stride,hw", [(4, 1, 16, 2, 23),
                                                    (3, 16, 20, 1, 9),
                                                    (1, 64, 100, 1, 6)])
def test_conv_int8_matches_jax(k, c_in, c_out, stride, hw):
    jl, tl = conv(k, c_in, c_out, stride, hw)
    x = RNG.rand(2, hw, hw, c_in).astype("f")
    want = jq.conv_int8(jq.quantize_conv(jl), jnp.asarray(x), stride)
    got = tq.conv_int8(tq.quantize_conv(tl), t(x.transpose(0, 3, 1, 2)))
    assert rel(got.permute(0, 2, 3, 1), want) < 1e-6


@pytest.mark.parametrize("m,k,n", [(1, 100, 1), (16, 16, 8), (17, 100, 104),
                                   (300, 7, 3)])
def test_int_mm_plain_is_the_exact_product(m, k, n):
    a = RNG.randint(-127, 128, (m, k)).astype(np.int8)
    w = RNG.randint(-127, 128, (n, k)).astype(np.int8)
    want = a.astype(np.int64) @ w.astype(np.int64).T
    got = tq.int_mm(t(a), t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def tiny(mode):
    cfg = tiny_config(inference_mode=mode)
    pnp = jax_params_np(cfg)
    return cfg, pnp, ported_params(cfg, pnp)


@pytest.mark.parametrize("mode", ["independent", "wavefront"])
def test_quantized_detector_matches_jax(mode):
    cfg, pnp, model = tiny(mode)
    x = np.random.RandomState(1).rand(2, 1, 48, 48).astype("f")
    jqp = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, pnp))
    want = jinfer.detect(jqp, jnp.asarray(x), cfg)
    quantized = tq.quantize_params_int8(model)
    got = tinfer.make_detector(tcfg(cfg))(quantized, t(x))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_array_equal(got["count"].numpy(),
                                  np.asarray(want["count"]))
    # the model it came from is left float
    assert isinstance(model.backbone.net.conv_out, nn.Conv2d)


def test_quantized_model_carries_int8_layers_and_keeps_the_rest():
    cfg, _, model = tiny("independent")
    q = tq.quantize_params_int8(model)
    layers = [m for m in q.modules() if tq.is_quantized(m)]
    floats = [m for m in q.modules() if isinstance(m, (nn.Linear,
                                                       nn.Conv2d))]
    assert layers and not floats
    assert all(m.w_q.dtype == torch.int8 for m in layers)
    assert torch.equal(q.virtual_edge_element, model.virtual_edge_element)


def test_mixed_model_quantized_backbone_only():
    cfg, pnp, model = tiny("independent")
    model.backbone = tq.quantize_params_int8(model.backbone)
    assert isinstance(model.backbone, Backbone)
    assert isinstance(model.box_network, MLP)
    x = np.random.RandomState(1).rand(1, 1, 48, 48).astype("f")
    got = tinfer.make_detector(tcfg(cfg))(model, t(x))
    jqp = dict(jax.tree_util.tree_map(jnp.asarray, pnp))
    jqp["backbone"] = jq.quantize_params_int8(jqp["backbone"])
    want = jinfer.detect(jqp, jnp.asarray(x), cfg)
    assert np.isfinite(got["scores"].numpy()).all()
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)


def test_bf16_compute_quantizes_the_bf16_input_as_jax_does():
    cfg = tiny_config(inference_mode="independent", compute_dtype="bfloat16")
    pnp = jax_params_np(cfg)
    model = ported_params(cfg, pnp)
    x = np.random.RandomState(2).rand(2, 1, 48, 48).astype("f")
    jqp = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, pnp))
    want = jinfer.detect(jqp, jnp.asarray(x), cfg)
    got = tinfer.make_detector(tcfg(cfg))(tq.quantize_params_int8(model),
                                          t(x))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-2)
