"""The port's compositor against the JAX package's Pallas kernel.

JAX's ``composite_pallas`` runs in interpret mode on the CPU, as the JAX
package's own tests run it. Tolerances: f32 relative error 1e-4 (bench.py's
forward gate, measured as max |port - jax| / max(1, max |jax|)), 1e-3 on
gradients; bf16 glimpses against f32 truth 3e-2. The CUDA kernels
themselves are compared with their plain versions on a card, in
test_torch_kernel_gpu.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.ops.pallas.composite import composite_pallas
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from tests.test_model import tiny_config
from tests.test_torch_ops import (assert_close, jax_params_np, ported_params,
                                  rel_err, t)

BF16_REL = 3e-2
# the JAX models package exports a function named render: go by module path
jrender = importlib.import_module("spair_pytorch_tpu.models.render")
trender = importlib.import_module("spair_pytorch_tpu_torch.models.render")


def make_inputs(seed, b=2, n=9, c=1, oh=14, ow=14, gated=False):
    rng = np.random.RandomState(seed)
    color = rng.rand(b, n, c, oh, ow).astype("f")
    alpha = rng.rand(b, n, 1, oh, ow).astype("f")
    imp = rng.rand(b, n, 1, oh, ow).astype("f") + 0.01
    boxes = np.stack([rng.uniform(0.1, 0.9, (b, n)),
                      rng.uniform(0.1, 0.9, (b, n)),
                      rng.uniform(0.1, 0.5, (b, n)),
                      rng.uniform(0.1, 0.5, (b, n))], -1).astype("f")
    gate = (rng.rand(b, n) > 0.5).astype("f") if gated else None
    return color, alpha, imp, boxes, gate


CASES = {  # name: (make_inputs kwargs, den_floor_n)
    "ungated": (dict(seed=0), None),
    "gated": (dict(seed=1, gated=True), None),
    "den_floor_n": (dict(seed=2, gated=True, n=5), 12),
    "c3": (dict(seed=3, c=3), None),
    "c3_gated_ragged_chunk": (dict(seed=4, c=3, n=11, gated=True), None),
}


def jax_composite(color, alpha, imp, boxes, gate, hw, floor_n=None):
    gate = None if gate is None else jnp.asarray(gate)
    num, den = composite_pallas(*map(jnp.asarray, (color, alpha, imp, boxes)),
                                hw, None, pres_gate=gate, den_floor_n=floor_n)
    return np.asarray(num), np.asarray(den)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    kw, floor_n = CASES[case]
    color, alpha, imp, boxes, gate = make_inputs(**kw)
    hw = (48, 40)
    want = jax_composite(color, alpha, imp, boxes, gate, hw, floor_n)
    got = K.composite_plain(t(color), t(alpha), t(imp), t(boxes), hw,
                            chunk=4, pres_gate=None if gate is None
                            else t(gate), den_floor_n=floor_n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_close(g, w)


@pytest.mark.parametrize("case", ["ungated", "gated"])
def test_bf16_glimpses_against_f32_truth(case):
    color, alpha, imp, boxes, gate = make_inputs(**CASES[case][0])
    hw = (48, 48)
    want = jax_composite(color, alpha, imp, boxes, gate, hw)
    bf = [t(a).to(torch.bfloat16) for a in (color, alpha, imp)]
    with torch.no_grad():
        got = K.composite_forward(*bf, t(boxes), hw,
                                  pres_gate=None if gate is None else t(gate))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g, w) < BF16_REL


def test_forward_on_cpu_is_the_plain_version():
    color, alpha, imp, boxes, gate = map(
        lambda a: None if a is None else t(a), make_inputs(5, gated=True))
    before = K.composite_forward.launches
    got = K.composite_forward(color, alpha, imp, boxes, (32, 32), 16,
                              pres_gate=gate, den_floor_n=20)
    want = K.composite_plain(color, alpha, imp, boxes, (32, 32),
                             pres_gate=gate, den_floor_n=20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert K.composite_forward.launches == before  # no kernel launched


def test_all_gated_gives_zero_num_and_floor_den():
    color, alpha, imp, boxes, _ = map(
        lambda a: None if a is None else t(a), make_inputs(6))
    num, den = K.composite_forward(color, alpha, imp, boxes, (32, 32),
                                   pres_gate=torch.zeros(2, 9))
    assert bool((num == 0).all())
    np.testing.assert_allclose(den.numpy(), 9e-9, rtol=1e-6)


def test_gradients_flow_through_composite():
    """``composite`` on CPU tensors: the autograd Function over the plain
    forward and backward gives autograd's gradients through the plain
    compositor, to the glimpses and boxes, and none to the gate."""
    color, alpha, imp, boxes, gate = map(
        lambda a: None if a is None else t(a), make_inputs(7, gated=True))
    dnum, dden = torch.randn(2, 1, 32, 32), torch.randn(2, 1, 32, 32)
    gate.requires_grad_(True)

    def grads(fn):
        leaves = [a.clone().requires_grad_(True)
                  for a in (color, alpha, imp, boxes)]
        num, den = fn(*leaves, (32, 32), pres_gate=gate)
        torch.autograd.backward((num, den), (dnum, dden))
        return [a.grad for a in leaves]

    got = grads(K.composite)
    assert gate.grad is None
    want = grads(K.composite_plain)
    assert all(g is not None for g in got)
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), rel=1e-3)


def test_refuses_devices_it_has_no_path_for():
    color, alpha, imp, boxes, _ = (
        None if a is None else t(a).to("meta") for a in make_inputs(8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.composite_forward(color, alpha, imp, boxes, (32, 32))
    with pytest.raises(ValueError, match="several devices"):
        K.composite_forward(color, alpha, imp, torch.zeros(2, 9, 4),
                            (32, 32))


def test_paste_window_rows_matches_jax():
    for cfg in (tiny_config(), tiny_config(image_shape=(1, 128, 128),
                                           object_shape=(28, 28),
                                           anchor_shape=(48, 48))):
        hw = cfg.image_shape[1:]
        assert trender.paste_window_rows(cfg, hw) == \
            jrender.paste_window_rows(cfg, hw)


def test_decode_objects_matches_jax():
    cfg = tiny_config()
    pnp = jax_params_np(cfg)
    model = ported_params(cfg, pnp)
    rng = np.random.RandomState(9)
    z_attr = rng.randn(2, 16, cfg.n_attributes).astype("f")
    z_pres = rng.rand(2, 16, 1).astype("f")
    z_depth = (4 * rng.rand(2, 16, 1)).astype("f")
    want = jrender.decode_objects(pnp, cfg, *map(jnp.asarray,
                                                 (z_attr, z_pres, z_depth)))
    with torch.no_grad():
        got = trender.decode_objects(model, cfg, t(z_attr), t(z_pres),
                                     t(z_depth))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert_close(g, w)
