"""The port's compositor backward against the JAX package's Pallas VJP.

``composite_backward_plain`` (the oracle of the CUDA backward kernel) is held
against the VJP of JAX ``composite_pallas`` in interpret mode on the CPU,
and against autograd through the port's plain forward. Tolerance: relative
error max |port - jax| / max(1, max |jax|) of 1e-3 for f32 (bench.py's
gradient bar), 6e-2 for bf16 glimpses against the f32 truth. The CUDA
kernel itself is held against the plain version on a card, in
test_torch_kernel_gpu.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.config import paper_config
from spair_pytorch_tpu.ops.pallas.composite import composite_pallas
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from tests.test_torch_ops import rel_err, t

GRAD_REL, BF16_GRAD_REL = 1e-3, 6e-2
trender = importlib.import_module("spair_pytorch_tpu_torch.models.render")


def make_inputs(seed, b=2, n=9, c=1, g=14, scale=(0.1, 0.5), gated=False):
    rng = np.random.RandomState(seed)
    color = rng.rand(b, n, c, g, g).astype("f")
    alpha = rng.rand(b, n, 1, g, g).astype("f")
    imp = rng.rand(b, n, 1, g, g).astype("f") + 0.01
    boxes = np.stack([rng.uniform(0.05, 0.95, (b, n)),
                      rng.uniform(0.05, 0.95, (b, n)),
                      rng.uniform(*scale, (b, n)),
                      rng.uniform(*scale, (b, n))], -1).astype("f")
    gate = (rng.rand(b, n) > 0.5).astype("f") if gated else None
    return color, alpha, imp, boxes, gate


def cotangents(seed, b, c, hw):
    rng = np.random.RandomState(seed + 100)
    return (rng.randn(b, c, *hw).astype("f"), rng.randn(b, 1, *hw).astype("f"))


def jax_vjp(color, alpha, imp, boxes, gate, hw, dnum, dden, win=None):
    gate = None if gate is None else jnp.asarray(gate)

    def f(co, al, im, bx):
        return composite_pallas(co, al, im, bx, hw, win, pres_gate=gate)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (color, alpha, imp, boxes)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dnum),
                                        jnp.asarray(dden)))]


def port_vjp(color, alpha, imp, boxes, gate, hw, dnum, dden):
    return K.composite_backward_plain(
        t(color), t(alpha), t(imp), t(boxes), hw, t(dnum), t(dden),
        None if gate is None else t(gate))


PAPER = paper_config()
PAPER_HW = PAPER.image_shape[1:]
CASES = {  # name: (make_inputs kwargs, canvas, window rows)
    "ungated": (dict(seed=0), (48, 40), None),
    "gated": (dict(seed=1, gated=True), (48, 40), None),
    "c3": (dict(seed=2, c=3, gated=True), (40, 48), None),
    # paper128 shapes with the paste window the model would use
    "windowed_paper": (dict(seed=3, n=6, g=28, scale=(0.05, 0.37)),
                       PAPER_HW, trender.paste_window_rows(PAPER, PAPER_HW)),
    # boxes larger than the canvas
    "large_boxes": (dict(seed=4, n=5, scale=(0.8, 1.6)), (32, 36), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_plain_matches_pallas_vjp(case):
    kw, hw, win = CASES[case]
    color, alpha, imp, boxes, gate = make_inputs(**kw)
    dnum, dden = cotangents(kw["seed"], color.shape[0], color.shape[2], hw)
    want = jax_vjp(color, alpha, imp, boxes, gate, hw, dnum, dden, win)
    got = port_vjp(color, alpha, imp, boxes, gate, hw, dnum, dden)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g, w) < GRAD_REL
    if gate is not None:
        dead = torch.from_numpy(gate == 0)
        assert all(bool((g[dead] == 0).all()) for g in got)


def test_backward_plain_bf16_glimpses_against_f32_truth():
    color, alpha, imp, boxes, gate = make_inputs(5, gated=True)
    hw = (48, 48)
    dnum, dden = cotangents(5, 2, 1, hw)
    want = jax_vjp(color, alpha, imp, boxes, gate, hw, dnum, dden)
    bf = [t(a).to(torch.bfloat16) for a in (color, alpha, imp)]
    got = K.composite_backward_plain(*bf, t(boxes), hw, t(dnum), t(dden),
                                     t(gate))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w in zip(got, want):
        assert rel_err(g.float(), w) < BF16_GRAD_REL


def test_backward_plain_at_integer_source_coordinates():
    """Canvas 33 = 2^5 + 1, glimpse 17 = 2^4 + 1, dyadic centres and
    scales: every source coordinate is exact in both frameworks, and many
    are integers, where the hat derivative is -sign(0) = 0 on one tap and
    masked on the other."""
    color, alpha, imp, _, _ = make_inputs(6, n=3, g=17)
    boxes = np.tile(np.float32([0.5, 0.5, 1.0, 1.0]), (2, 3, 1))
    boxes[:, 1] = (0.25, 0.75, 0.5, 0.5)
    boxes[:, 2] = (0.625, 0.375, 0.75, 0.25)
    hw = (33, 33)
    dnum, dden = cotangents(6, 2, 1, hw)
    want = jax_vjp(color, alpha, imp, boxes, None, hw, dnum, dden)
    got = port_vjp(color, alpha, imp, boxes, None, hw, dnum, dden)
    for g, w in zip(got, want):
        assert rel_err(g, w) < GRAD_REL


@pytest.mark.parametrize("seed", [7, 8])
def test_backward_plain_matches_autograd_through_plain_forward(seed):
    """Random boxes, from a quarter to one and a half canvases, gated."""
    color, alpha, imp, boxes, gate = make_inputs(seed, c=2, scale=(0.25, 1.5),
                                                 gated=True)
    hw = (40, 44)
    dnum, dden = cotangents(seed, 2, 2, hw)
    leaves = [t(a).requires_grad_(True) for a in (color, alpha, imp, boxes)]
    num, den = K.composite_plain(*leaves, hw, chunk=4, pres_gate=t(gate))
    torch.autograd.backward((num, den), (t(dnum), t(dden)))
    got = K.composite_backward_plain(t(color), t(alpha), t(imp), t(boxes), hw,
                                     t(dnum), t(dden), t(gate), chunk=4)
    for g, leaf in zip(got, leaves):
        assert rel_err(g, leaf.grad.numpy()) < GRAD_REL


def test_backward_on_cpu_is_the_plain_version():
    color, alpha, imp, boxes, gate = map(
        lambda a: None if a is None else t(a), make_inputs(9, gated=True))
    dnum, dden = map(t, cotangents(9, 2, 1, (32, 32)))
    before = K.composite_backward.launches
    got = K.composite_backward(color, alpha, imp, boxes, (32, 32), dnum,
                               dden, gate)
    want = K.composite_backward_plain(color, alpha, imp, boxes, (32, 32),
                                      dnum, dden, gate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.composite_backward.launches == before
    all_gated = K.composite_backward(color, alpha, imp, boxes, (32, 32),
                                     dnum, dden, torch.zeros_like(gate))
    assert all(bool((g == 0).all()) for g in all_gated)
