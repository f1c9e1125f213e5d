"""The CUDA compositor kernels (K1/K2, and K3/K4 for 'pallas_v3') against
their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips when no CUDA card is visible. The file
imports nothing from the other test modules, so it runs on a machine with
the card alone: ``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.
Tolerances, as relative error max |kernel - plain| / max |plain|: forward
1e-4 for f32 glimpses and 3e-2 for bf16 glimpses against f32 truth;
backward 1e-3 and 6e-2 (bench.py's gradient bars). TF32 is off, so the
plain versions compute in full f32."""

import numpy as np
import pytest
import torch

from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V

BARS = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_BARS = {"float32": 1e-3, "bfloat16": 6e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(seed, b, n, c, dev, gated, max_scale=0.6, g=14):
    rng = np.random.RandomState(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype("f"),
                               device=dev)
    glimpses = (u(b, n, c, g, g), u(b, n, 1, g, g), u(b, n, 1, g, g, lo=0.01))
    boxes = torch.cat([u(b, n, 2, lo=0.05, hi=0.95),
                       u(b, n, 2, lo=0.05, hi=max_scale)], -1).contiguous()
    gate = (u(b, n) > 0.5).float() if gated else None
    return glimpses, boxes, gate


def rel(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / \
        max(float(w.abs().max()) for w in want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_kernel_matches_plain(cuda, dtype, gated, c):
    glimpses, boxes, gate = inputs(c, 3, 30, c, cuda, gated)
    before = K.composite_forward.launches
    with torch.no_grad():
        got = K.composite_forward(
            *(g.to(getattr(torch, dtype)) for g in glimpses), boxes,
            (64, 48), 64, pres_gate=gate, den_floor_n=40)
        torch.cuda.synchronize()
        want = K.composite_plain(*glimpses, boxes, (64, 48), pres_gate=gate,
                                 den_floor_n=40)
    assert K.composite_forward.launches == before + 1
    assert got[0].shape == (3, c, 64, 48) and got[1].shape == (3, 1, 64, 48)
    assert rel(got, want) < BARS[dtype]


@pytest.mark.gpu
def test_kernel_all_gated(cuda):
    glimpses, boxes, _ = inputs(0, 2, 9, 1, cuda, False)
    with torch.no_grad():
        num, den = K.composite_forward(*glimpses, boxes, (32, 32),
                                       pres_gate=torch.zeros(2, 9,
                                                             device=cuda))
    assert bool((num == 0).all())
    np.testing.assert_allclose(den.cpu().numpy(), 9e-9, rtol=1e-6)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    glimpses, boxes, _ = inputs(1, 2, 9, 1, cuda, False)
    with pytest.raises(ValueError, match="contiguous"):
        K.composite_forward(glimpses[0].transpose(3, 4), *glimpses[1:],
                            boxes, (32, 32))
    with pytest.raises(TypeError):
        K.composite_forward(glimpses[0].half(), *glimpses[1:], boxes,
                            (32, 32))
    with pytest.raises(ValueError, match="boxes"):
        K.composite_forward(*glimpses, boxes.double(), (32, 32))


def cotangents(seed, b, c, hw, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, c) + hw, generator=gen, device=dev),
            torch.randn((b, 1) + hw, generator=gen, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(GRAD_BARS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("c", [1, 3])
def test_backward_kernel_matches_plain(cuda, dtype, gated, c):
    """Boxes up to 1.5x the canvas, so supports span more rows than one
    tile of the kernel."""
    glimpses, boxes, gate = inputs(10 + c, 3, 30, c, cuda, gated, 1.5)
    hw = (72, 56)
    dnum, dden = cotangents(c, 3, c, hw, cuda)
    before = K.composite_backward.launches
    got = K.composite_backward(
        *(g.to(getattr(torch, dtype)) for g in glimpses), boxes, hw, dnum,
        dden, pres_gate=gate)
    torch.cuda.synchronize()
    want = K.composite_backward_plain(*glimpses, boxes, hw, dnum, dden,
                                      pres_gate=gate)
    assert K.composite_backward.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == (w.dtype if g.shape[-1] == 4
                           else getattr(torch, dtype))
        assert rel((g.float(),), (w,)) < GRAD_BARS[dtype]
    if gate is not None:
        dead = gate == 0
        assert all(bool((g[dead] == 0).all()) for g in got)


@pytest.mark.gpu
def test_backward_kernel_all_gated_is_zero(cuda):
    glimpses, boxes, _ = inputs(2, 2, 9, 1, cuda, False)
    dnum, dden = cotangents(2, 2, 1, (32, 32), cuda)
    got = K.composite_backward(*glimpses, boxes, (32, 32), dnum, dden,
                               pres_gate=torch.zeros(2, 9, device=cuda))
    assert all(bool((g == 0).all()) for g in got)


@pytest.mark.gpu
def test_backward_kernel_integer_source_coordinates(cuda):
    """Canvas 33 = 2^5 + 1, glimpse 17 = 2^4 + 1, dyadic centres and
    scales: every source coordinate is exact, and many are integers, where
    the box derivative takes sign(0) = 0."""
    glimpses, _, _ = inputs(3, 2, 3, 1, cuda, False, g=17)
    boxes = torch.tensor([[0.5, 0.5, 1.0, 1.0], [0.25, 0.75, 0.5, 0.5],
                          [0.625, 0.375, 0.75, 0.25]],
                         device=cuda).expand(2, 3, 4).contiguous()
    hw = (33, 33)
    dnum, dden = cotangents(3, 2, 1, hw, cuda)
    got = K.composite_backward(*glimpses, boxes, hw, dnum, dden)
    want = K.composite_backward_plain(*glimpses, boxes, hw, dnum, dden)
    assert rel(got, want) < GRAD_BARS["float32"]


@pytest.mark.gpu
def test_autograd_function_matches_autograd_through_plain(cuda):
    glimpses, boxes, gate = inputs(4, 2, 20, 1, cuda, True)
    hw = (48, 40)
    dnum, dden = cotangents(4, 2, 1, hw, cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (*glimpses, boxes)]
        num, den = fn(*leaves, hw, pres_gate=gate)
        torch.autograd.backward((num, den), (dnum, dden))
        return [t.grad for t in leaves]

    f0, b0 = K.composite_forward.launches, K.composite_backward.launches
    got = grads(K.composite)
    assert (K.composite_forward.launches, K.composite_backward.launches) \
        == (f0 + 1, b0 + 1)
    want = grads(K.composite_plain)
    assert rel(got, want) < GRAD_BARS["float32"]


# --------------------------------------------------- K3 / K4 (composite_v3)

HW3, CELL3, GRID3 = (48, 48), 12, (4, 4)
BOUNDS3 = (0.0, 1.0, 0.25)  # bands of 40 of the 48 canvas rows


def banded(seed, c, dev, out_of_band=True):
    """Glimpses (B=3, 16 objects of a 4x4 grid) and boxes inside their
    cells' bounds; object 0 sits past its row's band."""
    rng = np.random.RandomState(seed)
    b, n = 3, 16

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype("f")
    glimpses = [torch.as_tensor(a, device=dev) for a in (
        u(b, n, c, 14, 14), u(b, n, 1, 14, 14), u(b, n, 1, 14, 14, lo=0.01))]
    hh, ww = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    yt = (hh.ravel()[None] + u(b, n)) * CELL3 / 48
    xt = (ww.ravel()[None] + u(b, n)) * CELL3 / 48
    boxes = np.stack([xt, yt, u(b, n, lo=0.05, hi=0.25),
                      u(b, n, lo=0.05, hi=0.25)], -1).astype("f")
    if out_of_band:
        boxes[:, 0] = (0.3, 0.88, 0.2, 0.2)
    return glimpses, torch.as_tensor(boxes, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("c", [1, 3])
def test_v3_kernels_match_plain(cuda, dtype, c):
    glimpses, boxes = banded(20 + c, c, cuda)
    geom = (HW3, CELL3, GRID3, BOUNDS3)
    dnum, dden = cotangents(c, 3, c, HW3, cuda)
    low = [g.to(getattr(torch, dtype)) for g in glimpses]
    f0, b0 = V.composite_v3_forward.launches, V.composite_v3_backward.launches
    with torch.no_grad():
        got = V.composite_v3_forward(*low, boxes, *geom)
        grads = V.composite_v3_backward(*low, boxes, *geom, dnum, dden)
        torch.cuda.synchronize()
    assert (V.composite_v3_forward.launches,
            V.composite_v3_backward.launches) == (f0 + 1, b0 + 1)
    want = V.composite_v3_plain(*glimpses, boxes, *geom)
    assert rel(got, want) < BARS[dtype]
    want = V.composite_v3_backward_plain(*glimpses, boxes, *geom, dnum, dden)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert rel((g.float(),), (w,)) < GRAD_BARS[dtype]


@pytest.mark.gpu
def test_v3_kernels_all_gated(cuda):
    glimpses, boxes = banded(3, 1, cuda)
    zeros = [torch.zeros_like(g) for g in glimpses]
    geom = (HW3, CELL3, GRID3, BOUNDS3)
    num, den = V.composite_v3_forward(*zeros, boxes, *geom)
    assert bool((num == 0).all())
    np.testing.assert_allclose(den.cpu().numpy(), 16e-9, rtol=1e-6)
    dnum, dden = cotangents(5, 3, 1, HW3, cuda)
    got = V.composite_v3_backward(*zeros, boxes, *geom, dnum, dden)
    want = V.composite_v3_backward_plain(*zeros, boxes, *geom, dnum, dden)
    for i in (0, 1, 3):
        assert bool((got[i] == 0).all())
    assert rel((got[2],), (want[2],)) < GRAD_BARS["float32"]


@pytest.mark.gpu
def test_v3_function_matches_k1_path_and_autograd(cuda):
    """For band-respecting boxes K3 computes K1's function; the autograd
    Function's gradients equal autograd's through the plain version."""
    glimpses, boxes = banded(6, 1, cuda, out_of_band=False)
    geom = (HW3, CELL3, GRID3, BOUNDS3)
    with torch.no_grad():
        assert rel(V.composite_v3_forward(*glimpses, boxes, *geom),
                   K.composite_forward(*glimpses, boxes, HW3)) < 1e-4
    dnum, dden = cotangents(7, 3, 1, HW3, cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (*glimpses, boxes)]
        torch.autograd.backward(fn(*leaves, *geom), (dnum, dden))
        return [t.grad for t in leaves]

    assert rel(grads(V.composite_v3), grads(V.composite_v3_plain)) \
        < GRAD_BARS["float32"]
