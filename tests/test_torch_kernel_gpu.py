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


# ------------------------------- K1 / K2 edge cases: culling, tiles, stages

def held(glimpses, boxes, hw, dev, gate=None, dtype="float32", seed=0):
    """K1 and K2 on the glimpses in ``dtype`` against their plain versions
    on the f32 glimpses; returns the kernels' outputs."""
    low = [g.to(getattr(torch, dtype)) for g in glimpses]
    dnum, dden = cotangents(seed, boxes.shape[0], glimpses[0].shape[2], hw,
                            dev)
    with torch.no_grad():
        fwd = K.composite_forward(*low, boxes, hw, pres_gate=gate)
        bwd = K.composite_backward(*low, boxes, hw, dnum, dden,
                                   pres_gate=gate)
        torch.cuda.synchronize()
        want_f = K.composite_plain(*glimpses, boxes, hw, pres_gate=gate)
        want_b = K.composite_backward_plain(*glimpses, boxes, hw, dnum, dden,
                                            pres_gate=gate)
    for g, w in zip(fwd, want_f):
        assert rel((g,), (w,)) < BARS[dtype]
    for g, w in zip(bwd, want_b):
        assert g.shape == w.shape
        assert rel((g.float(),), (w,)) < GRAD_BARS[dtype]
    return fwd, bwd


def boxes_of(rows, b, n, dev):
    """(b, n, 4) boxes cycling through ``rows`` of [xt, yt, xs, ys]."""
    t = torch.tensor(rows, dtype=torch.float32, device=dev)
    return t[torch.arange(n, device=dev) % len(rows)].expand(b, n, 4) \
        .contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_main_shape_kernels_match_plain(cuda, dtype, gated):
    """C = 1, 28 x 28 glimpses on a 128 x 128 canvas: K2's compile-time
    instantiation and its asynchronous glimpse stages."""
    glimpses, boxes, gate = inputs(30, 4, 121, 1, cuda, gated, 0.375, g=28)
    held(glimpses, boxes, (128, 128), cuda, gate, dtype)


@pytest.mark.gpu
def test_all_objects_on_one_box(cuda):
    glimpses, _, _ = inputs(31, 2, 121, 1, cuda, False, g=28)
    boxes = boxes_of([[0.3, 0.6, 0.2, 0.25]], 2, 121, cuda)
    held(glimpses, boxes, (128, 128), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [14, 28])
def test_boxes_larger_than_the_canvas(cuda, g):
    glimpses, _, _ = inputs(32, 2, 5, 1, cuda, False, g=g)
    boxes = boxes_of([[0.5, 0.5, 2.0, 3.0], [0.1, 0.9, 4.0, 1.5],
                      [-0.3, 1.2, 2.5, 2.5], [0.5, 0.5, 1.0, 1.0],
                      [0.7, 0.2, 1e-3, 1e-3]], 2, 5, cuda)
    held(glimpses, boxes, (72, 56), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_px", [16, 100])
@pytest.mark.parametrize("c", [1, 3])
def test_supports_past_every_tile(cuda, monkeypatch, tile_px, c):
    """Supports taller and wider than K1's 32 x 8 tile and K2's dP tile:
    K2 walks them in row and column tiles."""
    monkeypatch.setattr(K, "BWD_TILE_PX", tile_px)
    K._bwd_tile_px.cache_clear()
    try:
        glimpses, boxes, gate = inputs(33, 2, 20, c, cuda, True, 1.5, g=28)
        held(glimpses, boxes, (72, 56), cuda, gate)
    finally:
        K._bwd_tile_px.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("g", [14, 28])
def test_one_image_one_object(cuda, g):
    glimpses, boxes, _ = inputs(34, 1, 1, 1, cuda, False, g=g)
    held(glimpses, boxes, (40, 48), cuda)


@pytest.mark.gpu
def test_objects_past_the_cull_chunk(cuda):
    """N = 300: K1 culls in chunks of K.CULL_CHUNK and keeps object order."""
    glimpses, boxes, gate = inputs(35, 2, 300, 1, cuda, True, 0.3, g=28)
    held(glimpses, boxes, (64, 64), cuda, gate)


@pytest.mark.gpu
def test_unaligned_glimpses(cuda):
    """Glimpses 4 bytes off 16-byte alignment: K2 copies the planes itself
    instead of with the bulk copy."""
    glimpses, boxes, _ = inputs(36, 2, 30, 1, cuda, False, g=28)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out
    moved = [shifted(g) for g in glimpses]
    assert moved[0].data_ptr() % 16 != 0 and moved[0].is_contiguous()
    held(moved, boxes, (128, 128), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [14, 28])
def test_two_launches_agree_bit_for_bit(cuda, g):
    glimpses, boxes, gate = inputs(37, 8, 121, 1, cuda, True, 0.375, g=g)
    hw = (128, 128)
    dnum, dden = cotangents(37, 8, 1, hw, cuda)
    runs = [(*K.composite_forward(*glimpses, boxes, hw, pres_gate=gate),
             *K.composite_backward(*glimpses, boxes, hw, dnum, dden,
                                   pres_gate=gate)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


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


# ------------------------------------- K3 / K4 edge cases: the band launches

# (canvas, cell height, grid, box bounds): paper128's geometry, bands of 88
# of 128 rows (K4 through K2's fixed C = 1, 28 x 28 instantiation); a 4 x 40
# grid, N = 160 objects, past K1's cull chunk, bands of 64 rows; a 256 x 256
# canvas with bands of 144-152 rows
P128 = ((128, 128), 12, (11, 11), (-0.5, 1.5, 0.375))
WIDE40 = ((128, 128), 32, (4, 40), (0.0, 1.0, 0.1))
BIG = ((256, 256), 64, (4, 4), (0.0, 1.0, 0.25))


def v3_case(seed, b, c, g, geom, dev, past_band=True):
    """Glimpses (C channels, g x g) and boxes from the model's
    parameterization for ``geom``; with ``past_band`` every fifth object
    sits near the far edge of the canvas from its grid row, past its
    band."""
    hw, cell, (gh, gw), (min_cy, max_cy, max_ys) = geom
    rng = np.random.RandomState(seed)
    n = gh * gw

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype("f")
    glimpses = [torch.as_tensor(a, device=dev) for a in (
        u(b, n, c, g, g), u(b, n, 1, g, g), u(b, n, 1, g, g, lo=0.01))]
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    yt = (hh.ravel() + u(b, n, lo=min_cy, hi=max_cy)) * cell / hw[0]
    xt = (ww.ravel() + u(b, n, lo=min_cy, hi=max_cy)) / gw
    if past_band:
        yt[:, ::5] = np.where(hh.ravel()[::5] < gh / 2, 0.9, 0.1)
    boxes = np.stack([xt, yt, u(b, n, lo=0.05, hi=max_ys),
                      u(b, n, lo=0.05, hi=max_ys)], -1).astype("f")
    return glimpses, torch.as_tensor(boxes, device=dev)


def v3_held(glimpses, boxes, geom, dev, dtype="float32", seed=0):
    """K3 and K4 on the glimpses in ``dtype`` against their plain versions
    on the f32 glimpses, each output on its own scale; one launch of each."""
    dnum, dden = cotangents(seed, boxes.shape[0], glimpses[0].shape[2],
                            geom[0], dev)
    low = [g.to(getattr(torch, dtype)) for g in glimpses]
    f0, b0 = V.composite_v3_forward.launches, V.composite_v3_backward.launches
    with torch.no_grad():
        fwd = V.composite_v3_forward(*low, boxes, *geom)
        bwd = V.composite_v3_backward(*low, boxes, *geom, dnum, dden)
        torch.cuda.synchronize()
        want_f = V.composite_v3_plain(*glimpses, boxes, *geom)
        want_b = V.composite_v3_backward_plain(*glimpses, boxes, *geom, dnum,
                                               dden)
    assert (V.composite_v3_forward.launches,
            V.composite_v3_backward.launches) == (f0 + 1, b0 + 1)
    for g, w in zip(fwd, want_f):
        assert rel((g,), (w,)) < BARS[dtype]
    for g, w in zip(bwd, want_b):
        assert g.shape == w.shape
        assert rel((g.float(),), (w,)) < GRAD_BARS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(BARS))
def test_v3_paper128_shapes(cuda, dtype):
    """C = 1, 28 x 28 glimpses on paper128's bands: K4 through K2's
    compile-time instantiation and its bulk-copy stages."""
    glimpses, boxes = v3_case(40, 4, 1, 28, P128, cuda)
    v3_held(glimpses, boxes, P128, cuda, dtype)


@pytest.mark.gpu
def test_v3_objects_past_the_cull_chunk(cuda):
    """N = 160: K3 culls in chunks of K.CULL_CHUNK and keeps object order."""
    glimpses, boxes = v3_case(41, 2, 1, 28, WIDE40, cuda)
    v3_held(glimpses, boxes, WIDE40, cuda)


@pytest.mark.gpu
def test_v3_unaligned_glimpse_planes(cuda):
    """17 x 17 f32 planes, 1156 bytes, not a multiple of 16: K4 copies the
    planes itself instead of with the bulk copy."""
    geom = ((48, 48), 12, (4, 4), (0.0, 1.0, 0.25))
    glimpses, boxes = v3_case(42, 3, 1, 17, geom, cuda)
    v3_held(glimpses, boxes, geom, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("c, g", [(1, 28), (3, 14)])
def test_v3_band_past_a_block_of_shared_memory(cuda, c, g):
    """Bands of 144-152 of 256 rows, whose dnum and dden (C + 1 planes of
    band x 256 floats) would not fit the 227 KB of shared memory one block
    may use; C = 3, 14 x 14 takes the generic instantiation."""
    hw, cell, grid, bounds = BIG
    band, _ = V.band_geometry(hw, cell, *bounds, g, grid[0])
    assert band < hw[0] and 4 * (c + 1) * band * hw[1] > 227 * 1024
    glimpses, boxes = v3_case(43 + c, 2, c, g, BIG, cuda)
    v3_held(glimpses, boxes, BIG, cuda)


@pytest.mark.gpu
def test_v3_two_launches_agree_bit_for_bit(cuda):
    glimpses, boxes = v3_case(44, 8, 1, 28, P128, cuda)
    dnum, dden = cotangents(44, 8, 1, P128[0], cuda)
    runs = [(*V.composite_v3_forward(*glimpses, boxes, *P128),
             *V.composite_v3_backward(*glimpses, boxes, *P128, dnum, dden))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_v3_forward_equals_k1_for_boxes_in_their_bands(cuda):
    """Boxes inside their bands lose nothing to the clip: K3 lists the same
    objects in the same order wherever they paste, so its num and den equal
    K1's bit for bit."""
    glimpses, boxes = v3_case(45, 4, 1, 28, P128, cuda, past_band=False)
    with torch.no_grad():
        got = V.composite_v3_forward(*glimpses, boxes, *P128)
        want = K.composite_forward(*glimpses, boxes, P128[0])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# a tall, narrow canvas of 72 x 8 cells of 8 px: more grid rows than the
# launch's parameters carry (K.PARAM_BAND_ROWS = 64), so K3 and K4 read the
# band starts from device memory; 64 rows still take the parameter
def tall(gh):
    return ((8 * gh, 64), 8, (gh, 8), (-0.5, 1.5, 0.06))


@pytest.mark.gpu
@pytest.mark.parametrize("gh", [64, 65, 72])
@pytest.mark.parametrize("dtype", sorted(BARS))
def test_v3_grids_past_the_parameter_rows(cuda, gh, dtype):
    geom = tall(gh)
    band, starts = V.band_geometry(geom[0], geom[1], *geom[3], 14, gh)
    assert band < geom[0][0] and len(set(starts.tolist())) > 1
    glimpses, boxes = v3_case(50 + gh, 2, 1, 14, geom, cuda)
    v3_held(glimpses, boxes, geom, cuda, dtype)


@pytest.mark.gpu
def test_v3_tall_grid_equals_k1_for_boxes_in_their_bands(cuda):
    """At 72 grid rows, with boxes inside their bands, K3's num and den
    equal K1's bit for bit: the starts read from device memory clip
    nothing that K1 pastes."""
    geom = tall(72)
    glimpses, boxes = v3_case(46, 2, 1, 14, geom, cuda, past_band=False)
    with torch.no_grad():
        got = V.composite_v3_forward(*glimpses, boxes, *geom)
        want = K.composite_forward(*glimpses, boxes, geom[0])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------- top-K through K1/K2 (render_topk)

def topk_latents(cfg, b, live, dev, seed=0):
    """Latent grids for render on cfg's grid: boxes on the cell centres,
    presence 0.9 on ``live`` random cells of each image and 0.001
    elsewhere (the 0.01 gate drops those)."""
    from spair_pytorch_tpu_torch.models.latents import geometry
    _, (gh, gw), _ = geometry(cfg)
    rng = np.random.RandomState(seed)
    n = gh * gw
    pres = np.full((b, n), 0.001, "f")
    for i in range(b):
        pres[i, rng.choice(n, live, replace=False)] = 0.9
    yy, xx = np.meshgrid((np.arange(gh) + 0.5) / gh,
                         (np.arange(gw) + 0.5) / gw, indexing="ij")
    where = np.concatenate([np.stack([xx, yy], -1).reshape(1, n, 2)
                            .repeat(b, 0),
                            rng.uniform(0.1, 0.3, (b, n, 2))], -1)
    zs = (rng.randn(b, n, cfg.n_attributes), where,
          rng.uniform(0.5, 3.5, (b, n, 1)), pres[..., None])
    return [torch.as_tensor(z.reshape(b, gh, gw, -1).astype("f"), device=dev)
            for z in zs]


@pytest.mark.gpu
@pytest.mark.parametrize("live", [5, 40], ids=["sparse", "dense"])
def test_reference_topk_through_the_kernels(cuda, monkeypatch, live):
    """cluttered_fine's 16 x 16 grid, K = 32, the 0.01 gate: with at most
    K live objects an image, K1 and K2 run once each on N = K objects and
    match the full gated grid (values 1e-6, gradients against z_attr and
    z_where rtol 5e-4 / atol 1e-5, the JAX package's top-K bars); with more
    the full grid runs, N = 256."""
    import dataclasses

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.render import render

    topk = PRESETS["cluttered_fine"]()
    full = dataclasses.replace(topk, render_topk=0)
    model = init_params(topk, device=cuda)
    zs = topk_latents(topk, 4, live, cuda)
    sizes = []
    for name in ("_launch_forward", "_launch_backward"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, **kw: (
            sizes.append(a[0].shape[1]), _fn(*a, **kw))[1])

    def run(cfg):
        a, w = (z.clone().requires_grad_(True) for z in zs[:2])
        out = render(model, cfg, a, w, zs[2], zs[3], (128, 128))
        torch.sum(out ** 2).backward()
        return out.detach(), a.grad, w.grad

    want = run(full)
    del sizes[:]
    got = run(topk)
    torch.cuda.synchronize()
    assert sizes == ([32, 32] if live <= 32 else [256, 256])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=5e-4, atol=1e-5)


# every int8 product of the paper128 detector, (rows, inner, out): the
# wavefront's 6-lane fronts at serve batches 1 and 32 (6 rows are padded to
# 17; inner widths 324, 478, 479 to multiples of 8; outputs 1, 2, 100 to
# multiples of 8) and the backbone's convs as products of their patches
INT8_SHAPES = sorted(
    {(m, k, n) for m in (6, 192)
     for k, n in ((100, 1), (100, 2), (100, 8), (100, 100), (128, 100),
                  (256, 128), (324, 100), (478, 100), (479, 100),
                  (784, 256))}
    | {(121, 128, 100), (121, 128, 128), (121, 2048, 128), (576, 2048, 128),
       (2500, 16, 128), (3872, 128, 100), (3872, 128, 128),
       (3872, 2048, 128), (18432, 2048, 128), (80000, 16, 128)})


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int_mm_equals_the_exact_product(cuda, m, k, n):
    from spair_pytorch_tpu_torch.ops import quant
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    got = quant.int_mm(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, quant.int_mm_plain(a, w.t()))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 32])
def test_quantized_detector_products_are_exact(cuda, monkeypatch, b):
    """Every product the int8 paper128 detector computes, held to the
    exact product on its own operands; the detector's shapes are the
    list above."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.ops import quant
    cfg = PRESETS["paper128"]()
    model = quant.quantize_params_int8(init_params(cfg, device=cuda))
    seen = {}
    launch = quant.int_mm

    def record(a, w):
        out = launch(a, w)
        key = (a.shape[0], a.shape[1], w.shape[0])
        if key not in seen:
            seen[key] = torch.equal(out, quant.int_mm_plain(a, w.t()))
        return out

    monkeypatch.setattr(quant, "int_mm", record)
    x = torch.rand(b, 1, 128, 128, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(b))
    out = make_detector(cfg)(model, x)
    assert bool(torch.isfinite(out["scores"]).all())
    assert seen and all(seen.values()), seen
    assert set(seen) <= set(INT8_SHAPES), sorted(set(seen) - set(INT8_SHAPES))


@pytest.mark.gpu
def test_native_batch_reaches_the_card_equal_to_the_host_batch(cuda):
    from spair_pytorch_tpu_torch.data import DataConfig
    from spair_pytorch_tpu_torch.data.native import NativeScatteredDigits
    dcfg = DataConfig(image_hw=(128, 128), max_objects=6)
    on_card = NativeScatteredDigits(dcfg, 128, seed=3, device=cuda)
    on_host = NativeScatteredDigits(dcfg, 128, seed=3, device="cpu")
    for _ in range(3):
        got, want = next(on_card), next(on_host)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


def window_inputs(seed, scenes, k, g, dev):
    """Split refinement's windows: ``scenes`` scenes of ``k`` objects of
    g x g glimpses on a 32 x 32 canvas, boxes in the window's frame (the
    parent about 2/3 of the window, children inside it)."""
    rng = np.random.RandomState(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype("f"),
                               device=dev)
    color, alpha = u(scenes, k, 1, g, g), u(scenes, k, 1, g, g)
    boxes = torch.cat([u(scenes, k, 2, lo=0.3, hi=0.7),
                       u(scenes, k, 2, lo=0.3, hi=0.67)], -1).contiguous()
    return color, alpha, boxes


@pytest.mark.gpu
@pytest.mark.parametrize("scenes", [384, 2304])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("g", [14, 28])
def test_kernel_at_split_refinement_shapes(cuda, scenes, k, g):
    """K1 on refinement's windows (B*M scenes of one object, B*M*6 of two,
    at M = 12 and B = 32 or 192 / 6) against the plain compositor."""
    color, alpha, boxes = window_inputs(scenes + k + g, scenes, k, g, cuda)
    imp = torch.clamp(alpha, min=0.01)
    before = K.composite_forward.launches
    with torch.no_grad():
        got = K.composite_forward(color, alpha, imp, boxes, (32, 32))
        torch.cuda.synchronize()
        want = K.composite_plain(color, alpha, imp, boxes, (32, 32), chunk=k)
    assert K.composite_forward.launches == before + 1
    assert rel(got, want) < BARS["float32"]


@pytest.mark.gpu
def test_refinement_windows_past_the_scene_limit(cuda):
    """More than 65,535 scenes: refine composites them in two launches of
    K1, equal to the plain compositor on all of them at once."""
    import dataclasses

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import refine

    cfg = PRESETS["paper128"]()
    plain_cfg = dataclasses.replace(cfg, render_backend="xla")
    scenes = K.MAX_SCENES + 1000
    color, alpha, boxes = window_inputs(5, scenes, 2, 14, cuda)
    before = K.composite_forward.launches
    with torch.no_grad():
        got = refine._composite_window(cfg, color, alpha, boxes, (32, 32))
        torch.cuda.synchronize()
        assert K.composite_forward.launches == before + 2
        want = refine._composite_window(plain_cfg, color, alpha, boxes,
                                        (32, 32))
    assert got.shape == (scenes, 1, 32, 32)
    assert rel([got], [want]) < BARS["float32"]


@pytest.mark.gpu
def test_generative_grad_views_through_the_kernels(cuda):
    """The figure path's gradient views at paper128 width (B = 4): K1
    forward and K2 backward, ungated, against autograd through the plain
    compositor ('xla'), each output on its own scale at the gradient bar."""
    import dataclasses

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.utils.debug import generative_grad_views

    cfg = PRESETS["paper128"]()
    model = init_params(cfg, device=cuda)
    rng = np.random.RandomState(6)
    b, gh = 4, 11
    zs = [torch.as_tensor(z.astype("f"), device=cuda) for z in (
        rng.randn(b, cfg.n_attributes, gh, gh),
        np.concatenate([rng.uniform(0.1, 0.9, (b, 2, gh, gh)),
                        rng.uniform(0.05, 0.35, (b, 2, gh, gh))], 1),
        rng.uniform(0.5, 3.5, (b, 1, gh, gh)),
        rng.uniform(0.0, 1.0, (b, 1, gh, gh)))]
    x = torch.as_tensor(rng.rand(b, 1, 128, 128).astype("f"), device=cuda)
    launches = (K.composite_forward.launches, K.composite_backward.launches)
    got = generative_grad_views(model, cfg, x, *zs)
    torch.cuda.synchronize()
    assert (K.composite_forward.launches, K.composite_backward.launches) \
        == (launches[0] + 1, launches[1] + 1)
    want = generative_grad_views(
        model, dataclasses.replace(cfg, render_backend="xla"), x, *zs)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        assert rel([g], [w]) < GRAD_BARS["float32"]


@pytest.mark.gpu
def test_bench_check_passes_on_the_card(cuda):
    """The bench's --check gate at its default config (paper128, bf16,
    gate 0.01, b128): K1 and K2 three times each (f32, bf16 glimpses,
    gated), every error under bench.py's bar, and TF32 as it found it."""
    from spair_pytorch_tpu_torch import bench

    args = bench.parse_args([])
    torch.backends.cudnn.allow_tf32 = True
    launches = (K.composite_forward.launches, K.composite_backward.launches)
    res = bench.run_check(bench.build_config(args), cuda)
    assert (K.composite_forward.launches, K.composite_backward.launches) \
        == (launches[0] + 3, launches[1] + 3)
    assert res["passed"]
    for k, bar in bench.BARS.items():
        assert res[k] < bar, (k, res[k])
    assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
