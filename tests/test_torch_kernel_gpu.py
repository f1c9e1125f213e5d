"""The CUDA compositor kernels (K1/K2, and K3/K4 for 'pallas_v3') against
their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips when no CUDA card is visible. The file
imports nothing from the other test modules, so it runs on a machine with
the card alone: ``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.
Tolerances, as relative error max |kernel - plain| / max |plain|: forward
1e-4 for f32 glimpses and 3e-2 for bf16 glimpses against f32 truth;
backward 1e-3 and 6e-2 (bench.py's gradient bars). TF32 is off, so the
plain versions compute in full f32."""

import dataclasses

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


# K5, the windowed matmul paste of benchmarks/kernel_anatomy.py: each
# variant against its plain version with t's f32 sums rounded toward zero,
# as the tensor cores round them, at 1e-6 of each output's own scale: the
# kernel rounds the weights and t to bf16 where the plain version does, and
# a hat row has at most two nonzeros, so each sum is exact before its one
# rounding (the card reads ~1e-7, chip_smoke.py phase 22). The plain base
# with t kept in f32 reads ~1e-3 against it, which this bar must refuse.
# Against the plain version that rounds to nearest, 5e-3: there a few t
# sums straddle a bf16 rounding boundary and t's bf16 rounding flips.
ANATOMY_BAR = 1e-6
ANATOMY_NEAREST_BAR = 5e-3
ANATOMY_SHAPES = {  # (B, N, C, glimpse, canvas, window, max scale)
    "paper": (4, 121, 1, 28, (128, 128), 64, 48 / 128),
    "c3": (2, 9, 3, 14, (64, 64), 32, 0.3),
    "win_eq_h": (2, 40, 1, 28, (128, 128), 128, 48 / 128),
    # the constant box reaches rows 0-7 here: noaccum adds something
    "small": (2, 12, 1, 8, (16, 32), 16, 0.5),
}


def anatomy_inputs(shape, dev, seed=0):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    b, n, c, o, hw, win, max_scale = ANATOMY_SHAPES[shape]
    rng = np.random.RandomState(seed)

    def u(*s, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, s).astype("f"),
                               device=dev)
    g = A.pack(u(b, n, c, o, o), u(b, n, 1, o, o),
               u(b, n, 1, o, o, lo=0.01)).to(torch.bfloat16).contiguous()
    boxes = torch.cat([u(b, n, 2, lo=0.05, hi=0.95),
                       u(b, n, 2, lo=0.05, hi=max_scale)], -1).contiguous()
    return g, boxes, hw, win, c


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ANATOMY_SHAPES))
@pytest.mark.parametrize("variant", ["base", "hoisted", "nobuild",
                                     "nomatmul", "noaccum"])
def test_anatomy_kernel_matches_plain(cuda, variant, shape):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win, c = anatomy_inputs(shape, cuda)
    w = A.hoisted_weights(boxes, hw, g.shape[2:3] + (g.shape[3] // (c + 2),),
                          win) if variant == "hoisted" else (None, None)
    before = A.kernel_anatomy.launches
    got = A.kernel_anatomy(variant, g, boxes, hw, win, *w, channels=c)
    torch.cuda.synchronize()
    assert A.kernel_anatomy.launches == before + 1
    b = g.shape[0]
    assert got[0].shape == (b, c) + hw and got[1].shape == (b, 1) + hw
    for t_sum, bar in (("toward_zero", ANATOMY_BAR),
                       ("nearest", ANATOMY_NEAREST_BAR)):
        want = A.kernel_anatomy_plain(variant, g, boxes, hw, win, *w,
                                      channels=c, t_sum=t_sum)
        for x, y in zip(got, want):
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            assert (err / scale if scale else err) < bar, (t_sum, err, scale)


@pytest.mark.gpu
def test_anatomy_hoisted_kernel_matches_base_kernel(cuda):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win, c = anatomy_inputs("paper", cuda, seed=1)
    base = A.kernel_anatomy("base", g, boxes, hw, win)
    hoisted = A.kernel_anatomy("hoisted", g, boxes, hw, win,
                               *A.hoisted_weights(boxes, hw, (28, 28), win))
    assert rel(hoisted, base) < ANATOMY_BAR


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ANATOMY_SHAPES))
def test_anatomy_bar_refuses_t_kept_in_f32(cuda, shape):
    """The control: the base kernel against the plain base that keeps t in
    f32 between the products fails the bar the kernel is held to."""
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win, c = anatomy_inputs(shape, cuda)
    got = A.kernel_anatomy("base", g, boxes, hw, win, channels=c)
    unrounded = A.kernel_anatomy_plain("base", g, boxes, hw, win,
                                       channels=c, t_sum="toward_zero",
                                       round_t=False)
    assert rel(got, unrounded) >= ANATOMY_BAR


def held_to_plain(A, variant, got, g, boxes, hw, win, w, c=1):
    for t_sum, bar in (("toward_zero", ANATOMY_BAR),
                       ("nearest", ANATOMY_NEAREST_BAR)):
        want = A.kernel_anatomy_plain(variant, g, boxes, hw, win, *w,
                                      channels=c, t_sum=t_sum)
        for x, y in zip(got, want):
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            assert (err / scale if scale else err) < bar, (t_sum, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ANATOMY_SHAPES))
@pytest.mark.parametrize("variant", ["base", "hoisted", "nobuild",
                                     "nomatmul", "noaccum"])
def test_anatomy_kernel_lists_strips_touched(cuda, variant, shape):
    """The lists the kernel's producer walked are strips_touched's."""
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win, c = anatomy_inputs(shape, cuda)
    o = (g.shape[2], g.shape[3] // (c + 2))
    w = A.hoisted_weights(boxes, hw, o, win) if variant == "hoisted" \
        else (None, None)
    *got, listed = A.kernel_anatomy_listed(variant, g, boxes, hw, win, *w,
                                           channels=c)
    assert torch.equal(listed, A.strips_touched(variant, boxes, hw, o))
    held_to_plain(A, variant, got, g, boxes, hw, win, w, c)


# the seams of K5's design, paper shapes (28x28, 128x128, win 64) at B=2:
# an object whose support lies in one strip (strip 1 in image 0, strip 2 in
# image 1); objects centred on the strip boundaries; support edges on the
# strip boundaries within 3 float32 ulps; scales so small that one column
# step leaps the glimpse (the cull's column-by-column test); windows clamped
# at rows 0 and H - win; fewer objects than the consumers and the ring's
# stages, and counts that are not a multiple of the consumers' turns
ANATOMY_SEAMS = ("one_strip", "straddle", "edge_ulps", "tiny", "clamped",
                 "n1", "n2", "n3", "n5")


def seam_inputs(seam, dev):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    rng = np.random.RandomState(ANATOMY_SEAMS.index(seam))
    n = {"one_strip": 1, "straddle": 9, "clamped": 8, "edge_ulps": 84,
         "tiny": 16}.get(seam) or int(seam[1:])
    boxes = np.stack([rng.uniform(0.05, 0.95, (2, n)),
                      rng.uniform(0.05, 0.95, (2, n)),
                      rng.uniform(0.05, 48 / 128, (2, n)),
                      rng.uniform(0.05, 48 / 128, (2, n))], -1)
    if seam == "one_strip":  # columns 48 +- 7 and 80 +- 7
        boxes[:, 0] = [[48 / 127, 0.5, 0.1, 0.2], [80 / 127, 0.4, 0.1, 0.3]]
    elif seam == "straddle":
        boxes[..., 0] = np.repeat([32 / 127, 64 / 127, 96 / 127], 3)
        boxes[..., 2] = np.tile([0.05, 0.15, 0.3], 3)
    elif seam == "edge_ulps":  # src = -1 or 28 at columns 31, 32, 63, ...
        k, rows = 1.0 + 2.0 / 27, []
        for x in (31, 32, 63, 64, 95, 96):
            for t in (x / 127 + 0.1 * k / 2, x / 127 - 0.1 * k / 2):
                t32 = np.float32(t)
                rows += [t32 + u * np.spacing(t32) for u in range(-3, 4)]
        boxes[..., 0] = np.asarray(rows)
        boxes[..., 2] = 0.1
    elif seam == "tiny":
        boxes[..., 2] = rng.uniform(0.001, 0.007, (2, n))
    elif seam == "clamped":
        boxes[..., 1] = np.where(np.arange(n) % 2, rng.uniform(0.0, 0.05, n),
                                 rng.uniform(0.95, 1.0, n))
    g = A.pack(*(torch.as_tensor(rng.uniform(lo, 1.0, (2, n, 1, 28, 28))
                                 .astype("f"), device=dev)
                 for lo in (0.0, 0.0, 0.01))).to(torch.bfloat16).contiguous()
    return g, torch.as_tensor(boxes.astype("f"), device=dev), (128, 128), 64


@pytest.mark.gpu
@pytest.mark.parametrize("seam", ANATOMY_SEAMS)
@pytest.mark.parametrize("variant", ["base", "hoisted", "nobuild",
                                     "nomatmul", "noaccum"])
def test_anatomy_kernel_at_the_seams(cuda, variant, seam):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win = seam_inputs(seam, cuda)
    w = A.hoisted_weights(boxes, hw, (28, 28), win) \
        if variant == "hoisted" else (None, None)
    *got, listed = A.kernel_anatomy_listed(variant, g, boxes, hw, win, *w)
    assert torch.equal(listed, A.strips_touched(variant, boxes, hw, (28, 28)))
    if seam == "one_strip" and variant in ("base", "hoisted"):
        assert listed.sum(-1).tolist() == [[1], [1]]
    if seam == "clamped":
        y0 = A.window_start(boxes[..., 1], boxes[..., 3], 128, win, 28)
        assert set(y0.flatten().tolist()) == {0, 128 - win}
    held_to_plain(A, variant, got, g, boxes, hw, win, w)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["dtype", "device", "odd_glimpse", "width",
                                 "window", "strided"])
def test_anatomy_wrapper_refuses(cuda, bad):
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    g, boxes, hw, win, c = anatomy_inputs("c3", cuda)
    args = dict(variant="base", g=g, boxes=boxes, image_hw=hw, win=win,
                channels=c)
    if bad == "dtype":
        args["g"] = g.float()
    elif bad == "device":
        args["boxes"] = boxes.cpu()
    elif bad == "odd_glimpse":  # 5 planes of 13 columns
        args["g"] = g[..., :65].contiguous()
    elif bad == "width":
        args["image_hw"] = (64, 48)
    elif bad == "window":
        args["win"] = 24
    else:
        args["g"] = torch.empty_like(g).transpose(0, 1).contiguous() \
            .transpose(0, 1)
    before = A.kernel_anatomy.launches
    with pytest.raises((TypeError, ValueError)):
        A.kernel_anatomy(**args)
    assert A.kernel_anatomy.launches == before


@pytest.mark.gpu
def test_anatomy_entry_point_counts_replays(cuda, capsys):
    """main() at B=2, k=2: five lines and the JSON line; K5 launched once
    eagerly and 4 replays of 2 a variant, counted over the replays."""
    import json

    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    before = A.kernel_anatomy.launches
    line = A.main(["--batch", "2", "--k", "2"])
    assert A.kernel_anatomy.launches - before == 5 * (1 + 4 * 2)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 6 and json.loads(out[-1]) == line
    assert line["device"] == torch.cuda.get_device_name(0)
    assert all(v > 0 for v in line["ms"].values())


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


# the train step captured as a CUDA graph (parallel/captured.py), at the
# main path's widths: paper128, b128, bf16, wavefront, gate 0.01

def main_path(backend="auto", **kw):
    """(config, datagen) of the main path through ``backend``."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import DataConfig, glyph_bank

    cfg = PRESETS["paper128"](batch_size=128, inference_mode="wavefront",
                              compute_dtype="bfloat16",
                              pres_gate_threshold=0.01,
                              render_backend=backend, **kw)
    bank = torch.as_tensor(glyph_bank((14, 14)), device="cuda")
    return cfg, (DataConfig(image_hw=cfg.image_shape[1:],
                            min_objects=cfg.min_scene_objects,
                            max_objects=cfg.max_scene_objects), bank)


@pytest.fixture
def deterministic(cuda):
    """Deterministic kernels (cuDNN's and PyTorch's), so that two runs of
    the same steps can be compared bit for bit."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def state_tensors(state):
    """The step, every parameter and every tensor of Adam's state."""
    return ([state.step] + list(state.model.parameters())
            + [v for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v)])


def counted():
    return (K.composite_forward, K.composite_backward,
            V.composite_v3_forward, V.composite_v3_backward)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "pallas_v3"])
def test_captured_step_equals_eager(deterministic, backend):
    """5 calls of one step and one call of K = 5, captured against eager
    from the same state: every metric of every step, every parameter,
    Adam's state, the step and the generator, bit for bit. The K = 5 call
    launches each kernel of the path 5 times, counted over the replays."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    cfg, datagen = main_path(backend)
    runs = {}
    for eager in (True, False):
        state = create_train_state(cfg, device="cuda")
        one = make_train_step(cfg, datagen=datagen, eager=eager)
        five = make_train_step(cfg, datagen=datagen, steps_per_call=5,
                               eager=eager)
        metrics = [one(state)[1] for _ in range(5)]
        five(state)  # the captured step's warm-up and capture
        before = [fn.launches for fn in counted()]
        metrics.append(five(state)[1])
        torch.cuda.synchronize()
        launches = [fn.launches - n for fn, n in zip(counted(), before)]
        want = [5, 5, 0, 0] if backend == "auto" else [0, 0, 5, 5]
        assert launches == want, (eager, launches)
        runs[eager] = state, metrics
    (e, me), (c, mc) = runs[True], runs[False]
    assert int(c.step) == 15
    for got, want in zip(mc, me):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for got, want in zip(state_tensors(c), state_tensors(e)):
        assert torch.equal(got, want)
    assert torch.equal(c.generator.get_state(), e.generator.get_state())


@pytest.mark.gpu
def test_captured_replays_draw_new_scenes(cuda, monkeypatch):
    """The scenes each replay draws (copied out of the graph by a spy on
    the step's scene generator): every step's differ from the last one's,
    and they are the scenes the eager step draws, step for step."""
    import importlib

    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    cfg, datagen = main_path()
    real = ts.generate_batch
    seen = torch.zeros((cfg.batch_size, 1, 128, 128), device="cuda")

    def spy(*args):
        x, gt_bbox, gt_count = real(*args)
        seen.copy_(x)
        return x, gt_bbox, gt_count
    monkeypatch.setattr(ts, "generate_batch", spy)
    scenes = {}
    for eager in (True, False):
        state = create_train_state(cfg, device="cuda")
        step = make_train_step(cfg, datagen=datagen, eager=eager)
        scenes[eager] = []
        for _ in range(4):
            step(state)
            scenes[eager].append(seen.clone())
    for a, b in zip(scenes[False], scenes[False][1:]):
        assert not torch.equal(a, b)
    for a, b in zip(scenes[False], scenes[True]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_captured_metrics_are_fresh(cuda):
    """Metrics a call returns are not overwritten by the next call: each
    call's are new tensors, 0-d for K = 1 and (K,) for K = 3."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    cfg, datagen = main_path()
    for k in (1, 3):
        state = create_train_state(cfg, device="cuda")
        step = make_train_step(cfg, datagen=datagen, steps_per_call=k)
        calls = [step(state)[1] for _ in range(3)]
        kept = [{n: v.clone() for n, v in m.items()} for m in calls]
        step(state)
        torch.cuda.synchronize()
        for m, held in zip(calls, kept):
            assert all(v.shape == (() if k == 1 else (k,))
                       for v in m.values())
            assert all(torch.equal(m[n], held[n]) for n in m)
        losses = [m["losses/total"].reshape(-1)[0] for m in calls]
        assert len({float(x) for x in losses}) == 3
        assert calls[1]["losses/total"].data_ptr() != \
            calls[2]["losses/total"].data_ptr()


@pytest.mark.gpu
def test_captured_step_is_bound_to_its_state(cuda):
    """A captured step called with another state, or after Adam's state
    was loaded from new tensors, raises; after the parameters were loaded
    (copied in place) it runs."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    cfg, datagen = main_path()
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg, datagen=datagen)
    step(state)
    step(state)
    other = create_train_state(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="bound to the state"):
        step(other)
    state.model.load_state_dict(state.model.state_dict())  # copies in place
    step(state)
    saved = state.optimizer.state_dict()
    saved["state"] = {i: {k: v.clone() for k, v in s.items()}
                      for i, s in saved["state"].items()}
    state.optimizer.load_state_dict(saved)  # new tensors
    with pytest.raises(RuntimeError, match="bound to the state"):
        step(state)
    assert int(state.step) == 3


@pytest.mark.gpu
def test_a_checkpoint_with_a_host_step_count_restores_and_captures(
        cuda, tmp_path):
    """A checkpoint written with the earlier, non-capturable Adam (its step
    count a host tensor) restores into the capturable one, the count on
    the card, and the restored state trains captured."""
    from spair_pytorch_tpu_torch.parallel import (TrainState,
                                                  create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager

    cfg, datagen = main_path()
    old = create_train_state(cfg, device="cuda")
    old = TrainState(step=old.step, model=old.model,
                     optimizer=torch.optim.Adam(
                         old.model.parameters(), lr=cfg.learning_rate,
                         betas=(0.9, 0.999), eps=1e-8),
                     generator=old.generator)
    make_train_step(cfg, datagen=datagen, eager=True)(old)
    counts = [s["step"] for s in old.optimizer.state.values()]
    assert all(c.device.type == "cpu" for c in counts)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(old)
    state = ckpt.restore(create_train_state(cfg, device="cuda"))
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    assert all(s["step"].device.type == "cuda" and float(s["step"]) == 1
               for s in state.optimizer.state.values())
    step = make_train_step(cfg, datagen=datagen, steps_per_call=3)
    _, m = step(state)
    _, m = step(state)
    assert int(state.step) == 7
    assert bool(torch.isfinite(m["losses/total"]).all())


@pytest.mark.gpu
def test_resumed_captured_train_equals_an_uninterrupted_one(deterministic,
                                                            tmp_path):
    """train() of 4 steps (2 a call) against 2 steps, a resume from the
    checkpoint (then a new capture) and 2 more: logged losses, parameters,
    Adam's state, generator and step bit for bit."""
    import json

    from spair_pytorch_tpu_torch.train import train

    cfg, _ = main_path()
    run = dict(checkpoint_every=2, steps_per_call=2, digits="font",
               verbose=False, device="cuda")

    def losses(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return {r["step"]: r["losses/total"] for r in map(json.loads, f)
                    if "losses/total" in r}
    whole = train(cfg, steps=4, logdir=str(tmp_path / "a"), **run)
    train(cfg, steps=2, logdir=str(tmp_path / "b"), **run)
    split = train(cfg, steps=2, logdir=str(tmp_path / "b"), **run)
    assert losses("a") == losses("b") and len(losses("a")) == 4
    for got, want in zip(state_tensors(split), state_tensors(whole)):
        assert torch.equal(got, want)
    assert torch.equal(split.generator.get_state(),
                       whole.generator.get_state())


# the forward programs captured as CUDA graphs (parallel/captured.py::
# CapturedForward): the detector, the eval step, evaluate, calibrate

DETECTOR_ARMS = [(1, "f32"), (8, "f32"), (32, "f32"), (128, "f32"),
                 (32, "bf16"), (32, "int8")]


def paper128_detector_inputs(b, weights, dev):
    """(config, parameters, images) of the paper128 detector."""
    import dataclasses

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.ops.quant import quantize_params_int8

    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    if weights == "bf16":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if weights == "int8":
        params = quantize_params_int8(params)
    x = torch.rand((b, 1, 128, 128), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(b))
    return cfg, params, x


@pytest.mark.gpu
@pytest.mark.parametrize("nms", [None, 0.5], ids=["no_nms", "nms_0.5"])
@pytest.mark.parametrize("b, weights", DETECTOR_ARMS,
                         ids=[f"b{b}_{w}" for b, w in DETECTOR_ARMS])
def test_captured_detector_equals_eager(cuda, b, weights, nms):
    """The first call (eager run and capture) and a replay equal the eager
    detector bit for bit; a replay returns fresh tensors."""
    from spair_pytorch_tpu_torch.models.infer import make_detector

    cfg, params, x = paper128_detector_inputs(b, weights, cuda)
    captured = make_detector(cfg, nms_iou=nms)
    want = make_detector(cfg, nms_iou=nms, eager=True)(params, x)
    first, again = captured(params, x), captured(params, x)
    for got in (first, again):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert first["scores"].data_ptr() != again["scores"].data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "pallas_v3"])
def test_captured_eval_step_equals_eager(deterministic, backend):
    """3 calls of the captured eval step (a capture, then 2 replays)
    against the eager step from a generator in the same state: loss and
    every aux tensor bit for bit; each replay launches the path's kernel
    (K1 or K3) once, counted over the replays."""
    import dataclasses

    from spair_pytorch_tpu_torch.parallel import make_eval_step
    from torch.utils._pytree import tree_flatten

    cfg, params, x = paper128_detector_inputs(32, "f32", deterministic)
    cfg = dataclasses.replace(cfg, render_backend=backend)
    runs = {}
    for eager in (True, False):
        step = make_eval_step(cfg, eager=eager)
        gen = torch.Generator(device="cuda").manual_seed(7)
        runs[eager] = [step(params, x, 1500, gen)]
        before = [fn.launches for fn in counted()]
        runs[eager] += [step(params, x, 1500, gen) for _ in range(2)]
        torch.cuda.synchronize()
        launches = [fn.launches - n for fn, n in zip(counted(), before)]
        assert launches == ([2, 0, 0, 0] if backend == "auto"
                            else [0, 0, 2, 0]), (eager, launches)
    got, want = (tree_flatten(runs[e])[0] for e in (False, True))
    assert len(got) == len(want) > 20
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len({float(r[0]) for r in runs[False]}) == 3


@pytest.mark.gpu
def test_captured_programs_are_bound(cuda):
    """A captured detector runs after its parameters were loaded in place
    and raises for another module; a captured eval step raises for another
    generator."""
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.parallel import make_eval_step

    cfg, params, x = paper128_detector_inputs(8, "f32", cuda)
    detect = make_detector(cfg)
    detect(params, x)
    params.load_state_dict(init_params(cfg, device="cuda").state_dict())
    detect(params, x)
    with pytest.raises(RuntimeError, match="bound to the parameters"):
        detect(init_params(cfg, device="cuda"), x)
    step = make_eval_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, x, 1500, gen)
    step(params, x, 1500, gen)
    with pytest.raises(RuntimeError, match="generator of its first call"):
        step(params, x, 1500, torch.Generator(device="cuda"))


@pytest.mark.gpu
def test_captured_evaluate_and_calibrate_equal_eager(cuda):
    """evaluate twice with one seed (one capture, re-seeded) and once
    eagerly: equal results; calibrate captured and eager: equal."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.eval import calibrate, evaluate
    from spair_pytorch_tpu_torch.parallel import create_train_state

    cfg = PRESETS["paper128"](batch_size=16)
    state = create_train_state(cfg, device="cuda")
    kw = dict(digits="font", det_threshold=0.5, det_nms=0.5)
    got = [evaluate(cfg, state, 2, **kw)[0] for _ in range(2)]
    want = evaluate(cfg, state, 2, eager=True, **kw)[0]
    assert got[0] == got[1] == want
    assert calibrate(cfg, state, 2, digits="font") == calibrate(
        cfg, state, 2, digits="font", eager=True)


# render_topk captured as segments around the render's branch (parallel/
# captured.py::SegmentedStep, SegmentedForward): cluttered_fine (reference
# mode, K1/K2) and quality (ordered mode, plain torch) at their widths (16x16
# grid, 46 fronts, K = 32), b8. The cold state is dense and takes the full
# composite; the presence head's bias shifted by SPARSE_BIAS leaves ~8 of
# 256 objects live an image and takes the top-K one.
SPARSE_BIAS = -8.0
TOPK_PRESETS = {"reference": "cluttered_fine", "ordered": "quality"}


def topk_preset(mode, **kw):
    """(config, datagen) of the render_topk preset of ``mode`` at b8."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import DataConfig, glyph_bank

    cfg = PRESETS[TOPK_PRESETS[mode]](batch_size=8, **kw)
    bank = torch.as_tensor(glyph_bank((14, 14)), device="cuda")
    return cfg, (DataConfig(image_hw=cfg.image_shape[1:],
                            min_objects=cfg.min_scene_objects,
                            max_objects=cfg.max_scene_objects), bank)


def shifted_state(cfg, bias):
    """A fresh state with the presence head's output bias shifted in
    place."""
    from spair_pytorch_tpu_torch.parallel import create_train_state

    state = create_train_state(cfg, device="cuda")
    with torch.no_grad():
        state.model.obj_network.out.bias += bias
    return state


def topk_run(cfg, datagen, eager, bias, calls):
    """Calls of ``make_train_step`` (K steps each, one step function per
    K) from a fresh state: (state, each call's metrics, each call's
    branches, K1-K4 launches of the last call)."""
    from spair_pytorch_tpu_torch.parallel import make_train_step

    state = shifted_state(cfg, bias)
    fns = {k: make_train_step(cfg, datagen=datagen, steps_per_call=k,
                              eager=eager) for k in sorted(set(calls))}
    metrics, branches = [], []
    for k in calls:
        before = [fn.launches for fn in counted()]
        metrics.append(fns[k](state)[1])
        branches.append(list(fns[k].branches.last))
    torch.cuda.synchronize()
    return state, metrics, branches, [fn.launches - n for fn, n in
                                      zip(counted(), before)]


def assert_same_runs(captured, eager):
    (c, mc, bc, _), (e, me, be, _) = captured, eager
    assert bc == be
    for got, want in zip(mc, me):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for got, want in zip(state_tensors(c), state_tensors(e)):
        assert torch.equal(got, want)
    assert torch.equal(c.generator.get_state(), e.generator.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["topk", "full"])
@pytest.mark.parametrize("mode", sorted(TOPK_PRESETS))
def test_captured_topk_step_equals_eager(deterministic, mode, branch):
    """Calls of 1, 1 and 3 steps, captured (segments A and two Bs, one
    predicate read a step) against eager from the same state: every metric,
    parameter, Adam tensor, the step and the generator bit for bit, every
    step in the branch the state's presence names; K1/K2 launched once a
    step in reference mode (counted over the replays), never in ordered
    mode."""
    cfg, datagen = topk_preset(mode)
    bias = SPARSE_BIAS if branch == "topk" else 0.0
    runs = {eager: topk_run(cfg, datagen, eager, bias, (1, 1, 3))
            for eager in (True, False)}
    assert runs[True][2] == [[branch == "topk"]] * 2 + [
        [branch == "topk"] * 3]
    assert_same_runs(runs[False], runs[True])
    want = [3, 3, 0, 0] if mode == "reference" else [0, 0, 0, 0]
    assert runs[False][3] == runs[True][3] == want
    assert int(runs[False][0].step) == 5


@pytest.mark.gpu
def test_captured_topk_step_switches_branch_inside_a_call(deterministic,
                                                          monkeypatch):
    """K chosen from an eager probe of the largest live count of each step,
    so that the replays of one call of 6 steps take both branches: captured
    against eager, the branch sequences equal, every tensor bit for bit."""
    from spair_pytorch_tpu_torch.models import spair
    from spair_pytorch_tpu_torch.parallel import make_train_step

    cfg, datagen = topk_preset("reference")
    bias, seen = -7.0, []
    real = spair.render_objects

    def spy(*a, **kw):
        objects, pred = real(*a, **kw)
        seen.append(int((objects["gate"] > 0).sum(1).max()))
        return objects, pred
    monkeypatch.setattr(spair, "render_objects", spy)
    make_train_step(cfg, datagen=datagen, steps_per_call=6,
                    eager=True)(shifted_state(cfg, bias))
    monkeypatch.setattr(spair, "render_objects", real)
    k = sorted(seen[1:])[1]
    assert 0 < k < max(seen[1:]), seen
    cfg = dataclasses.replace(cfg, render_topk=k)
    runs = {eager: topk_run(cfg, datagen, eager, bias, (6, 6))
            for eager in (True, False)}
    assert_same_runs(runs[False], runs[True])
    replayed = runs[False][2][0][1:]
    assert True in replayed and False in replayed, (seen, k, runs[False][2])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(TOPK_PRESETS))
def test_captured_topk_eval_step_and_evaluate_equal_eager(deterministic,
                                                           mode):
    """The eval step (3 calls) and evaluate (2 batches) of the dense and
    the sparse state, captured as segments against eager: loss, aux and
    results equal bit for bit, each in its branch."""
    from spair_pytorch_tpu_torch.data import generate_batch
    from spair_pytorch_tpu_torch.eval import _CAPTURES, evaluate
    from spair_pytorch_tpu_torch.parallel import make_eval_step

    cfg, (dcfg, bank) = topk_preset(mode)
    x = generate_batch(torch.Generator(device="cuda").manual_seed(3), bank,
                       8, dcfg)[0]
    for bias, topk in ((0.0, False), (SPARSE_BIAS, True)):
        state = shifted_state(cfg, bias)
        runs = {}
        for eager in (True, False):
            step = make_eval_step(cfg, eager=eager)
            gen = torch.Generator(device="cuda").manual_seed(7)
            runs[eager] = [step(state.model, x, 1500, gen) for _ in range(3)]
            assert step.branches.counts == {"topk": 3 * topk,
                                            "full": 3 * (not topk)}
        for (lc, ac), (le, ae) in zip(runs[False], runs[True]):
            assert torch.equal(lc, le)
            for k in ("recon", "z_where", "z_pres", "z_attr"):
                assert torch.equal(ac[k], ae[k]), k
        got = evaluate(cfg, state, 2, digits="font")[0]
        assert got == evaluate(cfg, state, 2, digits="font", eager=True)[0]
        (program,) = _CAPTURES[state.model]["programs"].values()
        assert program.branches.counts == {"topk": 2 * topk,
                                           "full": 2 * (not topk)}


@pytest.fixture
def world_of_one(deterministic, monkeypatch):
    """A data-parallel world of one rank over NCCL, as ``make_mesh`` starts
    it without torchrun's environment; deterministic kernels."""
    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh("cuda")
    try:
        yield mesh
    finally:
        mesh.close()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["auto", "pallas_v3"])
def test_captured_mesh_step_equals_eager_and_the_plain_step(world_of_one,
                                                           backend):
    """The data-parallel step at world size 1 (NCCL's collectives inside
    the graph), 3 calls of one step and one of K = 2 after its first:
    captured against the eager mesh step and the captured plain step,
    every metric, parameter, Adam tensor, the step and the generator bit
    for bit; each kernel of the path launched once a replayed step."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.parallel.mesh import replicate

    cfg, datagen = main_path(backend)
    runs = {}
    for arm, mesh, eager in (("mesh captured", world_of_one, False),
                             ("mesh eager", world_of_one, True),
                             ("plain captured", None, False)):
        state = create_train_state(cfg, device="cuda")
        if mesh is not None:
            state = replicate(mesh, state)
        one = make_train_step(cfg, mesh, datagen=datagen, eager=eager)
        two = make_train_step(cfg, mesh, datagen=datagen, steps_per_call=2,
                              eager=eager)
        metrics = [one(state)[1] for _ in range(3)]
        two(state)
        before = [fn.launches for fn in counted()]
        metrics.append(two(state)[1])
        torch.cuda.synchronize()
        launches = [fn.launches - n for fn, n in zip(counted(), before)]
        assert launches == ([2, 2, 0, 0] if backend == "auto"
                            else [0, 0, 2, 2]), (arm, launches)
        runs[arm] = state, metrics
    c, mc = runs["mesh captured"]
    assert int(c.step) == 7
    for other in ("mesh eager", "plain captured"):
        o, mo = runs[other]
        for got, want in zip(mc, mo):
            assert list(got) == list(want)
            assert all(torch.equal(got[k], want[k]) for k in want), other
        for got, want in zip(state_tensors(c), state_tensors(o)):
            assert torch.equal(got, want), other
        assert torch.equal(c.generator.get_state(), o.generator.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 32])
def test_captured_refiner_equals_eager(cuda, b):
    """make_refiner captured (one graph for the batch size) against eager
    after the captured detector: the first call, a replay, the margin as a
    0-d tensor and as +inf, every output bit for bit; K1 launched twice a
    replay."""
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.models.refine import make_refiner

    cfg, params, x = paper128_detector_inputs(b, "f32", cuda)
    det = make_detector(cfg, nms_iou=0.5)(params, x)
    refine = make_refiner(cfg)
    eager = make_refiner(cfg, eager=True)
    first = refine(params, x, det, 0.0, 0.5)
    before = K.composite_forward.launches
    again = refine(params, x, det, 0.0, 0.5)
    torch.cuda.synchronize()
    assert K.composite_forward.launches - before == 2
    as_tensor = refine(params, x, det, torch.zeros((), device=cuda),
                       torch.full((), 0.5, device=cuda))
    want = eager(params, x, det, 0.0, 0.5)
    for got in (first, again, as_tensor):
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    inf, want_inf = (f(params, x, det, float("inf"), 0.5)
                     for f in (refine, eager))
    assert all(torch.equal(inf[k], want_inf[k]) for k in want_inf)
    assert int(inf["n_split"].sum()) == 0
    assert again["boxes"].data_ptr() != first["boxes"].data_ptr()


# the span recorder (utils/spans.py) in the captured step: marks inside the
# graphs, nothing else changed

def spans_run(cfg, datagen, on, bias=0.0, calls=(1, 1, 1)):
    """One-step calls of a captured step, spans on or off, from a fresh
    state (the presence head's bias shifted by ``bias``): (state, metrics,
    step function)."""
    from spair_pytorch_tpu_torch.parallel import make_train_step

    state = shifted_state(cfg, bias)
    fn = make_train_step(cfg, datagen=datagen, spans=on)
    metrics = [fn(state)[1] for _ in calls]
    torch.cuda.synchronize()
    return state, metrics, fn


SPAN_CASES = {"plain": lambda: (main_path(), 0.0),
              "segmented-full": lambda: (topk_preset("reference"), 0.0),
              "segmented-topk": lambda: (topk_preset("reference"),
                                         SPARSE_BIAS)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_captured_step_with_spans_equals_without(deterministic, case):
    """3 steps of the captured step (its eager first step and 2 replays)
    with spans on against off: every metric, parameter, Adam tensor, the
    step and the generator bit for bit; the recorder saw every step and
    every tile of it (gap.branch in a segmented step)."""
    from spair_pytorch_tpu_torch.utils import spans

    (cfg, datagen), bias = SPAN_CASES[case]()
    on, off = (spans_run(cfg, datagen, flag, bias) for flag in (True, False))
    assert off[2].spans is None
    for got, want in zip(on[1], off[1]):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for got, want in zip(state_tensors(on[0]), state_tensors(off[0])):
        assert torch.equal(got, want)
    assert torch.equal(on[0].generator.get_state(),
                       off[0].generator.get_state())
    r = on[2].spans.read()
    assert r.steps == 3
    tiles = [t for t in spans.TILES
             if case != "plain" or t != "gap.branch"]
    assert [list(d) for _, d in r.step_tiles()[:2]] == [tiles, tiles]
    names = [s.name for s in on[2].spans.host_spans]
    want = (["spair.capture.step"] if case == "plain" else
            ["spair.capture.A", "spair.capture.B.topk",
             "spair.capture.B.full"])
    assert [n for n in names if n.startswith("spair.capture.")] == want
    assert names.count("spair.call") == 3


def replay_kernels(fn, state):
    """Names of the device kernels of one call of one replayed step, in
    the order they started, from the profiler (no fills or copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(state)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    events.sort(key=lambda e: e.time_range.start)
    # fills and copies left out: the profiler names a graph's fill node
    # 'memset32' or 'Memset (Device)' from one replay to the next, and
    # does not report them alike
    return [e.name for e in events if "memset" not in e.name.lower()
            and "memcpy" not in e.name.lower()], prof


@pytest.mark.gpu
def test_spans_add_only_their_marks_to_the_graph(cuda):
    """The main path's captured step replayed under the profiler with
    spans on and off: the graph with spans holds the graph without them,
    kernel for kernel in order, plus one ``spair_span_mark`` a tile (16 a
    step); the graph without spans holds no mark."""
    from spair_pytorch_tpu_torch.parallel import make_train_step
    from spair_pytorch_tpu_torch.utils import spans

    cfg, datagen = main_path()
    names = {}
    for on in (False, True):
        state = shifted_state(cfg, 0.0)
        fn = make_train_step(cfg, datagen=datagen, spans=on)
        fn(state)
        names[on], _ = replay_kernels(fn, state)
    marks = [n for n in names[True] if n == "spair_span_mark"]
    assert len(marks) == len(spans.TILES) - 1
    assert "spair_span_mark" not in names[False]
    rest = [n for n in names[True] if n != "spair_span_mark"]
    at = next((j for j, (a, b) in enumerate(zip(rest, names[False]))
               if a != b), min(len(rest), len(names[False])))
    assert rest == names[False], (len(rest), len(names[False]), at,
                                  rest[max(0, at - 2):at + 3],
                                  names[False][max(0, at - 2):at + 3])


def clock_probes(first, n):
    """``n`` empty profiler ranges, numbered from ``first``, each bracketed
    by the host clock: [(name, t0, t1, t2, t3)], read before and after
    entering the range and before and after leaving it."""
    import time

    out = []
    for i in range(first, first + n):
        name = f"spans.clock_probe.{i}"
        rf = torch.profiler.record_function(name)
        t0 = time.perf_counter_ns()
        rf.__enter__()
        t1 = t2 = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        t3 = time.perf_counter_ns()
        out.append((name, t0, t1, t2, t3))
    return out


def trace_minus_host_ns(prof, probes):
    """The profiler's clock less ``perf_counter_ns``, from ``clock_probes``:
    each probe's range starts between t0 and t1 and ends between t2 and t3,
    so the offset lies in the intersection of those bounds over all probes;
    (its middle, the intersection's width)."""
    times = {e.name: e.time_range for e in prof.events()
             if e.name.startswith("spans.clock_probe.")}
    lo, hi = -float("inf"), float("inf")
    for name, t0, t1, t2, t3 in probes:
        ts, te = times[name].start * 1e3, times[name].end * 1e3
        lo = max(lo, ts - t1, te - t3)
        hi = min(hi, ts - t0, te - t2)
    return (lo + hi) / 2, hi - lo


@pytest.mark.gpu
def test_span_marks_lie_on_the_host_clock(cuda):
    """Two replayed steps of the main path under the profiler: each
    ``spair_span_mark`` kernel starts within 20 us of its ring timestamp
    taken to the host clock by the recorder's offset, and to the trace's
    clock by empty profiler ranges bracketed by the host clock
    (``trace_minus_host_ns``). The card's ``%globaltimer`` steps now and
    then (by ~0.55 ms, about every 20 s on an H100): an attempt in which
    the difference jumps by over 100 us between two marks saw a step, and
    is made again, at most twice."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spair_pytorch_tpu_torch.parallel import make_train_step

    cfg, datagen = main_path()
    state = shifted_state(cfg, 0.0)
    fn = make_train_step(cfg, datagen=datagen, steps_per_call=2, spans=True)
    fn(state)
    torch.cuda.synchronize()
    rec = fn.spans
    stepped = []
    for _ in range(3):
        rec.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            probes = clock_probes(0, 50)
            fn(state)
            torch.cuda.synchronize()
            probes += clock_probes(50, 50)
        r = rec.read()
        assert r.steps == 2
        ring = sorted(int(v) for _, row in r.rows() for v in row if v)
        marks = sorted(e.time_range.start for e in prof.events()
                       if e.name == "spair_span_mark"
                       and e.device_type == DeviceType.CUDA)
        assert len(marks) == len(ring) == 2 * 16
        to_trace, width = trace_minus_host_ns(prof, probes)
        diff = np.array(marks) * 1e3 - (np.array(ring) + r.offset_ns
                                        + to_trace)
        if np.abs(np.diff(diff)).max() < 100e3:
            break
        stepped.append(diff)
    assert np.abs(diff).max() < 20e3, (diff, width, stepped)


@pytest.mark.gpu
def test_a_host_read_in_the_step_makes_the_capture_raise(cuda, monkeypatch):
    """A host read injected into the step: the warm-up step runs it
    eagerly, the capture raises, and the step is not run eagerly instead,
    then or at a later call. Last in the file: it leaves a failed capture
    behind."""
    import importlib

    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    real = ts.global_norm
    monkeypatch.setattr(ts, "global_norm",
                        lambda g: real(g) * (real(g).item() > 0))
    cfg, datagen = main_path()
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg, datagen=datagen, steps_per_call=3)
    launches = [fn.launches for fn in counted()]
    with pytest.raises(RuntimeError):
        step(state)
    torch.cuda.synchronize()
    assert int(state.step) == 1
    assert [fn.launches for fn in counted()] == [
        launches[0] + 1, launches[1] + 1, *launches[2:]]
    with pytest.raises(RuntimeError, match="capture failed"):
        step(state)
    assert int(state.step) == 1


@pytest.mark.gpu
def test_a_host_read_in_the_detector_makes_its_capture_raise(cuda,
                                                            monkeypatch):
    """A host read injected into the detector's NMS: the first call's
    eager run reads it, the capture raises, and a later call raises
    without running the detector eagerly. Last in the file, after the
    step's own: it leaves a failed capture behind."""
    from spair_pytorch_tpu_torch.models import infer

    real = infer.pairwise_iou
    monkeypatch.setattr(infer, "pairwise_iou",
                        lambda b: real(b) * (real(b).sum().item() > -1))
    cfg, params, x = paper128_detector_inputs(8, "f32", cuda)
    detect = infer.make_detector(cfg, nms_iou=0.5)
    with pytest.raises(RuntimeError):
        detect(params, x)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="capture failed"):
        detect(params, x)


@pytest.mark.gpu
def test_a_host_read_in_a_topk_tail_makes_its_capture_raise(cuda,
                                                            monkeypatch):
    """A host read injected into segment B of a render_topk step: the
    warm-up step runs it eagerly, A is captured, the first B's capture
    raises, no step runs eagerly in its place, and the next call raises
    without running. Last in the file: it leaves a failed capture behind."""
    import importlib

    from spair_pytorch_tpu_torch.parallel import make_train_step

    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    calls = {"head": 0, "tail": 0}
    real_head, real_tail = ts.train_step_head, ts.train_step_tail

    def head(*a, **kw):
        calls["head"] += 1
        return real_head(*a, **kw)

    def tail(*a, **kw):
        calls["tail"] += 1
        out = real_tail(*a, **kw)
        return {k: v * (v.sum().item() > -1e30) for k, v in out.items()}
    monkeypatch.setattr(ts, "train_step_head", head)
    monkeypatch.setattr(ts, "train_step_tail", tail)
    cfg, datagen = topk_preset("reference")
    state = shifted_state(cfg, SPARSE_BIAS)
    step = make_train_step(cfg, datagen=datagen, steps_per_call=3)
    with pytest.raises(RuntimeError) as err:
        step(state)
    torch.cuda.synchronize()
    assert int(state.step) == 1
    assert calls == {"head": 2, "tail": 2}, str(err.value)[:400]
    with pytest.raises(RuntimeError, match="capture failed"):
        step(state)
    assert int(state.step) == 1 and calls == {"head": 2, "tail": 2}
