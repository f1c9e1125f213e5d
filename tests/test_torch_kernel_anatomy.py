"""The port's windowed matmul paste (``spair_pytorch_tpu_torch/benchmarks/
kernel_anatomy.py``) against the JAX package's ``benchmarks/
kernel_anatomy.py::_kernel``.

The JAX kernel runs in interpret mode on the CPU through a ``pallas_call``
built here with ``run_variant``'s specs (``run_variant`` itself only times).
Inputs are made with numpy from a seed and handed to both packages.

Tolerance: 5e-3 of each output's own scale, max |port - jax| / max |jax|,
for every variant (on the card the kernel is held to its plain version at
1e-6, with t's sums rounded toward zero as the tensor cores round them).
Two roundings to bf16 sit inside the function (the hat weights and t
between the two products), so one weight or one t that rounds the other
way moves a pixel by a bf16 ulp's share. The port takes
the JAX source's arithmetic for the weights (true division, as
``run_variant``'s hoisted weights evaluate it and as the compositor kernels
and ``ops/stn.py`` take it), so its ``base`` equals its ``hoisted``. The
JAX kernel's ``base`` builds its weights inside the interpreted, compiled
kernel, where a few of them round the other way (XLA computes 2i / (I - 1)
- 1 there as a multiply by the reciprocal with a fused add): within the
bar against the port, and ``base`` is also held to 1e-6 of the JAX
kernel's ``hoisted`` path, which takes the weights of the JAX source's
formulas.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import kernel_anatomy as jka
from spair_pytorch_tpu.ops.pallas.composite import _pack
from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A

BAR = 5e-3
SOURCE_BAR = 1e-6
# the kernel against this plain version with t's sums rounded toward zero
# (tests/test_torch_kernel_gpu.py, chip_smoke.py phase 22)
KERNEL_BAR = 1e-6


def make_inputs(seed, b, n, c, oh, ow, max_scale=48 / 128, clamp=False):
    """color, alpha, importance, boxes as the JAX script draws them;
    ``clamp`` puts half the centres in [0, 0.05] and half in [0.95, 1],
    which pushes the window start to 0 and to H - win."""
    rng = np.random.RandomState(seed)
    color = rng.rand(b, n, c, oh, ow).astype("f")
    alpha = rng.rand(b, n, 1, oh, ow).astype("f")
    imp = rng.uniform(0.01, 1.0, (b, n, 1, oh, ow)).astype("f")
    yt = rng.uniform(0.05, 0.95, (b, n))
    if clamp:
        yt = np.where(rng.rand(b, n) < 0.5, rng.uniform(0.0, 0.05, (b, n)),
                      rng.uniform(0.95, 1.0, (b, n)))
    boxes = np.stack([rng.uniform(0.05, 0.95, (b, n)), yt,
                      rng.uniform(0.05, max_scale, (b, n)),
                      rng.uniform(0.05, max_scale, (b, n))], -1).astype("f")
    return color, alpha, imp, boxes


CASES = {  # name: (make_inputs arguments, canvas, window rows)
    # paper shapes: 11x11 grid, 28x28 glimpses, 128x128, paste_window_rows
    "paper": (dict(seed=0, b=2, n=121, c=1, oh=28, ow=28), (128, 128), 64),
    "c3": (dict(seed=1, b=2, n=9, c=3, oh=14, ow=14, max_scale=0.3),
           (64, 64), 32),
    # the window is the canvas: y0 is always 0
    "win_eq_h": (dict(seed=3, b=2, n=121, c=1, oh=28, ow=28), (128, 128),
                 128),
    "clamps": (dict(seed=4, b=2, n=24, c=1, oh=14, ow=14, max_scale=0.3,
                    clamp=True), (64, 64), 32),
    # win = H on a small canvas, where the constant box reaches rows 0-7,
    # so noaccum adds something
    "small_canvas": (dict(seed=2, b=2, n=12, c=1, oh=8, ow=8, max_scale=0.5),
                     (16, 32), 16),
}
PAIRS = [(v, c) for c in CASES for v in A.VARIANTS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions are loops of small ops: one thread each keeps
    them fast beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def case_inputs(case):
    kw, hw, win = CASES[case]
    return make_inputs(**kw), hw, win


def jax_hoisted_weights(boxes, image_hw, object_hw, win):
    """``run_variant``'s vectorized weights (benchmarks/kernel_anatomy.py,
    the hoisted branch), in f32, as that script writes them."""
    ih, iw = image_hw
    oh, ow = object_hw
    boxes = jnp.asarray(boxes)
    xt, yt = boxes[..., 0], boxes[..., 1]
    xs, ys = boxes[..., 2], boxes[..., 3]
    kk = 1.0 + 2.0 / (oh - 1)
    lo = jnp.floor((yt - ys * (kk * 0.5)) * (ih - 1)).astype(jnp.int32)
    y0 = jnp.clip((lo // 8) * 8, 0, ih - win)
    r = jnp.arange(win, dtype=jnp.float32)
    u = 2.0 * (y0[..., None].astype(jnp.float32) + r) / (ih - 1) - 1.0
    src = ((u - (2.0 * yt[..., None] - 1.0)) / ys[..., None] + 1.0) \
        * (oh - 1) / 2.0
    a = jnp.arange(oh, dtype=jnp.float32)
    py = jnp.maximum(0.0, 1.0 - jnp.abs(src[..., None] - a))
    x = jnp.arange(iw, dtype=jnp.float32)
    ux = 2.0 * x / (iw - 1) - 1.0
    srcx = ((ux - (2.0 * xt[..., None] - 1.0)) / xs[..., None] + 1.0) \
        * (ow - 1) / 2.0
    ax = jnp.arange(ow, dtype=jnp.float32)
    pxt = jnp.maximum(0.0, 1.0 - jnp.abs(srcx[..., None, :]
                                         - ax[..., None]))
    return py, pxt


@functools.lru_cache(maxsize=None)
def jax_case_weights(case):
    (color, _, _, boxes), hw, win = case_inputs(case)
    return jax_hoisted_weights(boxes, hw, color.shape[-2:], win)


@functools.lru_cache(maxsize=None)
def jax_variant(variant, case):
    """(num, den) of the JAX ``_kernel`` in interpret mode, with
    ``run_variant``'s block specs."""
    (color, alpha, imp, boxes), (ih, iw), win = case_inputs(case)
    b, n, c, oh, ow = color.shape
    mm = jnp.bfloat16
    g = _pack(*map(jnp.asarray, (color, alpha, imp))).astype(mm)
    operands = [jnp.asarray(boxes, jnp.float32), g]
    in_specs = [
        pl.BlockSpec((None, n, 4), lambda i: (i, 0, 0),
                     memory_space=pltpu.SMEM),
        pl.BlockSpec((1, n, oh, (c + 2) * ow), lambda i: (i, 0, 0, 0),
                     memory_space=pltpu.VMEM)]
    kern = functools.partial(jka._kernel, n=n, c=c, oh=oh, ow=ow, ih=ih,
                             iw=iw, win=win, mm=mm, variant=variant)
    if variant == "hoisted":
        py, pxt = jax_case_weights(case)
        operands += [py.astype(mm), pxt.astype(mm)]
        in_specs += [
            pl.BlockSpec((1, n, win, oh), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, n, ow, iw), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM)]

        def body(b_, g_, py_, pxt_, nu, de):
            return kern(b_, g_, nu, de, py_ref=py_, pxt_ref=pxt_)
    else:
        def body(b_, g_, nu, de):
            return kern(b_, g_, nu, de)
    num, den = pl.pallas_call(
        body, grid=(b,), in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((1, c, ih, iw), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, ih, iw), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((b, c, ih, iw), jnp.float32),
                   jax.ShapeDtypeStruct((b, 1, ih, iw), jnp.float32)],
        interpret=True)(*operands)
    return np.asarray(num), np.asarray(den)


def port_variant(variant, case, t_sum="nearest"):
    (color, alpha, imp, boxes), hw, win = case_inputs(case)
    c, oh, ow = color.shape[2:]
    t = torch.from_numpy
    g = A.pack(t(color), t(alpha), t(imp)).to(torch.bfloat16).contiguous()
    py = pxt = None
    if variant == "hoisted":
        py, pxt = A.hoisted_weights(t(boxes), hw, (oh, ow), win)
    if t_sum != "nearest":
        return [x.numpy() for x in A.kernel_anatomy_plain(
            variant, g, t(boxes), hw, win, py, pxt, channels=c,
            t_sum=t_sum)]
    return [x.numpy() for x in A.kernel_anatomy(variant, g, t(boxes), hw,
                                                win, py, pxt, channels=c)]


def rel(got, want):
    """max |got - want| / max |want| for each output; an all-zero want
    (noaccum's num where the constant box misses rows 0-7) takes 0 only."""
    out = []
    for g, w in zip(got, want):
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        out.append(err / scale if scale else (np.inf if err else 0.0))
    return out


@pytest.mark.parametrize("variant,case", PAIRS)
def test_plain_matches_jax_kernel_interpret(variant, case):
    got = port_variant(variant, case)
    want = jax_variant(variant, case)
    (color, *_), (ih, iw), _ = case_inputs(case)
    b, _, c = color.shape[:3]
    assert got[0].shape == (b, c, ih, iw) and got[1].shape == (b, 1, ih, iw)
    assert max(rel(got, want)) < BAR, rel(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_base_takes_the_jax_sources_arithmetic(case):
    """base against the JAX kernel fed run_variant's weights: the same
    function with the weights of the JAX source's formulas."""
    got = port_variant("base", case)
    assert max(rel(got, jax_variant("hoisted", case))) < SOURCE_BAR


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_bar_tells_t_kept_in_f32_apart(case):
    """The control of the kernel's bar: base with t kept in f32 between the
    products lies above the kernel's bar on each output (though within the
    JAX parity bar), so a kernel that dropped that rounding fails it."""
    (color, alpha, imp, boxes), hw, win = case_inputs(case)
    t = torch.from_numpy
    g = A.pack(t(color), t(alpha), t(imp)).to(torch.bfloat16).contiguous()
    c = color.shape[2]
    base, unrounded = (
        [x.numpy() for x in A.kernel_anatomy_plain(
            "base", g, t(boxes), hw, win, channels=c, t_sum="toward_zero",
            round_t=r)] for r in (True, False))
    rels = rel(unrounded, base)
    assert min(rels) >= KERNEL_BAR, rels


def test_matmul_toward_zero_truncates_the_exact_sum():
    """1 + 0.75 ulp rounds up to nearest and down toward zero; sums that
    float32 holds exactly are the same either way."""
    ulp = 2.0 ** -23
    a = torch.tensor([[1.0, 1.0], [0.5, 0.25]])
    b = torch.tensor([[1.0], [0.75 * ulp]])
    near = torch.matmul(a, b)
    down = A.matmul_toward_zero(a, b)
    assert float(near[0, 0]) == 1.0 + ulp and float(down[0, 0]) == 1.0
    c = torch.tensor([[1.0], [2.0]])
    assert torch.equal(A.matmul_toward_zero(a, c), torch.matmul(a, c))
    with pytest.raises(ValueError):
        port_variant("base", "c3", t_sum="upward")


@pytest.mark.parametrize("case", ["paper", "clamps"])
def test_toward_zero_plain_is_within_the_jax_bar(case):
    """The plain version with the tensor cores' rounding of t's sums is the
    same function: within the bar of the JAX kernel in interpret mode."""
    got = port_variant("base", case, t_sum="toward_zero")
    assert max(rel(got, jax_variant("base", case))) < BAR


def test_noaccum_adds_rows_0_to_7_only():
    """On the small canvas the constant box reaches rows 0-7: noaccum's num
    is nonzero there and zero below, as the JAX kernel's."""
    num, den = port_variant("noaccum", "small_canvas")
    assert np.abs(num[:, :, :8]).max() > 0
    assert not num[:, :, 8:].any()
    np.testing.assert_array_equal(den[:, :, 8:], np.float32(12 * 1e-9))


@pytest.mark.parametrize("case", ["paper", "clamps", "c3"])
def test_hoisted_weights_equal_the_jax_formulas(case):
    (color, _, _, boxes), hw, win = case_inputs(case)
    jpy, jpxt = jax_case_weights(case)
    py, pxt = A.hoisted_weights(torch.from_numpy(boxes), hw,
                                color.shape[-2:], win)
    assert py.dtype == pxt.dtype == torch.bfloat16
    for got, want in ((py, jpy), (pxt, jpxt)):
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


def test_window_start_clamps_at_both_ends():
    (_, _, _, boxes), (ih, _), win = case_inputs("clamps")
    y0 = A.window_start(torch.from_numpy(boxes[..., 1]),
                        torch.from_numpy(boxes[..., 3]), ih, win, 14)
    assert set(y0.flatten().tolist()) == {0, ih - win}


@pytest.mark.parametrize("case", ["paper", "clamps"])
def test_plain_hoisted_equals_plain_base(case):
    base = port_variant("base", case)
    hoisted = port_variant("hoisted", case)
    for b, h in zip(base, hoisted):
        np.testing.assert_array_equal(b, h)


def test_pack_is_the_jax_packing():
    (color, alpha, imp, _), _, _ = case_inputs("c3")
    t = torch.from_numpy
    np.testing.assert_array_equal(
        A.pack(t(color), t(alpha), t(imp)).numpy(),
        np.asarray(_pack(*map(jnp.asarray, (color, alpha, imp)))))


@pytest.mark.parametrize("bad", ["variant", "dtype", "planes", "boxes",
                                 "weights_missing", "weights_extra",
                                 "weights_shape", "window"])
def test_wrapper_refuses_bad_inputs(bad):
    (color, alpha, imp, boxes), hw, win = case_inputs("c3")
    t = torch.from_numpy
    g = A.pack(t(color), t(alpha), t(imp)).to(torch.bfloat16).contiguous()
    bx = t(boxes)
    py, pxt = A.hoisted_weights(bx, hw, (14, 14), win)
    args = dict(variant="base", g=g, boxes=bx, image_hw=hw, win=win,
                channels=3)
    if bad == "variant":
        args["variant"] = "fused"
    elif bad == "dtype":
        args["g"] = g.float()
    elif bad == "planes":
        args["channels"] = 2
    elif bad == "boxes":
        args["boxes"] = bx[:, :-1]
    elif bad == "weights_missing":
        args["variant"] = "hoisted"
    elif bad == "weights_extra":
        args.update(py=py, pxt=pxt)
    elif bad == "weights_shape":
        args.update(variant="hoisted", py=py[:, :, :-1], pxt=pxt)
    else:
        args["win"] = hw[0] + 8
    with pytest.raises((TypeError, ValueError)):
        A.kernel_anatomy(**args)


def test_bound_at_paper_shapes():
    """The bound's work at paper shapes (B=32): 6.50 GFLOP of products and
    22.5 MB. The tensor cores, the f32 pipes and the memory work at once,
    so the bound is the largest of the three times: base's bytes (6.71 us)
    over its products (6.57 us) and its f32 operations (3.61 us)."""
    moved, products, f32 = A.work("base", 32, 121, 1, (28, 28), (128, 128),
                                  64)
    assert products == 2 * 3872 * (64 * 28 * 84 + 3 * 64 * 28 * 128)
    assert abs(moved / 1e6 - 22.47) < 0.01
    times = (moved / A.HBM_BYTES_PER_S, products / A.BF16_OPS_PER_S,
             f32 / A.F32_OPS_PER_S)
    assert times[0] > times[1] > times[2]
    ms, by = A.bound("base", 32, 121, 1, (28, 28), (128, 128), 64)
    assert by == "bytes" and ms == times[0] * 1e3
    _, nomatmul, _ = A.work("nomatmul", 32, 121, 1, (28, 28), (128, 128),
                            64)
    assert nomatmul == 2 * 3872 * 64 * 28 * 84


def test_bound_takes_the_largest_term_not_a_sum():
    """Operations bind only where one pipe's time alone passes the bytes':
    the products on a canvas 1024 wide, the f32 combine behind glimpses of
    2 x 2; the bound is that one time, not the sum of the pipes'."""
    for variant, shape, glimpse, binds in (
            ("nobuild", (32, 1024), (28, 28), 1),
            ("base", (128, 128), (2, 2), 2)):
        moved, products, f32 = A.work(variant, 4, 64, 1, glimpse, shape, 64)
        times = (moved / A.HBM_BYTES_PER_S, products / A.BF16_OPS_PER_S,
                 f32 / A.F32_OPS_PER_S)
        assert max(times) == times[binds]
        ms, by = A.bound(variant, 4, 64, 1, glimpse, shape, 64)
        assert (ms, by) == (times[binds] * 1e3, "operations")


def test_main_prints_five_lines_and_the_json_line(capsys):
    line = A.main(["--batch", "2", "--k", "1", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 6
    for name, text in zip(A.VARIANTS, out):
        assert text.startswith(f"{name:9s} fwd ") and text.endswith(" ms")
    import json
    assert json.loads(out[-1]) == line
    assert line["device"] == "cpu" and line["batch"] == 2
    assert set(line["ms"]) == set(line["bound_ms"]) == set(A.VARIANTS)
    assert line["shares_ms"]["build"] == line["ms"]["base"] - \
        line["ms"]["nobuild"]
    assert set(line["composite_forward_ms"]) == {"float32", "bfloat16"}
    assert all(v > 0 for v in line["ms"].values())


def test_main_defaults_to_the_card():
    assert A.make_parser().get_default("device") == "cuda"
    assert A.make_parser().get_default("batch") == 32
    assert A.make_parser().get_default("k") == 30


# The kernel's per-strip cull (``strips_touched``, csrc/kernel_anatomy.cu::
# touches) on the shapes the card's tests take (tests/test_torch_kernel_gpu.py
# ANATOMY_SHAPES): (B, N, C, glimpse, canvas, window, max scale)
STRIP_SHAPES = {
    "paper": (4, 121, 1, 28, (128, 128), 64, 48 / 128),
    "c3": (2, 9, 3, 14, (64, 64), 32, 0.3),
    "win_eq_h": (2, 40, 1, 28, (128, 128), 128, 48 / 128),
    "small": (2, 12, 1, 8, (16, 32), 16, 0.5),
}


def strip_boxes(shape, placement):
    """(1, M, 4) float32 boxes for a shape: 'random' as the card's tests draw
    them; 'boundaries' with a support edge (src = -1 or src = ow) at the
    last column of a strip or the first of the next, each centre jittered by
    -3 to +3 float32 ulps, at three scales (and at the canvas's first and
    last columns); 'edges' centred off and on the
    canvas edges, with scales down to where one column step leaps the whole
    glimpse (|xs| (W - 1) < 1) and around that threshold."""
    b, n, _, o, (ih, iw), _, max_scale = STRIP_SHAPES[shape]
    rng = np.random.RandomState(sorted(STRIP_SHAPES).index(shape))
    if placement == "random":
        boxes = np.stack([rng.uniform(0.05, 0.95, (b, n)),
                          rng.uniform(0.05, 0.95, (b, n)),
                          rng.uniform(0.05, max_scale, (b, n)),
                          rng.uniform(0.05, max_scale, (b, n))], -1)
        return boxes.reshape(1, -1, 4).astype("f")
    rows = []
    if placement == "boundaries":
        k = 1.0 + 2.0 / (o - 1)  # src = -1 at u = 2t - 1 - s k, ow at + s k
        columns = [0, iw - 1] + [c for s in range(A.STRIP, iw, A.STRIP)
                                 for c in (s - 1, s)]
        for x in columns:
            for s in (0.05, 0.15, max_scale):
                for t in (x / (iw - 1) + s * k / 2,   # left edge at x
                          x / (iw - 1) - s * k / 2):  # right edge at x
                    t32 = np.float32(t)
                    for ulps in range(-3, 4):
                        rows.append([t32 + ulps * np.spacing(t32), 0.5, s,
                                     0.2])
    else:
        for t in (-0.3, -0.05, 0.0, 0.02, 0.5, 0.98, 1.0, 1.05, 1.3):
            for s in (1e-4, 0.5 / (iw - 1), 0.999 / (iw - 1), 1.0 / (iw - 1),
                      1.001 / (iw - 1), 0.05, max_scale, 1.5):
                rows.append([t, 0.5, s, 0.2])
    return np.asarray(rows, "f")[None]


@pytest.mark.parametrize("placement", ["random", "boundaries", "edges"])
@pytest.mark.parametrize("shape", sorted(STRIP_SHAPES))
@pytest.mark.parametrize("variant", A.VARIANTS)
def test_strips_touched_is_any_nonzero_weight(variant, shape, placement):
    """strips_touched lists exactly the strips on which the variant's own
    column weights (hoisted_weights' pxt for base and hoisted, the constant
    box's for nobuild and noaccum) have a nonzero; nomatmul's broadcast
    planes are nonzero everywhere, so it lists every strip."""
    _, _, _, o, hw, win, _ = STRIP_SHAPES[shape]
    boxes = torch.from_numpy(strip_boxes(shape, placement))
    got = A.strips_touched(variant, boxes, hw, (o, o))
    b, n = boxes.shape[:2]
    strips = hw[1] // A.STRIP
    assert got.shape == (b, n, strips) and got.dtype == torch.bool
    if variant == "nomatmul":
        assert bool(got.all())
        return
    if variant in ("base", "hoisted"):
        _, pxt = A.hoisted_weights(boxes, hw, (o, o), win)
    else:
        pxt = A.constant_weights(hw, (o, o), win, "cpu")[1].expand(
            b, n, o, hw[1])
    nonzero = (pxt != 0).any(-2).reshape(b, n, strips, A.STRIP).any(-1)
    np.testing.assert_array_equal(got.numpy(), nonzero.numpy())


@pytest.mark.parametrize("variant,case", PAIRS)
def test_culled_plain_equals_dense_plain(variant, case):
    """The plain version with each object added only on the strips
    strips_touched lists for it (the rest of the canvas left as it was, as
    the kernel skips them) equals the dense plain version bit for bit."""
    (color, alpha, imp, boxes), hw, win = case_inputs(case)
    c, oh, ow = color.shape[2:]
    t = torch.from_numpy
    g = A.pack(t(color), t(alpha), t(imp)).to(torch.bfloat16).contiguous()
    w = A.hoisted_weights(t(boxes), hw, (oh, ow), win) \
        if variant == "hoisted" else (None, None)
    dense = A.kernel_anatomy_plain(variant, g, t(boxes), hw, win, *w,
                                   channels=c)
    culled = A.kernel_anatomy_plain(variant, g, t(boxes), hw, win, *w,
                                    channels=c, cull=True)
    for x, y in zip(culled, dense):
        assert torch.equal(x, y)


def test_listed_on_the_cpu_is_strips_touched():
    (color, alpha, imp, boxes), hw, win = case_inputs("paper")
    t = torch.from_numpy
    g = A.pack(t(color), t(alpha), t(imp)).to(torch.bfloat16).contiguous()
    num, den, listed = A.kernel_anatomy_listed("base", g, t(boxes), hw, win)
    assert torch.equal(listed, A.strips_touched("base", t(boxes), hw,
                                                (28, 28)))
    want = A.kernel_anatomy("base", g, t(boxes), hw, win)
    assert torch.equal(num, want[0]) and torch.equal(den, want[1])
