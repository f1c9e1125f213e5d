"""K1's per-tile cull (``cull_tiles``) against the JAX package's paste.

The forward kernel (csrc/composite_fwd.cu) lists, for each canvas tile, the
live objects whose support meets it, and sums over that list only. These
tests hold the plain version of that rule: every (pixel, object) pair with a
nonzero product of ``spair_pytorch_tpu.ops.stn.paste_weights`` must be in
its tile's list, and gated objects never are. The bound, ``canvas_range``,
reaches at most 3 rows past the exact interval of the support (it widens
by 2 indices against rounding). Compositing each tile from its list alone must give
``composite_plain``'s tile, to 1e-6 relative (the left-out objects add exact
zeros, so the sums are equal up to their order of chunks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.ops.stn import paste_weights as jax_paste_weights
from spair_pytorch_tpu_torch.ops.kernels import composite as K

HW, OBJ = (48, 40), (14, 14)
TILES = [(16, 16), (8, 32), (32, 8)]


def make_boxes(case, seed, b=2, n=24):
    """(boxes (B, N, 4) float32, gate (B, N) float32 or None) for a case."""
    rng = np.random.RandomState(seed)

    def u(lo, hi, m=n):
        return rng.uniform(lo, hi, (b, m))
    gate = None
    if case == "random":
        parts = u(0.05, 0.95), u(0.05, 0.95), u(0.05, 0.6), u(0.05, 0.6)
    elif case == "off_canvas":
        parts = u(-1.0, 2.0), u(-1.0, 2.0), u(0.05, 0.8), u(0.05, 0.8)
    elif case == "scale_1e-3":
        parts = u(0.0, 1.0), u(0.0, 1.0), u(1e-3, 1e-3), u(1e-3, 1e-3)
    elif case == "scale_4":
        parts = u(-0.5, 1.5), u(-0.5, 1.5), u(4.0, 4.0), u(4.0, 4.0)
    elif case == "negative_scale":
        parts = u(0.1, 0.9), u(0.1, 0.9), u(-0.5, -0.05), u(-0.5, -0.05)
    elif case == "one_tile":  # every support inside the top-left 16x16 tile
        parts = u(0.1, 0.2), u(0.1, 0.2), u(0.02, 0.1), u(0.02, 0.1)
    elif case == "n_past_chunk":  # N not a multiple of the kernel's chunk
        n = K.CULL_CHUNK + 5
        parts = (u(0.0, 1.0, n), u(0.0, 1.0, n), u(0.05, 0.4, n),
                 u(0.05, 0.4, n))
    elif case == "gated":
        parts = u(0.05, 0.95), u(0.05, 0.95), u(0.05, 0.6), u(0.05, 0.6)
        gate = (rng.rand(b, n) > 0.5).astype("f")
    else:
        raise ValueError(case)
    boxes = np.stack(parts, -1).astype("f")
    return boxes, gate


CASES = ["random", "off_canvas", "scale_1e-3", "scale_4", "negative_scale",
         "one_tile", "n_past_chunk", "gated"]


def support_pixels(boxes):
    """(B, N, H, W) bool: the pixels where some texel's paste weight, JAX's
    py(y, a) px(x, q), is nonzero."""
    py, px = jax_paste_weights(jnp.asarray(boxes), OBJ, HW)
    rows = np.asarray(py != 0).any(-1)                  # (B, N, H)
    cols = np.asarray(px != 0).any(-1)                  # (B, N, W)
    return rows[..., :, None] & cols[..., None, :]


def per_pixel(mask, tile):
    """(B, tiles_y, tiles_x, N) -> (B, N, H, W): each pixel's tile's list."""
    th, tw = tile
    m = mask.numpy().repeat(th, 1).repeat(tw, 2)[:, :HW[0], :HW[1]]
    return m.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_cull_lists_every_pasted_pixel(case, tile):
    boxes, gate = make_boxes(case, seed=CASES.index(case))
    mask = K.cull_tiles(torch.as_tensor(boxes), HW, OBJ, tile,
                        None if gate is None else torch.as_tensor(gate))
    th, tw = tile
    assert mask.shape == (boxes.shape[0], -(-HW[0] // th), -(-HW[1] // tw),
                          boxes.shape[1])
    listed = per_pixel(mask, tile)
    need = support_pixels(boxes)
    if gate is not None:
        need &= (gate != 0)[:, :, None, None]
        assert not listed[gate == 0].any(), "a gated object was listed"
    assert not (need & ~listed).any(), "a pasted pixel's tile misses it"
    if case == "one_tile" and tile == (16, 16):
        assert mask[:, 0, 0].all() and not mask[:, 1:].any() \
            and not mask[:, :, 1:].any()


@pytest.mark.parametrize("case", ["random", "off_canvas", "n_past_chunk",
                                  "gated"])
def test_composite_over_listed_objects_equals_composite(case):
    boxes, gate = make_boxes(case, seed=10 + CASES.index(case))
    b, n = boxes.shape[:2]
    rng = np.random.RandomState(20)
    color, alpha = (torch.as_tensor(rng.rand(b, n, 1, *OBJ).astype("f"))
                    for _ in range(2))
    imp = torch.as_tensor(rng.rand(b, n, 1, *OBJ).astype("f") + 0.01)
    boxes_t = torch.as_tensor(boxes)
    gate_t = None if gate is None else torch.as_tensor(gate)
    tile = (32, 8)  # the kernel's tile, cull_tiles' default
    mask = K.cull_tiles(boxes_t, HW, OBJ, pres_gate=gate_t)
    want = K.composite_plain(color, alpha, imp, boxes_t, HW, pres_gate=gate_t)
    th, tw = tile
    for i in range(mask.shape[1]):
        for j in range(mask.shape[2]):
            got = K.composite_plain(color, alpha, imp, boxes_t, HW,
                                    pres_gate=mask[:, i, j].float(),
                                    den_floor_n=n)
            win = (..., slice(i * th, (i + 1) * th),
                   slice(j * tw, (j + 1) * tw))
            for g, w in zip(got, want):
                scale = max(float(w[win].abs().max()), 1e-30)
                assert float((g[win] - w[win]).abs().max()) / scale < 1e-6


def test_canvas_range_bounds_the_support_tightly():
    """canvas_range over (-1, oh) holds every canvas row whose glimpse
    coordinate lies in (-1, oh), and reaches at most 3 rows past the exact
    (float64) interval of such rows, for boxes of every case."""
    for case in CASES:
        boxes, _ = make_boxes(case, seed=30 + CASES.index(case))
        yt, ys = torch.as_tensor(boxes[..., 1]), torch.as_tensor(boxes[..., 3])
        lo, hi = K.canvas_range(-1.0, float(OBJ[0]), HW[0], yt, ys, OBJ[0])
        lo, hi = lo.numpy(), hi.numpy()
        u = 2.0 * np.arange(HW[0], dtype="f") / np.float32(HW[0] - 1) - 1.0
        sy = ((u - (2.0 * boxes[..., 1:2] - 1.0)) / boxes[..., 3:4] + 1.0) \
            * np.float32(OBJ[0] - 1) / 2.0
        inside = (sy > -1) & (sy < OBJ[0])
        y = np.arange(HW[0])
        within = (y >= lo[..., None]) & (y <= hi[..., None])
        assert not (inside & ~within).any(), case
        t, s = boxes[..., 1].astype("d"), boxes[..., 3].astype("d")
        ends = [((src * 2.0 / (OBJ[0] - 1) - 1.0) * s + 2.0 * t)
                * (HW[0] - 1) / 2.0 for src in (-1.0, OBJ[0])]
        first, last = np.minimum(*ends), np.maximum(*ends)
        listed = lo <= hi
        assert (lo[listed] >= np.floor(first[listed]) - 3).all(), case
        assert (hi[listed] <= np.ceil(last[listed]) + 3).all(), case
