"""K1's per-tile cull (``cull_tiles``) against the JAX package's paste.

The forward kernel (csrc/composite_fwd.cu) lists, for each canvas tile, the
live objects whose support meets it, and sums over that list only. These
tests hold the plain version of that rule: every (pixel, object) pair with a
nonzero product of ``spair_pytorch_tpu.ops.stn.paste_weights`` must be in
its tile's list, and gated objects never are. The bound, ``canvas_range``,
reaches at most 3 rows past the exact interval of the support (it widens
by 2 indices against rounding). Compositing each tile from its list alone must give
``composite_plain``'s tile, to 1e-6 relative (the left-out objects add exact
zeros, so the sums are equal up to their order of chunks).

K3 (the banded compositor, the same kernel launched with a row band) culls
by the same rule with each object's rows first clipped to its grid row's
band; the banded tests hold ``cull_tiles(..., bands=...)`` against the JAX
package's ``band_geometry`` and paste weights in the same way, and against
``composite_v3_plain``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.ops.pallas.composite_v3 import \
    band_geometry as jax_band_geometry
from spair_pytorch_tpu.ops.stn import paste_weights as jax_paste_weights
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V

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


def support_pixels(boxes, obj=OBJ, hw=HW):
    """(B, N, H, W) bool: the pixels where some texel's paste weight, JAX's
    py(y, a) px(x, q), is nonzero."""
    py, px = jax_paste_weights(jnp.asarray(boxes), obj, hw)
    rows = np.asarray(py != 0).any(-1)                  # (B, N, H)
    cols = np.asarray(px != 0).any(-1)                  # (B, N, W)
    return rows[..., :, None] & cols[..., None, :]


def per_pixel(mask, tile, hw=HW):
    """(B, tiles_y, tiles_x, N) -> (B, N, H, W): each pixel's tile's list."""
    th, tw = tile
    m = mask.numpy().repeat(th, 1).repeat(tw, 2)[:, :hw[0], :hw[1]]
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


# ---------------------------------------------------------- K3's banded cull

# (canvas, glimpse, cell height, grid, box bounds (min_cy, max_cy, max_ys)):
# paper128's geometry (bands of 88 of 128 rows), and a 4 x 40 grid of N =
# 160 objects, past K1's cull chunk, with bands of 64 rows
PAPER128 = ((128, 128), (28, 28), 12, (11, 11), (-0.5, 1.5, 0.375))
BANDED = {"paper128": PAPER128, "past_band": PAPER128, "band_edge": PAPER128,
          "grid_4x40": ((128, 128), (28, 28), 32, (4, 40), (0.0, 1.0, 0.1))}


def edge_box(row, first, hw, oh, ys=0.2):
    """yt of a box of scale ys whose paste support (sy in (-1, oh)) has
    ``row`` as its first canvas row (``first``) or its last: sy(row) is
    -0.5 or oh - 0.5, and the next row out lies past -1 or oh."""
    u = 2.0 * row / (hw[0] - 1) - 1.0
    src = -0.5 if first else oh - 0.5
    return (u + 1.0 - ys * (src * 2.0 / (oh - 1) - 1.0)) / 2.0


def banded_case(case, b, seed):
    """(geometry, boxes (B, N, 4) float32 from the model's parameterization,
    the JAX package's (band, starts)). 'past_band' moves every seventh
    object near the far edge of the canvas from its grid row, past its
    band; 'band_edge' moves two objects of each grid row whose band lies
    inside the canvas so that one canvas row of their support is in the
    band: its first row (support above it) or its last (support below)."""
    hw, obj, cell, (gh, gw), (min_cy, max_cy, max_ys) = geom = BANDED[case]
    rng = np.random.RandomState(seed)
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    n = gh * gw
    yt = (hh.ravel() + rng.uniform(min_cy, max_cy, (b, n))) * cell / hw[0]
    xt = (ww.ravel() + rng.uniform(min_cy, max_cy, (b, n))) / gw
    scale = rng.uniform(0.05, max_ys, (b, n, 2))
    band, starts = jax_band_geometry(hw, cell, min_cy, max_cy, max_ys,
                                     obj[0], gh)
    if case == "past_band":
        yt[:, ::7] = np.where(hh.ravel()[::7] < gh / 2, 0.93, 0.07)
    if case == "band_edge":
        for h, lo in enumerate(starts):
            if 0 < lo and lo + band < hw[0]:
                yt[:, h * gw] = edge_box(lo, False, hw, obj[0])
                yt[:, h * gw + 1] = edge_box(lo + band - 1, True, hw, obj[0])
                scale[:, h * gw:h * gw + 2, 1] = 0.2
    boxes = np.stack([xt, yt, scale[..., 0], scale[..., 1]], -1).astype("f")
    return geom, boxes, (int(band), [int(v) for v in starts])


def band_rows(hw, band, starts, gw):
    """(N, H) bool: the canvas rows of each object's band."""
    lo = np.repeat(np.asarray(starts), gw)[:, None]
    y = np.arange(hw[0])[None]
    return (y >= lo) & (y < lo + band)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", list(BANDED))
def test_banded_cull_lists_every_in_band_pixel(case, tile):
    """Every (pixel, object) pair with a nonzero in-band paste weight is
    listed, and no object is listed for a tile its band misses."""
    (hw, obj, _, (gh, gw), _), boxes, (band, starts) = banded_case(
        case, 2, seed=40 + list(BANDED).index(case))
    assert band < hw[0]  # a real clip
    mask = K.cull_tiles(torch.as_tensor(boxes), hw, obj, tile,
                        bands=(band, starts, gw))
    th, tw = tile
    assert mask.shape == (2, -(-hw[0] // th), -(-hw[1] // tw), gh * gw)
    rows = band_rows(hw, band, starts, gw)                 # (N, H)
    need = support_pixels(boxes, obj, hw) & rows[None, :, :, None]
    listed = per_pixel(mask, tile, hw)
    assert need.any() and not (need & ~listed).any(), \
        "an in-band pasted pixel's tile misses it"
    # a tile's rows meet the band of every object it lists
    tile_rows = np.arange(mask.shape[1])[:, None] * th + np.arange(th)
    meets = rows[:, np.minimum(tile_rows, hw[0] - 1)].any(-1)  # (N, ty)
    assert not (mask.numpy() & ~meets.T[None, :, None, :]).any(), \
        "an object was listed for a tile its band misses"
    if case == "past_band":  # the clip drops boxes K1's cull would list
        assert (K.cull_tiles(torch.as_tensor(boxes), hw, obj, tile)
                & ~mask).any()


@pytest.mark.parametrize("case", list(BANDED))
def test_banded_composite_over_listed_objects_equals_composite_v3(case):
    """Each K3 tile composited from its list alone (the other objects'
    glimpses zeroed) gives composite_v3_plain's tile."""
    (hw, obj, cell, grid, bounds), boxes, (band, starts) = banded_case(
        case, 1, seed=50 + list(BANDED).index(case))
    b, n = boxes.shape[:2]
    rng = np.random.RandomState(21)
    color, alpha = (torch.as_tensor(rng.rand(b, n, 1, *obj).astype("f"))
                    for _ in range(2))
    imp = torch.as_tensor(rng.rand(b, n, 1, *obj).astype("f") + 0.01)
    boxes_t = torch.as_tensor(boxes)
    geom = (hw, cell, grid, bounds)
    mask = K.cull_tiles(boxes_t, hw, obj, bands=(band, starts, grid[1]))
    want = V.composite_v3_plain(color, alpha, imp, boxes_t, *geom)
    th, tw = 32, 8  # the kernel's tile, cull_tiles' default
    tiles = [(i, j) for i in range(mask.shape[1])
             for j in range(mask.shape[2])]
    # the tiles' masked inputs stacked on the batch axis, 32 tiles a call:
    # one composite a tile, in two calls instead of one call a tile
    for first in range(0, len(tiles), 32):
        group = tiles[first:first + 32]
        keep = torch.cat([mask[:, i, j] for i, j in group]).float()[
            :, :, None, None, None]

        def stacked(t):
            return t.repeat((len(group),) + (1,) * (t.dim() - 1))
        got = V.composite_v3_plain(stacked(color) * keep,
                                   stacked(alpha) * keep,
                                   stacked(imp) * keep, stacked(boxes_t),
                                   *geom)
        for k, (i, j) in enumerate(group):
            win = (..., slice(i * th, (i + 1) * th),
                   slice(j * tw, (j + 1) * tw))
            for g, w in zip(got, want):
                g = g[k * b:(k + 1) * b]
                scale = max(float(w[win].abs().max()), 1e-30)
                assert float((g[win] - w[win]).abs().max()) / scale < 1e-6
