"""The port's split refinement (``models/refine.py``) against the JAX
package's on the same inputs: the same weights (the JAX initialization
carried over), the same images from a numpy seed and the same detections
(one detector output, given to both).

Tolerance: f32 relative error 1e-4 (max |port - jax| / max(1, max |jax|));
detection indices, counts and split counts must be equal. On the CPU the
port's windows go through the plain compositor, the kernel's oracle."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.models import refine as jrefine
from spair_pytorch_tpu_torch.models import infer as tinfer
from spair_pytorch_tpu_torch.models import refine, render
from tests.test_model import tiny_config
from tests.test_torch_ops import (assert_close, jax_params_np, ported_params,
                                  t, tcfg)

JCFG = tiny_config(inference_mode="independent")
INTS = ("idx",)


@pytest.fixture(scope="module")
def setup():
    pnp = jax_params_np(JCFG, seed=31)
    model = ported_params(JCFG, pnp)
    x = np.random.RandomState(32).rand(3, 1, 48, 48).astype("f")
    # the port's detector (held against the JAX one in test_torch_serve.py)
    det = tinfer.make_detector(tcfg(JCFG), 0.5, 0.3)(model, t(x))
    return pnp, model, x, {k: v.numpy() for k, v in det.items()}


def port_det(det):
    return {k: t(v) for k, v in det.items()}


def jax_gains(pnp, cfg, x, boxes, scores, **kw):
    fn = jax.jit(partial(jrefine.split_gains, cfg=cfg, **kw))
    return jax.device_get(fn(pnp, x=jnp.asarray(x), boxes=jnp.asarray(boxes),
                             scores=jnp.asarray(scores)))


def assert_gains_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in INTS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            assert_close(got[k], np.asarray(w))


@pytest.mark.parametrize("hw", [(48, 48), (48, 64)], ids=["square", "wide"])
def test_geometry_round_trips_match_jax(hw):
    rng = np.random.RandomState(0)
    zw = np.stack([rng.uniform(0.2, 0.8, (5, 7)),
                   rng.uniform(0.2, 0.8, (5, 7)),
                   rng.uniform(0.05, 0.4, (5, 7)),
                   rng.uniform(0.05, 0.4, (5, 7))], axis=-1).astype("f")
    corner = refine.zwhere_to_corner(t(zw), hw)
    assert_close(corner, np.asarray(jrefine.zwhere_to_corner(
        jnp.asarray(zw), hw)))
    back = refine.corner_to_zwhere(corner, hw)
    np.testing.assert_allclose(back.numpy(), zw, atol=1e-5)
    assert_close(back, np.asarray(jrefine.corner_to_zwhere(
        jnp.asarray(corner.numpy()), hw)))
    assert refine._CANDIDATES == jrefine._CANDIDATES
    assert refine.N_CANDIDATES == jrefine.N_CANDIDATES == 6
    assert_close(refine.split_candidates(t(zw)),
                 np.asarray(jrefine.split_candidates(jnp.asarray(zw))))


@pytest.mark.parametrize("top_m, thr", [(4, 0.5), (12, 0.3)])
def test_split_gains_match_jax(setup, top_m, thr):
    pnp, model, x, det = setup
    want = jax_gains(pnp, JCFG, x, det["boxes"], det["scores"], top_m=top_m,
                     pres_threshold=thr)
    got = refine.split_gains(model, tcfg(JCFG), t(x), t(det["boxes"]),
                             t(det["scores"]), top_m=top_m,
                             pres_threshold=thr)
    assert_gains_equal(got, want)
    assert got["best_child"].shape == (3, top_m, 2, 4)


@pytest.mark.parametrize("margin, max_iou", [
    (np.inf, 0.3), (-np.inf, 2.0), (0.1, 0.3), (-0.5, 0.5)],
    ids=["inf", "accept_all", "0.1", "-0.5"])
def test_apply_splits_matches_jax(setup, margin, max_iou):
    pnp, model, x, det = setup
    thr = 0.3
    jg = jax_gains(pnp, JCFG, x, det["boxes"], det["scores"], top_m=6,
                   pres_threshold=thr)
    want = jax.device_get(jrefine.apply_splits(
        {k: jnp.asarray(v) for k, v in det.items()},
        {k: jnp.asarray(v) for k, v in jg.items()}, margin, thr,
        max_neighbor_iou=max_iou))
    gains = refine.split_gains(model, tcfg(JCFG), t(x), t(det["boxes"]),
                               t(det["scores"]), top_m=6, pres_threshold=thr)
    got = refine.apply_splits(port_det(det), gains, margin, thr,
                              max_neighbor_iou=max_iou)
    assert_close(got["boxes"], want["boxes"])
    assert_close(got["scores"], want["scores"])
    for k in ("count", "n_split"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    live = (gains["score"] >= thr).sum(-1)
    if margin == np.inf:  # a no-op: the detections unchanged
        assert int(got["n_split"].sum()) == 0
        assert torch.equal(got["boxes"][:, :-6], t(det["boxes"]))
    if margin == -np.inf:  # every live detection splits, one box more each
        assert torch.equal(got["n_split"], live)
        base = (t(det["scores"]) >= thr).sum(-1)
        assert torch.equal(got["count"], base + live)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["float", "tensor"])
def test_make_refiner_matches_jax(setup, as_tensor):
    """refine(params, x, det, margin, threshold) after the detector, with
    margin and threshold as floats or 0-d tensors."""
    pnp, model, x, det = setup
    want = jax.device_get(jrefine.make_refiner(JCFG, top_m=5)(
        pnp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in det.items()},
        0.05, 0.4))
    margin, thr = ((torch.tensor(0.05), torch.tensor(0.4)) if as_tensor
                   else (0.05, 0.4))
    got = refine.make_refiner(tcfg(JCFG), top_m=5)(model, t(x),
                                                   port_det(det), margin, thr)
    assert sorted(got) == sorted(want)
    assert_close(got["boxes"], want["boxes"])
    assert_close(got["scores"], want["scores"])
    for k in ("count", "n_split"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_the_candidate_table_is_made_once_on_the_device():
    """The (6, 6) candidate table is a tensor made once per device and
    dtype, by the first call, and no later call makes a tensor from host
    data (a copy a captured refiner cannot hold)."""
    from tests.test_torch_captured_step import no_host_reads
    zw = torch.rand((2, 3, 4), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    first = refine.split_candidates(zw)
    table = refine.candidate_table(zw.device, zw.dtype)
    assert refine.candidate_table(torch.device("cpu"), torch.float64) \
        is table
    assert torch.equal(table, torch.tensor(refine._CANDIDATES,
                                           dtype=torch.float64))
    with no_host_reads():
        again = refine.split_candidates(zw)
    assert torch.equal(again, first)


def test_top_m_ties_go_to_the_lower_index(setup):
    """Fewer live detections than top_m: after NMS most scores are exactly
    0, so the picks past the live ones are ties, which jax.lax.top_k gives
    to the lower index."""
    pnp, model, x, det = setup
    scores = np.zeros_like(det["scores"])
    scores[:, [7, 3, 11]] = [0.9, 0.6, 0.9]     # a tie among the live too
    scores[1, 5] = 0.6
    want = jax_gains(pnp, JCFG, x, det["boxes"], scores, top_m=12)
    got = refine.split_gains(model, tcfg(JCFG), t(x), t(det["boxes"]),
                             t(scores), top_m=12)
    assert_gains_equal(got, want)
    idx = got["idx"].numpy()
    assert list(idx[0, :3]) == [7, 11, 3]
    dead = idx[0, 3:]
    assert list(dead) == sorted(dead) and 3 not in dead


def test_degenerate_box_floor_on_a_non_square_image():
    """The 2 px floor is 2 / max(H, W) on both axes, as in the JAX package
    (ROADMAP queue 3): zero-width and zero-height boxes on a 48 x 64
    image."""
    cfg = dataclasses.replace(JCFG, image_shape=(1, 48, 64))
    pnp = jax_params_np(JCFG, seed=33)
    model = ported_params(JCFG, pnp)
    rng = np.random.RandomState(34)
    x = rng.rand(2, 1, 48, 64).astype("f")
    boxes = np.concatenate([rng.uniform(8, 40, (2, 6, 2)),
                            rng.uniform(8, 40, (2, 6, 2))], -1)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(4, 16, (2, 6, 2))
    boxes[:, 0, 2] = boxes[:, 0, 0]            # zero width
    boxes[:, 1, 3] = boxes[:, 1, 1]            # zero height
    boxes[:, 2, 2:] = boxes[:, 2, :2]          # a point
    boxes = boxes.astype("f")
    scores = np.linspace(0.95, 0.4, 6, dtype="f")[None].repeat(2, 0)
    want = jax_gains(pnp, cfg, x, boxes, scores, top_m=4)
    got = refine.split_gains(model, tcfg(cfg), t(x), t(boxes), t(scores),
                             top_m=4)
    assert_gains_equal(got, want)
    # the point's best child is sized from the floor on both axes
    child = got["best_child"][:, 2]
    size = child[..., 2:] - child[..., :2]
    assert float(size.min()) > 0


def test_best_candidate_ties_go_to_the_first(setup):
    """Alpha decoded as exactly 0 makes every reconstruction 0, so all six
    candidates tie on err; jnp.argmin takes candidate 0, and so must the
    port."""
    _, _, x, det = setup
    pnp = jax_params_np(JCFG, seed=35)
    b = np.array(pnp["object_decoder"]["heads"][0]["b"])
    b[1::2] = -1e4  # alpha logits: -1e3 + 5 after scale and bias
    pnp["object_decoder"]["heads"][0]["b"] = b
    model = ported_params(JCFG, pnp)
    want = jax_gains(pnp, JCFG, x, det["boxes"], det["scores"], top_m=4)
    got = refine.split_gains(model, tcfg(JCFG), t(x), t(det["boxes"]),
                             t(det["scores"]), top_m=4)
    assert_gains_equal(got, want)
    assert torch.equal(got["err_parent"], got["err_child"])
    first = refine.zwhere_to_corner(refine.split_candidates(
        refine.corner_to_zwhere(torch.take_along_dim(
            t(det["boxes"]), got["idx"][..., None], dim=1), (48, 48)))
        [:, :, 0], (48, 48))
    assert_close(got["best_child"], first.numpy())


def test_round_trip_is_float32_under_bf16_compute(setup):
    """The object round trip computes in f32 whatever the compute dtype."""
    pnp, model, x, det = setup
    inputs = (t(x), t(det["boxes"]), t(det["scores"]))
    f32 = refine.split_gains(model, tcfg(JCFG), *inputs, top_m=4)
    bf16 = refine.split_gains(
        model, tcfg(dataclasses.replace(JCFG, compute_dtype="bfloat16")),
        *inputs, top_m=4)
    for k in f32:
        assert torch.equal(f32[k], bf16[k]), k


def test_windows_are_composited_in_calls_of_at_most_max_scenes(setup,
                                                               monkeypatch):
    """Past the kernel's scene limit the windows go in several calls with
    the same result (here with a limit of 5 scenes)."""
    pnp, model, x, det = setup
    args = (model, tcfg(JCFG), t(x), t(det["boxes"]), t(det["scores"]))
    whole = refine.split_gains(*args, top_m=4)
    calls = []
    plain = render.composite_forward

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return plain(*a, **kw)
    monkeypatch.setattr(refine, "MAX_SCENES", 5)
    monkeypatch.setattr(render, "composite_forward", counted)
    chunked = refine.split_gains(*args, top_m=4)
    # 12 parents in 5 + 5 + 2, 72 candidate scenes in 14 x 5 + 2
    assert calls == [5, 5, 2] + [5] * 14 + [2]
    for k in whole:
        assert torch.allclose(whole[k].float(), chunked[k].float(),
                              rtol=0, atol=1e-6), k
