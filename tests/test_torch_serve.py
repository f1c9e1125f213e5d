"""The port's serving path (NMS, detector, DetectorServer, CLI) and scene
generator against the JAX package on the same inputs.

Tolerance: f32 relative error 1e-4 (max |port - jax| / max(1, max |jax|));
keep masks, counts and generated scenes must be equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.data.scattered_mnist import DataConfig as JaxDataConfig
from spair_pytorch_tpu.data.scattered_mnist import _generate_one
from spair_pytorch_tpu.data.scattered_mnist import glyph_bank as jax_bank
from spair_pytorch_tpu.models import infer as jinfer
from spair_pytorch_tpu.serve import DetectorServer as JaxServer
from spair_pytorch_tpu_torch import serve
from spair_pytorch_tpu_torch.data import (DataConfig, generate_batch,
                                          glyph_bank, place_patches)
from spair_pytorch_tpu_torch.models import infer as tinfer
from spair_pytorch_tpu_torch.serve import DetectorServer
from tests.test_model import tiny_config
from tests.test_torch_ops import (assert_close, jax_params_np, ported_params,
                                  t)


def random_boxes(seed, b=3, n=20):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 12, (b, n, 2))
    wh = rng.uniform(4, 20, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype("f")
    return boxes, rng.rand(b, n).astype("f")


def test_pairwise_iou_matches_jax():
    boxes, _ = random_boxes(0)
    want = jinfer.pairwise_iou(jnp.asarray(boxes[0]))
    assert_close(tinfer.pairwise_iou(t(boxes[0])), np.asarray(want))
    batched = tinfer.pairwise_iou(t(boxes))
    assert_close(batched[1], np.asarray(jinfer.pairwise_iou(
        jnp.asarray(boxes[1]))))


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.6])
def test_nms_matches_jax(thr):
    boxes, scores = random_boxes(int(thr * 10))
    want = np.asarray(jinfer.nms_keep_batch(jnp.asarray(boxes),
                                            jnp.asarray(scores), thr))
    got = tinfer.nms_keep_batch(t(boxes), t(scores), thr).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(boxes.shape[0]):
        single = tinfer.nms_keep(t(boxes[i]), t(scores[i]), thr).numpy()
        np.testing.assert_array_equal(single, np.asarray(jinfer.nms_keep(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr)))
        np.testing.assert_array_equal(single, got[i])
    assert 0 < got.sum() < got.size  # the case suppresses something


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = tiny_config(inference_mode="wavefront")
    pnp = jax_params_np(cfg, seed=21)
    model = ported_params(cfg, pnp)
    x = np.random.RandomState(22).rand(5, 1, 48, 48).astype("f")
    return cfg, pnp, model, x


@pytest.mark.parametrize("nms_iou", [None, 0.2])
def test_detect_matches_jax(tiny_setup, nms_iou):
    cfg, pnp, model, x = tiny_setup
    want = jinfer.detect(pnp, jnp.asarray(x), cfg, 0.5, nms_iou)
    got = tinfer.make_detector(cfg, 0.5, nms_iou)(model, t(x))
    for k in ("boxes", "scores", "z_depth"):
        assert_close(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(got["count"].numpy(),
                                  np.asarray(want["count"]))


def test_server_matches_jax_server(tiny_setup):
    cfg, pnp, model, x = tiny_setup
    want = JaxServer(cfg, jax.tree_util.tree_map(jnp.asarray, pnp),
                     batch_sizes=(1, 4), pres_threshold=0.45).detect(x)
    server = DetectorServer(cfg, model, batch_sizes=(1, 4),
                            pres_threshold=0.45)
    server.warmup()
    got = server.detect(x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["count"] == w["count"]
        assert_close(g["boxes"], w["boxes"])
        assert_close(g["scores"], w["scores"])


def test_glyph_bank_equals_jax():
    np.testing.assert_array_equal(glyph_bank((14, 14)), jax_bank((14, 14)))


def test_place_patches_matches_jax_generator():
    """The JAX generator's own draws, replayed through place_patches."""
    dcfg = DataConfig(image_hw=(48, 40), min_objects=1, max_objects=5,
                      channels=2)
    jcfg = JaxDataConfig(**vars(dcfg))
    bank = glyph_bank((14, 14))
    m, ih, iw = dcfg.max_objects, 48, 40
    draws, want = [], []
    for s in range(6):
        key = jax.random.PRNGKey(s)
        k_count, k_pick, k_y, k_x = jax.random.split(key, 4)
        draws.append([np.asarray(v) for v in (
            jax.random.randint(k_pick, (m,), 0, bank.shape[0]),
            jax.random.randint(k_y, (m,), 0, ih - 14 + 1),
            jax.random.randint(k_x, (m,), 0, iw - 14 + 1),
            jax.random.randint(k_count, (), 1, m + 1))])
        want.append([np.asarray(v) for v in
                     _generate_one(key, jnp.asarray(bank), jcfg)])
    picks, oys, oxs, count = (torch.as_tensor(np.stack(v)).long()
                              for v in zip(*draws))
    image, bbox, cnt = place_patches(torch.as_tensor(bank), picks, oys, oxs,
                                     count, dcfg)
    for got, ref in zip((image, bbox, cnt), zip(*want)):
        np.testing.assert_array_equal(got.numpy(), np.stack(ref))


def test_generate_batch_is_seeded_and_well_formed():
    dcfg = DataConfig(image_hw=(64, 64), max_objects=4)
    bank = torch.as_tensor(glyph_bank((14, 14)))
    a = generate_batch(torch.Generator().manual_seed(3), bank, 8, dcfg)
    b = generate_batch(torch.Generator().manual_seed(3), bank, 8, dcfg)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    image, bbox, count = a
    assert tuple(image.shape) == (8, 1, 64, 64)
    assert float(image.min()) >= 0.0 and float(image.max()) <= 1.0
    active = (bbox[..., 2] > 0).sum(-1).float()
    assert torch.equal(active, count[:, 0])


def test_resolve_operating_point(tmp_path):
    assert serve.resolve_threshold(None, None) == 0.5
    assert serve.resolve_nms(None, None) is None
    (tmp_path / "calibration.json").write_text(
        json.dumps({"pres_threshold": 0.3, "nms_iou": 0.4}))
    assert serve.resolve_threshold(None, str(tmp_path)) == 0.3
    assert serve.resolve_threshold(0.7, str(tmp_path)) == 0.7
    assert serve.resolve_nms(None, str(tmp_path)) == 0.4
    assert serve.resolve_nms(0, str(tmp_path)) is None


def test_serve_cli_runs_on_cpu(capsys):
    dets = serve.main(["--preset", "small48", "--requests", "3",
                       "--batch", "2", "--device", "cpu"])
    assert len(dets) == 3
    assert "served 3 requests" in capsys.readouterr().out
