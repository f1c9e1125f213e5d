"""The port's training entry point (train, eval, checkpoints, logging) on
the CPU, on the tiny config with ``render_backend='pallas_v3'``, against the
JAX package's loop: its config file, its tags, its cadence rule, its
metrics. Detection-metric values are compared to 1e-6 absolute; a resumed
run must equal an uninterrupted one bit for bit."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu import config as jconfig
from spair_pytorch_tpu import eval as jeval
from spair_pytorch_tpu import metrics as jmetrics
from spair_pytorch_tpu import train as jtrain
from spair_pytorch_tpu.parallel import train_step as jts
from spair_pytorch_tpu_torch import eval as teval
from spair_pytorch_tpu_torch import metrics, serve
from spair_pytorch_tpu_torch import train as ttrain
from spair_pytorch_tpu_torch.parallel import create_train_state
from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_model import tiny_config
from tests.test_torch_ops import t, tcfg

JCFG = tiny_config(batch_size=2, inference_mode="wavefront",
                   render_backend="pallas_v3", render_chunk_k=2,
                   pres_gate_threshold=0.01)
CFG = tcfg(JCFG)
RUN = dict(checkpoint_every=2, eval_every=2, eval_batches=1,
           steps_per_call=2, digits="font", verbose=False, device="cpu")
HAVE_MPL = importlib.util.find_spec("matplotlib") is not None


def rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def adam_tensors(state):
    return [v for s in state.optimizer.state_dict()["state"].values()
            for v in s.values()]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 steps in one run == 2 steps, a resume from the checkpoint, 2 more:
    losses, parameters, Adam state, generator and step, bit for bit. Also
    the run dir: config.json read by the JAX package, metrics.jsonl with the
    JAX step's tags and the held-out eval under eval/*."""
    whole = ttrain.train(CFG, steps=4, logdir=str(tmp_path / "a"), **RUN)
    ttrain.train(CFG, steps=2, logdir=str(tmp_path / "b"), **RUN)
    assert CheckpointManager(str(tmp_path / "b" / "checkpoints")
                             ).latest_step() == 2
    split = ttrain.train(CFG, steps=2, logdir=str(tmp_path / "b"), **RUN)
    assert int(whole.step) == int(split.step) == 4
    for p, q in zip(whole.model.parameters(), split.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(adam_tensors(whole), adam_tensors(split)):
        assert torch.equal(p, q)
    assert torch.equal(whole.generator.get_state(),
                       split.generator.get_state())

    def losses(logdir):
        return {r["step"]: r["losses/total"] for r in rows(logdir)
                if "losses/total" in r}
    assert losses(tmp_path / "a") == losses(tmp_path / "b")
    assert sorted(losses(tmp_path / "a")) == [0, 1, 2, 3]

    with open(tmp_path / "a" / "config.json") as f:
        assert jconfig.config_from_json(f.read()) == JCFG
    batch = (jnp.zeros((2,) + JCFG.image_shape), jnp.zeros((2, 6, 4)),
             jnp.ones((2, 1)))
    # the step's tags do not depend on the compositor; 'xla' traces fast
    jcfg = dataclasses.replace(JCFG, render_backend="xla")
    _, step_tags = jax.eval_shape(
        jts.make_train_step(jcfg, with_detection=True, donate=False),
        jax.eval_shape(lambda: jts.create_train_state(jcfg)), batch)
    train_rows = [r for r in rows(tmp_path / "a") if "losses/total" in r]
    # before step 1000 the accuracy/* tags are filtered, as in JAX
    assert set(train_rows[0]) - {"step", "time"} == {
        k for k in step_tags if not k.startswith("accuracy/")}
    eval_rows = [r for r in rows(tmp_path / "a") if "eval/ap_at_50" in r]
    assert [r["step"] for r in eval_rows] == [2, 4]


def jax_state(cfg):
    """A JAX TrainState of zeros, without the eager init's op-by-op cost."""
    return jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: jts.create_train_state(cfg)))


def test_steps_per_call_cadence_error_is_jaxs(tmp_path, monkeypatch):
    # the check does not read the state; skip the JAX package's eager init
    monkeypatch.setattr(jtrain, "create_train_state", jax_state)
    kw = dict(steps=4, checkpoint_every=3, steps_per_call=2, verbose=False)
    with pytest.raises(ValueError) as want:
        jtrain.train(JCFG, logdir=str(tmp_path / "jax"), **kw)
    with pytest.raises(ValueError) as got:
        ttrain.train(CFG, logdir=str(tmp_path / "port"), device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_remainder_window_runs_exactly_the_steps_asked(tmp_path):
    state = ttrain.train(CFG, steps=3, logdir=str(tmp_path), **RUN)
    assert int(state.step) == 3
    assert CheckpointManager(str(tmp_path / "checkpoints")).all_steps() \
        == [2, 3]


@pytest.mark.parametrize("kw", [
    dict(hdf5="scenes.hdf5"), dict(data_source="native"),
    dict(use_mesh=True), dict(log_images_every=2),
    dict(log_figures_every=2)], ids=lambda kw: next(iter(kw)))
def test_unported_train_options_raise(tmp_path, monkeypatch, kw):
    """The train() options the port once refused are all ported now and
    take a step: the HDF5 and native data sources, the mesh (tests/
    test_torch_data_inputs.py and test_torch_parallel.py hold them against
    the JAX package), and image and figure logging, whose step 0 writes
    (tests/test_torch_viz.py holds every tag)."""
    if "hdf5" in kw:
        pytest.importorskip("h5py")
        from spair_pytorch_tpu_torch.data.build_hdf5 import build
        kw = dict(hdf5=build(str(tmp_path / kw["hdf5"]), CFG.batch_size,
                             ttrain.data_config(CFG), digits="font"))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if "log_figures_every" in kw and not HAVE_MPL:
        # without matplotlib figure logging raises matplotlib's own error
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            ttrain.train(CFG, steps=1, logdir=str(tmp_path / "run"),
                         checkpoint_every=0, verbose=False, digits="font",
                         device="cpu", **kw)
        return
    state = ttrain.train(CFG, steps=1, logdir=str(tmp_path / "run"),
                         checkpoint_every=0, verbose=False, digits="font",
                         device="cpu", **kw)
    assert int(state.step) == 1
    if "log_images_every" in kw or "log_figures_every" in kw:
        with open(tmp_path / "run" / "metrics.jsonl") as f:
            latent = ["z_presence/mean" in json.loads(line) for line in f]
        assert any(latent) == ("log_figures_every" in kw)


def test_unported_cli_paths_raise(tmp_path):
    """The paths that should refuse still do; eval --figure, which the
    port once refused, writes its PNG (without matplotlib it raises
    matplotlib's own error)."""
    with pytest.raises(ValueError, match="unknown data source"):
        ttrain.make_data(CFG, source="disk", device="cpu")
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.main(["--preset", "small48", "--logdir", str(tmp_path),
                    "--device", "cpu"])
    logdir = str(tmp_path / "run")
    ttrain.train(CFG, steps=1, logdir=logdir, checkpoint_every=1,
                 verbose=False, digits="font", device="cpu")
    args = ["--logdir", logdir, "--figure", str(tmp_path / "out.png"),
            "--batches", "1", "--digits", "font", "--device", "cpu"]
    if not HAVE_MPL:
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            teval.main(args)
        return
    teval.main(args)
    assert (tmp_path / "out.png").stat().st_size > 0


def match_inputs():
    rng = np.random.RandomState(4)
    z_where = np.concatenate([rng.rand(3, 2, 4, 5),
                              rng.uniform(0.05, 0.4, (3, 2, 4, 5))],
                             axis=1).astype("f")
    z_pres = rng.rand(3, 1, 4, 5).astype("f")
    z_pres[0, 0, 0, :2] = 0.0  # suppressed predictions
    z_pres[1, 0, 1, :] = z_pres[1, 0, 0, :]  # tied scores
    gt_count = np.float32([[1], [3], [6]])
    gt_bbox = np.concatenate([rng.uniform(0, 100, (3, 6, 2)),
                              rng.uniform(5, 40, (3, 6, 2))], -1)
    # some ground truth near predictions, so that every IoU bar has hits:
    # GT slot 0 of each image is its prediction 3's box (the renderer's
    # centre semantics), shifted by a pixel
    pred = z_where.reshape(3, 4, -1)[:, :, 3] * 128
    gt_bbox[:, 0, :2] = pred[:, :2] - pred[:, 2:] / 2 + 1.0
    gt_bbox[:, 0, 2:] = pred[:, 2:]
    gt_bbox = (gt_bbox * (np.arange(6)[None, :, None] < gt_count[:, :, None])
               ).astype("f")
    return z_where, z_pres, gt_bbox, gt_count


@pytest.mark.parametrize("iou", [0.1, 0.3, 0.5])
def test_matching_and_average_precision_match_jax(iou):
    z_where, z_pres, gt_bbox, gt_count = match_inputs()
    args = (z_where, z_pres, gt_bbox, gt_count)
    want = jmetrics.match_predictions(*map(jnp.asarray, args), 128,
                                      iou_threshold=iou)
    got = metrics.match_predictions(*map(t, args), 128, iou_threshold=iou)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert float(got[1].sum()) > 0
    ap_j = jmetrics.average_precision(*map(np.asarray, want))
    assert abs(metrics.average_precision(*(g.numpy() for g in got))
               - ap_j) < 1e-6

    pred = (z_where.reshape(3, 4, -1).transpose(0, 2, 1) * 128)
    pred[..., 2:] += pred[..., :2]
    scores = z_pres.reshape(3, -1)
    want = jmetrics.match_boxes(jnp.asarray(pred), jnp.asarray(scores),
                                jnp.asarray(gt_bbox), jnp.asarray(gt_count),
                                iou)
    got = metrics.match_boxes(t(pred), t(scores), t(gt_bbox), t(gt_count),
                              iou)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(
        metrics.batch_jaccard(t(pred), t(pred)).numpy(),
        np.asarray(jmetrics.batch_jaccard(jnp.asarray(pred),
                                          jnp.asarray(pred))), atol=1e-6)


def test_evaluate_and_calibrate_return_the_jax_keys():
    batch = [np.random.RandomState(0).rand(2, 1, 48, 48).astype("f"),
             np.zeros((2, 6, 4), "f"), np.ones((2, 1), "f")]
    want, _, _ = jeval.evaluate(JCFG, jax_state(JCFG), 1,
                                data=iter([tuple(map(jnp.asarray, batch))]),
                                det_threshold=0.5, det_nms=0.5)
    state = create_train_state(CFG, device="cpu")
    got, aux, x = teval.evaluate(CFG, state, 1, data=[tuple(map(t, batch))],
                                 det_threshold=0.5, det_nms=0.5)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(v) for v in got.values())
    assert tuple(aux["recon"].shape) == (2, 1, 48, 48) and x.shape[0] == 2
    cal = teval.calibrate(CFG, state, 1, data=[tuple(map(t, batch))])
    assert sorted(cal) == ["ap_at_50", "count_accuracy", "nms_iou",
                           "pres_threshold", "scenes", "seed", "step",
                           "target"]
    assert cal["pres_threshold"] in teval.CALIB_THRESHOLDS
    assert sorted(cal["count_accuracy"]) == ["0.5", "0.6", "0.7", "none"]


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    cfg = dataclasses.replace(CFG, inference_mode="independent")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = create_train_state(cfg, device="cpu")
    assert mgr.restore(state) is None
    for step in (1, 2, 3):
        state.step.fill_(step)
        mgr.save(state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    fresh = create_train_state(cfg, seed=9, device="cpu")
    assert int(mgr.restore(fresh, step=2).step) == 2
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
