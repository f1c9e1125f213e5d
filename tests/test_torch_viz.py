"""The port's figure path against the JAX package's, on the CPU: the
gradient views (``utils/debug.py::generative_grad_views``), the six figures
of ``utils/viz.py`` drawn from the same numpy inputs, image and figure
logging in ``train()``, ``eval --figure``; and the whole-program NaN check
and the logistic noise.

Tolerance: the gradient views within 1e-3 relative (bench.py's gradient
bar, max |port - jax| / max(1, max |jax|)); figures equal array for array;
the noise equal bit for bit."""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.utils import debug as jdebug
from spair_pytorch_tpu.utils import viz as jviz
from spair_pytorch_tpu_torch import eval as teval
from spair_pytorch_tpu_torch import train as ttrain
from spair_pytorch_tpu_torch.config import config_to_json
from spair_pytorch_tpu_torch.models.latents import sample_noise
from spair_pytorch_tpu_torch.ops.math import logistic_noise
from spair_pytorch_tpu_torch.utils import debug, viz
from spair_pytorch_tpu_torch.utils import logging as tlogging
from tests.test_model import tiny_config
from tests.test_torch_ops import (assert_close, jax_params_np, ported_params,
                                  t, tcfg)

plt = pytest.importorskip("matplotlib.pyplot")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 1e-3
# the JAX package's figure-surface test config (tests/test_viz.py)
JCFG = tiny_config(batch_size=2, mlp_hidden=(16,), encoder_hidden=(16,),
                   decoder_hidden=(16,), n_backbone_features=8,
                   n_passthrough_features=8, inference_mode="independent")
B, GH, GW, A, OH = 2, 4, 4, 8, 14
N = GH * GW


def grids(seed):
    """Latent grids in NCHW, as forward's aux holds them, and an image."""
    rng = np.random.RandomState(seed)
    z_where = np.concatenate([rng.uniform(0.1, 0.9, (B, 2, GH, GW)),
                              rng.uniform(0.1, 0.5, (B, 2, GH, GW))], 1)
    return {"z_attr": rng.randn(B, A, GH, GW),
            "z_where": z_where,
            "z_depth": rng.uniform(0.0, 4.0, (B, 1, GH, GW)),
            "z_pres": rng.uniform(0.0, 1.0, (B, 1, GH, GW)),
            "x": rng.rand(B, 1, 48, 48)}


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_generative_grad_views_match_jax(backend):
    """The decoder-logit and z_attr gradients through decode -> composite
    -> BCE: 'auto' through the compositor's autograd Function (the K1/K2
    pair's plain versions here), 'xla' through autograd of the plain
    compositor."""
    g = {k: v.astype("f") for k, v in grids(0).items()}
    pnp = jax_params_np(JCFG, seed=3)
    fn = jax.jit(partial(jdebug.generative_grad_views, cfg=JCFG))
    want = fn(pnp, x=jnp.asarray(g["x"]), **{
        k: jnp.asarray(v) for k, v in g.items() if k != "x"})
    cfg = tcfg(dataclasses.replace(JCFG, render_backend=backend))
    got = debug.generative_grad_views(
        ported_params(JCFG, pnp), cfg, t(g["x"]), t(g["z_attr"]),
        t(g["z_where"]), t(g["z_depth"]), t(g["z_pres"]))
    assert got[0].shape == (B, N, 2, OH, OH)
    assert got[1].shape == (B, A, GH, GW)
    for gt, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0
        assert_close(gt, np.asarray(w), rel=GRAD_REL)


def drawn(fig):
    """What a figure shows: each axes' title, image arrays and rectangles."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(),
                    [np.ma.getdata(im.get_array()) for im in ax.get_images()],
                    [(p.get_xy(), p.get_width(), p.get_height(),
                      p.get_edgecolor()) for p in ax.patches]))
    plt.close(fig)
    return out


def figure_args(name):
    g = grids(1)
    rng = np.random.RandomState(2)
    glimpses = rng.rand(B, N, 1, OH, OH)
    return {
        "render_analysis_figure": (g["x"], rng.rand(B, 1, 48, 48),
                                   g["z_where"], g["z_pres"], g["z_depth"]),
        "glimpse_grid_figure": (glimpses,),
        "prerender_components_figure": (
            glimpses, rng.rand(B, N, 1, OH, OH), rng.rand(B, N, 1, OH, OH),
            g["z_where"], g["z_pres"], g["z_depth"], g["x"]),
        "attr_stats_figure": (g["z_attr"],),
        "attr_stats_figure_prefix": (g["z_attr"], 1, "grad "),
        "decoder_grad_figure": (rng.randn(B, N, 2, OH, OH) * 1e-4,
                                (GH, GW)),
    }[name]


@pytest.mark.parametrize("name", [
    "render_analysis_figure", "glimpse_grid_figure",
    "prerender_components_figure", "attr_stats_figure",
    "attr_stats_figure_prefix", "decoder_grad_figure"])
def test_figures_equal_the_jax_packages(name):
    fn = name.replace("_prefix", "")
    args = figure_args(name)
    got, want = (drawn(getattr(m, fn)(*args)) for m in (viz, jviz))
    assert len(got) == len(want) and len(got) >= 1
    for (gt, gi, gp), (wt, wi, wp) in zip(got, want):
        assert gt == wt
        assert len(gi) == len(wi)
        for a, b in zip(gi, wi):
            np.testing.assert_array_equal(a, b)
        assert gp == wp
    assert any(images for _, images, _ in got)


def test_mosaic_and_heat_equal_the_jax_packages():
    tiles = np.random.RandomState(5).rand(2, 3, 4, 5)
    np.testing.assert_array_equal(viz._mosaic(tiles), jviz._mosaic(tiles))
    figs = [plt.subplots(1, 1) for _ in range(2)]
    for m, (fig, ax) in zip((viz, jviz), figs):
        m._heat(ax, fig, "t", tiles[0, 0], "spring")
    got, want = (drawn(f) for f, _ in figs)
    assert [(a, [i.tolist() for i in b]) for a, b, _ in got] == \
        [(a, [i.tolist() for i in b]) for a, b, _ in want]


class Recorder:
    """A TensorBoard writer stand-in recording what ``MetricWriter`` writes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(tag=None, value=None, step=None, *a, **kw):
            self.calls.append((name, tag, step))
            if name == "add_figure":
                plt.close(value)
        return record


# the tags the JAX package's test_train_loop_writes_full_debug_surface
# checks, and the image pair and latent statistics it also writes
FIGURE_TAGS = ("renderer_analysis", "debug_cropped_input_images",
               "z_attr/heatmap", "grad_visualization/decoder_out",
               "grad_visualization/z_attr", "analysis/renderer")


@pytest.mark.parametrize("sink", ["files", "tensorboard"])
def test_train_writes_the_full_debug_surface(tmp_path, monkeypatch, sink):
    """3 train() steps with images and figures every 2 steps: every tag of
    the JAX package's debug surface, at steps 0 and 2; the training stream
    is the one a run without logging draws."""
    rec = Recorder()
    monkeypatch.setattr(tlogging, "_try_tb_writer",
                        lambda d: rec if sink == "tensorboard" else None)
    run = dict(steps=3, checkpoint_every=0, log_flush_every=1,
               verbose=False, digits="font", device="cpu")
    cfg = tcfg(JCFG)
    open_figures = len(plt.get_fignums())
    state = ttrain.train(cfg, logdir=str(tmp_path / "a"), log_images_every=2,
                         log_figures_every=2, **run)
    assert len(plt.get_fignums()) == open_figures  # every figure closed
    plain = ttrain.train(cfg, logdir=str(tmp_path / "b"), **run)
    for p, q in zip(state.model.parameters(), plain.model.parameters()):
        assert torch.equal(p, q)
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    stats = [r["step"] for r in rows if "z_presence/mean" in r]
    assert stats == [0, 2] and all("z_depth/max" in r for r in rows
                                   if "z_presence/mean" in r)
    if sink == "files":
        figs = {p.name for p in (tmp_path / "a" / "figures").iterdir()}
        for step in (0, 2):
            for tag in FIGURE_TAGS:
                assert f"{tag.replace('/', '_')}_{step}.png" in figs
        return
    calls = {(n, tag, step) for n, tag, step in rec.calls}
    for step in (0, 2):
        assert ("add_image", "SPAIR input_output", step) in calls
        for tag in FIGURE_TAGS:
            assert ("add_figure", tag, step) in calls
        for axis in "xywh":
            assert ("add_histogram", f"box/{axis}", step) in calls


def test_eval_figure_writes_its_png(tmp_path, monkeypatch):
    """eval --figure: the renderer-analysis panel of the evaluated batch."""
    monkeypatch.setattr(tlogging, "_try_tb_writer", lambda d: None)
    logdir = str(tmp_path / "run")
    ttrain.train(tcfg(JCFG), steps=1, logdir=logdir, checkpoint_every=1,
                 verbose=False, digits="font", device="cpu")
    out = tmp_path / "fig.png"
    drawn_args = []
    panel = viz.render_analysis_figure

    def spy(*a, **kw):
        drawn_args.append(a)
        return panel(*a, **kw)
    monkeypatch.setattr(viz, "render_analysis_figure", spy)
    teval.main(["--logdir", logdir, "--figure", str(out), "--batches", "1",
                "--digits", "font", "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 0
    x, recon, z_where, z_pres, z_depth = drawn_args[0]
    assert x.shape == recon.shape == (2, 1, 48, 48)
    assert z_where.shape == (2, 4, GH, GW) and z_pres.shape == (2, 1, GH, GW)
    assert plt.imread(str(out)).ndim == 3


def test_debug_nans_raises_at_the_first_nan():
    try:
        debug.enable_debug_nans(True)
        debug.enable_debug_nans(True)  # a second push is a no-op
        a = torch.tensor([1.0, -1.0], requires_grad=True)
        torch.exp(a)                   # no NaN: silent
        with pytest.raises(FloatingPointError, match="nan"):
            torch.sqrt(a)
        b = torch.tensor([0.0], requires_grad=True)
        y = torch.sqrt(b) * 0.0        # forward finite, backward 0 * inf
        with pytest.raises(FloatingPointError, match="nan"):
            y.backward()
    finally:
        debug.enable_debug_nans(False)


def test_debug_nans_off_is_silent_and_leaves_no_mode():
    debug.enable_debug_nans(True)
    debug.enable_debug_nans(False)
    debug.enable_debug_nans(False)
    assert torch._C._len_torch_dispatch_stack() == 0
    assert bool(torch.isnan(torch.sqrt(torch.tensor(-1.0))))


def test_logistic_noise_is_sample_noises_draw_bit_for_bit():
    device = "cpu"
    cfg = tcfg(JCFG)
    got = sample_noise(torch.Generator(device).manual_seed(9), 3, (4, 4), cfg)
    gen = torch.Generator(device).manual_seed(9)
    for name in ("box", "attr", "depth"):  # the draws before presence
        torch.randn(got[name].shape, generator=gen, device=device)
    u = torch.rand(got["pres_noise"].shape, generator=gen, device=device)
    want = torch.log(u + 1e-9) - torch.log(1.0 - u + 1e-9)
    assert torch.equal(got["pres_noise"], want)
    again = logistic_noise(torch.Generator(device).manual_seed(4), (5, 7))
    u = torch.rand((5, 7), generator=torch.Generator(device).manual_seed(4))
    assert torch.equal(again, torch.log(u + 1e-9) - torch.log(1.0 - u + 1e-9))


def test_without_matplotlib_images_log_and_figures_raise(tmp_path):
    """As on the card's machine: with matplotlib missing, utils/viz.py
    imports, image logging trains, and figure logging raises matplotlib's
    ModuleNotFoundError (uncaught, as in the JAX package)."""
    code = f"""
import sys
sys.modules["matplotlib"] = None  # an import of it raises
from spair_pytorch_tpu_torch.config import config_from_json
from spair_pytorch_tpu_torch.train import train
from spair_pytorch_tpu_torch.utils import viz
cfg = config_from_json({config_to_json(tcfg(JCFG))!r})
run = dict(steps=1, checkpoint_every=0, verbose=False, digits="font",
           device="cpu")
train(cfg, logdir={str(tmp_path / "images")!r}, log_images_every=1, **run)
try:
    train(cfg, logdir={str(tmp_path / "figures")!r}, log_figures_every=1,
          **run)
except ModuleNotFoundError as e:
    print("raised", e.name)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "raised matplotlib"


def test_quickstart_example_runs_on_the_cpu(tmp_path, monkeypatch):
    """The port's quickstart: train small_config, evaluate, write the
    analysis panel (one step here)."""
    from spair_pytorch_tpu_torch.examples import quickstart
    monkeypatch.setattr(tlogging, "_try_tb_writer", lambda d: None)
    result = quickstart.main(["--steps", "1", "--out", str(tmp_path),
                              "--device", "cpu"])
    assert "count_exact_accuracy" in result
    assert (tmp_path / "analysis.png").stat().st_size > 0
