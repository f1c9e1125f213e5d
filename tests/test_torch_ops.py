"""The port's ops against the JAX package's, on the same numpy inputs.

Tolerance: f32 forward relative error 1e-4, measured as bench.py measures
its kernel gate, max |port - jax| / max(1, max |jax|); both sides compute in
full f32 (tests/conftest.py sets JAX's matmul precision to 'highest')."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.config import COUNT_PRIOR, TRAINING_WHEEL
from spair_pytorch_tpu.models import init_params as jax_init_params
from spair_pytorch_tpu.ops import backbone as jbb
from spair_pytorch_tpu.ops import math as jm
from spair_pytorch_tpu.ops import mlp as jmlp
from spair_pytorch_tpu.ops import stn as jstn
from spair_pytorch_tpu.ops.schedules import exponential_decay as jdecay
from spair_pytorch_tpu.utils.interop import to_torch_state_dict
from spair_pytorch_tpu_torch.models import init_params
from spair_pytorch_tpu_torch.ops import backbone as tbb
from spair_pytorch_tpu_torch.ops import math as tm
from spair_pytorch_tpu_torch.ops import stn as tstn
from spair_pytorch_tpu_torch.ops.mlp import MLP
from spair_pytorch_tpu_torch.ops.schedules import exponential_decay
from spair_pytorch_tpu_torch.utils.interop import (load_jax_params,
                                                   state_dict_from_jax)
from tests.test_model import tiny_config

F32_REL = 1e-4


def rel_err(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def assert_close(got, want, rel=F32_REL):
    err = rel_err(got, want)
    assert err < rel, f"relative error {err:.3e} >= {rel:g}"


def t(a):
    """numpy/jax array -> torch tensor (a writable copy)."""
    return torch.from_numpy(np.array(a))


def jax_params_np(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(seed), cfg))


def ported_params(cfg, params_np):
    return load_jax_params(init_params(cfg), params_np)


# ---------------------------------------------------------------- math

RNG = np.random.RandomState(0)
X = (RNG.randn(3, 4, 10) * 6).astype("f")
P = RNG.rand(3, 4, 10).astype("f")
P[0, 0, :3] = (0.0, 1.0, 1.0 - 1e-8)


@pytest.mark.parametrize("name,jfn,tfn,args", [
    ("latent_mean", lambda a: jm.latent_to_mean_std(a)[0],
     lambda a: tm.latent_to_mean_std(a)[0], (X,)),
    ("latent_std", lambda a: jm.latent_to_mean_std(a)[1],
     lambda a: tm.latent_to_mean_std(a)[1], (X,)),
    ("clamped_sigmoid", jm.clamped_sigmoid, tm.clamped_sigmoid, (X * 3,)),
    ("analytical_sigmoid", lambda a: jm.clamped_sigmoid(a, True),
     lambda a: tm.clamped_sigmoid(a, True), (X * 30,)),
    ("safe_log", jm.safe_log, tm.safe_log, (P,)),
    ("gaussian_kl", jm.gaussian_kl, tm.gaussian_kl,
     (X, P + 0.1, X[::-1].copy(), P[::-1].copy() + 0.2)),
    ("bernoulli_kl", jm.bernoulli_kl, tm.bernoulli_kl, (P, P[::-1].copy())),
    ("bce_sum", jm.binary_cross_entropy_sum, tm.binary_cross_entropy_sum,
     (P, np.round(P[::-1]))),
])
def test_math_matches_jax(name, jfn, tfn, args):
    want = np.asarray(jfn(*map(jnp.asarray, args)))
    got = tfn(*map(t, args))
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want)


@pytest.mark.parametrize("sched", [TRAINING_WHEEL, COUNT_PRIOR],
                         ids=["training_wheel", "count_prior"])
@pytest.mark.parametrize("step", [0, 999, 1000, 1500, 50000])
def test_exponential_decay_matches_jax(sched, step):
    want = float(jdecay(step, sched))
    got = exponential_decay(step, sched)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))


def test_training_wheel_cliff():
    assert float(exponential_decay(999, TRAINING_WHEEL)) == 1.0
    assert float(exponential_decay(1000, TRAINING_WHEEL)) == 0.0


# ------------------------------------------------------------- backbone

@pytest.mark.parametrize("hw,topo", [
    ((128, 128), None), ((48, 48), None), ((100, 70), ((8, 3, 2), (8, 4, 2))),
])
def test_grid_geometry_matches_jax(hw, topo):
    from spair_pytorch_tpu.config import BACKBONE_TOPOLOGY
    topo = topo or BACKBONE_TOPOLOGY
    assert tbb.grid_geometry(hw, topo) == jbb.grid_geometry(hw, topo)


def test_backbone_matches_jax():
    cfg = tiny_config()
    pnp = jax_params_np(cfg)
    model = ported_params(cfg, pnp)
    x = np.random.RandomState(1).rand(2, 1, 48, 48).astype("f")
    pads = jbb.grid_geometry((48, 48), cfg.backbone_topology)[0]
    want = jbb.apply_backbone(pnp["backbone"], jnp.asarray(x),
                              cfg.backbone_topology, pads)
    with torch.no_grad():
        got = model.backbone(t(x))
    assert tuple(got.shape) == (2, 4, 4, cfg.n_backbone_features)
    assert_close(got, want)


def test_init_matches_reference_layout():
    """Fresh port params have exactly the converted dict's keys and shapes,
    the torch fan-in bounds, and a sigmoid-squashed edge element."""
    cfg = tiny_config()
    sd_ref = state_dict_from_jax(jax_params_np(cfg))
    model = init_params(cfg, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert sorted(sd) == sorted(sd_ref)
    for k, v in sd.items():
        assert tuple(v.shape) == sd_ref[k].shape, k
    w = sd["box_network.body.dense0.weight"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[1])
    edge = sd["virtual_edge_element"]
    a = cfg.n_attributes
    squashed = torch.cat([edge[:4], edge[4 + a:]])
    assert bool(((squashed > 0) & (squashed < 1)).all())
    again = init_params(cfg, torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ------------------------------------------------------------------ mlp

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("heads", [(6,), (8, 5)])
def test_mlp_matches_jax(heads, packed):
    p = jmlp.init_mlp(jax.random.PRNGKey(3), 7, (16, 12), heads)
    x = np.random.RandomState(2).randn(5, 3, 7).astype("f")
    want = jmlp.apply_mlp(p, jnp.asarray(x), packed=packed)
    model = MLP(7, (16, 12), heads)
    trunk = model.body if model.multi else model
    with torch.no_grad():
        for i, layer in enumerate(p["trunk"]):
            getattr(trunk, f"dense{i}").weight.copy_(t(layer["w"]).T)
            getattr(trunk, f"dense{i}").bias.copy_(t(layer["b"]))
        for head, lin in zip(p["heads"], model.heads()):
            lin.weight.copy_(t(head["w"]).T)
            lin.bias.copy_(t(head["b"]))
        got = model(t(x), packed=packed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


# ------------------------------------------------------------------ stn

BOXES = np.stack([RNG.uniform(0.05, 0.95, (2, 5)),
                  RNG.uniform(0.05, 0.95, (2, 5)),
                  RNG.uniform(0.05, 0.6, (2, 5)),
                  RNG.uniform(0.05, 0.6, (2, 5))], -1).astype("f")


@pytest.mark.parametrize("fn", ["crop_weights", "paste_weights"])
def test_stn_weights_match_jax(fn):
    want = getattr(jstn, fn)(jnp.asarray(BOXES), (14, 12), (48, 40))
    got = getattr(tstn, fn)(t(BOXES), (14, 12), (48, 40))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_crop_glimpses_matches_jax():
    img = np.random.RandomState(4).rand(2, 3, 48, 40).astype("f")
    want = jstn.crop_glimpses(jnp.asarray(img), jnp.asarray(BOXES), (14, 12))
    got = tstn.crop_glimpses(t(img), t(BOXES), (14, 12))
    assert tuple(got.shape) == (2, 5, 3, 14, 12)
    assert_close(got, want)


def test_crop_matches_grid_sample():
    """Crop semantics are grid_sample(align_corners=True, border)."""
    import torch.nn.functional as F
    img = torch.rand(2, 1, 48, 40, generator=torch.Generator().manual_seed(5))
    boxes = t(BOXES)
    got = tstn.crop_glimpses(img, boxes, (14, 12))
    xt, yt, xs, ys = boxes.unbind(-1)
    theta = torch.zeros(2, 5, 2, 3)
    theta[..., 0, 0], theta[..., 0, 2] = xs, 2 * xt - 1
    theta[..., 1, 1], theta[..., 1, 2] = ys, 2 * yt - 1
    grid = F.affine_grid(theta.reshape(10, 2, 3), (10, 1, 14, 12),
                         align_corners=True)
    want = F.grid_sample(img.repeat_interleave(5, 0), grid,
                         padding_mode="border", align_corners=True)
    assert_close(got.reshape(10, 1, 14, 12), want.numpy())


# -------------------------------------------------------------- interop

def test_state_dict_from_jax_equals_to_torch_state_dict():
    cfg = tiny_config(n_object_slots=2)
    pnp = jax_params_np(cfg, seed=4)
    ours, ref = state_dict_from_jax(pnp), to_torch_state_dict(pnp)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k])
    model = ported_params(cfg, pnp)  # load_state_dict(strict=True)
    np.testing.assert_array_equal(
        model.backbone.net.conv_0.weight.detach().numpy(),
        ref["backbone.net.conv_0.weight"])


# ------------------------------------------------------------ jax-free

def test_port_imports_without_jax():
    code = ("import sys, spair_pytorch_tpu_torch, "
            "spair_pytorch_tpu_torch.serve, "
            "spair_pytorch_tpu_torch.models.spair, "
            "spair_pytorch_tpu_torch.ops.kernels.composite, "
            "spair_pytorch_tpu_torch.parallel, spair_pytorch_tpu_torch.data, "
            "spair_pytorch_tpu_torch.utils.interop, "
            "spair_pytorch_tpu_torch.parallel.train_step, "
            "spair_pytorch_tpu_torch.metrics, "
            "spair_pytorch_tpu_torch.utils.debug\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.'))\n"
            "assert not bad, bad\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
