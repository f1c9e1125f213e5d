"""The port's band-clipped compositor (K3/K4's plain versions, the autograd
Function, render 'pallas_v3') against the JAX package's
``composite_pallas_v3``, which runs in interpret mode on the CPU, as the JAX
package's own tests run it.

Inputs follow ``tests/test_pallas_composite.py::make_banded_inputs``: B=2,
a 4x4 grid of 12-px cells, a 48x48 canvas, 14x14 glimpses, boxes from the
model's parameterization. With the model's bounds (centres in the cell +
[-0.5, 1.5], scales <= 0.5) the band is the whole canvas; the 'banded'
bounds (centres in the cell + [0, 1], scales <= 0.25) give bands of 40 of
the 48 rows, so the clip is exercised. Tolerances, as max |port - jax| /
max(1, max |jax|): f32 forward 1e-4, gradients 1e-3; bf16 glimpses against
the f32 truth 3e-2 and 6e-2. The CUDA kernels themselves are held against
these plain versions on a card (tests/test_torch_kernel_gpu.py)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.ops.pallas.composite_v3 import band_geometry as jband
from spair_pytorch_tpu.ops.pallas.composite_v3 import composite_pallas_v3
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V
from tests.test_model import tiny_config
from tests.test_torch_ops import (jax_params_np, ported_params, rel_err, t,
                                  tcfg)

F32_REL, GRAD_REL, BF16_REL, BF16_GRAD_REL = 1e-4, 1e-3, 3e-2, 6e-2
HW, CELL, GRID = (48, 48), 12, (4, 4)
BOUNDS = {"model": (-0.5, 1.5, 0.5), "banded": (0.0, 1.0, 0.25)}
jrender = importlib.import_module("spair_pytorch_tpu.models.render")
trender = importlib.import_module("spair_pytorch_tpu_torch.models.render")


def banded_inputs(seed, bounds, c=1, out_of_band=False):
    """(color, alpha, imp, boxes) as numpy, boxes within each cell's
    bounds; with ``out_of_band`` object 0 (grid row 0) sits near the bottom
    of the canvas, past its row's band."""
    min_cy, max_cy, max_ys = bounds
    rng = np.random.RandomState(seed)
    b, (gh, gw), n = 2, GRID, GRID[0] * GRID[1]
    col = rng.rand(b, n, c, 14, 14).astype("f")
    alp = rng.rand(b, n, 1, 14, 14).astype("f")
    imp = (rng.rand(b, n, 1, 14, 14) + 0.01).astype("f")
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    yt = (hh.ravel()[None] + rng.uniform(min_cy, max_cy, (b, n))) * CELL / 48
    xt = (ww.ravel()[None] + rng.uniform(min_cy, max_cy, (b, n))) * CELL / 48
    scale = rng.uniform(0.05, max_ys, (b, n, 2))
    boxes = np.stack([xt, yt, scale[..., 0], scale[..., 1]], -1).astype("f")
    if out_of_band:
        boxes[:, 0] = (0.3, 0.88, 0.2, 0.2)
    return col, alp, imp, boxes


def jax_vjp(arrays, bounds, chunk_k, dnum, dden):
    """((num, den), (dcolor, dalpha, dimp, dbox)) of the JAX kernel."""
    def f(*a):
        return composite_pallas_v3(*a, HW, CELL, GRID, bounds, chunk_k)
    out, vjp = jax.vjp(f, *map(jnp.asarray, arrays))
    grads = vjp((jnp.asarray(dnum), jnp.asarray(dden)))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def cotangents(seed, c=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, c, *HW).astype("f"), rng.randn(2, 1, *HW).astype("f"))


@pytest.mark.parametrize("args", [
    ((128, 128), 12, -0.5, 1.5, 0.375, 28, 11),   # paper128
    ((48, 48), 12, -0.5, 1.5, 0.5, 14, 4),        # the tiny model: no clip
    ((48, 48), 12, 0.0, 1.0, 0.25, 14, 4),        # banded
    ((128, 128), 8, -0.5, 1.5, 0.375, 28, 16),    # the fine 8-px grid
])
def test_band_geometry_matches_jax(args):
    band, starts = V.band_geometry(*args)
    jb, js = jband(*args)
    assert band == jb and starts.dtype == js.dtype
    np.testing.assert_array_equal(starts, js)
    if args[0] == (128, 128) and args[1] == 12:
        assert band == 88 and list(starts) == [0, 0, 0, 0, 8, 24, 32, 40,
                                               40, 40, 40]


@pytest.mark.parametrize("case", ["model", "banded", "out_of_band"])
@pytest.mark.parametrize("chunk_k", [1, 2, 4])
def test_plain_and_vjp_match_jax(chunk_k, case):
    bounds = BOUNDS["model" if case == "model" else "banded"]
    arrays = banded_inputs(chunk_k, bounds, out_of_band=case == "out_of_band")
    dnum, dden = cotangents(10 + chunk_k)
    (num_j, den_j), grads_j = jax_vjp(arrays, bounds, chunk_k, dnum, dden)
    tensors = [t(a) for a in arrays]
    num, den = V.composite_v3_plain(*tensors, HW, CELL, GRID, bounds, chunk_k)
    fwd_err = max(rel_err(num, num_j), rel_err(den, den_j))
    assert fwd_err < F32_REL
    np.testing.assert_allclose(den.min(), 16e-9, rtol=1e-6)  # N * 1e-9
    grads = V.composite_v3_backward_plain(*tensors, HW, CELL, GRID, bounds,
                                          t(dnum), t(dden), chunk_k)
    grad_err = max(rel_err(g, w) for g, w in zip(grads, grads_j))
    assert grad_err < GRAD_REL
    # the readings PERF.md records (shown with pytest -s)
    print(f"chunk_k={chunk_k} {case}: forward {fwd_err:.2e}, "
          f"gradients {grad_err:.2e}")
    if case == "out_of_band":
        # the clip matters: the unclipped compositor pastes object 0 onto
        # rows past its band
        band, starts = V.band_geometry(HW, CELL, *bounds, 14, GRID[0])
        assert starts[0] + band < HW[0]
        full, _ = K.composite_plain(*tensors, HW)
        assert rel_err(full, num_j) > 10 * F32_REL


def test_bf16_glimpses_against_f32_truth():
    bounds = BOUNDS["banded"]
    arrays = banded_inputs(5, bounds, c=3)
    dnum, dden = cotangents(6, c=3)
    (num_j, den_j), grads_j = jax_vjp(arrays, bounds, 2, dnum, dden)
    bf = [t(a).to(torch.bfloat16) for a in arrays[:3]]
    num, den = V.composite_v3_forward(*bf, t(arrays[3]), HW, CELL, GRID,
                                      bounds)
    assert num.dtype == torch.float32
    assert rel_err(num, num_j) < BF16_REL and rel_err(den, den_j) < BF16_REL
    grads = V.composite_v3_backward(*bf, t(arrays[3]), HW, CELL, GRID,
                                    bounds, t(dnum), t(dden))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w in zip(grads, grads_j):
        assert rel_err(g.float(), w) < BF16_GRAD_REL


def test_all_gated():
    """Zeroed glimpses, as render's gate leaves them: num == 0 and den ==
    N * 1e-9; the VJP gives dbox, dcolor and dalpha exactly 0 and, as the
    JAX kernel does, an importance gradient py^T dden px, which the gate's
    mask zeroes on its way upstream."""
    bounds = BOUNDS["banded"]
    col, alp, imp, boxes = banded_inputs(7, bounds)
    zeros = [np.zeros_like(a) for a in (col, alp, imp)]
    dnum, dden = cotangents(8)
    (num_j, den_j), grads_j = jax_vjp((*zeros, boxes), bounds, 4, dnum, dden)
    num, den = V.composite_v3_forward(*map(t, zeros), t(boxes), HW, CELL,
                                      GRID, bounds)
    assert bool((num == 0).all()) and float(np.abs(num_j).max()) == 0.0
    np.testing.assert_allclose(den.numpy(), 16e-9, rtol=1e-6)
    grads = V.composite_v3_backward(*map(t, zeros), t(boxes), HW, CELL, GRID,
                                    bounds, t(dnum), t(dden))
    for i in (0, 1, 3):
        assert bool((grads[i] == 0).all()) and not np.abs(grads_j[i]).any()
    assert float(grads[2].abs().max()) > 0
    assert rel_err(grads[2], grads_j[2]) < GRAD_REL

    gate = torch.zeros(2, 16, 1, 1, 1)
    leaves = [t(a).requires_grad_(True) for a in (col, alp, imp, boxes)]
    out = V.composite_v3(*(v * gate for v in leaves[:3]), leaves[3], HW, CELL,
                         GRID, bounds)
    torch.autograd.backward(out, (t(dnum), t(dden)))
    assert all(bool((v.grad == 0).all()) for v in leaves)


def test_function_matches_autograd_through_plain():
    bounds = BOUNDS["banded"]
    arrays = banded_inputs(9, bounds, out_of_band=True)
    dnum, dden = map(t, cotangents(11))

    def grads(fn):
        leaves = [t(a).requires_grad_(True) for a in arrays]
        out = fn(*leaves, HW, CELL, GRID, bounds, 2)
        torch.autograd.backward(out, (dnum, dden))
        return [v.grad for v in leaves]

    before = (V.composite_v3_forward.launches,
              V.composite_v3_backward.launches)
    got, want = grads(V.composite_v3), grads(V.composite_v3_plain)
    assert (V.composite_v3_forward.launches,
            V.composite_v3_backward.launches) == before  # CPU: no kernel
    for g, w in zip(got, want):
        assert rel_err(g, w.numpy()) < GRAD_REL
    with pytest.raises(ValueError, match="chunk_k"):
        V.composite_v3_forward(*map(t, arrays), HW, CELL, GRID, bounds, 0)
    with pytest.raises(ValueError, match="grid"):
        V.composite_v3_forward(*map(t, arrays), HW, CELL, (4, 3), bounds)


@pytest.mark.parametrize("gate", [0.0, 0.3], ids=["ungated", "gated"])
def test_render_pallas_v3_matches_jax_and_xla(gate):
    """render with 'pallas_v3' on model-generated boxes, against the JAX
    package's render with 'pallas_v3' and the port's 'xla': values and, for
    the port, every decoder gradient."""
    jcfg = tiny_config(render_backend="pallas_v3", render_chunk_k=2,
                       pres_gate_threshold=gate)
    pnp = jax_params_np(jcfg)
    model = ported_params(jcfg, pnp)
    rng = np.random.RandomState(5)
    b, gh, gw = 2, 4, 4
    z_attr = (rng.randn(b, gh, gw, jcfg.n_attributes) * 0.3).astype("f")
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    yt = (hh[None] + rng.uniform(-0.4, 1.4, (b, gh, gw))) * 12 / 48
    xt = (ww[None] + rng.uniform(-0.4, 1.4, (b, gh, gw))) * 12 / 48
    sc = rng.uniform(0.1, 0.4, (b, gh, gw, 2))
    z_where = np.stack([xt, yt, sc[..., 0], sc[..., 1]], -1).astype("f")
    z_depth = np.full((b, gh, gw, 1), 2.0, "f")
    z_pres = rng.uniform(0.0, 1.0, (b, gh, gw, 1)).astype("f")
    lat = (z_attr, z_where, z_depth, z_pres)
    want = np.asarray(jrender.render(pnp, jcfg, *map(jnp.asarray, lat), HW))

    def port(backend):
        model.zero_grad(set_to_none=True)
        cfg = tcfg(dataclasses.replace(jcfg, render_backend=backend))
        out = trender.render(model, cfg, *map(t, lat), HW)
        (out ** 2).sum().backward()
        return out.detach(), {k: p.grad.clone() for k, p in
                              model.object_decoder.named_parameters()}

    got, g_v3 = port("pallas_v3")
    ref, g_xla = port("xla")
    assert rel_err(got, want) < F32_REL and rel_err(got, ref.numpy()) < F32_REL
    for k in g_xla:
        assert rel_err(g_v3[k], g_xla[k].numpy()) < GRAD_REL, k
