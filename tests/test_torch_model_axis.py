"""The mesh's 'model' axis (``parallel/mesh.py::make_mesh(n_model=M)``,
``parallel/constraints.py``, the sharded inference of ``models/spair.py``)
on the CPU with gloo.

The ranks' layout against the JAX mesh's ``reshape(n_data, n_model)``; the
cell blocks and their padding; the lane rule of the scans; then, in one
launch of four ranks on a (data=2, model=2) mesh, the independent and the
wavefront step (each rank's summed gradients, its parameters after Adam
and the reduced metrics) and the eval step over the mesh against one
process of the global batch within ``REL`` (the ranks reduce in another
order than one batch does), every rank's parameters equal bit for bit,
and a second step of each under the host-read guard; and in one launch of
three ranks on a (data=1, model=3) mesh, independent mode with padded
blocks of 6/6/4 cells and the wavefront, whose K = 2 lanes 3 does not
divide, so they are replicated. The one-process step is held against the
JAX package by the other tests."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from spair_pytorch_tpu_torch.config import PRESETS, config_to_json
from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
from spair_pytorch_tpu_torch.models.latents import geometry, init_params
from spair_pytorch_tpu_torch.models.spair import inference_schedule
from spair_pytorch_tpu_torch.parallel import make_eval_step
from spair_pytorch_tpu_torch.parallel.constraints import (block, lanes_split,
                                                          shard_cells)
from spair_pytorch_tpu_torch.parallel.mesh import mesh_coords
from spair_pytorch_tpu_torch.train import data_config
from tests.test_torch_parallel import (CFG, REL,
                                       assert_ranks_equal_one_process,
                                       launch, plain_step)

MODES = ("independent", "wavefront")
EVAL_STEP, EVAL_SEED, X_SEED = 1500, 11, 7  # the eval step's inputs

WORKER = """
import sys, torch
torch.set_num_threads(1)
from spair_pytorch_tpu_torch.config import config_from_json
from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
from spair_pytorch_tpu_torch.models.latents import init_params
from spair_pytorch_tpu_torch.parallel import constraints
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_eval_step, make_train_step)
from spair_pytorch_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                   shard_batch)
from spair_pytorch_tpu_torch.train import data_config
out, n_model, guard, x_seed, eval_step, eval_seed = sys.argv[1:7]
gathers, real = [0], constraints.gather_cells


def counted(*a, **kw):
    gathers[0] += 1
    return real(*a, **kw)


constraints.gather_cells = counted
mesh = make_mesh("cpu", n_model=int(n_model))
saved = {"coords": (mesh.data_rank, mesh.model_rank)}
try:
    for text in sys.argv[7:]:
        cfg = config_from_json(text)
        dcfg = data_config(cfg)
        bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
        state = replicate(mesh, create_train_state(cfg, device="cpu"))
        step = make_train_step(cfg, mesh, datagen=(dcfg, bank))
        gathers[0] = 0
        state, metrics = step(state)
        got = {"params": [p.detach().clone()
                          for p in state.model.parameters()],
               "grads": [p.grad.clone() for p in state.model.parameters()],
               "metrics": metrics, "gathers": gathers[0]}
        if guard == "1":
            from tests.test_torch_captured_step import (no_host_reads,
                                                        step_counts)
            with no_host_reads(step_counts(state)):
                _, again = step(state)
            got["guarded"] = all(bool(torch.isfinite(v)) for v in
                                 again.values())
        saved[cfg.inference_mode] = got
        if cfg.inference_mode == "wavefront" and guard == "1":
            x = generate_batch(torch.Generator().manual_seed(int(x_seed)),
                               bank, cfg.batch_size, dcfg)[0]
            loss, aux = make_eval_step(cfg, mesh)(
                init_params(cfg, device="cpu"), shard_batch(mesh, (x,))[0],
                int(eval_step), torch.Generator().manual_seed(int(eval_seed)))
            saved["eval"] = (loss, aux)
finally:
    mesh.close()
torch.save(saved, out)
"""


def with_mode(mode):
    return dataclasses.replace(CFG, inference_mode=mode)


def mesh_run(tmp_path_factory, world, n_model, guard):
    cfgs = [config_to_json(with_mode(mode)) for mode in MODES]
    return launch(tmp_path_factory.mktemp(f"mesh{world}x{n_model}"), WORKER,
                  world, n_model, int(guard), X_SEED, EVAL_STEP, EVAL_SEED,
                  *cfgs, timeout=300)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """What each of four ranks on a (data=2, model=2) mesh saved."""
    return mesh_run(tmp_path_factory, 4, 2, True)


@pytest.fixture(scope="module")
def mesh13(tmp_path_factory):
    """What each of three ranks on a (data=1, model=3) mesh saved."""
    return mesh_run(tmp_path_factory, 3, 3, False)


@pytest.fixture(scope="module")
def one_process():
    """The one-process step of the global batch, for each mode."""
    return {mode: plain_step(with_mode(mode)) for mode in MODES}


@pytest.mark.parametrize("world,n_model", [(1, 1), (4, 1), (4, 2), (4, 4),
                                           (8, 2), (6, 3), (8, 4)])
def test_mesh_coords_match_the_jax_layout(world, n_model):
    """The JAX mesh's devices[:n_data * n_model].reshape(n_data, n_model)
    (``spair_pytorch_tpu/parallel/mesh.py``): rank r sits at the (data,
    model) position of device r."""
    grid = np.arange(world).reshape(world // n_model, n_model)
    for rank in range(world):
        want = tuple(int(i) for i in np.argwhere(grid == rank)[0])
        assert mesh_coords(rank, world, n_model) == want


@pytest.mark.parametrize("world,n_model", [(4, 3), (2, 4), (4, 0)])
def test_mesh_coords_refuse_an_uneven_model_axis(world, n_model):
    with pytest.raises(ValueError, match="does not divide"):
        mesh_coords(0, world, n_model)


@pytest.mark.parametrize("n,m,sizes", [(16, 2, [8, 8]), (16, 3, [6, 6, 4]),
                                       (121, 4, [31, 31, 31, 28]),
                                       (4, 3, [2, 2, 0])])
def test_cell_blocks_pad_by_clamping(n, m, sizes):
    """Each rank's block is ceil(n / m) cells, the last ones padded with
    cell n - 1 (a 0-size block all padding); the backward writes the real
    rows' cotangent into zeros and drops the padded rows'."""
    t = torch.randn(2, n, 3, dtype=torch.float64, requires_grad=True)
    size = -(-n // m)
    got_sizes, total = [], torch.zeros_like(t)
    for rank in range(m):
        mesh = types.SimpleNamespace(n_model=m, model_rank=rank)
        start, stop, width = block(n, mesh)
        got_sizes.append(stop - start)
        cells = torch.arange(rank * size, (rank + 1) * size).clamp(max=n - 1)
        part = shard_cells(t, mesh)
        assert width == size and part.shape == (2, size, 3)
        assert torch.equal(part, t[:, cells])
        cot = torch.randn_like(part)
        grad, = torch.autograd.grad(part, t, cot)
        want = torch.zeros_like(t)
        want[:, start:stop] = cot[:, :stop - start]
        assert torch.equal(grad, want)
        total += grad
        hw = shard_cells(torch.arange(n), mesh, dim=0)
        assert torch.equal(hw, cells)
    assert got_sizes == sizes
    assert torch.count_nonzero(total) == total.numel()


def test_lanes_split_where_the_model_axis_divides_them():
    """JAX's rule (``spair_pytorch_tpu/models/spair.py``: K % n_model):
    paper128's wavefront (K = 6) splits over 2 and 3 ranks and not over 4;
    raster (K = 1) never splits; rowscan (K = 11) not over 2."""
    def lanes(mode):
        return inference_schedule(mode, 11, 11)["lanes"]

    def mesh(m):
        return types.SimpleNamespace(n_model=m)
    assert (lanes("wavefront"), lanes("raster"), lanes("rowscan")) == (6, 1,
                                                                        11)
    assert [lanes_split(6, mesh(m)) for m in (1, 2, 3, 4)] == [False, True,
                                                               True, False]
    assert not any(lanes_split(1, mesh(m)) for m in (2, 3, 4))
    assert not lanes_split(11, mesh(2)) and lanes_split(11, mesh(11))
    assert not lanes_split(6, None)


def test_ranks_sit_where_the_jax_mesh_puts_them(mesh22, mesh13):
    assert [r["coords"] for r in mesh22] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["coords"] for r in mesh13] == [(0, 0), (0, 1), (0, 2)]


@pytest.mark.parametrize("mode", MODES)
def test_data_model_mesh_step_equals_one_process(mesh22, one_process, mode):
    """(data=2, model=2): each data rank trains on 2 of the 4 scenes, the
    cells (independent: blocks of 8 of 16) or each front's K = 2 lanes
    (wavefront: one each) split over its model group, one gather a block;
    every rank's gradients, parameters and metrics are the one-process
    step's within REL, and all four ranks' parameters are equal."""
    want, want_m, _ = one_process[mode]
    ranks = [r[mode] for r in mesh22]
    fronts = inference_schedule(mode, 4, 4)["steps"] if mode != \
        "independent" else 1
    assert [r["gathers"] for r in ranks] == [fronts] * 4
    assert_ranks_equal_one_process(ranks, want, want_m)


@pytest.mark.parametrize("mode", MODES)
def test_model_only_mesh_step_equals_one_process(mesh13, one_process, mode):
    """(data=1, model=3): independent mode in blocks of 6, 6 and 4 of 16
    cells (the last padded with cell 15, one gather); the wavefront's K = 2
    lanes, which 3 does not divide, replicated on every rank (no gather);
    the loss scaled by 1/3 on each rank and the gradients summed."""
    want, want_m, _ = one_process[mode]
    ranks = [r[mode] for r in mesh13]
    assert [r["gathers"] for r in ranks] == [int(mode == "independent")] * 3
    assert_ranks_equal_one_process(ranks, want, want_m)


@pytest.mark.parametrize("mode", MODES)
def test_model_axis_step_makes_no_host_read(mesh22, mode):
    """A second step of each mode on the (2, 2) mesh, with its subgroups'
    collectives and the cell split's autograd Functions, ran under
    ``tests/test_torch_captured_step.py``'s host-read guard on every rank
    (it fails the rank's process otherwise), with finite metrics."""
    assert [r[mode]["guarded"] for r in mesh22] == [True] * 4


def test_eval_step_over_a_mesh_equals_one_process(mesh22):
    """``make_eval_step(cfg, mesh)`` on the (2, 2) mesh, wavefront, each
    rank given its data rank's 2 of 4 images: every rank returns the
    one-process eval of the 4 images, the loss and its terms summed over
    the data ranks and every batched output gathered, within REL."""
    cfg = with_mode("wavefront")
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
    x = generate_batch(torch.Generator().manual_seed(X_SEED), bank,
                       cfg.batch_size, dcfg)[0]
    want_loss, want = make_eval_step(cfg)(
        init_params(cfg, device="cpu"), x, EVAL_STEP,
        torch.Generator().manual_seed(EVAL_SEED))

    def rel(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                     1e-30)
    for rank in mesh22:
        loss, aux = rank["eval"]
        assert rel(loss, want_loss) < REL
        assert set(aux) == set(want) and set(aux["losses"]) == set(
            want["losses"])
        for k, v in want["losses"].items():
            assert rel(aux["losses"][k], v) < REL, k
        for k, v in want.items():
            if k != "losses":
                assert aux[k].shape == v.shape, k
                assert rel(aux[k], v) < REL, k
    assert all(torch.equal(r["eval"][0], mesh22[0]["eval"][0])
               for r in mesh22)


def test_paper128_blocks_are_padded():
    """At paper128 (11 x 11 = 121 cells) neither 2 nor 4 ranks divide the
    cells: the padding is on the main path's independent mode."""
    gh, gw = geometry(PRESETS["paper128"]())[1]
    assert gh * gw == 121
    for m in (2, 4):
        start, stop, size = block(121, types.SimpleNamespace(
            n_model=m, model_rank=m - 1))
        assert 0 < stop - start < size
