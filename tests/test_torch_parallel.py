"""The port's data parallelism (parallel/mesh.py, data/sharded.py) on the
CPU with gloo: the rank slices against the JAX package's, scene content
independent of the world size, a world of one equal to the plain step bit
for bit, and a 2-process step equal to the 1-process step within 1e-5
relative (the ranks' slices reduce in another order than one batch does);
with ``render_topk``, both ranks take the 1-process step's branch where
one rank's slice alone would take the other."""

import dataclasses
import os
import socket
import subprocess
import sys

import pytest
import torch

from spair_pytorch_tpu.data import sharded as jsharded
from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
from spair_pytorch_tpu_torch.data.sharded import (generate_host_local,
                                                  host_slice)
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_train_step)
from spair_pytorch_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                   shard_batch)
from spair_pytorch_tpu_torch.train import data_config
from tests.test_model import tiny_config
from tests.test_torch_ops import tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tcfg(tiny_config(batch_size=4, inference_mode="wavefront",
                       pres_gate_threshold=0.01))
REL = 1e-5
# render_topk: with the presence head's output bias shifted by TOPK_BIAS,
# the first step's four images hold 8, 5, 11 and 7 live objects: rank 0's
# slice at most TOPK, rank 1's more, the global batch more
TOPK, TOPK_BIAS = 9, -5.0
CFG_TOPK = dataclasses.replace(CFG, render_topk=TOPK)


@pytest.mark.parametrize("global_batch,world", [(8, 1), (8, 2), (12, 3),
                                                (128, 4)])
def test_host_slice_matches_jax(global_batch, world):
    for rank in range(world):
        assert host_slice(global_batch, world, rank) == \
            jsharded.host_slice(global_batch, world, rank)


def test_host_slice_refuses_an_uneven_batch():
    with pytest.raises(ValueError):
        host_slice(10, 4, 0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_content_does_not_depend_on_the_world_size(world):
    dcfg = data_config(CFG)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
    want = generate_batch(torch.Generator().manual_seed(3), bank, 8, dcfg)
    parts = [generate_host_local(torch.Generator().manual_seed(3), bank,
                                 dcfg, 8, world, rank)
             for rank in range(world)]
    for got, ref in zip(zip(*parts), want):
        assert torch.equal(torch.cat(got), ref)


def shift_presence_(model, bias):
    with torch.no_grad():
        model.obj_network.out.bias += bias


def plain_step(cfg=CFG, bias=0.0):
    """One step of one process: (state, metrics, the branches it took, or
    None without render_topk)."""
    state = create_train_state(cfg, device="cpu")
    shift_presence_(state.model, bias)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
    step = make_train_step(cfg, datagen=(dcfg, bank))
    state, metrics = step(state)
    return state, metrics, (None if step.branches is None
                            else step.branches.last)


def test_world_of_one_equals_the_plain_step_bit_for_bit(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    want, want_m, _ = plain_step()
    mesh = make_mesh("cpu")
    try:
        assert (mesh.world_size, mesh.rank) == (1, 0)
        state = replicate(mesh, create_train_state(CFG, device="cpu"))
        dcfg = data_config(CFG)
        bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
        state, metrics = make_train_step(CFG, mesh,
                                         datagen=(dcfg, bank))(state)
        batch = tuple(torch.arange(8.0).reshape(4, 2) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(shard_batch(mesh, batch),
                                                     batch))
    finally:
        mesh.close()
    for p, q in zip(state.model.parameters(), want.model.parameters()):
        assert torch.equal(p, q)
    assert set(metrics) == set(want_m)
    for k in want_m:
        assert torch.equal(metrics[k], want_m[k]), k
    assert torch.equal(state.generator.get_state(),
                       want.generator.get_state())


WORKER = """
import sys, torch
torch.set_num_threads(2)
from spair_pytorch_tpu_torch.config import config_from_json
from spair_pytorch_tpu_torch.data import glyph_bank
from spair_pytorch_tpu_torch.models import spair
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_train_step)
from spair_pytorch_tpu_torch.parallel.mesh import make_mesh, replicate
from spair_pytorch_tpu_torch.train import data_config
cfg = config_from_json(sys.argv[2])
live, real = [], spair.render_objects


def spy(*a, **kw):
    out = real(*a, **kw)
    if out[0]["gate"] is not None:  # this rank's largest live count
        live.append(int((out[0]["gate"] > 0).sum(1).max()))
    return out


spair.render_objects = spy
mesh = make_mesh("cpu")
try:
    state = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        state.model.obj_network.out.bias += float(sys.argv[3])
    state = replicate(mesh, state)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw))
    step = make_train_step(cfg, mesh, datagen=(dcfg, bank))
    state, metrics = step(state)
    torch.save({"params": [p.detach() for p in state.model.parameters()],
                "grads": [p.grad for p in state.model.parameters()],
                "metrics": metrics, "live": live,
                "branches": None if step.branches is None
                else step.branches.last}, sys.argv[1])
finally:
    mesh.close()
"""


def launch(tmp_path, worker, world, *args, timeout=120):
    """``python -c worker OUT *args`` as ``world`` gloo ranks on a free
    localhost port, OUT each rank's own file under ``tmp_path``: what each
    rank saved there."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, str(tmp_path / f"rank{rank}.pt"),
             *map(str, args)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def two_process_step(tmp_path, cfg, bias=0.0):
    """One step of two gloo ranks of 2 scenes each, the presence bias
    shifted by ``bias``: what each rank saved."""
    from spair_pytorch_tpu_torch.config import config_to_json
    return launch(tmp_path, WORKER, 2, config_to_json(cfg), bias)


def assert_ranks_equal_one_process(ranks, want, want_m):
    """Each rank's summed gradients, parameters after Adam and reduced
    metrics against one process's, within REL; every rank's parameters
    equal bit for bit."""
    grads = [p.grad for p in want.model.parameters()]
    params = list(want.model.parameters())
    for got in ranks:
        for name, got_t, want_t in (("grads", got["grads"], grads),
                                    ("params", got["params"], params)):
            for g, w in zip(got_t, want_t):
                w = w.detach()
                scale = max(float(w.abs().max()), 1e-30)
                err = float((g - w).abs().max()) / scale
                assert err < REL, (name, err)
        for k, v in want_m.items():
            err = abs(float(got["metrics"][k]) - float(v)) / max(
                abs(float(v)), 1e-6)
            assert err < REL, (k, float(got["metrics"][k]), float(v))
    for other in ranks[1:]:
        for a, b in zip(ranks[0]["params"], other["params"]):
            assert torch.equal(a, b)


def test_two_process_step_equals_the_one_process_step(tmp_path):
    """Two gloo ranks of 2 scenes each against one process of 4: the
    summed gradients, the parameters after Adam and the reduced metrics."""
    ranks = two_process_step(tmp_path, CFG)
    want, want_m, _ = plain_step()
    assert_ranks_equal_one_process(ranks, want, want_m)


def test_two_process_top_k_step_takes_the_one_process_branch(tmp_path):
    """render_topk over two gloo ranks, where rank 0's slice has at most K
    live objects in every image and rank 1's has more: the predicate is
    the global batch's (the largest live count reduced over the ranks), so
    both ranks take the full composite, as one process of 4 does, and the
    step equals it as the step without top-K does."""
    ranks = two_process_step(tmp_path, CFG_TOPK, TOPK_BIAS)
    want, want_m, branches = plain_step(CFG_TOPK, TOPK_BIAS)
    assert [r["live"] for r in ranks] == [[8], [11]]  # the premise
    assert branches == [False]
    assert [r["branches"] for r in ranks] == [branches, branches]
    assert_ranks_equal_one_process(ranks, want, want_m)
