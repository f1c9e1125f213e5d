"""A run with the timed path broken underneath comes out not correct: the
program's step is faulted on the CPU, at a tiny size, and the harness
drives the rest of the run as it does on the card."""

import importlib

import pytest
import torch

from perfbench.run import execute
from perfbench.tests.tiny import tiny_run


def run_cell(cell, **kw):
    # the tiny runs compute in float32: over two images bfloat16's rounding
    # is not averaged as over a cell's 128, and would fail a sound run
    result, rows = execute(*tiny_run(cell, compute_dtype="float32", **kw))
    return result["correct"], rows


@pytest.mark.parametrize("cell", ["train.paper128.b128",
                                  "train.quality.b32"])
def test_a_sound_training_run_is_correct(cell):
    ok, rows = run_cell(cell, batch=2)
    assert ok, rows


@pytest.mark.parametrize("cell", ["train.paper128.b128",
                                  "train.quality.b32"])
def test_every_leaf_has_a_gradient_in_the_checked_steps(cell):
    """The checked steps lie past the training wheel, so the comparison
    holds every layer's backward, not the glimpse codec's alone."""
    from perfbench.drivers import train
    from perfbench.judge import leaves
    from perfbench.reference.spair import F32
    _, r, _ = tiny_run(cell, batch=2)
    out = train.run(r)
    ref = train.reference(r, out, F32)
    assert all(float(g.abs().max()) > 0 for g in ref["grad1"].values())
    assert leaves(out["program"], ref)["left_out"] == []


@pytest.mark.parametrize("cell", ["train.paper128.b128",
                                  "train.quality.b32"])
def test_a_step_that_leaves_its_state_unchanged_fails(cell, monkeypatch):
    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    make = ts.optimizer

    def frozen(cfg, model):
        opt = make(cfg, model)
        plain = opt.step

        def step(*a, **kw):
            saved = [p.detach().clone() for p in model.parameters()]
            plain(*a, **kw)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
                for st in opt.state.values():
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
        opt.step = step
        return opt
    monkeypatch.setattr(ts, "optimizer", frozen)
    ok, rows = run_cell(cell, batch=2)
    assert not ok, rows


@pytest.mark.parametrize("cell", ["train.paper128.b128",
                                  "train.quality.b32"])
def test_half_of_the_batch_left_out_fails(cell, monkeypatch):
    model_spair = importlib.import_module("spair_pytorch_tpu_torch.models."
                                          "spair")
    plain = model_spair.loss_and_metrics

    def half(x, recon, kls, cfg, batch_share=1.0):
        b = x.shape[0] // 2
        loss, terms = plain(x[:b], recon[:b], {k: v[:b] for k, v in
                                                kls.items()}, cfg,
                            batch_share)
        loss = loss + terms["losses/reconst"]
        return loss, dict(terms, **{"losses/total": loss})
    monkeypatch.setattr(model_spair, "loss_and_metrics", half)
    ok, rows = run_cell(cell, batch=4)
    assert not ok, rows


def test_the_float8_control_fails_a_bfloat16_cell():
    """The reference in float8 in the program's place, at the tiny size:
    it fails the cell's limits (the readings on the card are in PERF.md)."""
    from perfbench.drivers import train
    from perfbench.judge import verdict
    from perfbench.reference.spair import F32, Precision
    registry, r, limits = tiny_run("train.paper128.b128", batch=4)
    out = train.run(r)
    ref = train.reference(r, out, F32)
    ctrl = train.reference(r, out, Precision("fp8"))
    numbers = train.numbers(r, train.as_program(ctrl, out), ref)
    ok, rows = verdict(numbers, limits)
    assert not ok, rows
