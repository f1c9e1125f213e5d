"""The port's benchmark entry point (``spair_pytorch_tpu_torch/bench.py``)
against the root ``bench.py`` on the CPU, at small48.

``bench.py``'s parser, its flag -> config mapping and its pretraining rule
are read from its source with ``ast`` and run here, so the port is held to
the code itself: flags (names, defaults, choices), the config field for
field, the pretraining calls. Its JSON line comes from a run on the CPU in
a subprocess. The port's ``--check`` must catch a wrong compositor; its
delta timing and FLOP count are checked on stubs and on two batches."""

import argparse
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from spair_pytorch_tpu import config as jconfig
from spair_pytorch_tpu_torch import bench
from spair_pytorch_tpu_torch.data import DataConfig, glyph_bank
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench.py")
SMALL = ["--device", "cpu", "--preset", "small48", "--batch", "4",
         "--steps", "2", "--repeats", "1", "--block-sleep", "0"]


def bench_tree():
    with open(BENCH) as f:
        return ast.parse(f.read())


def bench_main_body():
    return next(n for n in bench_tree().body if isinstance(
        n, ast.FunctionDef) and n.name == "main").body


def assigns(stmt, name):
    return (isinstance(stmt, ast.Assign) and isinstance(
        stmt.targets[0], ast.Name) and stmt.targets[0].id == name)


def run_statements(body, first, last, ns):
    """Run bench.py's main() statements from the assignment to ``first``
    up to and including the assignment to ``last`` in namespace ``ns``."""
    i = next(j for j, s in enumerate(body) if assigns(s, first))
    k = next(j for j, s in enumerate(body) if assigns(s, last))
    exec(compile(ast.Module(body=body[i:k + 1], type_ignores=[]), BENCH,
                 "exec"), ns)
    return ns


def jax_parser():
    """bench.py's own ArgumentParser, built by its own statements: from
    ``p = argparse.ArgumentParser()`` up to the parse."""
    baseline = next(s for s in bench_tree().body
                    if assigns(s, "REFERENCE_BASELINE_IPS"))
    ns = {"argparse": argparse,
          "REFERENCE_BASELINE_IPS": ast.literal_eval(baseline.value)}
    body = bench_main_body()
    i = next(j for j, s in enumerate(body) if assigns(s, "p"))
    k = next(j for j, s in enumerate(body) if assigns(s, "args"))
    exec(compile(ast.Module(body=body[i:k], type_ignores=[]), BENCH, "exec"),
         ns)
    return ns["p"]


def jax_config(argv):
    """bench.py's config for ``argv``: its parser, then its override
    statements against the JAX package's PRESETS."""
    args = jax_parser().parse_args(argv)
    return run_statements(bench_main_body(), "overrides", "cfg",
                          {"args": args, "PRESETS": jconfig.PRESETS})["cfg"]


def jax_pretrain_calls(pretrain, k):
    """The untimed calls bench.py makes: its ``if args.pretrain:`` loop's
    range, evaluated as it is written."""
    loop = next(n for n in ast.walk(ast.Module(body=bench_main_body(),
                                               type_ignores=[]))
                if isinstance(n, ast.If) and isinstance(n.test, ast.Attribute)
                and n.test.attr == "pretrain").body[0]
    expr = ast.Expression(body=loop.iter.args[0])
    args = argparse.Namespace(pretrain=pretrain)
    if not args.pretrain:
        return 0
    return eval(compile(expr, BENCH, "eval"), {"args": args, "k": k,
                                                "max": max})


def action_spec(a):
    return (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
            a.const, a.required, type(a))


def test_flags_equal_bench_py():
    want = {a.dest: action_spec(a) for a in jax_parser()._actions
            if a.dest != "help"}
    got = {a.dest: action_spec(a) for a in bench.make_parser()._actions
           if a.dest != "help"}
    assert len(want) == 16
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), "cuda")


@pytest.mark.parametrize("argv", [
    [],
    ["--render", "pallas_v3", "--count-kl", "par"],
    ["--remat", "none"],
    ["--render-mode", "ordered", "--topk", "8"],
    ["--preset", "small48", "--batch", "4", "--mode", "raster",
     "--compute-dtype", "float32", "--gate", "0", "--render", "xla",
     "--count-kl", "seq", "--remat", "dots"],
], ids=["defaults", "v3-par", "remat-none", "ordered-topk", "small48-mixed"])
def test_build_config_equals_bench_py(argv):
    got = bench.build_config(bench.parse_args(argv))
    want = jax_config(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_topk_without_the_gate_is_an_error(capsys):
    with pytest.raises(SystemExit) as e:
        bench.parse_args(["--topk", "8", "--gate", "0"])
    assert e.value.code == 2
    assert "--topk requires --gate" in capsys.readouterr().err


def test_cuda_without_a_card_fails():
    """No CPU fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench.main(SMALL[2:])


def numbers(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


def test_line_has_bench_py_keys(capsys):
    """The port's line against bench.py's line, both on the CPU. bench.py
    is run with --pretrain 4, one untimed call: at --pretrain 2 with
    --steps 2 it makes no pretraining call and then reads the loss of
    that loop, which raises (UnboundLocalError; the port reads a loss
    only after a call)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", SPAIR_COMPILE_CACHE="0")
    jax_run = subprocess.run(
        [sys.executable, BENCH, *SMALL[2:], "--pretrain", "4", "--check"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]
    want = json.loads(jax_run.stdout.strip().splitlines()[-1])
    got = bench.main(SMALL + ["--pretrain", "2", "--check"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == got

    assert set(got) == set(want) | {"card"}
    assert set(got["spread"]) == set(want["spread"])
    assert set(got["check"]) == set(want["check"])
    assert got["unit"] == want["unit"] == "images/sec/chip"
    assert got["card"] == "cpu"
    # a delta of two CPU runs of 2 steps each is not held to a sign here,
    # on a loaded test machine; phase 16 of chip_smoke.py holds value > 0
    # on the card
    assert all(math.isfinite(v) for v in numbers(got))
    assert got["gflop_per_step"] > 0
    assert got["check"]["passed"] and got["check"]["k_step_loss_finite"]
    assert got["spread"]["trials"] == 1
    assert got["mfu_pct"] is None  # no peak for the CPU
    assert want["check"]["passed"]
    # bench.py's words, with the preset's image size in place of 128x128
    assert got["metric"] == want["metric"].replace("128x128", "48x48")


def test_the_metric_string_is_bench_py_s_at_paper128():
    """bench.py's metric expression, evaluated as it is written, against
    the port's at paper128; elsewhere the port writes the preset's size."""
    node = next(n for n in ast.walk(ast.Module(body=bench_main_body(),
                                               type_ignores=[]))
                if isinstance(n, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "metric"
                    for k in n.keys)).values[0]
    for argv in ([], ["--batch", "32", "--mode", "raster",
                      "--compute-dtype", "float32"]):
        args = bench.parse_args(argv)
        cfg = bench.build_config(args)
        want = eval(compile(ast.Expression(body=node), BENCH, "eval"),
                    {"args": args, "cfg": cfg})
        assert bench.metric_name(args, cfg) == want
    args = bench.parse_args(["--preset", "small48"])
    assert "48x48 scattered-MNIST" in bench.metric_name(
        args, bench.build_config(args))


def small_cfg():
    return bench.build_config(bench.parse_args(SMALL))


def test_check_catches_a_wrong_compositor(monkeypatch):
    real = bench.composite

    def wrong(*args, **kw):
        num, den = real(*args, **kw)
        return num * 1.001, den

    monkeypatch.setattr(bench, "composite", wrong)
    with pytest.raises(AssertionError, match="bench --check FAILED"):
        bench.run_check(small_cfg(), "cpu")


def test_check_reads_the_bf16_legs_error():
    """On the CPU both arms of the f32 and gated legs are the plain
    compositor; the bf16 leg reads the rounding of its glimpses."""
    res = bench.run_check(small_cfg(), "cpu")
    assert res["passed"]
    assert set(res) == set(bench.BARS) | {"passed"}
    for k in ("bf16_path_fwd_relerr", "bf16_path_grad_relerr"):
        assert 0 < res[k] < 3e-2, (k, res[k])
    for k in bench.BARS:
        assert res[k] < bench.BARS[k], k


def test_delta_arithmetic():
    """(t3 - t1) / 2K: what every run pays once cancels."""
    k, s, once = 50, 0.0123, 0.7
    per = bench.delta_per_step(lambda n: once + n * k * s, k, 3, 0)
    assert per == pytest.approx([s] * 3, rel=1e-12)


def test_delta_timing_of_a_stub_step():
    """A stub step that sleeps a known time per step, through the real
    window: the steps' time is read back, the warm-up call's is not."""
    s, k = 0.05, 2

    def step(state):
        time.sleep(s * k)
        return state, {"losses/total": torch.zeros(k),
                       "debug/pres_count_mean": torch.zeros(k)}

    per_step, _ = bench.timed_window(step, None, k, pretrain=0, repeats=2,
                                     block_sleep=0)
    assert len(per_step) == 2 and per_step == sorted(per_step)
    for v in per_step:
        assert v == pytest.approx(s, rel=0.2)


@pytest.mark.parametrize("k", [1, 50])
@pytest.mark.parametrize("pretrain", [0, 2, 49, 2500])
def test_pretrain_calls_equal_bench_py(pretrain, k):
    calls = []

    def step(state):
        calls.append(1)
        z = torch.zeros(k) if k > 1 else torch.tensor(1.0)
        return state, {"losses/total": z, "debug/pres_count_mean": z}

    check = {}
    bench.timed_window(step, None, k, pretrain, repeats=1, block_sleep=0,
                       check=check)
    want = jax_pretrain_calls(pretrain, k)
    assert bench.pretrain_calls(pretrain, k) == want
    # warm-up, pretraining, the check's call, one trial of 1 + 3 calls
    assert len(calls) == 1 + want + 1 + 4
    assert check == {"k_step_loss_finite": True}


def test_flops_scale_with_the_batch():
    flops = []
    for b in (4, 8):
        cfg = bench.build_config(bench.parse_args(
            ["--preset", "small48", "--batch", str(b)]))
        bank = torch.as_tensor(glyph_bank((14, 14)))
        dcfg = DataConfig(image_hw=cfg.image_shape[1:],
                          max_objects=cfg.max_scene_objects,
                          min_objects=cfg.min_scene_objects)
        state = create_train_state(cfg, device="cpu")
        flops.append(bench.step_flops(
            make_train_step(cfg, datagen=(dcfg, bank)), state))
    assert flops[0] > 0
    assert flops[1] / flops[0] == pytest.approx(2.0, rel=1e-2)
