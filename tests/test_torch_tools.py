"""The port's export CLI, NaN hunter, span recorder, memory report and
profiling CLI, on the CPU; the export against the JAX package's
``to_torch_state_dict`` key for key and bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from spair_pytorch_tpu.utils.interop import to_torch_state_dict
from spair_pytorch_tpu_torch import export, profile
from spair_pytorch_tpu_torch.config import config_to_json
from spair_pytorch_tpu_torch.models.spair import forward
from spair_pytorch_tpu_torch.parallel import create_train_state
from spair_pytorch_tpu_torch.utils import debug, memory, spans
from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager
from spair_pytorch_tpu_torch.utils.interop import load_jax_params
from tests.test_model import tiny_config
from tests.test_torch_ops import jax_params_np, tcfg

JCFG = tiny_config(inference_mode="independent")
CFG = tcfg(JCFG)


def run_dir(tmp_path, cfg, pnp=None):
    """A run directory holding one checkpoint of ``cfg``'s state (the JAX
    parameters ``pnp`` when given) at step 7."""
    logdir = tmp_path / "run"
    os.makedirs(logdir)
    with open(logdir / "config.json", "w") as f:
        f.write(config_to_json(cfg))
    state = create_train_state(cfg, device="cpu")
    if pnp is not None:
        load_jax_params(state.model, pnp)
    state.step.fill_(7)
    CheckpointManager(str(logdir / "checkpoints")).save(state)
    return str(logdir), state


def test_export_equals_jax_to_torch_state_dict(tmp_path):
    pnp = jax_params_np(JCFG)
    logdir, _ = run_dir(tmp_path, CFG, pnp)
    out = export.main(["--logdir", logdir, "--out",
                       str(tmp_path / "step.pkl"), "--device", "cpu"])
    got = torch.load(out, weights_only=True)
    want = to_torch_state_dict(pnp)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_export_then_import_round_trips_bit_for_bit(tmp_path):
    logdir, state = run_dir(tmp_path, CFG)
    pkl = export.main(["--logdir", logdir, "--step", "7", "--out",
                       str(tmp_path / "s.pkl"), "--device", "cpu"])
    fresh = tmp_path / "fresh"
    os.makedirs(fresh)
    with open(fresh / "config.json", "w") as f:  # the model to import into
        f.write(config_to_json(CFG))
    export.main(["--import-pkl", pkl, "--logdir", str(fresh), "--device",
                 "cpu"])
    template = create_train_state(dataclasses.replace(CFG, seed=5),
                                  device="cpu")
    back = CheckpointManager(str(fresh / "checkpoints")).restore(template)
    assert back is not None
    for (k, p), q in zip(state.model.named_parameters(),
                         back.model.parameters()):
        assert torch.equal(p, q), k


def test_export_leaves_out_the_self_attention_and_import_ignores_extras():
    cfg = dataclasses.replace(CFG, vestigial_self_attn=True)
    model = create_train_state(cfg, device="cpu").model
    sd = export.reference_state_dict(model)
    assert not any(k.startswith("self_attn.") for k in sd)
    assert sorted(sd) == sorted(to_torch_state_dict(jax_params_np(JCFG)))
    other = create_train_state(dataclasses.replace(cfg, seed=9),
                               device="cpu").model
    export.load_reference_state_dict(
        other, dict(sd, **{"attn.query_conv.weight": torch.zeros(1)}))
    for k, v in export.reference_state_dict(other).items():
        assert torch.equal(v, sd[k])
    del sd["virtual_edge_element"]
    with pytest.raises(KeyError):
        export.load_reference_state_dict(other, sd)


def test_export_without_a_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit):
        export.main(["--logdir", str(tmp_path), "--device", "cpu"])


@pytest.fixture
def hunter():
    debug.enable_nan_hunter(True)
    yield
    debug.enable_nan_hunter(False)


def test_nan_hunter_is_silent_when_off():
    debug.nan_hunter("off", x=torch.tensor([float("nan")]))


def test_nan_hunter_passes_clean_tensors(hunter):
    debug.nan_hunter("clean", x=torch.ones(4), y=torch.zeros(2, 3))


def test_nan_hunter_raises_naming_the_location_and_tensor(hunter, capsys):
    with pytest.raises(FloatingPointError, match="at render in \\['recon'\\]"):
        debug.nan_hunter("render", feat=torch.ones(3),
                         recon=torch.tensor([1.0, float("nan")]))
    assert "NaN HUNTER (render)" in capsys.readouterr().out


def test_forward_loss_is_the_same_with_the_hunter_on():
    model = create_train_state(CFG, device="cpu").model
    x = torch.from_numpy(np.random.RandomState(1).rand(
        2, 1, 48, 48).astype("f"))

    def loss():
        return forward(model, CFG, x, 0,
                       torch.Generator().manual_seed(2))[0]

    off = loss()
    debug.enable_nan_hunter(True)
    try:
        on = loss()
    finally:
        debug.enable_nan_hunter(False)
    assert torch.equal(on, off) and bool(torch.isfinite(on))


def test_forward_hunter_catches_a_nan_input():
    model = create_train_state(CFG, device="cpu").model
    x = torch.full((1, 1, 48, 48), float("nan"))
    debug.enable_nan_hunter(True)
    try:
        with pytest.raises(FloatingPointError, match="after inference"):
            forward(model, CFG, x, 0, torch.Generator().manual_seed(2))
    finally:
        debug.enable_nan_hunter(False)


def test_benchmark_spans_accumulate():
    """The span recorder's host spans (``utils/spans.py``): nested spans
    keep their parents and the step they began at, and each is a profiler
    range."""
    rec = spans.Spans()
    with torch.profiler.profile() as prof:
        for _ in range(2):
            with rec.host("op"):
                with rec.host("inner"):
                    sum(range(1000))
            rec.next_step()
        with rec.host("other"):
            pass
    got = [(s.name, s.parent, s.step) for s in rec.host_spans]
    ops = [s.id for s in rec.host_spans if s.name == "op"]
    assert got == [("inner", ops[0], 0), ("op", 0, 0), ("inner", ops[1], 1),
                   ("op", 0, 1), ("other", 0, 2)]
    assert all(s.end >= s.start for s in rec.host_spans)
    assert rec.host_seconds("op") == pytest.approx(sum(
        s.end - s.start for s in rec.host_spans if s.name == "op") / 1e9)
    names = [e.name for e in prof.events()]
    assert names.count("op") == 2 and names.count("inner") == 2


def test_memory_reports_without_a_card():
    assert memory.device_memory_stats() == {}
    assert memory.live_array_report().startswith("total live: 0.0 MB")


def test_profile_writes_a_trace(tmp_path):
    """The profiling CLI on the CPU: its recorder's tiles over the profiled
    step, and the program's host spans and span marks in the trace."""
    recorder, path = profile.main(["--preset", "small48", "--steps", "1",
                                   "--warmup", "0", "--out", str(tmp_path),
                                   "--device", "cpu"])
    summary = recorder.summary()
    assert summary["steps"] == 1 and "fronts" in summary["tiles"]
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"spair.call", "spair.step", "spair_span_mark"} <= names
    assert any(str(n).startswith("aten::") for n in names)
