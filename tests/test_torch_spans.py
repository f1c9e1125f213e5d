"""The span recorder (``utils/spans.py``) on the CPU: the tiles an eager
step marks and their order, tiles that sum to each step's span and to the
window, host spans with their parents and step ids, the recorder's
arithmetic on scripted clocks, steps bit for bit equal with spans on and
off, no mark anywhere with spans off, and ``train(spans=True)``'s logged
tiles. The card's side (the captured step with marks, the graph's kernels,
the clock offset) is in ``tests/test_torch_kernel_gpu.py``."""

import json
import os
import time
import types

import pytest
import torch

from spair_pytorch_tpu_torch import train as ttrain
from spair_pytorch_tpu_torch.config import PRESETS, SpairConfig
from spair_pytorch_tpu_torch.data import glyph_bank
from spair_pytorch_tpu_torch.models.spair import forward_head, forward_tail
from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                              make_train_step)
from spair_pytorch_tpu_torch.utils import spans

# the forward and backward tiles of a step, in order, without the branch
PLAIN = [t for t in spans.TILES if t != "gap.branch"]


def tiny(**kw):
    base = dict(image_shape=(1, 48, 48), batch_size=2,
                object_shape=(14, 14), anchor_shape=(24, 24),
                n_attributes=8, mlp_hidden=(32, 32), encoder_hidden=(32,),
                decoder_hidden=(32,), n_backbone_features=16,
                n_passthrough_features=16, render_chunk=4,
                inference_mode="wavefront", pres_gate_threshold=0.01)
    base.update(kw)
    return SpairConfig(**base)


# reference mode (the plain compositor on the CPU) and ordered mode with
# top-K (a segmented step: gap.branch between its segments)
CFGS = {"reference": tiny(),
        "ordered_topk": tiny(render_mode="ordered", render_topk=8)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def datagen(cfg):
    dcfg = ttrain.data_config(cfg)
    return dcfg, torch.as_tensor(glyph_bank(dcfg.patch_hw))


def run(cfg, n, on, bias=0.0):
    """``n`` one-step calls of a fresh state past the training wheel, so
    that every leaf has a gradient; (state, metrics, step_fn)."""
    state = create_train_state(cfg, seed=3, device="cpu")
    state.step.fill_(1000)
    with torch.no_grad():
        state.model.obj_network.out.bias += bias
    fn = make_train_step(cfg, datagen=datagen(cfg), spans=on)
    metrics = [fn(state)[1] for _ in range(n)]
    return state, metrics, fn


def test_small48_eager_step_marks_every_tile_in_order():
    """small48 (independent inference) and a wavefront segmented step: each
    step marks every tile once, in the module's order, the segmented step
    with gap.branch between decoder and composite."""
    _, _, fn = run(PRESETS["small48"](batch_size=2), 2, True)
    r = fn.spans.read()
    assert r.steps == 2
    first, second = (list(t) for _, t in r.step_tiles())
    assert first == PLAIN
    assert second == PLAIN[:-1]   # its gap.replay opened, never closed
    assert list(fn.spans.summary()["tiles"]) == PLAIN
    _, _, fn = run(CFGS["ordered_topk"], 2, True)
    assert list(fn.spans.read().step_tiles()[0][1]) == list(spans.TILES)


def test_tiles_sum_to_each_step_and_to_the_window():
    """Each step's tiles sum exactly to the span from its first mark to the
    next step's; the window's tiles plus the time before the first mark and
    after the last equal the window's host clock; every host span has a
    parent inside whose interval it lies (0 for a call) and a step id."""
    state = create_train_state(CFGS["reference"], seed=3, device="cpu")
    fn = make_train_step(CFGS["reference"], datagen=datagen(
        CFGS["reference"]), steps_per_call=2, spans=True)
    fn(state)
    fn.spans.reset()
    t0 = time.perf_counter_ns()
    fn(state)
    fn(state)
    t1 = time.perf_counter_ns()
    r = fn.spans.read()
    assert r.steps == 4
    steps = r.step_tiles()
    for (start, tiles), (nxt, _) in zip(steps, steps[1:]):
        assert sum(tiles.values()) == nxt - start
    rows = [row for _, row in r.rows()]
    first = min(int(v) for v in rows[0] if v)
    last = int(rows[-1][spans.TILES.index(spans.LAST)])
    assert int(r.acc_ns.sum()) + (first - t0) + (t1 - last) == t1 - t0
    assert int(r.count.sum()) == 4 * len(PLAIN) - 1
    summary = fn.spans.summary()
    assert sum(t["ms"] for t in summary["tiles"].values()) * 4 == \
        pytest.approx(r.acc_ns.sum() / 1e6)
    by_id = {s.id: s for s in fn.spans.host_spans}
    names = [s.name for s in fn.spans.host_spans]
    assert names.count("spair.call") == 3 and names.count("spair.step") == 6
    for s in fn.spans.host_spans:
        assert s.step >= 0 and s.start <= s.end
        if s.name == "spair.call":
            assert s.parent == 0
        else:
            p = by_id[s.parent]
            assert p.name == "spair.call" and p.start <= s.start <= s.end \
                <= p.end and p.step <= s.step
    assert [s.step for s in fn.spans.host_spans
            if s.name == "spair.step"] == list(range(6))


def scripted(monkeypatch, times):
    """The host clock of the recorder's marks, read from ``times``."""
    it = iter(times)
    clock = types.SimpleNamespace(perf_counter_ns=lambda: next(it))
    monkeypatch.setattr(spans, "time", clock)


def test_summary_and_slices_of_scripted_steps(monkeypatch):
    """Three steps of three tiles on a scripted clock: the tiles' means a
    step, their p50 and p95 from the ring, their counts, and the steps in
    5-s slices by their first marks."""
    rec = spans.Spans()
    rec.bind("cpu")
    # step k starts at 10 s * k + 1 ns: scenes 2 ns, fronts 3 + k ns, the
    # gap up to the next step's start
    times = []
    for k in range(3):
        s = 10 ** 10 * k + 1
        times += [s, s + 2, s + 5 + k]
    scripted(monkeypatch, times)
    for _ in range(3):
        for tile in ("scenes", "fronts", spans.LAST):
            rec.mark(tile)
    summary = rec.summary()
    assert summary["steps"] == 3
    tiles = summary["tiles"]
    assert list(tiles) == ["scenes", "fronts", "gap.replay"]
    assert tiles["scenes"]["ms"] == pytest.approx(6 / 3 / 1e6)
    assert tiles["fronts"]["ms"] == pytest.approx(12 / 3 / 1e6)
    assert tiles["fronts"]["p50_ms"] == pytest.approx(4 / 1e6)
    assert tiles["fronts"]["p95_ms"] == pytest.approx(4.9 / 1e6)
    assert [tiles[t]["count"] for t in tiles] == [3, 3, 2]
    gap = 10 ** 10 - 5
    assert tiles["gap.replay"]["p50_ms"] == pytest.approx((gap - 0.5) / 1e6)
    sl = rec.slices(1, seconds=5.0)
    assert [s["steps"] for s in sl] == [1, 0, 1, 0, 1]
    assert sl[2]["ms"] == {"scenes": 2e-6, "fronts": 4e-6,
                           "gap.replay": (gap - 1) / 1e6}
    rec.reset()
    assert rec.summary()["steps"] == 0 and rec.summary()["tiles"] == {}


def assert_equal_runs(a, b):
    (sa, ma, _), (sb, mb, _) = a, b
    for x, y in zip(ma, mb):
        assert list(x) == list(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    pa, pb = list(sa.model.parameters()), list(sb.model.parameters())
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)
        assert torch.equal(x.grad, y.grad)
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


@pytest.mark.parametrize("case", ["reference", "ordered_topk-full",
                                  "ordered_topk-topk"])
def test_spans_leave_the_step_bit_for_bit(case):
    """3 steps with spans on against off: every metric (the loss among
    them), every parameter and every gradient bit for bit; the top-K case
    with the presence head's bias shifted so that every step takes the
    top-K branch."""
    name, _, branch = case.partition("-")
    bias = -6.0 if branch == "topk" else 0.0
    on, off = (run(CFGS[name], 3, flag, bias) for flag in (True, False))
    assert_equal_runs(on, off)
    if on[2].branches is not None:
        assert on[2].branches.counts == off[2].branches.counts
        assert on[2].branches.counts["topk" if branch == "topk"
                                     else "full"] == 3


def grad_fn_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo += [n for n, _ in node.next_functions]
    return names


def test_spans_off_apply_no_mark(monkeypatch):
    """With no recorder the step calls no mark and applies no boundary,
    and a forward's autograd graph holds no boundary node; with one active
    it does (the check's control)."""
    cfg = CFGS["reference"]

    def refuse(*a, **kw):
        raise AssertionError("a span mark with spans off")
    monkeypatch.setattr(spans.Spans, "mark", refuse)
    monkeypatch.setattr(spans._Boundary, "apply", refuse)
    state, _, fn = run(cfg, 1, False)
    assert fn.spans is None
    monkeypatch.undo()

    x = torch.rand((cfg.batch_size,) + tuple(cfg.image_shape))
    gen = torch.Generator().manual_seed(0)

    def loss():
        head = forward_head(state.model, cfg, x, 1000, gen)
        return forward_tail(state.model, cfg, head, False)[0]
    assert not any("Boundary" in n for n in grad_fn_names(loss()))
    rec = spans.Spans()
    rec.bind("cpu")
    with spans.active(rec):
        assert "_BoundaryBackward" in grad_fn_names(loss())


def test_train_logs_the_tiles_at_each_flush(tmp_path):
    """``train(spans=True)`` writes ``spans/<tile>_ms`` rows at its flushes,
    one for every tile of the step, positive."""
    ttrain.train(CFGS["reference"], steps=4, logdir=str(tmp_path),
                 checkpoint_every=0, log_flush_every=2, digits="font",
                 verbose=False, device="cpu", spans=True)
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = [r for r in rows if any(k.startswith("spans/") for k in r)]
    assert len(logged) == 2
    for r in logged:
        tiles = {k[len("spans/"):-len("_ms")]: v for k, v in r.items()
                 if k.startswith("spans/")}
        assert list(tiles) == PLAIN and all(v > 0 for v in tiles.values())


def test_a_recorder_keeps_its_device():
    rec = spans.Spans()
    rec.bind("cpu")
    rec.bind(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="bound to cpu"):
        rec.bind("meta")
