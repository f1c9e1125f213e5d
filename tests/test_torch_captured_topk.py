"""The render's top-K branch as the segments of a captured program
(``parallel/captured.py::SegmentedStep`` and ``SegmentedForward``), what can
be held on the CPU.

On the card a ``render_topk`` step is captured as segment A (scenes, the
forward up to the decoder, the gate and the branch's predicate) and one
segment B for each branch (the composite, the loss, backward, clipping,
Adam), replayed around one host read of the predicate a step, where the JAX
step has its ``lax.cond``. Here, at tiny_config size (a 4x4 grid, K = 8),
in ordered and reference mode and in each branch: the cold state's dense
presence takes the full composite, and the presence head's output bias
shifted by SPARSE_BIAS leaves every image at most K live objects and takes
the top-K one.

(a) A and each B make no host read, no tensor from host data and no
data-shaped op (the guard of ``tests/test_torch_captured_step.py``; the
CPU optimizer's step counts, which it reads with ``.item()``, are the only
exemption, as there), and the predicate is read once a step, between them;
also for the data-parallel step at world size 1 over gloo, whose segment A
reduces the live count over the ranks.
(b) The segmented step equals the unsplit ``train_step`` bit for bit, in
calls of one step and of three. (c) The same for the eval step and
``evaluate``, their segments under the guard with no exemption. (d) The
calls of ``SegmentedStep`` and ``SegmentedForward`` with stand-in graphs:
each step replays A, reads the predicate once and replays the B it names;
both Bs capture their backward through one A; a failed capture of a B
raises, and so does the next call; the garbage collector is off during a
capture. (e) The forward
of a sparse state through the top-K branch against the JAX package's, at
the f32 bars (loss and terms 1e-4; reference mode's gradients 1e-3).

The card's side (captured against eager in both branches, a branch switch
inside one call, a failed capture) is in ``tests/test_torch_kernel_gpu.py``.
"""

import contextlib
import dataclasses
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu.models import forward as jax_forward
from spair_pytorch_tpu_torch import eval as teval
from spair_pytorch_tpu_torch.data import generate_batch
from spair_pytorch_tpu_torch.models.spair import forward, forward_head
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.parallel import (captured, create_train_state,
                                              make_eval_step, make_train_step,
                                              train_step)
from spair_pytorch_tpu_torch.utils.interop import state_dict_from_jax
from tests.test_model import tiny_config
from tests.test_torch_captured_forward import (GuardedProgram,
                                               GuardedSegments, _patch,
                                               scenes, tiny_state)
from tests.test_torch_captured_step import (assert_same_state, data,
                                            no_host_reads, step_counts,
                                            world_of_one)
from tests.test_torch_options import GRAD_REL, setup, tnoise
from tests.test_torch_ops import F32_REL, assert_close, ported_params, t, tcfg

ts = importlib.import_module("spair_pytorch_tpu_torch.parallel.train_step")

TOPK = 8
# the presence head's output bias shift that leaves at most TOPK of the 16
# objects live (above the 0.01 gate) in every image: presence ~0.2
SPARSE_BIAS = -6.0
JCFGS = {
    "ordered": tiny_config(batch_size=2, inference_mode="wavefront",
                           pres_gate_threshold=0.01, render_topk=TOPK,
                           render_mode="ordered", render_chunk=4),
    # 'pallas', so that the JAX package's reference render takes its
    # top-K branch too (its 'auto' is 'xla' off the TPU); the port treats
    # 'pallas' as 'auto'
    "reference": tiny_config(batch_size=2, inference_mode="wavefront",
                             pres_gate_threshold=0.01, render_topk=TOPK,
                             render_backend="pallas"),
}
CFGS = {mode: tcfg(c) for mode, c in JCFGS.items()}
CASES = [(m, b) for m in sorted(CFGS) for b in ("topk", "full")]
IDS = [f"{m}-{b}" for m, b in CASES]


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread a test, so that the
    test workers beside it do not contend for the cores with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sparse_(model, bias=SPARSE_BIAS):
    """Shifts the presence head's output bias in place (its address, to
    which a captured program is bound, kept)."""
    with torch.no_grad():
        model.obj_network.out.bias += bias


def state_for(mode, branch, seed=5):
    state = create_train_state(CFGS[mode], seed=seed, device="cpu")
    if branch == "topk":
        sparse_(state.model)
    return state


class Segments:
    """Once ``armed``, runs each step's segment A (scene generation and
    train_step_head) and B (train_step_tail) under the host-read guard,
    and logs "A", "read" (each read of a predicate) and "B" in order."""

    def __init__(self):
        self.armed = False
        self.log = []
        self.guard = contextlib.ExitStack()

    def enter(self, exempt=()):
        if self.armed:
            self.guard.enter_context(no_host_reads(exempt))


@pytest.fixture
def segments(monkeypatch):
    seg = Segments()
    real_gen, real_head = ts.generate_batch, ts.train_step_head
    real_local = ts.generate_host_local
    real_tail, real_read = ts.train_step_tail, ts.takes_topk

    def gen(*a, **kw):
        seg.enter()
        return real_gen(*a, **kw)

    def local(*a, **kw):  # a data-parallel step's scenes
        seg.enter()
        return real_local(*a, **kw)

    def head(*a, **kw):
        try:
            return real_head(*a, **kw)
        finally:
            seg.guard.close()
            seg.log.append("A")

    def tail(cfg, state, *a, **kw):
        seg.log.append("B")
        seg.enter(step_counts(state))
        try:
            return real_tail(cfg, state, *a, **kw)
        finally:
            seg.guard.close()

    def read(pred):
        if pred is not None:  # None: no branch, nothing read
            seg.log.append("read")
        return real_read(pred)
    monkeypatch.setattr(ts, "generate_batch", gen)
    monkeypatch.setattr(ts, "generate_host_local", local)
    monkeypatch.setattr(ts, "train_step_head", head)
    monkeypatch.setattr(ts, "train_step_tail", tail)
    monkeypatch.setattr(ts, "takes_topk", read)
    try:
        yield seg
    finally:
        seg.guard.close()


# ------------------------------------------- (a) the train step's segments

@pytest.mark.parametrize("mode,branch", CASES, ids=IDS)
def test_step_segments_make_no_host_read(segments, mode, branch):
    """After a warm-up call, a call of two steps: A, one read, B a step,
    each segment under the guard; the branch the state's presence names."""
    cfg = CFGS[mode]
    step = make_train_step(cfg, datagen=data(cfg), steps_per_call=2)
    state = state_for(mode, branch)
    step(state)
    segments.armed, segments.log = True, []
    _, metrics = step(state)
    assert segments.log == ["A", "read", "B"] * 2
    assert step.branches.last == [branch == "topk"] * 2
    assert step.branches.counts == {"topk": 4 * (branch == "topk"),
                                    "full": 4 * (branch == "full")}
    assert int(state.step) == 4
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


@pytest.mark.parametrize("branch", ["topk", "full"])
def test_mesh_step_segments_make_no_host_read(segments, world_of_one,
                                              branch):
    """The data-parallel step at world size 1, reference mode: A (with the
    live count's MAX all-reduce), one read, B (the gradient all-reduce and
    the metrics' all-gather) a step, each segment under the guard."""
    cfg = CFGS["reference"]
    step = make_train_step(cfg, world_of_one, datagen=data(cfg),
                           steps_per_call=2)
    state = state_for("reference", branch)
    step(state)
    segments.armed, segments.log = True, []
    step(state)
    assert segments.log == ["A", "read", "B"] * 2
    assert step.branches.last == [branch == "topk"] * 2


def test_a_step_without_top_k_reads_nothing(segments):
    """Without render_topk the step has no branch: A and B run with no
    read between them, and the step keeps no branch count."""
    cfg = dataclasses.replace(CFGS["ordered"], render_topk=0)
    step = make_train_step(cfg, datagen=data(cfg))
    state = create_train_state(cfg, device="cpu")
    step(state)
    segments.armed, segments.log = True, []
    step(state)
    assert segments.log == ["A", "B"] and step.branches is None


# --------------------------------- (b) the segmented step, the unsplit step

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode,branch", CASES, ids=IDS)
def test_segmented_step_equals_the_unsplit_step(mode, branch, k):
    """3 steps of make_train_step (segments with the predicate read between
    them) against 3 calls of train_step on the same scenes: every metric,
    the parameters, Adam's state and the generator bit for bit."""
    cfg = CFGS[mode]
    dcfg, bank = data(cfg)
    state, ref = state_for(mode, branch), state_for(mode, branch)
    step = make_train_step(cfg, datagen=(dcfg, bank), steps_per_call=k)
    got = [step(state)[1] for _ in range(3 // k)]
    want = []
    for _ in range(3):
        x, gt_bbox, gt_count = generate_batch(ref.generator, bank,
                                              cfg.batch_size, dcfg)
        want.append(train_step(cfg, ref, x, gt_bbox, gt_count))
    for key in want[0]:
        seq = torch.stack([g[key] for g in got]) if k == 1 else got[0][key]
        assert torch.equal(seq, torch.stack([w[key] for w in want])), key
    assert_same_state(state, ref)
    assert step.branches.counts[branch] == 3


# ------------------------------------ (c) the eval step and evaluate

def model_for(mode, branch):
    return state_for(mode, branch).model


@pytest.mark.parametrize("mode,branch", CASES, ids=IDS)
def test_eval_step_segments_equal_the_unsplit_forward(monkeypatch, mode,
                                                      branch):
    """The eval step as captured (the second call's segments under the
    guard, no exemption, the predicate read once between them) equals the
    eager eval step and forward under no_grad, bit for bit."""
    _patch(monkeypatch, GuardedProgram)
    cfg, model = CFGS[mode], model_for(mode, branch)
    x = torch.rand((2, 1, 48, 48), generator=torch.Generator().manual_seed(1))
    run = make_eval_step(cfg)
    gen = torch.Generator().manual_seed(4)
    calls = [run(model, x, 1500, gen) for _ in range(2)]
    (program,) = GuardedSegments.made
    assert not GuardedProgram.made
    assert (program.guarded, program.reads) == (1, 2)
    assert run.branches.counts[branch] == 2
    assert run.branches.last == [branch == "topk"]
    ref, ref_eager = (torch.Generator().manual_seed(4) for _ in range(2))
    eager = make_eval_step(cfg, eager=True)
    for loss, aux in calls:
        with torch.no_grad():
            unsplit = forward(model, cfg, x, 1500, ref)
        for other_loss, other in (unsplit, eager(model, x, 1500, ref_eager)):
            assert torch.equal(loss, other_loss)
            assert all(torch.equal(aux["losses"][k], other["losses"][k])
                       for k in other["losses"])
            for k in ("recon", "z_where", "z_pres", "z_attr"):
                assert torch.equal(aux[k], other[k]), k


@pytest.mark.parametrize("mode,branch", CASES, ids=IDS)
def test_evaluate_segments_equal_eager(monkeypatch, mode, branch):
    """evaluate over 2 batches as captured (one segmented program, its
    second batch guarded) equals the eager evaluate: every metric, the last
    batch's aux; one predicate read a batch."""
    _patch(monkeypatch, GuardedProgram)
    cfg, model = CFGS[mode], model_for(mode, branch)
    state, batches = tiny_state(model), scenes(2)
    kw = dict(det_threshold=0.5, det_nms=0.5)
    got, aux, _ = teval.evaluate(cfg, state, 2, data=batches, **kw)
    (program,) = GuardedSegments.made
    assert (program.guarded, program.reads) == (1, 2)
    assert program.branches.counts[branch] == 2
    want, want_aux, _ = teval.evaluate(cfg, state, 2, data=batches,
                                       eager=True, **kw)
    assert got == want
    assert all(torch.equal(aux[k], want_aux[k])
               for k in ("recon", "z_where", "z_pres", "z_pres_prob"))


# ---------------------- (d) the segmented calls, with stand-in graphs

class StandInGraph:
    """A captured graph's stand-in: its replay logs its name and runs
    ``effect``, what the graph would write."""

    def __init__(self, name, log, effect=lambda: None):
        self.name, self.log, self.effect = name, log, effect

    def replay(self):
        self.log.append(self.name)
        self.effect()


def test_a_segmented_call_replays_a_then_the_b_it_reads(monkeypatch):
    """A call of 4 steps: each replays A, reads the predicate A wrote once
    and replays that branch's B; the branches are counted, the metrics
    copied out of the static output after each B, and the launches of each
    replay added (K1 and K2 once a B)."""
    log = []
    cfg = CFGS["reference"]
    state = create_train_state(cfg, device="cpu")
    step = captured.SegmentedStep(None, None, None, steps_per_call=4)
    flips = iter([True, False, False, True])
    pred = torch.zeros((), dtype=torch.bool)
    out = torch.zeros(2)
    step.graph = StandInGraph("A", log, lambda: pred.fill_(next(flips)))
    step.per_replay = [0, 0, 0, 0]
    step.pred = pred
    step.tails = {
        True: (StandInGraph("B topk", log, lambda: out.add_(1)),
               [1, 1, 0, 0]),
        False: (StandInGraph("B full", log, lambda: out.add_(10)),
                [1, 1, 0, 0])}
    step.keys, step.static_out = ["a", "b"], out
    step.bound, step.ready = captured._addresses(state), True
    real_read = captured.takes_topk
    monkeypatch.setattr(captured, "takes_topk",
                        lambda p: (log.append("read"), real_read(p))[1])
    before = (K.composite_forward.launches, K.composite_backward.launches)
    _, metrics = step(state)
    assert log == ["A", "read", "B topk", "A", "read", "B full",
                   "A", "read", "B full", "A", "read", "B topk"]
    assert step.branches.counts == {"topk": 2, "full": 2}
    assert step.branches.last == [True, False, False, True]
    assert metrics["a"].tolist() == [1, 11, 21, 22]
    assert (K.composite_forward.launches - before[0],
            K.composite_backward.launches - before[1]) == (4, 4)


def test_a_segmented_program_call_replays_a_then_the_b_it_reads(monkeypatch):
    """SegmentedForward's call: the inputs copied into the static ones, A
    replayed, its predicate read once, that branch's B replayed and its
    outputs returned as copies."""
    log = []
    x = torch.zeros(3)
    model = torch.nn.Linear(1, 1)
    program = captured.SegmentedForward(None, None, None)
    entry = captured._Graph()
    pred = torch.zeros((), dtype=torch.bool)
    entry.static_in, entry.pred = (x.clone(),), pred
    entry.graph = StandInGraph("A", log, lambda: pred.fill_(
        bool(entry.static_in[0][0] > 0)))
    entry.per_replay = [0, 0, 0, 0]
    entry.tails = {}
    for topk, value in ((True, 1.0), (False, 2.0)):
        tail = entry.tails[topk] = captured._Graph()
        tail.graph = StandInGraph(f"B {topk}", log)
        tail.static_out, tail.tree = torch.utils._pytree.tree_flatten(
            {"out": torch.full((2,), value)})
        tail.per_replay = [0, 0, 0, 0]
    entry.ready = True
    program.graphs[((3,), x.dtype, x.device),] = entry
    program.bound = captured._module_addresses(model)
    real_read = captured.takes_topk
    monkeypatch.setattr(captured, "takes_topk",
                        lambda p: (log.append("read"), real_read(p))[1])
    got = [program(model, x + v)["out"] for v in (1.0, -1.0)]
    assert log == ["A", "read", "B True", "A", "read", "B False"]
    assert [g.tolist() for g in got] == [[1.0, 1.0], [2.0, 2.0]]
    assert program.branches.counts == {"topk": 1, "full": 1}
    assert program.branches.last == [False]
    assert got[0] is not entry.tails[True].static_out[0]


def stand_in_captures(monkeypatch, fail_at=None):
    """Captures and streams stood in on the CPU: a "capture" runs its
    function once, eagerly, and returns the generator registered with it
    (a list); the ``fail_at``-th raises as a capture that reads the host
    does."""
    registered = []

    def capture(graph, fn, device, generator=None, pool=None):
        registered.append(generator)
        if len(registered) == fail_at:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return fn(), [0, 0, 0, 0]
    monkeypatch.setattr(captured, "_warm_up", lambda device, fn: fn())
    monkeypatch.setattr(captured, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(ts, "eager_reason", lambda *a: None)
    return registered


@pytest.mark.parametrize("mode", sorted(CFGS))
def test_both_b_captures_run_backward_through_one_a(monkeypatch, mode):
    """The first call's captures, each run once on the CPU: A, then the
    top-K B, whose backward keeps A's autograd graph, then the full B,
    whose backward runs through it again although the first B's Adam
    updated the parameters A saved (autograd's version counters are put
    back: a capture runs nothing). The state's generator is registered
    with A alone; the step is ready."""
    registered = stand_in_captures(monkeypatch)
    made = []
    real = ts.SegmentedStep

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(ts, "SegmentedStep", keep)
    cfg = CFGS[mode]
    state = state_for(mode, "topk")
    step = make_train_step(cfg, datagen=data(cfg))
    _, metrics = step(state)
    (seg,) = made
    assert registered == [state.generator, None, None]
    assert seg.ready and sorted(seg.tails) == [False, True]
    assert step.branches.last == [True]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_a_failed_b_capture_raises_and_is_not_retried(monkeypatch):
    """The warm-up step runs; the capture of the second segment raises; the
    call raises, no step runs eagerly in its place, and the next call
    raises without running (captures and streams stood in on the CPU)."""
    cfg = CFGS["ordered"]
    state = state_for("ordered", "topk")
    registered = stand_in_captures(monkeypatch, fail_at=2)
    step = make_train_step(cfg, datagen=data(cfg), steps_per_call=3)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        step(state)
    # the state's generator registered with A alone
    assert registered == [state.generator, None]
    assert int(state.step) == 1 and step.branches.counts["topk"] == 1
    with pytest.raises(RuntimeError, match="capture failed"):
        step(state)
    assert int(state.step) == 1


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "raises"])
def test_the_collector_is_off_during_a_capture(monkeypatch, fails):
    """A graph that the garbage collector frees during another capture
    invalidates it, so a capture runs with the collector off and turns it
    back on after, whether the capture succeeds or raises."""
    class Graph:  # torch.cuda.graph's stand-in
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def fn():
        if fails:
            raise RuntimeError("capture")
        return gc.isenabled()
    monkeypatch.setattr(torch.cuda, "graph", Graph)
    monkeypatch.setattr(captured, "_side_stream", lambda device: None)
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture"):
            captured._capture(None, fn, "cpu")
    else:
        assert captured._capture(None, fn, "cpu") == (
            False, [0] * len(captured.COUNTED))
    assert gc.isenabled()


# --------------------------- (e) the top-K branch against the JAX package

@pytest.mark.parametrize("mode", sorted(CFGS))
def test_the_top_k_branch_of_forward_matches_jax(mode):
    """A sparse state (4 and 5 live objects in the two images, on the
    predicate's boundary at K = 5; independent inference, as the gradient
    tests of tests/test_torch_options.py): the port's forward takes the
    top-K branch, and its loss, terms and reconstruction equal the JAX
    package's forward, which takes it in its lax.cond; in reference mode
    every parameter's gradient too (ordered mode's top-K gradients are
    held against JAX's at the render, test_torch_options.py's tie test)."""
    jcfg = dataclasses.replace(JCFGS[mode], render_topk=5,
                               inference_mode="independent")
    pnp, _, x, noise = setup(jcfg, seed=21)
    pnp["obj_net"]["heads"][0]["b"] = pnp["obj_net"]["heads"][0]["b"] - 5.0
    model = ported_params(jcfg, pnp)
    cfg, step = tcfg(jcfg), 2500
    with torch.no_grad():
        head = forward_head(model, cfg, t(x), step, noise=tnoise(noise))
    live = (head["objects"]["gate"] > 0).sum(1)
    assert live.tolist() == [4, 5] and bool(head["live_at_most_k"])
    def jax_fn(p):
        return jax_forward(p, jcfg, jnp.asarray(x), step, None, noise)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    if mode == "ordered":
        (loss_j, aux_j), jgrads = jax.jit(jax_fn)(jp), None
    else:
        (loss_j, aux_j), jgrads = jax.jit(jax.value_and_grad(
            jax_fn, has_aux=True))(jp)
    loss, aux = forward(model, cfg, t(x), step, noise=tnoise(noise))
    assert abs(float(loss.detach()) - float(loss_j)) \
        < F32_REL * abs(float(loss_j))
    for k, v in aux_j["losses"].items():
        assert abs(float(aux["losses"][k].detach()) - float(v)) \
            < F32_REL * max(1.0, abs(float(v))), k
    assert_close(aux["recon"], np.asarray(aux_j["recon"]))
    if jgrads is None:
        return
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss.backward()
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_close(g, want[k], rel=GRAD_REL)
