"""The port's forward programs as they are captured on the card (the
detector, the eval step and the per-batch programs of ``evaluate`` and
``calibrate``; ``parallel/captured.py::CapturedForward``), what can be held
on the CPU.

(a) NMS with no host read (``nms_keep_batch(early_exit=False)``, the
captured detector's form) keeps JAX's keep mask, on random scenes and on a
chain of N boxes each of which suppresses the next (depth N - 1, N sweeps).
(b) Each program as a capture takes it (the split refiner's too) makes no
host read, no tensor from host data and no data-shaped op after its
warm-up: ``CapturedForward`` is
replaced by a stand-in that runs the first call of each shape as the
warm-up does and every later call, where the card would capture and replay,
under the guard of ``tests/test_torch_captured_step.py``; the device is
taken for a card's. Its results equal the eager program's bit for bit, and
the deterministic ones JAX's (f32 relative error 1e-4; masks and counts
equal, as ``tests/test_torch_serve.py`` states). (c) Which programs stay
eager, and why: the CPU always, the NaN hunter for all; with
``render_topk`` the programs that render are captured as segments around
the render's branch (``GuardedSegments`` stands in for
``captured.SegmentedForward``; ``tests/test_torch_captured_topk.py`` holds
those segments).

The card's side (captured against eager, binding, a failed capture,
re-seeding) is in ``tests/test_torch_kernel_gpu.py``."""

import contextlib
import dataclasses
import importlib
import math
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spair_pytorch_tpu import eval as jeval
from spair_pytorch_tpu.models import infer as jinfer
from spair_pytorch_tpu_torch import eval as teval
from spair_pytorch_tpu_torch import metrics as tmetrics
from spair_pytorch_tpu_torch.config import PRESETS
from spair_pytorch_tpu_torch.models import infer as tinfer
from spair_pytorch_tpu_torch.models import refine as trefine
from spair_pytorch_tpu_torch.models.latents import geometry, noise_shapes
from spair_pytorch_tpu_torch.models.render import takes_topk
from spair_pytorch_tpu_torch.models.spair import forward, infer_latents
from spair_pytorch_tpu_torch.ops import quant as tq
from spair_pytorch_tpu_torch.parallel import captured, make_eval_step
from spair_pytorch_tpu_torch.serve import DetectorServer
from spair_pytorch_tpu_torch.utils import debug
from tests.test_model import tiny_config
from tests.test_torch_captured_step import no_host_reads
from tests.test_torch_ops import (assert_close, jax_params_np, ported_params,
                                  t, tcfg)

ts = importlib.import_module("spair_pytorch_tpu_torch.parallel.train_step")

JCFG = tiny_config(batch_size=2, inference_mode="wavefront",
                   pres_gate_threshold=0.01)
CFG = tcfg(JCFG)


# ------------------------------------------------------------------- NMS

def random_scene(seed, b=4, n=40):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 30, (b, n, 2))
    wh = rng.uniform(4, 20, (b, n, 2))
    return (np.concatenate([xy, xy + wh], -1).astype("f"),
            rng.rand(b, n).astype("f"))


def chain(n):
    """Two images of n boxes 10 px wide, 4 px apart: IoU 0.43 with the next
    box, 0.11 with the one after. In score order each box suppresses only
    the next, so greedy NMS keeps every other box, and sweeps from
    all-ones need all n to get there. The second image holds the same
    boxes in a shuffled order."""
    x0 = 4.0 * np.arange(n)
    boxes = np.stack([x0, np.zeros(n), x0 + 10, np.full(n, 10.0)], -1)
    scores = np.linspace(1.0, 0.5, n)
    perm = np.random.RandomState(n).permutation(n)
    return (np.stack([boxes, boxes[perm]]).astype("f"),
            np.stack([scores, scores[perm]]).astype("f"))


NMS_CASES = {f"random_{s}_{thr}": (random_scene(s), thr)
             for s, thr in ((0, 0.1), (1, 0.3), (2, 0.6))}
NMS_CASES.update({f"chain_{n}": (chain(n), 0.3) for n in (7, 121)})


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_without_a_host_read_equals_jax(case):
    (boxes, scores), thr = NMS_CASES[case]
    with no_host_reads():
        got = tinfer.nms_keep_batch(t(boxes), t(scores), thr,
                                    early_exit=False)
    want = np.asarray(jinfer.nms_keep_batch(jnp.asarray(boxes),
                                            jnp.asarray(scores), thr))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tinfer.nms_keep_batch(t(boxes), t(scores), thr).numpy(), want)
    for i in range(boxes.shape[0]):
        np.testing.assert_array_equal(want[i], np.asarray(jinfer.nms_keep(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr)))
    if case.startswith("chain"):
        n = boxes.shape[1]
        in_order = got[0].numpy()
        np.testing.assert_array_equal(in_order, np.arange(n) % 2 == 0)
        # the depth: n - 1 sweeps change the keep set, the n-th changes
        # nothing
        iou = tinfer.pairwise_iou(t(boxes[0])).numpy()
        edge = (iou > thr) & np.tril(np.ones((n, n), bool), -1)
        keep, changed = np.ones(n, bool), 0
        while True:
            new = ~(edge & keep[None, :]).any(-1)
            if (new == keep).all():
                break
            keep, changed = new, changed + 1
        assert changed == n - 1
    else:
        assert 0 < want.sum() < want.size


# ------------------------------------------- the programs, as captured

class GuardedProgram:
    """``CapturedForward``'s stand-in on the CPU: the first call of each
    input shape runs the program as the warm-up does; every later call
    runs it where the card captures or replays it, under the guard. Inputs
    become static buffers as the capture makes them."""

    made = []

    def __init__(self, program, generator=None, pool=None):
        self.program, self.generator = program, generator
        self.shapes = set()
        self.guarded = 0
        GuardedProgram.made.append(self)

    def __call__(self, params, *inputs):
        key = tuple(tuple(x.shape) if torch.is_tensor(x) else type(x)
                    for x in inputs)
        inputs = tuple(captured.static_input(x, "cpu") for x in inputs)
        if key not in self.shapes:
            self.shapes.add(key)
            return self.program(params, *inputs)
        self.guarded += 1
        with no_host_reads():
            return self.program(params, *inputs)


class GuardedSegments:
    """``SegmentedForward``'s stand-in on the CPU: the first call of each
    input shape runs the head, the predicate's read and the tail as the
    warm-up does; every later call runs the head and the tail where the
    card replays A and a B, each under the guard, and reads the predicate
    between them, outside it, once (``reads``)."""

    made = []

    def __init__(self, head, tail, predicate, generator=None, pool=None,
                 branches=None):
        self.head, self.tail, self.predicate = head, tail, predicate
        self.generator = generator
        self.branches = captured.Branches() if branches is None else branches
        self.shapes = set()
        self.guarded = 0
        self.reads = 0
        GuardedSegments.made.append(self)

    def __call__(self, params, *inputs):
        key = tuple(tuple(x.shape) if torch.is_tensor(x) else type(x)
                    for x in inputs)
        inputs = tuple(captured.static_input(x, "cpu") for x in inputs)
        guard = no_host_reads if key in self.shapes else contextlib.nullcontext
        self.guarded += key in self.shapes
        self.shapes.add(key)
        with guard():
            carry = self.head(params, *inputs)
        topk = takes_topk(self.predicate(carry))
        self.reads += 1
        self.branches.new_call()
        self.branches.took(topk)
        with guard():
            return self.tail(params, carry, topk)


def _patch(monkeypatch, program_cls, segments_cls=GuardedSegments):
    """Every module that makes a CapturedForward makes ``program_cls``
    (and a SegmentedForward ``segments_cls``), and the CPU is taken for a
    card when the choice is made."""
    reason = captured.forward_eager_reason

    def as_on_a_card(cfg, device):
        return reason(cfg, "cuda")
    for module in (captured, ts, teval):
        monkeypatch.setattr(module, "CapturedForward", program_cls)
        monkeypatch.setattr(module, "SegmentedForward", segments_cls)
        monkeypatch.setattr(module, "forward_eager_reason", as_on_a_card)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(teval, "_CAPTURES", weakref.WeakKeyDictionary())
    GuardedProgram.made = []
    GuardedSegments.made = []


@pytest.fixture
def as_captured(monkeypatch):
    _patch(monkeypatch, GuardedProgram)
    return GuardedProgram


@pytest.fixture(scope="module")
def tiny():
    pnp = jax_params_np(JCFG, seed=21)
    x = np.random.RandomState(22).rand(2, 1, 48, 48).astype("f")
    return pnp, ported_params(JCFG, pnp), x


@pytest.mark.parametrize("nms_iou", [None, 0.5], ids=["no_nms", "nms_0.5"])
@pytest.mark.parametrize("weights", ["f32", "bf16", "int8"])
def test_detector_program_makes_no_host_read(as_captured, tiny, weights,
                                             nms_iou):
    """Two calls of the captured detector (the second guarded) equal the
    eager detector bit for bit; f32 equals JAX's detect."""
    pnp, model, x = tiny
    cfg = CFG
    if weights == "bf16":
        cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    if weights == "int8":
        model = tq.quantize_params_int8(model)
    detect = tinfer.make_detector(cfg, 0.5, nms_iou)
    first = detect(model, t(x))
    got = detect(model, t(x))
    assert [p.guarded for p in as_captured.made] == [1]
    want = tinfer.make_detector(cfg, 0.5, nms_iou, eager=True)(model, t(x))
    for out in (first, got):
        assert list(out) == list(want)
        assert all(torch.equal(out[k], want[k]) for k in want)
    if weights == "f32":
        ref = jinfer.detect(pnp, jnp.asarray(x), JCFG, 0.5, nms_iou)
        for k in ("boxes", "scores", "z_depth"):
            assert_close(got[k], np.asarray(ref[k]))
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.asarray(ref["count"]))


@pytest.mark.parametrize("margin", [0.0, "tensor", math.inf, -math.inf])
def test_refiner_program_makes_no_host_read(as_captured, tiny, margin):
    """make_refiner's program at B=2 after the detector, called twice (the
    second guarded), with the margin a float, a 0-d tensor or an infinity
    (-inf with max_neighbor_iou 1, which splits every live detection of
    the top M): the four outputs equal the eager refiner's bit for bit."""
    _, model, x = tiny
    det = tinfer.make_detector(CFG, 0.5, 0.5, eager=True)(model, t(x))
    if margin == "tensor":
        margin = torch.tensor(0.0)
    kw = dict(top_m=5, max_neighbor_iou=1.0 if margin == -math.inf else 0.3)
    refiner = trefine.make_refiner(CFG, **kw)
    calls = [refiner(model, t(x), det, margin, 0.5) for _ in range(2)]
    assert [p.guarded for p in as_captured.made] == [1]
    want = trefine.make_refiner(CFG, eager=True, **kw)(model, t(x), det,
                                                       margin, 0.5)
    for got in calls:
        assert sorted(got) == ["boxes", "count", "n_split", "scores"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    if margin == -math.inf:
        assert int(want["n_split"].sum()) > 0


def test_the_detector_step_is_the_parents_int_step(tiny):
    """The detector's step, a device tensor made once, gives the latents
    the Python int 10 ** 6 gave, bit for bit."""
    _, model, x = tiny
    noise = {k: torch.zeros(s) for k, s in noise_shapes(
        2, geometry(CFG)[1], CFG).items()}
    step = tinfer._wheel_off_step(torch.device("cpu"))
    assert step is tinfer._wheel_off_step(torch.device("cpu"))
    a = infer_latents(model, CFG, t(x), 10 ** 6, noise=noise)
    b = infer_latents(model, CFG, t(x), step, noise=noise)
    for k in ("z_where", "z_pres_prob", "z_depth", "training_wheel"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("step", [1500, "tensor"])
def test_eval_step_program_makes_no_host_read(as_captured, tiny, step):
    """The captured eval step (x and the step static inputs, a Python int
    step filled into a tensor) called twice, the second guarded: loss and
    aux equal the eager step's bit for bit, from generators in one state.
    A call with another generator raises."""
    _, model, x = tiny
    if step == "tensor":
        step = torch.tensor(1500)
    run = make_eval_step(CFG)
    gen = torch.Generator().manual_seed(4)
    calls = [run(model, t(x), step, gen) for _ in range(2)]
    assert [p.guarded for p in as_captured.made] == [1]
    eager = make_eval_step(CFG, eager=True)
    ref = torch.Generator().manual_seed(4)
    for loss, aux in calls:
        want_loss, want = eager(model, t(x), 1500, ref)
        assert torch.equal(loss, want_loss)
        assert sorted(aux) == sorted(want)
        for k in want:
            if k == "losses":
                assert all(torch.equal(aux[k][n], want[k][n])
                           for n in want[k])
            else:
                assert torch.equal(aux[k], want[k]), k
    with pytest.raises(RuntimeError, match="generator of its first call"):
        run(model, t(x), step, torch.Generator().manual_seed(4))


def scenes(n, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        count = rng.randint(1, 4, (2, 1)).astype("f")
        xy = rng.uniform(0, 30, (2, 6, 2))
        box = np.concatenate([xy, np.full((2, 6, 2), 14.0)], -1)
        box *= (np.arange(6)[None, :, None] < count[:, :, None])
        out.append(tuple(map(t, (rng.rand(2, 1, 48, 48).astype("f"),
                                 box.astype("f"), count))))
    return out


def tiny_state(model):
    return types.SimpleNamespace(model=model, step=torch.tensor(1500))


@pytest.mark.parametrize("det", [(None, None), (0.5, 0.5)],
                         ids=["plain", "calibrated_nms"])
def test_evaluate_program_makes_no_host_read(as_captured, tiny, det):
    """evaluate over 2 batches, twice: one captured program (the second
    batch and the second call guarded), re-seeded at each call. Both
    results and the last aux equal the eager evaluate's; the deterministic
    detector's keys equal JAX's."""
    pnp, model, _ = tiny
    state, data = tiny_state(model), scenes(2)
    kw = dict(det_threshold=det[0], det_nms=det[1])
    got = [teval.evaluate(CFG, state, 2, data=data, **kw) for _ in range(2)]
    assert len(as_captured.made) == 1 and as_captured.made[0].guarded == 3
    want, want_aux, _ = teval.evaluate(CFG, state, 2, data=data, eager=True,
                                       **kw)
    for result, aux, x in got:
        assert result == want
        assert all(torch.equal(aux[k], want_aux[k]) for k in
                   ("recon", "z_where", "z_pres", "z_pres_prob"))
        assert x is data[-1][0]
    jdata = [tuple(jnp.asarray(v.numpy()) for v in b) for b in data]
    ref, _, _ = jeval.evaluate(JCFG, types.SimpleNamespace(
        params=pnp, step=1500), 2, data=iter(jdata), **kw)
    assert sorted(ref) == sorted(want)
    for k in ("det_count_acc_50", "det_count_acc_70", "det_count_acc_cal"):
        if k in ref:
            assert want[k] == pytest.approx(ref[k], abs=1e-6), k


def test_calibrate_program_makes_no_host_read(as_captured, tiny):
    """calibrate over 2 batches: one captured program for each NMS setting
    (the second batch guarded); its result equals the eager calibrate's
    and JAX's (counts equal, AP@0.5 within 1e-4)."""
    pnp, model, _ = tiny
    state, data = tiny_state(model), scenes(2, seed=5)
    got = teval.calibrate(CFG, state, 2, data=data)
    assert [p.guarded for p in as_captured.made] == [1] * len(
        teval.CALIB_NMS)
    want = teval.calibrate(CFG, state, 2, data=data, eager=True)
    assert got == want
    jdata = [tuple(jnp.asarray(v.numpy()) for v in b) for b in data]
    ref = jeval.calibrate(JCFG, types.SimpleNamespace(params=pnp, step=1500),
                          2, data=iter(jdata))
    assert got["count_accuracy"] == ref["count_accuracy"]
    assert (got["pres_threshold"], got["nms_iou"]) == (ref["pres_threshold"],
                                                       ref["nms_iou"])
    for g in got["ap_at_50"]:
        assert got["ap_at_50"][g] == pytest.approx(ref["ap_at_50"][g],
                                                   abs=1e-4)


@torch.no_grad()
def parent_evaluate(cfg, state, batches, data, det_threshold, det_nms,
                    seed=1234):
    """The parent commit's eager evaluate, its loop as it was."""
    data, img = iter(data), cfg.image_shape[-1]
    gen = torch.Generator().manual_seed(seed)
    sums, pooled = None, {t: [] for t in teval.AP_THRESHOLDS}
    for _ in range(batches):
        x, gt_bbox, gt_count = next(data)
        _, aux = forward(state.model, cfg, x, state.step, gen)
        zw, zp = aux["z_where"], aux["z_pres"]
        for t in teval.AP_THRESHOLDS:
            pooled[t].append(tmetrics.match_predictions(
                zw, zp, gt_bbox, gt_count, img, iou_threshold=t))
        det = tinfer.detect(state.model, x, cfg)
        gt = gt_count[:, 0]
        m = {"bbox_average_precision": tmetrics.mAP(zw, zp, gt_bbox,
                                                    gt_count, img),
             "bbox_ap_center": tmetrics.mAP_center(zw, zp, gt_bbox,
                                                   gt_count, img),
             "object_count_error": tmetrics.object_count_error(zp, gt_count),
             "count_exact_accuracy": tmetrics.count_accuracy(zp, gt_count),
             "det_count_acc_50": torch.mean((det["count"] == gt).float()),
             "det_count_acc_70": torch.mean(
                 (torch.sum(det["scores"] >= 0.7, dim=-1) == gt).float())}
        if det_threshold is not None:
            scores = det["scores"] * tinfer.nms_keep_batch(
                det["boxes"], det["scores"], det_nms)
            m["det_count_acc_cal"] = torch.mean(
                (torch.sum(scores >= det_threshold, dim=-1) == gt).float())
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    result = {k: float(v) / batches for k, v in sums.items()}
    for t in teval.AP_THRESHOLDS:
        result[f"ap_at_{int(t * 100)}"] = tmetrics.average_precision(
            *(torch.cat([p[i].reshape(-1) for p in pooled[t]]).numpy()
              for i in range(3)))
    result["step"] = int(state.step)
    return result


@torch.no_grad()
def parent_calibrate_tables(cfg, state, data):
    """The parent commit's eager calibrate loop: hits and pooled matches
    per NMS setting."""
    th = torch.as_tensor(teval.CALIB_THRESHOLDS)
    hits = {g: np.zeros(len(th)) for g in teval.CALIB_NMS}
    pooled = {g: [] for g in teval.CALIB_NMS}
    for x, gt_bbox, gt_count in data:
        for g in teval.CALIB_NMS:
            det = tinfer.detect(state.model, x, cfg, nms_iou=g)
            counts = torch.sum(det["scores"][:, None, :]
                               >= th[None, :, None], dim=-1)
            hits[g] += torch.sum((counts == gt_count[:, :1]).float(),
                                 dim=0).numpy()
            pooled[g].append([t.reshape(-1).numpy() for t in
                              tmetrics.match_boxes(det["boxes"],
                                                   det["scores"], gt_bbox,
                                                   gt_count, 0.5)])
    return hits, pooled


def test_evaluate_and_calibrate_equal_the_parents(tiny):
    """The restructured eager evaluate and calibrate give the parent
    commit's loops' results exactly: every metric, and calibrate's count
    table and AP@0.5 from the parent's hits and matches."""
    _, model, _ = tiny
    state, data = tiny_state(model), scenes(2, seed=7)
    for det in ((None, None), (0.5, 0.5)):
        got = teval.evaluate(CFG, state, 2, data=data, det_threshold=det[0],
                             det_nms=det[1])[0]
        assert got == parent_evaluate(CFG, state, 2, data, *det)
    got = teval.calibrate(CFG, state, 2, data=data)
    hits, pooled = parent_calibrate_tables(CFG, state, data)
    for g in teval.CALIB_NMS:
        key = "none" if g is None else f"{g:.1f}"
        assert got["count_accuracy"][key] == {
            f"{t:.2f}": float(a) for t, a in
            zip(teval.CALIB_THRESHOLDS, hits[g] / 4)}
        assert got["ap_at_50"][key] == tmetrics.average_precision(
            *(np.concatenate([p[i] for p in pooled[g]]) for i in range(3)))


def test_evaluate_reuses_one_capture_a_model(as_captured, tiny):
    """The evaluations of a run reuse one program a model and option set:
    the second evaluate makes none; another model makes its own."""
    pnp, model, _ = tiny
    data = scenes(1)
    teval.evaluate(CFG, tiny_state(model), 1, data=data)
    teval.evaluate(CFG, tiny_state(model), 1, data=data)
    assert len(as_captured.made) == 1
    other = ported_params(JCFG, pnp)
    teval.evaluate(CFG, tiny_state(other), 1, data=data)
    teval.evaluate(CFG, tiny_state(model), 1, data=data, det_threshold=0.5)
    assert len(as_captured.made) == 3


def test_the_server_captures_every_bucket_at_warmup(as_captured, tiny):
    _, model, x = tiny
    server = DetectorServer(CFG, model, batch_sizes=(1, 2))
    seconds = server.warmup()
    assert sorted(seconds) == [1, 2]
    (program,) = as_captured.made
    assert program.shapes == {((1, 1, 48, 48),), ((2, 1, 48, 48),)}
    dets = server.detect(np.concatenate([x, x[:1]]))
    assert program.guarded == 2 and len(dets) == 3


# ---------------------------------------------------- what stays eager

def test_what_stays_eager():
    """The CPU and the NaN hunter keep every program eager; every preset's
    programs are captured on a card, the render_topk presets' too."""
    cuda = torch.device("cuda")
    reason = captured.forward_eager_reason
    for preset in ("paper128", "small48", "tpu_throughput",
                   "cluttered_fine", "quality"):
        assert reason(PRESETS[preset](), cuda) is None
    assert "CUDA device" in reason(CFG, "cpu")
    try:
        debug.enable_nan_hunter(True)
        assert "NaN hunter" in reason(CFG, cuda)
        assert "NaN hunter" in reason(PRESETS["quality"](), cuda)
    finally:
        debug.enable_nan_hunter(False)


def refuse(*a, **kw):
    raise AssertionError("an eager program reached the capture")


def run_every_program(cfg, model, x):
    tinfer.make_detector(cfg, nms_iou=0.5)(model, t(x))
    make_eval_step(cfg)(model, t(x), 1500, torch.Generator())
    teval.evaluate(cfg, tiny_state(model), 1, data=scenes(1))
    teval.calibrate(cfg, tiny_state(model), 1, data=scenes(1))


def test_the_cpu_never_captures_a_forward_program(monkeypatch, tiny):
    for module in (captured, ts, teval):
        monkeypatch.setattr(module, "CapturedForward", refuse)
        monkeypatch.setattr(module, "SegmentedForward", refuse)
    _, model, x = tiny
    run_every_program(CFG, model, x)
    run_every_program(dataclasses.replace(CFG, render_topk=4), model, x)


@pytest.mark.parametrize("option", ["render_topk", "nan_hunter"])
def test_what_stays_eager_stays_eager(monkeypatch, tiny, option):
    """As on a card: with render_topk every program is captured, the eval
    step and evaluate's batch program as segments around the render's
    branch, the detector and calibrate's programs (which do not render) as
    one graph each; with the NaN hunter every program stays eager."""
    _, model, x = tiny
    _patch(monkeypatch, GuardedProgram)
    made = []

    def record(program, generator=None, pool=None):
        made.append(program)
        return GuardedProgram(program, generator, pool)
    for module in (captured, ts, teval):
        monkeypatch.setattr(module, "CapturedForward", record)
    cfg = CFG
    if option == "render_topk":
        cfg = dataclasses.replace(CFG, render_topk=4, pres_gate_threshold=0.01)
        run_every_program(cfg, model, x)
        # the detector, and calibrate's four NMS settings, one graph each;
        # the eval step and evaluate, segments
        assert len(made) == 1 + len(teval.CALIB_NMS)
        assert len(GuardedSegments.made) == 2
        assert all(p.reads == 1 for p in GuardedSegments.made)
    else:
        try:
            debug.enable_nan_hunter(True)
            run_every_program(cfg, model, x)
        finally:
            debug.enable_nan_hunter(False)
        assert not made and not GuardedSegments.made
