"""The port's train step as a captured CUDA graph (``parallel/captured.py``),
what can be held on the CPU.

(a) The steps a graph captures make no host read and no copy from the
host: one step of each form, after a warm-up step that fills the caches as
the capture's warm-up does, runs with the Tensor methods that read a value
on the host patched to raise, with host-data factories (``torch.tensor``
of a list or a number, ``torch.from_numpy``, ...) refused and with the ops
whose output shape depends on the data refused. On the CPU the optimizer
is not capturable and reads its step count with ``.item()``: those count
tensors alone are exempt (on CUDA ``optimizer()`` keeps them on the device).
The same for the data-parallel step at world size 1 over gloo, whose
collectives a capture holds on the card (``world_of_one``; its segmented
form with ``render_topk`` is in ``tests/test_torch_captured_topk.py``).
(b) Which configurations stay eager, and why: ``render_topk`` and ``mesh``
no longer among them (the top-K segments are held in
``tests/test_torch_captured_topk.py``).
(c) The CPU step is the
parent commit's eager step, bit for bit: ``make_train_step`` against a
loop of ``train_step`` with the parent's Adam.

The card's side (captured against eager, fresh metrics, launch counts,
binding, a failed capture) is in ``tests/test_torch_kernel_gpu.py``."""

import contextlib
import dataclasses
import importlib

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from spair_pytorch_tpu_torch.config import PRESETS
from spair_pytorch_tpu_torch.data import (DataConfig, generate_batch,
                                          glyph_bank)
from spair_pytorch_tpu_torch.models.render import topk_branches
from spair_pytorch_tpu_torch.parallel import (TrainState, create_train_state,
                                              make_train_step, train_step)
from spair_pytorch_tpu_torch.parallel.captured import eager_reason
from spair_pytorch_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from spair_pytorch_tpu_torch.utils import debug

# the module (the package exports its function ``train_step`` by that name)
ts = importlib.import_module("spair_pytorch_tpu_torch.parallel.train_step")

# the main path (paper128's widths, wavefront, bf16, gate 0.01) on a
# 48x48 canvas and a batch of 2
MAIN = PRESETS["paper128"](image_shape=(1, 48, 48), batch_size=2,
                           inference_mode="wavefront",
                           compute_dtype="bfloat16", pres_gate_threshold=0.01)
# the configurations captured on the card besides the main path: the plain
# compositor, tpu_throughput's inference and count prior, ordered
# compositing without top-K, the conv codec, the self-attention.
# 'pallas_v3' is not among them: on the CPU it runs K3/K4's plain version,
# which builds its band mask from host data; the card's K3/K4 take the
# bands as launch parameters and are held by the gpu tests
OPTIONS = {
    "main": {},
    "xla": dict(render_backend="xla"),
    "tpu_throughput": dict(inference_mode="independent",
                           count_prior_parallel=True),
    "ordered": dict(render_mode="ordered"),
    "conv_codec": dict(object_codec="conv"),
    "self_attn": dict(vestigial_self_attn=True),
}
HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__",
              "tolist", "cpu", "numpy")
HOST_DATA = (torch.tensor, torch.as_tensor, torch.asarray, torch.from_numpy)
DATA_SHAPED = ("nonzero", "masked_select", "unique", "_unique2",
               "unique_consecutive", "argwhere", "repeat_interleave.Tensor",
               "repeat_interleave.self_Tensor")


def data(cfg):
    bank = torch.as_tensor(glyph_bank((14, 14)))
    return DataConfig(image_hw=cfg.image_shape[1:],
                      min_objects=cfg.min_scene_objects,
                      max_objects=cfg.max_scene_objects), bank


class _NoHostData(TorchFunctionMode):
    """Refuses tensors made from host data: on the card each is a copy from
    the host, which a capture refuses."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = args[0] if args else kwargs.get("data", kwargs.get("obj"))
        if func is torch.Tensor.new_tensor:
            src = args[1] if len(args) > 1 else kwargs.get("data")
        if ((func in HOST_DATA or func is torch.Tensor.new_tensor)
                and not isinstance(src, torch.Tensor)):
            raise AssertionError(f"{func.__name__} of host data in the step")
        return func(*args, **kwargs)


class _NoDataShapedOps(TorchDispatchMode):
    """Refuses a read of a value on the host from below Python (``aten.
    _local_scalar_dense``; ``exempt`` holds the ids of the tensors allowed
    it), ops whose output shape depends on the data (each reads a count on
    the host) and indexing by a boolean mask."""

    def __init__(self, exempt):
        super().__init__()
        self.exempt = exempt

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name == "_local_scalar_dense" and id(args[0]) not in self.exempt:
            raise AssertionError(f"{func} in the step")
        if name in DATA_SHAPED or f"{name}.{func._overloadname}" in \
                DATA_SHAPED or (
                name in ("index", "index_put", "index_put_") and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ()) or ())):
            raise AssertionError(f"{func} in the step")
        return func(*args, **(kwargs or {}))


def step_counts(state):
    """The CPU optimizer's step counts, which it reads with ``.item()``."""
    return [s["step"] for s in state.optimizer.state.values()]


@contextlib.contextmanager
def no_host_reads(exempt=()):
    """Inside: the host reads raise for every tensor but those in
    ``exempt`` (a train step's: ``step_counts(state)``), host-data
    factories and data-shaped ops too."""
    exempt = {id(t) for t in exempt}
    with pytest.MonkeyPatch.context() as mp:
        for name in HOST_READS:
            original = getattr(torch.Tensor, name)

            def refuse(self, *a, _name=name, _original=original, **kw):
                if id(self) in exempt:
                    return _original(self, *a, **kw)
                raise AssertionError(f"Tensor.{_name} in the step")
            mp.setattr(torch.Tensor, name, refuse)
        with _NoHostData(), _NoDataShapedOps(exempt):
            yield


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_datagen_step_makes_no_host_read(option):
    cfg = dataclasses.replace(MAIN, **OPTIONS[option])
    step = make_train_step(cfg, datagen=data(cfg))
    state = create_train_state(cfg, device="cpu")
    step(state)  # the warm-up step: schedules and caches made once
    with no_host_reads(step_counts(state)):
        _, metrics = step(state)
    assert int(state.step) == 2
    assert "losses/total" in metrics and "accuracy/count_exact" in metrics
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("with_detection", [True, False],
                         ids=["with_detection", "images"])
def test_batch_step_makes_no_host_read(with_detection):
    dcfg, bank = data(MAIN)
    step = make_train_step(MAIN, with_detection=with_detection)
    state = create_train_state(MAIN, device="cpu")
    gen = torch.Generator().manual_seed(3)
    batches = [generate_batch(gen, bank, MAIN.batch_size, dcfg)
               for _ in range(2)]

    def arg(b):
        return b if with_detection else b[0]
    step(state, arg(batches[0]))
    with no_host_reads(step_counts(state)):
        _, metrics = step(state, arg(batches[1]))
    assert int(state.step) == 2
    assert len(metrics) == (24 if with_detection else 20)


@pytest.fixture
def world_of_one(monkeypatch):
    """A data-parallel world of one rank over gloo, as ``make_mesh`` starts
    it without torchrun's environment."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh("cpu")
    try:
        yield mesh
    finally:
        mesh.close()


@pytest.mark.parametrize("k", [1, 2])
def test_mesh_step_makes_no_host_read(world_of_one, k):
    """The data-parallel step (its gradient all-reduce and metrics
    all-gather), a call of K steps after a warm-up call, under the guard."""
    step = make_train_step(MAIN, world_of_one, datagen=data(MAIN),
                           steps_per_call=k)
    state = replicate(world_of_one, create_train_state(MAIN, device="cpu"))
    step(state)
    with no_host_reads(step_counts(state)):
        _, metrics = step(state)
    assert int(state.step) == 2 * k
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


@pytest.mark.parametrize("fault, message", [
    (lambda n: n * (n.item() > 0), "Tensor.item"),
    (lambda n: n * bool(n > 0), "Tensor.__bool__"),
    (lambda n: n * torch.tensor(1.0), "tensor of host data"),
    (lambda n: n + n.reshape(1)[n.reshape(1) > 0].sum(), "index"),
    (lambda n: n + n[n > 0].sum(), "_local_scalar_dense"),
], ids=["item", "bool", "tensor", "mask", "scalar_mask"])
def test_the_guard_catches_a_host_read(monkeypatch, fault, message):
    """The guard of the two tests above fails a step that reads a value on
    the host (from Python or below it), makes a tensor from host data or
    indexes by a mask."""
    step = make_train_step(MAIN, datagen=data(MAIN))
    state = create_train_state(MAIN, device="cpu")
    step(state)
    real = ts.global_norm
    monkeypatch.setattr(ts, "global_norm", lambda g: fault(real(g)))
    with pytest.raises(AssertionError, match=message):
        with no_host_reads(step_counts(state)):
            step(state)


def test_what_stays_eager():
    cuda = torch.device("cuda")
    assert eager_reason(MAIN, cuda) is None
    assert eager_reason(PRESETS["paper128"](), cuda) is None
    assert eager_reason(PRESETS["tpu_throughput"](), cuda) is None
    assert "CUDA device" in eager_reason(MAIN, "cpu")
    # the data-parallel step is captured, its collectives in the graph
    mesh = Mesh(world_size=1, rank=0, device=cuda, owns_group=False)
    assert eager_reason(MAIN, cuda, mesh) is None
    assert "CUDA device" in eager_reason(MAIN, "cpu", mesh)
    for preset in ("cluttered_fine", "quality"):
        # captured as segments around the render's top-K branch
        assert eager_reason(PRESETS[preset](), cuda) is None
        assert topk_branches(PRESETS[preset]())
    assert not topk_branches(MAIN) and not topk_branches(PRESETS["quality"](
        render_topk=0))
    try:
        debug.enable_nan_hunter(True)
        assert "NaN hunter" in eager_reason(MAIN, cuda)
    finally:
        debug.enable_nan_hunter(False)
    try:
        debug.enable_debug_nans(True)
        assert "NaN hunter" in eager_reason(MAIN, cuda)
    finally:
        debug.enable_debug_nans(False)
    assert eager_reason(MAIN, cuda) is None


def test_the_cpu_step_never_captures(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU step reached the capture")
    monkeypatch.setattr(ts, "CapturedStep", refuse)
    step = make_train_step(MAIN, datagen=data(MAIN), steps_per_call=2)
    state = create_train_state(MAIN, device="cpu")
    step(state)
    assert int(state.step) == 2
    assert not state.optimizer.defaults["capturable"]


def parent_state(cfg, seed):
    """``create_train_state`` with the parent commit's optimizer: Adam over
    the parameters with lr, betas and eps as the reference sets them."""
    fresh = create_train_state(cfg, seed=seed, device="cpu")
    opt = torch.optim.Adam(fresh.model.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(step=fresh.step, model=fresh.model, optimizer=opt,
                      generator=fresh.generator)


def parent_steps(cfg, state, n, dcfg, bank):
    """n eager steps of the parent's datagen step, one at a time."""
    out = []
    for _ in range(n):
        x, gt_bbox, gt_count = generate_batch(state.generator, bank,
                                              cfg.batch_size, dcfg)
        out.append(train_step(cfg, state, x, gt_bbox, gt_count))
    return out


def assert_same_state(a, b):
    assert int(a.step) == int(b.step)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    for s, r in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert all(torch.equal(s[k], r[k]) for k in s)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("k", [1, 3])
def test_cpu_step_equals_the_parent_eager_step(k):
    """3 steps of ``make_train_step`` (three calls of K = 1, or one of
    K = 3): metrics, parameters, Adam's state and the generator equal the
    parent's eager step's bit for bit."""
    dcfg, bank = data(MAIN)
    step = make_train_step(MAIN, datagen=(dcfg, bank), steps_per_call=k)
    state = create_train_state(MAIN, seed=5, device="cpu")
    got = [step(state)[1] for _ in range(3 // k)]
    ref = parent_state(MAIN, 5)
    want = parent_steps(MAIN, ref, 3, dcfg, bank)
    for key in want[0]:
        seq = (torch.stack([g[key] for g in got]) if k == 1
               else got[0][key])
        assert seq.shape == (3,), key
        assert torch.equal(seq, torch.stack([w[key] for w in want])), key
    assert_same_state(state, ref)


@pytest.mark.parametrize("with_detection", [True, False],
                         ids=["with_detection", "images"])
def test_cpu_batch_step_equals_the_parent_eager_step(with_detection):
    dcfg, bank = data(MAIN)
    gen = torch.Generator().manual_seed(9)
    batches = [generate_batch(gen, bank, MAIN.batch_size, dcfg)
               for _ in range(3)]
    step = make_train_step(MAIN, with_detection=with_detection)
    state = create_train_state(MAIN, seed=5, device="cpu")
    ref = parent_state(MAIN, 5)
    for x, gt_bbox, gt_count in batches:
        if with_detection:
            _, got = step(state, (x, gt_bbox, gt_count))
            want = train_step(MAIN, ref, x, gt_bbox, gt_count)
        else:
            _, got = step(state, x)
            want = train_step(MAIN, ref, x)
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert_same_state(state, ref)


def test_a_card_checkpoint_restores_into_the_cpu_optimizer(tmp_path):
    """A checkpoint whose Adam was capturable (as the card writes it)
    restores into the CPU's Adam, which stays not capturable and trains;
    the card's side (a checkpoint of the earlier, non-capturable Adam into
    the capturable one) is a gpu test."""
    from spair_pytorch_tpu_torch.utils.checkpoint import _FILE, \
        CheckpointManager

    step = make_train_step(MAIN, datagen=data(MAIN))
    state = create_train_state(MAIN, device="cpu")
    step(state)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state)
    path = tmp_path / "1" / _FILE
    payload = torch.load(path, weights_only=True)
    for group in payload["optimizer"]["param_groups"]:
        group["capturable"] = True
    torch.save(payload, path)
    restored = ckpt.restore(create_train_state(MAIN, device="cpu"))
    assert not any(g["capturable"] for g in restored.optimizer.param_groups)
    make_train_step(MAIN, datagen=data(MAIN))(restored)
    step(state)
    assert_same_state(restored, state)
