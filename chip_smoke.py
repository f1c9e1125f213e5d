#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spair_pytorch_tpu_torch).

Drives the port's serving path and its training step at paper128 width on
one CUDA card, with random weights from the preset's seed:

  1. device     the card's name and power limit (nvidia-smi);
  2. build      compiles csrc/composite_fwd.cu and csrc/composite_bwd.cu,
                one nvcc each, started together;
  3. kernel     the composite kernel against its plain PyTorch version at
                paper128 shapes (B=32, N=121, C=1, 28x28 glimpses, 128x128
                canvas): f32 ungated, f32 gated, all gated, bf16 glimpses,
                den_floor_n; error = max |kernel - plain| / max |plain|;
  4. eval step  make_eval_step on a generated batch of 32, through the
                kernel ('auto') and through the plain compositor ('xla');
                ungated and with pres_gate_threshold=0.01;
  5. serving    DetectorServer with buckets (1, 8, 32) answers 64 requests;
  6. times      CUDA-event times after warmup: kernel vs plain compositor at
                B=32 and B=128 (both kernels first held against their plain
                versions on the timed inputs, ungated and gated), the eval
                step and the detector at B=32; each layer of the eval step
                alone; the device-busy share of one eval step under
                torch.profiler;
  7. backward   the backward kernel against composite_backward_plain at
                paper128 shapes: f32 ungated and gated, all gated (exact
                zeros), bf16 glimpses against f32 truth, C=3; and the
                autograd Function against autograd through composite_plain;
  8. train      one f32 train step at B=32 through the kernels ('auto') and
                through the plain compositor ('xla'), from the same weights,
                images and noise: loss and every parameter's gradient;
  9. main path  make_train_step(datagen, steps_per_call=10) at paper128,
                bf16, wavefront, gate 0.01, batch 128: cold-start steps
                from random weights (dense presence), finite losses, ms/step
                and img/s, the device-busy share of one step; then both
                kernels against their plain versions on the compositor
                inputs that the trained state's inference and decoder make
                for a generated batch of 128 (f32 glimpses, the 0.01 gate);
 10. times      the backward kernel against its plain version at B=32 and
                B=128, each first held against it on the timed inputs.

Every phase raises on failure. TF32 is off for the whole run (matmuls and
cuDNN convs in full f32), so kernels and plain versions are compared on the
same arithmetic. The last two lines are a JSON summary of the kernels and
the result line {"ok": true, "device": {...}}.

    python3 chip_smoke.py              # on a machine with a CUDA card
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

F32_BAR = 1e-4   # f32 forward relative error (bench.py's kernel gate)
BF16_BAR = 3e-2  # bf16 glimpses against f32 truth
GRAD_BAR = 1e-3       # f32 gradients (bench.py's gradient gate)
BF16_GRAD_BAR = 6e-2  # bf16 glimpses' gradients against f32 truth
B, N, C, OH, OW, HW, WIN = 32, 121, 1, 28, 28, (128, 128), 64
TRAIN_B, STEPS_PER_CALL, TRAIN_CALLS = 128, 10, 3


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call between CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_glimpses(b, n, gen, dev, c=C):
    """Inputs drawn as the JAX package's bench check draws them: uniform
    glimpses, importance >= 0.01, centres in [0.05, 0.95], scales in
    [0.05, anchor/H]."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    color = u(b, n, c, OH, OW)
    alpha = u(b, n, 1, OH, OW)
    imp = u(b, n, 1, OH, OW, lo=0.01)
    boxes = torch.cat([u(b, n, 2, lo=0.05, hi=0.95),
                       u(b, n, 2, lo=0.05, hi=48 / HW[0])], dim=-1)
    return color, alpha, imp, boxes.contiguous()


def rel_err(got, want):
    """(max |got - want| / max |want|, max |got - want|) over all outputs."""
    abs_err = max(float((g.float() - w).abs().max())
                  for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return abs_err / scale, abs_err


def check(tag, name, bar, got, want):
    """Hold a kernel's outputs against its plain version's; raises above
    ``bar``, returns the max abs error."""
    torch.cuda.synchronize()
    rel, abs_err = rel_err(got, want)
    phase(tag, f"{name}: rel err {rel:.3e} (bar {bar:g}), max abs err "
               f"{abs_err:.3e}")
    if not rel < bar:
        raise AssertionError(f"{tag} case {name} disagrees: {rel}")
    return abs_err


def random_gate(b, gen, dev):
    """About 30% of the objects gated off."""
    return (torch.rand((b, N), generator=gen, device=dev) > 0.3).float()


def random_cotangents(b, gen, dev, c=C):
    return (torch.randn((b, c) + HW, generator=gen, device=dev),
            torch.randn((b, 1) + HW, generator=gen, device=dev))


def held_at(K, inputs, gate, cotangents):
    """K1 and K2 against their plain versions on one set of inputs (color,
    alpha, importance, boxes) and cotangents (dnum, dden), ungated and with
    ``gate``."""
    b = inputs[0].shape[0]
    dnum, dden = cotangents
    for name, g in (("ungated", None), ("gated", gate)):
        check("held", f"composite_fwd B={b} {name}", F32_BAR,
              K.composite_forward(*inputs, HW, WIN, pres_gate=g),
              K.composite_plain(*inputs, HW, pres_gate=g))
        check("held", f"composite_bwd B={b} {name}", GRAD_BAR,
              K.composite_backward(*inputs, HW, dnum, dden, pres_gate=g),
              K.composite_backward_plain(*inputs, HW, dnum, dden,
                                         pres_gate=g))


def kernel_phase(K, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    color, alpha, imp, boxes = random_glimpses(B, N, gen, dev)
    gate = (torch.rand((B, N), generator=gen, device=dev) > 0.7).float()
    cases = {}

    def case(name, bar, got, want):
        cases[name] = check("kernel", name, bar, got, want)

    args = (color, alpha, imp, boxes, HW)
    case("f32 ungated", F32_BAR, K.composite_forward(*args, WIN),
         K.composite_plain(*args))
    phase("kernel", f"f32 gated: {int(gate.sum())} of {B * N} objects live")
    case("f32 gated", F32_BAR,
         K.composite_forward(*args, WIN, pres_gate=gate),
         K.composite_plain(*args, pres_gate=gate))

    num, den = K.composite_forward(*args, WIN,
                                   pres_gate=torch.zeros_like(gate))
    torch.cuda.synchronize()
    floor = torch.tensor(N * 1e-9, dtype=torch.float32)
    if not (bool((num == 0).all())
            and torch.allclose(den.cpu(), floor.expand(den.shape),
                               rtol=1e-6, atol=0)):
        raise AssertionError("all-gated composite is not num=0, den=N*1e-9")
    phase("kernel", f"all gated: num == 0, den == {float(den[0, 0, 0, 0]):.6e}")

    bf = tuple(t.to(torch.bfloat16) for t in (color, alpha, imp))
    case("bf16 glimpses", BF16_BAR, K.composite_forward(*bf, boxes, HW, WIN),
         K.composite_plain(*args))

    few = tuple(t[:, :16].contiguous() for t in (color, alpha, imp, boxes))
    case("den_floor_n=121, N=16", F32_BAR,
         K.composite_forward(*few, HW, WIN, den_floor_n=N),
         K.composite_plain(*few, HW, den_floor_n=N))
    return max(v for k, v in cases.items() if not k.startswith("bf16"))


def profiled(fn):
    """Run fn once under torch.profiler after a synchronize: (wall ms,
    device-busy ms, device kernel count, key_averages)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # only the device's own rows (kernels, memcpy, memset), as the
    # profiler's "Self CUDA time total" counts them: host-side rows (aten::
    # ops, autograd nodes) and device-side user annotations (the optimizer's
    # record_function range) repeat the time of the kernels inside them
    from torch.autograd import DeviceType
    events = prof.key_averages()
    device_rows = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in device_rows) / 1e3
    return wall, busy, sum(e.count for e in device_rows), events


def profile_eval(cfg, params, x, step, eval_step, card):
    """Per-layer times of one eval step (CUDA events, each layer run alone
    and synchronized) and the device-busy share from torch.profiler."""
    from spair_pytorch_tpu_torch.models.infer import nms_keep_batch
    from spair_pytorch_tpu_torch.models.kl import (count_prior_kl,
                                                   independent_kl)
    from spair_pytorch_tpu_torch.models.render import render
    from spair_pytorch_tpu_torch.models.spair import (infer_latents,
                                                      loss_and_metrics)

    gen = torch.Generator(device=x.device).manual_seed(4)
    with torch.no_grad():
        z = infer_latents(params, cfg, x, step, gen)
        kls = independent_kl(z["posterior"], z["z_pres"], cfg)
        recon = render(params, cfg, z["z_attr"], z["z_where"], z["z_depth"],
                       z["z_pres"], cfg.image_shape[1:])
        xla = dataclasses.replace(cfg, render_backend="xla")
        boxes = torch.rand((x.shape[0], 121, 4), device=x.device) * 64
        boxes[..., 2:] += boxes[..., :2]
        layers = {
            "backbone": lambda: params.backbone(x),
            "inference (backbone + wavefront scan)":
                lambda: infer_latents(params, cfg, x, step, gen),
            "independent KL": lambda: independent_kl(
                z["posterior"], z["z_pres"], cfg),
            "count-prior KL": lambda: count_prior_kl(
                z["z_pres_prob"], z["z_pres"], step, cfg),
            "render, kernel": lambda: render(
                params, cfg, z["z_attr"], z["z_where"], z["z_depth"],
                z["z_pres"], cfg.image_shape[1:]),
            "render, plain compositor": lambda: render(
                params, xla, z["z_attr"], z["z_where"], z["z_depth"],
                z["z_pres"], cfg.image_shape[1:]),
            "loss": lambda: loss_and_metrics(x, recon, kls, cfg),
            "NMS B=32 (IoU 0.5)": lambda: nms_keep_batch(
                boxes, torch.rand(boxes.shape[:2], device=x.device), 0.5),
        }
        for name, fn in layers.items():
            phase("layer", f"{name}: {cuda_ms(fn, 5):.3f} ms ({card})")
        eval_step(params, x, step, gen)
        wall, busy, n_kernels, events = profiled(
            lambda: eval_step(params, x, step, gen))
    phase("layer", f"eval step under the profiler: {wall:.3f} ms wall, "
                   f"device busy {busy:.3f} ms ({busy / wall:.1%}), "
                   f"{n_kernels} device kernels ({card})")
    print(events.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)


def grad_rel(got, want):
    """max |got - want| / max(1, max |want|), bench.py's gradient error."""
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def backward_phase(K, dev):
    """The backward kernel against composite_backward_plain at paper128
    shapes; returns the largest f32 absolute error."""
    gen = torch.Generator(device=dev).manual_seed(17)
    errs = {}

    def case(name, bar, inputs, gate=None, bf16=False):
        color, alpha, imp, boxes = inputs
        dnum, dden = random_cotangents(B, gen, dev, c=color.shape[2])
        glimpses = (color, alpha, imp)
        if bf16:
            glimpses = tuple(t.to(torch.bfloat16) for t in glimpses)
        got = K.composite_backward(*glimpses, boxes, HW, dnum, dden,
                                   pres_gate=gate)
        want = K.composite_backward_plain(color, alpha, imp, boxes, HW, dnum,
                                          dden, pres_gate=gate)
        errs[name] = check("backward", name, bar, got, want)
        return got

    inputs = random_glimpses(B, N, gen, dev)
    gate = (torch.rand((B, N), generator=gen, device=dev) > 0.7).float()
    case("f32 ungated", GRAD_BAR, inputs)
    got = case("f32 gated", GRAD_BAR, inputs, gate)
    dead = gate == 0
    if not all(bool((g[dead] == 0).all()) for g in got):
        raise AssertionError("gated objects got nonzero gradients")
    got = K.composite_backward(*inputs, HW, torch.ones((B, C) + HW, device=dev),
                               torch.ones((B, 1) + HW, device=dev),
                               pres_gate=torch.zeros_like(gate))
    torch.cuda.synchronize()
    if not all(bool((g == 0).all()) for g in got):
        raise AssertionError("all-gated backward is not exactly zero")
    phase("backward", "all gated: every gradient == 0")
    case("bf16 glimpses", BF16_GRAD_BAR, inputs, gate, bf16=True)
    case("C=3 gated", GRAD_BAR, random_glimpses(B, N, gen, dev, c=3), gate)

    # the autograd Function against autograd through the plain compositor
    color, alpha, imp, boxes = (t[:4].contiguous() for t in inputs)
    nb = color.shape[0]
    dnum, dden = random_cotangents(nb, gen, dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (color, alpha, imp, boxes)]
        num, den = fn(*leaves, HW, pres_gate=gate[:nb].contiguous())
        torch.autograd.backward((num, den), (dnum, dden))
        return [t.grad for t in leaves]

    got, want = grads(K.composite), grads(K.composite_plain)
    rel = max(grad_rel(g, w) for g, w in zip(got, want))
    phase("backward", f"CompositeFunction vs autograd through composite_plain"
                      f" (B={nb}, gated): rel err {rel:.3e} (bar "
                      f"{GRAD_BAR:g})")
    if not rel < GRAD_BAR:
        raise AssertionError("CompositeFunction disagrees with autograd")
    return max(v for k, v in errs.items() if not k.startswith("bf16"))


def train_parity_phase(K, cfg, x, dev):
    """One f32 train step at B=32 through the kernels and through the plain
    compositor, from the same weights, images and noise."""
    from spair_pytorch_tpu_torch.models import geometry, sample_noise
    from spair_pytorch_tpu_torch.parallel import create_train_state, train_step

    noise = sample_noise(torch.Generator(device=dev).manual_seed(9), B,
                         geometry(cfg)[1], cfg, dev)

    def run(backend):
        c = dataclasses.replace(cfg, render_backend=backend)
        state = create_train_state(c, device=dev)
        state.step.fill_(1500)  # past the training wheel: every head learns
        metrics = train_step(c, state, x, noise=noise)
        torch.cuda.synchronize()
        return metrics, {k: p.grad for k, p in
                         state.model.named_parameters()}

    K.composite_forward.launches = K.composite_backward.launches = 0
    m_k, g_k = run("auto")
    launches = (K.composite_forward.launches, K.composite_backward.launches)
    m_p, g_p = run("xla")
    loss_k, loss_p = float(m_k["losses/total"]), float(m_p["losses/total"])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(g_p, key=lambda k: grad_rel(g_k[k], g_p[k]))
    grad_err = grad_rel(g_k[worst], g_p[worst])
    phase("train", f"f32 step B={B}: loss {loss_k:.6f} (plain compositor "
                   f"{loss_p:.6f}, rel diff {loss_rel:.3e}, bar {F32_BAR:g});"
                   f" worst parameter gradient {worst} rel err "
                   f"{grad_err:.3e} (bar {GRAD_BAR:g}); launches K1 "
                   f"{launches[0]}, K2 {launches[1]}")
    if min(launches) < 1:
        raise AssertionError("the train step did not launch both kernels")
    if not (loss_rel < F32_BAR and grad_err < GRAD_BAR):
        raise AssertionError("kernel train step disagrees with the plain "
                             "compositor")


def main_path_phase(K, card, dev):
    """The training main path at paper128, bf16, wavefront, gate 0.01,
    batch 128: make_train_step with on-device data, steps_per_call=10.
    Returns the kernel launch counts of the run."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import DataConfig, glyph_bank
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)

    cfg = PRESETS["paper128"](batch_size=TRAIN_B, inference_mode="wavefront",
                              compute_dtype="bfloat16",
                              pres_gate_threshold=0.01)
    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    dcfg = DataConfig(image_hw=cfg.image_shape[1:],
                      min_objects=cfg.min_scene_objects,
                      max_objects=cfg.max_scene_objects)
    state = create_train_state(cfg, device=dev)
    step_fn = make_train_step(cfg, datagen=(dcfg, bank),
                              steps_per_call=STEPS_PER_CALL)

    K.composite_forward.launches = K.composite_backward.launches = 0
    losses = []
    t0 = time.perf_counter()
    state, m = step_fn(state)  # warmup call: cuDNN and allocator
    losses.append(m["losses/total"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_CALLS):
        state, m = step_fn(state)
        losses.append(m["losses/total"])
    end.record()
    torch.cuda.synchronize()
    launches = (K.composite_forward.launches, K.composite_backward.launches)
    ms = start.elapsed_time(end) / (TRAIN_CALLS * STEPS_PER_CALL)
    losses = torch.cat(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    if min(launches) < 1:
        raise AssertionError(f"the main path did not launch both kernels: "
                             f"{launches}")
    steps = (1 + TRAIN_CALLS) * STEPS_PER_CALL
    phase("main", f"{steps} train steps, paper128 bf16 wavefront gate 0.01 "
                  f"b{TRAIN_B}: losses {float(losses[0]):.1f} -> "
                  f"{float(losses[-1]):.1f}, all finite; live objects "
                  f"{float(m['debug/pres_count_mean'][-1]):.1f}/{N} per image"
                  f" (cold start from random weights: dense presence, unlike"
                  f" bench.py's --pretrain 2500); launches K1 {launches[0]}, "
                  f"K2 {launches[1]}; warmup call {warm:.2f} s")
    phase("main", f"train step: {ms:.3f} ms/step, {TRAIN_B / ms * 1e3:.1f} "
                  f"img/s (CUDA events over {TRAIN_CALLS} calls of "
                  f"{STEPS_PER_CALL} steps; {card})")
    one = make_train_step(cfg, datagen=(dcfg, bank))
    wall, busy, n_kernels, events = profiled(lambda: one(state))
    # the profiler's host overhead stretches the wall; the busy share of the
    # unprofiled step is the device time over the CUDA-event ms/step
    phase("main", f"one train step under the profiler: {wall:.3f} ms wall, "
                  f"device busy {busy:.3f} ms ({busy / wall:.1%} of that "
                  f"wall, {busy / ms:.1%} of the unprofiled {ms:.3f} ms), "
                  f"{n_kernels} device kernels ({card})")
    print(events.table(sort_by="self_device_time_total", row_limit=15),
          flush=True)

    # both kernels held against their plain versions on the compositor's
    # inputs as the main path's render makes them from the trained state
    inputs, gate = main_path_inputs(state, cfg, dcfg, bank)
    phase("main", f"main-path compositor inputs: glimpses {inputs[0].dtype},"
                  f" {int(gate.sum())} of {gate.numel()} objects live")
    held_at(K, inputs, gate, random_cotangents(
        TRAIN_B, torch.Generator(device=dev).manual_seed(5), dev))
    return launches


def main_path_inputs(state, cfg, dcfg, bank):
    """((color, alpha, importance, boxes), gate) as ``render`` hands them to
    the compositor, for a batch generated from the state's generator."""
    from spair_pytorch_tpu_torch.data import generate_batch
    from spair_pytorch_tpu_torch.models.render import decode_objects
    from spair_pytorch_tpu_torch.models.spair import (compute_dtype,
                                                      infer_latents)
    x, _, _ = generate_batch(state.generator, bank, cfg.batch_size, dcfg)
    with torch.no_grad():
        z = infer_latents(state.model, cfg, x, state.step, state.generator)
        flat = {k: z[k].reshape(x.shape[0], -1, z[k].shape[-1])
                for k in ("z_attr", "z_pres", "z_depth", "z_where")}
        glimpses = decode_objects(state.model, cfg, flat["z_attr"],
                                  flat["z_pres"], flat["z_depth"],
                                  compute_dtype(cfg))
    gate = (flat["z_pres"][..., 0] > cfg.pres_gate_threshold).float()
    return (*glimpses, flat["z_where"].contiguous()), gate.contiguous()


def backward_times(K, card, dev):
    """CUDA-event ms of the backward kernel and its plain version, in turns
    (plain, kernel, kernel, plain), at B=32 and B=128, each held against
    its plain version on the inputs it is timed on."""
    times = {}
    for b in (32, 128):
        gen = torch.Generator(device=dev).manual_seed(b + 1)
        inputs = random_glimpses(b, N, gen, dev)
        dnum, dden = random_cotangents(b, gen, dev)
        held_at(K, inputs, random_gate(b, gen, dev), (dnum, dden))

        def kern():
            K.composite_backward(*inputs, HW, dnum, dden)

        def plain():
            K.composite_backward_plain(*inputs, HW, dnum, dden)

        p1, k1, k2, p2 = (cuda_ms(f, 10) for f in (plain, kern, kern, plain))
        times[b] = ((k1 + k2) / 2, (p1 + p2) / 2)
        phase("time", f"composite backward B={b}: kernel {times[b][0]:.4f} "
                      f"ms, plain {times[b][1]:.4f} ms ({card})")
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import (DataConfig, generate_batch,
                                              glyph_bank)
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.ops.kernels import composite as K
    from spair_pytorch_tpu_torch.parallel import make_eval_step
    from spair_pytorch_tpu_torch.serve import DetectorServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    libs = K.build_library()
    for name in libs:
        K.load_library(name)
    phase("build", f"{', '.join(p.name for p in libs.values())} in "
                   f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel against plain version
    with torch.no_grad():
        max_abs_err = kernel_phase(K, dev)

    # 4. eval step, paper128 wavefront f32
    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    dcfg = DataConfig(image_hw=cfg.image_shape[1:],
                      max_objects=cfg.max_scene_objects)
    x, _, _ = generate_batch(torch.Generator(device=dev).manual_seed(0),
                             bank, B, dcfg)
    step = 1500

    def run(c):
        loss, aux = make_eval_step(c)(
            params, x, step, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        return loss, aux

    for thr in (0.0, 0.01):
        c_auto = dataclasses.replace(cfg, render_backend="auto",
                                     pres_gate_threshold=thr)
        c_xla = dataclasses.replace(c_auto, render_backend="xla")
        K.composite_forward.launches = 0
        loss, aux = run(c_auto)
        n_launch = K.composite_forward.launches
        loss_x, aux_x = run(c_xla)
        recon = aux["recon"]
        if n_launch < 1:
            raise AssertionError("the eval step did not launch the kernel")
        if tuple(recon.shape) != (B,) + cfg.image_shape or not (
                bool(torch.isfinite(loss)) and bool(torch.isfinite(recon).all())):
            raise AssertionError(f"eval step output bad: loss {loss}, "
                                 f"recon {tuple(recon.shape)}")
        rel = abs(float(loss) - float(loss_x)) / abs(float(loss_x))
        recon_err = float((recon - aux_x["recon"]).abs().max())
        live = int((aux["z_pres"] > thr).sum()) if thr else B * N
        phase("eval", f"gate {thr}: loss {float(loss):.6f} (plain "
                      f"compositor {float(loss_x):.6f}, rel diff {rel:.3e}, "
                      f"bar {F32_BAR:g}); recon max abs diff "
                      f"{recon_err:.3e}; kernel launches {n_launch}; "
                      f"{live} live objects")
        if not (rel < F32_BAR and recon_err < F32_BAR):
            raise AssertionError("kernel eval step disagrees with the plain "
                                 "compositor")

    # 5. serving
    server = DetectorServer(cfg, params, batch_sizes=(1, 8, 32))
    server.warmup()
    requests, _, labels = generate_batch(
        torch.Generator(device=dev).manual_seed(2), bank, 64, dcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = server.detect(requests)
    dt = time.perf_counter() - t0
    counts = [d["count"] for d in dets]
    if len(dets) != 64 or not all(
            d["boxes"].shape == (d["count"], 4) for d in dets):
        raise AssertionError("detector returned malformed detections")
    hist = {k: counts.count(k) for k in sorted(set(counts))}
    phase("serve", f"64 requests in {dt * 1e3:.1f} ms ({64 / dt:.1f} img/s, "
                   f"host clock, buckets 1/8/32); predicted counts {hist} "
                   f"(random weights: counts are not meaningful)")

    # 6. times (CUDA events, after warmup)
    times = {}
    with torch.no_grad():
        for b in (32, 128):
            gen = torch.Generator(device=dev).manual_seed(b)
            inputs = random_glimpses(b, N, gen, dev)
            held_at(K, inputs, random_gate(b, gen, dev),
                    random_cotangents(b, gen, dev))

            def kern():
                K.composite_forward(*inputs, HW, WIN)

            def plain():
                K.composite_plain(*inputs, HW)

            p1, k1, k2, p2 = (cuda_ms(f, 20) for f in (plain, kern, kern,
                                                       plain))
            times[b] = ((k1 + k2) / 2, (p1 + p2) / 2)
            phase("time", f"composite B={b}: kernel {times[b][0]:.4f} ms, "
                          f"plain {times[b][1]:.4f} ms ({card})")
    eval_auto = make_eval_step(cfg)
    eval_xla = make_eval_step(dataclasses.replace(cfg, render_backend="xla"))
    gen = torch.Generator(device=dev).manual_seed(3)
    e_k = cuda_ms(lambda: eval_auto(params, x, step, gen), 5)
    e_p = cuda_ms(lambda: eval_xla(params, x, step, gen), 5)
    phase("time", f"eval step B=32: {e_k:.3f} ms with the kernel, "
                  f"{e_p:.3f} ms with the plain compositor ({card})")
    detect = make_detector(cfg)
    d_ms = cuda_ms(lambda: detect(params, x), 5)
    phase("time", f"detector B=32: {d_ms:.3f} ms/call, "
                  f"{B / d_ms * 1e3:.1f} img/s ({card})")

    profile_eval(cfg, params, x, step, eval_auto, card)

    # 7. backward kernel against its plain version
    bwd_abs_err = backward_phase(K, dev)

    # 8. one f32 train step, kernels against the plain compositor
    train_parity_phase(K, dataclasses.replace(cfg, pres_gate_threshold=0.01),
                       x, dev)

    # 9. the training main path
    launches = main_path_phase(K, card, dev)

    # 10. backward times
    bwd_times = backward_times(K, card, dev)

    src = "spair_pytorch_tpu_torch/csrc"
    pallas = "spair_pytorch_tpu/ops/pallas/composite.py"
    print(json.dumps({"kernels": [
        {"name": "composite_fwd", "route": "cuda",
         "source": f"{src}/composite_fwd.cu", "replaces": f"{pallas}:79",
         "launches": launches[0], "max_abs_err": max_abs_err,
         "ms": times[32][0], "plain_ms": times[32][1]},
        {"name": "composite_bwd", "route": "cuda",
         "source": f"{src}/composite_bwd.cu", "replaces": f"{pallas}:133",
         "launches": launches[1], "max_abs_err": bwd_abs_err,
         "ms": bwd_times[32][0], "plain_ms": bwd_times[32][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
