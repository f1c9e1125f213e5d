#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spair_pytorch_tpu_torch).

Drives the port's serving path, its training step and its training entry
point through the banded compositor ('pallas_v3') at paper128 width on one
CUDA card, with random weights from the preset's seed:

  1. device     the card's name and power limit (nvidia-smi);
  2. build      compiles csrc/composite_fwd.cu, composite_bwd.cu,
                composite_v3_fwd.cu and composite_v3_bwd.cu, one nvcc each,
                started together;
  3. kernel     the composite kernel against its plain PyTorch version at
                paper128 shapes (B=32, N=121, C=1, 28x28 glimpses, 128x128
                canvas): f32 ungated, f32 gated, all gated, bf16 glimpses,
                den_floor_n; error = max |kernel - plain| / max |plain|
                for each output (num, den; dcolor, dalpha, dimp, dbox) on
                its own, as in every later phase;
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
 10. v3         K3 and K4 (csrc/composite_v3_*.cu) against their plain
                versions at paper128 shapes, B=32 and B=128, boxes from the
                model's parameterization: f32 ungated, f32 with about half
                the objects zeroed as the gate zeroes them, bf16 glimpses
                against f32 truth, all gated; K3 against K1 on the same
                inputs;
 11. v3 times   K1, K2, K3, K4 and their plain versions on the same inputs
                in one call, at B=32 and B=128, with each kernel's bound;
 12. v3 path    the training entry point, train(), at paper128, bf16,
                wavefront, gate 0.01, b128, render_backend='pallas_v3',
                steps_per_call=10: 20 steps with checkpoints and held-out
                evaluation every 10, a restore checked tensor for tensor,
                then a resumed run of 10 more; K3 and K4 launch counts, the
                eval keys, K3/K4 against their plain versions on the path's
                own compositor inputs; then the same step timed alone.

Every phase raises on failure. TF32 is off for the whole run (matmuls and
cuDNN convs in full f32), so kernels and plain versions are compared on the
same arithmetic. The last two lines are a JSON summary of the kernels and
the result line {"ok": true, "device": {...}}.

    python3 chip_smoke.py              # on a machine with a CUDA card
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# the paper128 model's box parameterization, which fixes K3/K4's bands:
# 11x11 grid of 12-px cells, centres in the cell + [-0.5, 1.5], scales up to
# max_hw * anchor / H = 48 / 128
GRID, CELL, BOUNDS = (11, 11), 12, (-0.5, 1.5, 48 / 128)
V3_GEOM = (HW, CELL, GRID, BOUNDS)
# the card's peaks for the bound (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# the JAX package's evaluate() keys, without a calibrated threshold
EVAL_KEYS = ("ap_at_30", "ap_at_40", "ap_at_50", "ap_at_60",
             "bbox_ap_center", "bbox_average_precision",
             "count_exact_accuracy", "det_count_acc_50", "det_count_acc_70",
             "object_count_error")


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


# the outputs a compositor call returns, in order
OUTPUTS = {2: ("num", "den"), 4: ("dcolor", "dalpha", "dimp", "dbox")}


def rel_err(got, want):
    """([max |got - want| / max |want| for each output], max |got - want|
    over all of them). Each output is held to its own scale, so a large one
    (dbox) does not loosen the bar on a small one (dG)."""
    rels, abs_err = [], 0.0
    for g, w in zip(got, want):
        err, scale = float((g.float() - w).abs().max()), float(w.abs().max())
        rels.append(err / scale if scale else (math.inf if err else 0.0))
        abs_err = max(abs_err, err)
    return rels, abs_err


def check(tag, name, bar, got, want, names=None):
    """Hold a kernel's outputs against its plain version's, each output on
    its own; raises if any is above ``bar``, returns the max abs error."""
    torch.cuda.synchronize()
    rels, abs_err = rel_err(got, want)
    names = names or OUTPUTS[len(rels)]
    phase(tag, f"{name}: rel err " + ", ".join(
        f"{n} {r:.3e}" for n, r in zip(names, rels))
        + f" (bar {bar:g}), max abs err {abs_err:.3e}")
    if not max(rels) < bar:
        raise AssertionError(f"{tag} case {name} disagrees: {rels}")
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


def banded_glimpses(b, gen, dev):
    """paper128 glimpses (as random_glimpses draws them) on boxes from the
    model's parameterization: each object's centre in its cell + [-0.5,
    1.5], scales in [0.05, 0.375], so every box lies in its row's band."""
    color, alpha, imp, _ = random_glimpses(b, N, gen, dev)

    def u(lo, hi):
        return torch.rand((b, N), generator=gen, device=dev) * (hi - lo) + lo
    h = torch.arange(GRID[0], device=dev).repeat_interleave(GRID[1])
    w = torch.arange(GRID[1], device=dev).repeat(GRID[0])
    boxes = torch.stack([(w + u(*BOUNDS[:2])) * CELL / HW[1],
                         (h + u(*BOUNDS[:2])) * CELL / HW[0],
                         u(0.05, BOUNDS[2]), u(0.05, BOUNDS[2])], dim=-1)
    return color, alpha, imp, boxes.contiguous()


def masked(inputs, gate):
    """The glimpses zeroed where the gate is 0, as render masks them."""
    g = gate[:, :, None, None, None]
    return (*(t * g for t in inputs[:3]), inputs[3])


def v3_held(V, tag, inputs, cotangents):
    """K3 and K4 against their plain versions on one set of inputs; returns
    their max abs errors."""
    b = inputs[0].shape[0]
    e3 = check(tag, f"K3 B={b}", F32_BAR, V.composite_v3_forward(
        *inputs, *V3_GEOM), V.composite_v3_plain(*inputs, *V3_GEOM))
    e4 = check(tag, f"K4 B={b}", GRAD_BAR, V.composite_v3_backward(
        *inputs, *V3_GEOM, *cotangents), V.composite_v3_backward_plain(
            *inputs, *V3_GEOM, *cotangents))
    return e3, e4


def v3_phase(V, K, dev):
    """K3 and K4 against their plain versions at paper128 shapes, B=32 and
    B=128; returns the largest f32 absolute error of each."""
    errs3, errs4 = [], []
    for b in (32, 128):
        gen = torch.Generator(device=dev).manual_seed(300 + b)
        inputs = banded_glimpses(b, gen, dev)
        cot = random_cotangents(b, gen, dev)
        e3, e4 = v3_held(V, "v3", inputs, cot)
        errs3.append(e3)
        errs4.append(e4)

        gate = (torch.rand((b, N), generator=gen, device=dev) > 0.5).float()
        phase("v3", f"gated B={b}: {int(gate.sum())} of {b * N} objects "
                    f"live, the rest zeroed")
        e3, e4 = v3_held(V, "v3", masked(inputs, gate), cot)
        errs3.append(e3)
        errs4.append(e4)

        bf = tuple(t.to(torch.bfloat16) for t in inputs[:3])
        check("v3", f"K3 B={b} bf16 glimpses", BF16_BAR,
              V.composite_v3_forward(*bf, inputs[3], *V3_GEOM),
              V.composite_v3_plain(*inputs, *V3_GEOM))
        check("v3", f"K4 B={b} bf16 glimpses", BF16_GRAD_BAR,
              V.composite_v3_backward(*bf, inputs[3], *V3_GEOM, *cot),
              V.composite_v3_backward_plain(*inputs, *V3_GEOM, *cot))

        # all gated: every glimpse zeroed
        zero = masked(inputs, torch.zeros_like(gate))
        num, den = V.composite_v3_forward(*zero, *V3_GEOM)
        torch.cuda.synchronize()
        floor = torch.full_like(den, N * 1e-9)
        if not (bool((num == 0).all())
                and torch.allclose(den, floor, rtol=1e-6, atol=0)):
            raise AssertionError("all-gated K3 is not num=0, den=N*1e-9")
        grads = V.composite_v3_backward(*zero, *V3_GEOM, *cot)
        torch.cuda.synchronize()
        if not all(bool((grads[i] == 0).all()) for i in (0, 1, 3)):
            raise AssertionError("all-gated K4: dcolor, dalpha or dbox != 0")
        errs4.append(check(
            "v3", f"K4 B={b} all gated, importance gradient py^T dden px",
            GRAD_BAR, grads[2:3], V.composite_v3_backward_plain(
                *zero, *V3_GEOM, *cot)[2:3], names=("dimp",)))
        # what render hands upstream: gradients through the gate's mask
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out = V.composite_v3(*masked(leaves, torch.zeros_like(gate)),
                             *V3_GEOM)
        torch.autograd.backward(out, cot)
        if not all(bool((t.grad == 0).all()) for t in leaves):
            raise AssertionError("all-gated composite_v3 passed a gradient")
        phase("v3", f"all gated B={b}: num == 0, den == "
                    f"{float(den[0, 0, 0, 0]):.6e}; dcolor, dalpha, dbox == "
                    f"0; every gradient through the gate mask == 0")

        with torch.no_grad():
            check("v3", f"K3 against K1 B={b}", F32_BAR,
                  V.composite_v3_forward(*inputs, *V3_GEOM),
                  K.composite_forward(*inputs, HW, WIN))
    return max(errs3), max(errs4)


def bound(b, c, glimpse_bytes, forward, pairs):
    """(least ms, 'bytes' or 'operations') for one compositor call: each
    input read once and each output written once, against the card's HBM
    rate; and an estimate of the gather's arithmetic (per object and
    support pixel, (C + 2) bilinear samples of 9 operations and ~3C + 2
    more; four times that in the backward) against the f32 peak."""
    glimpses = b * N * (c + 2) * OH * OW * glimpse_bytes
    canvas = b * (c + 1) * HW[0] * HW[1] * 4
    boxes = b * N * 4 * 4
    if forward:
        moved = glimpses + boxes + canvas
        ops = pairs * (9 * (c + 2) + 3 * c + 2)
    else:  # glimpses, boxes, dnum, dden in; dG, dbox out
        moved = 2 * glimpses + 2 * boxes + canvas
        ops = 4 * pairs * (9 * (c + 2) + 3 * c + 2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def support_pairs(boxes, band_rows=None):
    """Canvas pixels inside each object's paste support (sy in (-1, oh),
    sx in (-1, ow)), summed over the objects; with ``band_rows`` (N, H)
    only the rows of each object's band count."""
    from spair_pytorch_tpu_torch.ops.stn import _source_coords_paste
    xt, yt, xs, ys = boxes.unbind(-1)
    sy = _source_coords_paste(yt, ys, HW[0], OH)
    sx = _source_coords_paste(xt, xs, HW[1], OW)
    rows = ((sy > -1) & (sy < OH)).float()
    if band_rows is not None:
        rows = rows * band_rows
    cols = ((sx > -1) & (sx < OW)).float()
    return float((rows.sum(-1) * cols.sum(-1)).sum())


def v3_times(V, K, card, dev):
    """CUDA-event ms of K1, K2, K3, K4 and the plain K3/K4 on the same
    inputs, in turns, at B=32 and B=128, with each kernel's bound. Each
    kernel is first held against its plain version on the timed inputs."""
    times = {}
    band, starts = V.band_geometry(HW, CELL, *BOUNDS, OH, GRID[0])
    y = torch.arange(HW[0], device=dev)
    lo = torch.as_tensor(starts, device=dev).repeat_interleave(GRID[1])
    band_rows = ((y >= lo[:, None]) & (y < lo[:, None] + band)).float()
    for b in (32, 128):
        gen = torch.Generator(device=dev).manual_seed(400 + b)
        inputs = banded_glimpses(b, gen, dev)
        dnum, dden = random_cotangents(b, gen, dev)
        v3_held(V, "time", inputs, (dnum, dden))
        held_at(K, inputs, random_gate(b, gen, dev), (dnum, dden))
        fns = {
            "K1": lambda: K.composite_forward(*inputs, HW, WIN),
            "plain K1": lambda: K.composite_plain(*inputs, HW),
            "K3": lambda: V.composite_v3_forward(*inputs, *V3_GEOM),
            "plain K3": lambda: V.composite_v3_plain(*inputs, *V3_GEOM),
            "K2": lambda: K.composite_backward(*inputs, HW, dnum, dden),
            "plain K2": lambda: K.composite_backward_plain(*inputs, HW, dnum,
                                                           dden),
            "K4": lambda: V.composite_v3_backward(*inputs, *V3_GEOM, dnum,
                                                  dden),
            "plain K4": lambda: V.composite_v3_backward_plain(
                *inputs, *V3_GEOM, dnum, dden),
        }
        got = {k: [] for k in fns}
        with torch.no_grad():
            for k in ("plain K1", "plain K3", "K3", "K1", "plain K2",
                      "plain K4", "K4", "K2", "K2", "K4", "plain K4",
                      "plain K2", "K1", "K3", "plain K3", "plain K1"):
                got[k].append(cuda_ms(fns[k], 5 if k.startswith("plain")
                                      else 20))
        t = {k: sum(v) / len(v) for k, v in got.items()}
        full = support_pairs(inputs[3])
        clipped = support_pairs(inputs[3], band_rows)
        t["bound"] = {"K1": bound(b, C, 4, True, full),
                      "K3": bound(b, C, 4, True, clipped),
                      "K2": bound(b, C, 4, False, full),
                      "K4": bound(b, C, 4, False, clipped)}
        times[b] = t
        for k in ("K1", "K3", "K2", "K4"):
            bms, by = t["bound"][k]
            plain = f", plain {t['plain ' + k]:.4f} ms"
            phase("time", f"{k} B={b}: {t[k]:.4f} ms{plain}; bound "
                          f"{bms:.4f} ms ({by}), {bms / t[k]:.1%} of it "
                          f"({card})")
        phase("time", f"B={b}: K3/K1 {t['K3'] / t['K1']:.3f}, K4/K2 "
                      f"{t['K4'] / t['K2']:.3f}")
    return times


def adam_tensors(state):
    return [v for s in state.optimizer.state_dict()["state"].values()
            for v in s.values() if torch.is_tensor(v)]


def v3_path_phase(V, K, card, dev):
    """The slice's path: train() at paper128, bf16, wavefront, gate 0.01,
    b128, 'pallas_v3', steps_per_call=10, with checkpoints, resume and
    held-out evaluation; returns the (K3, K4) launches of the run."""
    import os
    import tempfile

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.train import data_config, train
    from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = PRESETS["paper128"](batch_size=TRAIN_B, inference_mode="wavefront",
                              compute_dtype="bfloat16",
                              pres_gate_threshold=0.01,
                              render_backend="pallas_v3")
    run = dict(checkpoint_every=10, eval_every=10, eval_batches=2,
               steps_per_call=STEPS_PER_CALL, digits="font", device=dev)
    with tempfile.TemporaryDirectory() as logdir:
        counters = (V.composite_v3_forward, V.composite_v3_backward,
                    K.composite_forward, K.composite_backward)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        first = train(cfg, steps=20, logdir=logdir, **run)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ckpts = CheckpointManager(os.path.join(logdir, "checkpoints"))
        restored = ckpts.restore(create_train_state(cfg, device=dev))
        same = (int(restored.step) == int(first.step) == 20
                and torch.equal(restored.generator.get_state(),
                                first.generator.get_state())
                and all(torch.equal(p, q) for p, q in zip(
                    restored.model.parameters(), first.model.parameters()))
                and all(torch.equal(p, q) for p, q in zip(
                    adam_tensors(restored), adam_tensors(first))))
        if not same:
            raise AssertionError("the restored state differs from the saved")
        phase("path", f"checkpoints {ckpts.all_steps()}; the restored state "
                      f"equals the saved one tensor for tensor (parameters, "
                      f"{len(adam_tensors(first))} Adam tensors, generator, "
                      f"step 20)")
        t2 = time.perf_counter()
        last = train(cfg, steps=10, logdir=logdir, **run)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = tuple(fn.launches for fn in counters)
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    losses = {r["step"]: r["losses/total"] for r in rows
              if "losses/total" in r}
    evals = [r for r in rows if "eval/ap_at_50" in r]
    if int(last.step) != 30 or sorted(losses) != list(range(30)) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"step {int(last.step)}, losses {losses}")
    for r in evals:
        keys = sorted(k[len("eval/"):] for k in r if k.startswith("eval/"))
        if keys != sorted(EVAL_KEYS) or not all(
                math.isfinite(r[f"eval/{k}"]) for k in keys):
            raise AssertionError(f"eval row at {r['step']}: {r}")
    eval_forwards = len(evals) * run["eval_batches"]
    want = (30 + eval_forwards, 30, 0, 0)
    phase("path", f"30 train() steps at paper128 bf16 wavefront gate 0.01 "
                  f"b{TRAIN_B} pallas_v3: losses {losses[0]:.1f} -> "
                  f"{losses[29]:.1f}, all finite; evals at "
                  f"{[r['step'] for r in evals]}, finite, the JAX key set; "
                  f"launches K3 {launches[0]}, K4 {launches[1]}, K1 "
                  f"{launches[2]}, K2 {launches[3]} (expected {want})")
    if launches != want or [r["step"] for r in evals] != [10, 20, 30]:
        raise AssertionError("K3/K4 launch counts or eval steps are off")
    phase("path", f"train() wall clock, host clock, checkpoints and evals "
                  f"included: {(t1 - t0) * 1e3 / 20:.3f} ms/step over the "
                  f"first 20 steps (cold), {(t3 - t2) * 1e3 / 10:.3f} ms/step "
                  f"over the resumed 10 ({card})")

    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    inputs, gate = main_path_inputs(last, cfg, data_config(cfg), bank)
    phase("path", f"the path's compositor inputs: glimpses "
                  f"{inputs[0].dtype}, {int(gate.sum())} of {gate.numel()} "
                  f"objects live")
    v3_held(V, "path", masked(inputs, gate), random_cotangents(
        TRAIN_B, torch.Generator(device=dev).manual_seed(6), dev))

    # the same step alone, CUDA events over 2 calls of 10 after a warmup,
    # as phase 9 times the K1/K2 step
    step_fn = make_train_step(cfg, datagen=(data_config(cfg), bank),
                              steps_per_call=STEPS_PER_CALL)
    state = create_train_state(cfg, device=dev)
    state, _ = step_fn(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        state, m = step_fn(state)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (2 * STEPS_PER_CALL)
    phase("path", f"pallas_v3 train step: {ms:.3f} ms/step, "
                  f"{TRAIN_B / ms * 1e3:.1f} img/s (CUDA events over 2 calls "
                  f"of {STEPS_PER_CALL} steps, cold start; {card})")
    return launches[:2]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")

    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import (DataConfig, generate_batch,
                                              glyph_bank)
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.ops.kernels import composite as K
    from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V
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

    # 10. K3 and K4 against their plain versions
    v3_errs = v3_phase(V, K, dev)

    # 11. K1-K4 on the same inputs
    same = v3_times(V, K, card, dev)[TRAIN_B]

    # 12. the slice's path: train() through 'pallas_v3'
    v3_launches = v3_path_phase(V, K, card, dev)

    # the kernels at the main paths' batch, B=128, on the same inputs
    src = "spair_pytorch_tpu_torch/csrc"
    pallas = "spair_pytorch_tpu/ops/pallas"
    rows = (("composite_fwd", "K1", "composite.py:79", launches[0],
             max_abs_err),
            ("composite_bwd", "K2", "composite.py:133", launches[1],
             bwd_abs_err),
            ("composite_v3_fwd", "K3", "composite_v3.py:151",
             v3_launches[0], v3_errs[0]),
            ("composite_v3_bwd", "K4", "composite_v3.py:203",
             v3_launches[1], v3_errs[1]))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{src}/{name}.cu",
         "replaces": f"{pallas}/{where}", "launches": n, "max_abs_err": err,
         "ms": same[k], "plain_ms": same[f"plain {k}"],
         "bound_ms": same["bound"][k][0], "bound_by": same["bound"][k][1],
         "library_ms": None}
        for name, k, where, n, err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
