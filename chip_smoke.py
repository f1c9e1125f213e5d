#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spair_pytorch_tpu_torch).

Drives the port's serving path, its training step, its training entry
point through the banded compositor ('pallas_v3') at paper128 width, the
model options of three more presets, the host data inputs, int8 serving,
data-parallel training (world size 1) and the tools, and split refinement
and the figure path, on one CUDA card, with random weights from the
preset's seed:

  1. device     the card's name and power limit (nvidia-smi);
  2. build      compiles csrc/composite_fwd.cu (K1, and K3 as its banded
                instantiation) and csrc/composite_bwd.cu (K2, and K4 as
                its launch with a band), one nvcc each, started together;
                ptxas's registers, spills and stack for every
                instantiation;
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
                for a generated batch of 128 (f32 glimpses, the 0.01 gate),
                and their times there beside their plain versions and
                bounds;
 10. v3         K3 and K4 (K1's and K2's kernels launched with paper128's
                bands) against their plain versions at paper128 shapes,
                B=32 and B=128, boxes from the model's parameterization:
                f32 ungated, f32 with about half the objects zeroed as the
                gate zeroes them, bf16 glimpses against f32 truth, all
                gated; K3 against K1 on the same inputs (equal bit for bit
                where every box lies in its band);
 11. v3 times   K1, K2, K3, K4 and their plain versions on the same inputs
                in one call, at B=32 and B=128, with each kernel's bound,
                its share of it and the bound's bytes over its time;
 12. v3 path    the training entry point, train(), at paper128, bf16,
                wavefront, gate 0.01, b128, render_backend='pallas_v3',
                steps_per_call=10: 20 steps with checkpoints and held-out
                evaluation every 10, a restore checked tensor for tensor,
                then a resumed run of 10 more; K3 and K4 launch counts, the
                eval keys, K3/K4 against their plain versions on the path's
                own compositor inputs and their times there beside their
                plain versions and bounds; then the same step timed alone,
                and one step's device time under the profiler;
 13. options    the model options of cluttered_fine, quality and
                tpu_throughput: (a) K3 and K4 on a 576x64 canvas of 72
                grid rows, past the 64 whose band starts travel in the
                launch's parameters, against their plain versions at 1e-6
                and K3 against K1; (b) reference-mode top-K through K1/K2
                at cluttered_fine width (16x16 grid, K=32, gate 0.01, B=32),
                sparse and dense, against the full gated grid, with the N
                of every launch; (c) train() of the three presets for 10
                steps each at their widths and batches from random
                weights: losses, ms/step, K1/K2 launches, top-K and
                fallback steps; (d) one train step with the conv codec and
                one with the vestigial self-attention (its loss equal to
                the loss without it bit for bit); (e) the sequential and
                the parallel count prior, and the ordered compositor's full
                scan and top-32, timed in turns.
 14. inputs     the data inputs, int8 serving, data parallelism and the
                tools: (a) the paper128 detector at B=32, wavefront, with
                f32, bf16 and int8 weights, timed in turns, int8 against
                f32 (count agreement, max |score| and |box| differences),
                every int8 product it computes held to the exact integer
                product, and `serve --quantize int8` on 64 requests; (b)
                10 train() steps of the main path with --data native
                against the on-device generator, in turns (device, native,
                native, device), ms/step and K1/K2 launches, and the
                native generator's host time a batch;
                (c) 10 train() steps of the main path with --mesh (world
                size 1, NCCL) against 10 without, under deterministic
                algorithms: parameters equal bit for bit; one step with the
                NaN hunter on against off: losses equal bit for bit; (d)
                peak device memory of a main-path step at b128 and of a
                tpu_throughput step at b256 (utils/memory.py); (e)
                profile.py over 3 steps (its trace names K1 and K2) and an
                export.py round trip of the mesh run's parameters, bit for
                bit.
 15. refine and figures
                split refinement and the figure path at paper128 width:
                (a) the detector (wavefront, f32, NMS 0.5) and make_refiner
                (top_m=12, window_px=32) at B=32 and B=128: K1's two
                launches a call (B*M parents of one object and B*M*6
                candidates of two, on 32x32 windows) each against the plain
                compositor on its inputs, the whole split_gains dict
                through K1 against the plain compositor's, margin +inf
                (detections unchanged) and -inf with max_neighbor_iou 1
                (count = live + live in the top M), the refiner's ms/call
                beside the detector's in turns, and both launches' times
                beside their plain versions and bounds; (b)
                generative_grad_views at B=32 on an eval forward's latents,
                K1/K2 ungated, against autograd through the plain
                compositor (each view at the gradient bar), and K1/K2 timed
                on its inputs; (c) 10 train() steps of the main path with
                the input|output images every 5 steps, K1/K2 launches and
                ms/step. The card's machine has no matplotlib, so the
                figures themselves are drawn only by the CPU tests
                (tests/test_torch_viz.py); this phase computes everything
                they plot.
 16. bench      the port's benchmark entry point, python -m
                spair_pytorch_tpu_torch.bench, in a child process, twice:
                the main path with --check (5 steps a call, 2 trials, 10
                steps of pretraining), then 'pallas_v3' with the parallel
                count prior in f32 (2 steps a call, 1 trial, no
                pretraining); each JSON line printed, its check's six
                errors beside their bars, the compositor kernels' launches
                of each run (those of the check apart) against the count
                its steps give.

Every phase raises on failure. TF32 is off for the whole run (matmuls and
cuDNN convs in full f32), so kernels and plain versions are compared on the
same arithmetic. The last two lines are a JSON summary of the kernels and
the result line {"ok": true, "device": {...}}. A kernel's "launches" there
are its own path's, K1/K2 from phase 9 and K3/K4 from phase 12, and its
"path_launches" those of phase 15's and phase 16's paths, each read from
its own run.

    python3 chip_smoke.py              # on a machine with a CUDA card
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

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


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def demangle(symbol):
    """A kernel's C++ name without its argument list (c++filt where the
    machine has it, else the symbol as it is)."""
    import shutil
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return symbol
    name = subprocess.run([tool, symbol], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def print_ptxas(K, name, label="build"):
    """Each kernel's registers, spills and shared memory in the build of
    ``name``, from nvcc's -Xptxas -v report."""
    entry, spill = None, ""
    for line in K.ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            entry = demangle(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            phase(label, f"{name} {entry}: "
                           f"{line.split(':', 1)[1].strip()}; {spill}")
            entry, spill = None, ""


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
    cot = random_cotangents(TRAIN_B, torch.Generator(device=dev).manual_seed(5),
                            dev)
    held_at(K, inputs, gate, cot)
    # their times on these inputs, kernel and plain version in turns
    fns = {"K1": lambda: K.composite_forward(*inputs, HW, WIN,
                                             pres_gate=gate),
           "plain K1": lambda: K.composite_plain(*inputs, HW,
                                                 pres_gate=gate),
           "K2": lambda: K.composite_backward(*inputs, HW, *cot,
                                              pres_gate=gate),
           "plain K2": lambda: K.composite_backward_plain(*inputs, HW, *cot,
                                                          pres_gate=gate)}
    got = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("plain K1", "K1", "K1", "plain K1", "plain K2", "K2", "K2",
                  "plain K2"):
            got[k].append(cuda_ms(fns[k], 5 if k.startswith("plain")
                                  else 20))
    for k, fwd in (("K1", True), ("K2", False)):
        bms, by, moved = bound(TRAIN_B, C, inputs[0].element_size(), fwd,
                               support_pairs(inputs[3], gate=gate),
                               live=float(gate.sum()))
        t = sum(got[k]) / 2
        phase("main", f"{k} on the main path's inputs (b{TRAIN_B}, "
                      f"{inputs[0].dtype}, gate 0.01): "
                      f"{', '.join(f'{x:.4f}' for x in got[k])} ms, plain "
                      f"{', '.join(f'{x:.4f}' for x in got['plain ' + k])} "
                      f"ms; bound {bms:.4f} ms ({by}), {bms / t:.1%} of it;"
                      f" achieved {moved / t / 1e6:.1f} GB/s ({card})")
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


def band_rows(dev):
    """(N, H) 1.0 on the canvas rows of each paper128 object's band."""
    from spair_pytorch_tpu_torch.ops.kernels.composite_v3 import \
        band_geometry
    band, starts = band_geometry(HW, CELL, *BOUNDS, OH, GRID[0])
    y = torch.arange(HW[0], device=dev)
    lo = torch.as_tensor(starts, device=dev).repeat_interleave(GRID[1])
    return ((y >= lo[:, None]) & (y < lo[:, None] + band)).float()


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
            got = V.composite_v3_forward(*inputs, *V3_GEOM)
            want = K.composite_forward(*inputs, HW, WIN)
            check("v3", f"K3 against K1 B={b}", F32_BAR, got, want)
            phase("v3", f"K3 against K1 B={b}, every box in its band: equal "
                        f"bit for bit: "
                        f"{all(torch.equal(g, w) for g, w in zip(got, want))}")
    return max(errs3), max(errs4)


def bound(b, c, glimpse_bytes, forward, pairs, live=None, n=N,
          glimpse=(OH, OW), canvas_hw=HW):
    """(least ms, 'bytes' or 'operations', bytes moved) for one compositor
    call of b scenes of n objects: each input read once and each output
    written once, against the card's HBM rate; and an estimate of the
    gather's arithmetic (per object and support pixel, (C + 2) bilinear
    samples of 9 operations and ~3C + 2 more; four times that in the
    backward) against the f32 peak. ``live`` objects (default all b * n)
    have glimpses to read; the backward writes every object's gradient."""
    per_object = (c + 2) * glimpse[0] * glimpse[1] * glimpse_bytes
    read = (b * n if live is None else live) * per_object
    canvas = b * (c + 1) * canvas_hw[0] * canvas_hw[1] * 4
    boxes = b * n * 4 * 4
    if forward:
        moved = read + boxes + canvas
        ops = pairs * (9 * (c + 2) + 3 * c + 2)
    else:  # glimpses, boxes, dnum, dden in; dG, dbox out
        moved = read + b * n * per_object + 2 * boxes + canvas
        ops = 4 * pairs * (9 * (c + 2) + 3 * c + 2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", moved
    return t_ops, "operations", moved


def support_pairs(boxes, band_rows=None, gate=None, glimpse=(OH, OW),
                  canvas_hw=HW):
    """Canvas pixels inside each object's paste support (sy in (-1, oh),
    sx in (-1, ow)), summed over the objects; with ``band_rows`` (N, H)
    only the rows of each object's band count, with ``gate`` (B, N) only
    the objects whose gate is nonzero."""
    from spair_pytorch_tpu_torch.ops.stn import _source_coords_paste
    oh, ow = glimpse
    xt, yt, xs, ys = boxes.unbind(-1)
    sy = _source_coords_paste(yt, ys, canvas_hw[0], oh)
    sx = _source_coords_paste(xt, xs, canvas_hw[1], ow)
    rows = ((sy > -1) & (sy < oh)).float()
    if band_rows is not None:
        rows = rows * band_rows
    cols = ((sx > -1) & (sx < ow)).float()
    per_object = rows.sum(-1) * cols.sum(-1)
    if gate is not None:
        per_object = per_object * (gate != 0)
    return float(per_object.sum())


def v3_times(V, K, card, dev):
    """CUDA-event ms of K1, K2, K3, K4 and the plain K3/K4 on the same
    inputs, in turns, at B=32 and B=128, with each kernel's bound. Each
    kernel is first held against its plain version on the timed inputs."""
    times = {}
    rows = band_rows(dev)
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
        clipped = support_pairs(inputs[3], rows)
        t["bound"] = {"K1": bound(b, C, 4, True, full),
                      "K3": bound(b, C, 4, True, clipped),
                      "K2": bound(b, C, 4, False, full),
                      "K4": bound(b, C, 4, False, clipped)}
        times[b] = t
        for k in ("K1", "K3", "K2", "K4"):
            bms, by, moved = t["bound"][k]
            plain = f", plain {t['plain ' + k]:.4f} ms"
            phase("time", f"{k} B={b}: {t[k]:.4f} ms{plain}; bound "
                          f"{bms:.4f} ms ({by}), {bms / t[k]:.1%} of it; "
                          f"achieved {moved / t[k] / 1e6:.1f} GB/s of the "
                          f"bound's bytes ({card})")
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
    inputs = masked(inputs, gate)
    cot = random_cotangents(
        TRAIN_B, torch.Generator(device=dev).manual_seed(6), dev)
    v3_held(V, "path", inputs, cot)
    # their times on these inputs, kernel and plain version in turns, as
    # phase 9 times K1 and K2 on the main path's inputs
    fns = {"K3": lambda: V.composite_v3_forward(*inputs, *V3_GEOM),
           "plain K3": lambda: V.composite_v3_plain(*inputs, *V3_GEOM),
           "K4": lambda: V.composite_v3_backward(*inputs, *V3_GEOM, *cot),
           "plain K4": lambda: V.composite_v3_backward_plain(
               *inputs, *V3_GEOM, *cot)}
    got = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("plain K3", "K3", "K3", "plain K3", "plain K4", "K4", "K4",
                  "plain K4"):
            got[k].append(cuda_ms(fns[k], 5 if k.startswith("plain")
                                  else 20))
    pairs = support_pairs(inputs[3], band_rows(dev))
    for k, fwd in (("K3", True), ("K4", False)):
        bms, by, moved = bound(TRAIN_B, C, inputs[0].element_size(), fwd,
                               pairs)
        t = sum(got[k]) / 2
        phase("path", f"{k} on the path's inputs (b{TRAIN_B}, "
                      f"{inputs[0].dtype}, gated glimpses zeroed): "
                      f"{', '.join(f'{x:.4f}' for x in got[k])} ms, plain "
                      f"{', '.join(f'{x:.4f}' for x in got['plain ' + k])} "
                      f"ms; bound {bms:.4f} ms ({by}), {bms / t:.1%} of it;"
                      f" achieved {moved / t / 1e6:.1f} GB/s ({card})")

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
    one = make_train_step(cfg, datagen=(data_config(cfg), bank))
    wall, busy, n_kernels, events = profiled(lambda: one(state))
    phase("path", f"one pallas_v3 train step under the profiler: {wall:.3f} "
                  f"ms wall, device busy {busy:.3f} ms ({busy / ms:.1%} of "
                  f"the unprofiled {ms:.3f} ms), {n_kernels} device kernels "
                  f"({card})")
    print(events.table(sort_by="self_device_time_total", row_limit=10),
          flush=True)
    return launches[:2]


# phase 13: the model options. A tall, narrow canvas of 72 grid rows of
# 8-px cells, past the 64 rows whose band starts travel in the launch's
# parameters; cluttered_fine's 16x16 grid with top-K 32 and the 0.01 gate
OPT_BAR = 1e-6    # f32 K3/K4 on the tall grid, each output on its own scale
TALL = ((576, 64), 8, (72, 8), (-0.5, 1.5, 0.06))
FINE_B, TOPK = 32, 32


class LaunchSizes:
    """While active, records the object count N of every K1/K2 launch and
    of every ordered composite, without counting a launch: wraps
    ``composite.py``'s ``_launch_forward`` / ``_launch_backward`` and
    ``render.py``'s ``composite_ordered``."""

    def __init__(self, K, R):
        self.targets = [(K, "_launch_forward", "K1"),
                        (K, "_launch_backward", "K2"),
                        (R, "composite_ordered", "ordered")]
        self.sizes = {label: [] for _, _, label in self.targets}

    def __enter__(self):
        self.saved = []
        for module, name, label in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrap(*args, _fn=fn, _label=label, **kw):
                self.sizes[_label].append(int(args[0].shape[1]))
                return _fn(*args, **kw)
            setattr(module, name, wrap)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def tall_glimpses(b, gen, dev):
    """14x14 glimpses on TALL's grid, boxes from the model's
    parameterization (inside their bands)."""
    (ih, iw), cell, (gh, gw), (lo, hi, max_ys) = TALL
    n = gh * gw

    def u(*shape, a=0.0, z=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (z - a) + a
    h = torch.arange(gh, device=dev).repeat_interleave(gw)
    w = torch.arange(gw, device=dev).repeat(gh)
    boxes = torch.stack([(w + u(b, n, a=lo, z=hi)) / gw,
                         (h + u(b, n, a=lo, z=hi)) * cell / ih,
                         u(b, n, a=0.02, z=max_ys), u(b, n, a=0.02, z=max_ys)],
                        dim=-1)
    return (u(b, n, 1, 14, 14), u(b, n, 1, 14, 14),
            u(b, n, 1, 14, 14, a=0.01), boxes.contiguous())


def fine_latents(cfg, b, live, gen, dev):
    """Latent grids (B, gh, gw, ·) on cfg's grid for render: boxes near
    their cells, presence 0.9 on ``live`` random cells of each image and
    0.001 on the rest, which the 0.01 gate drops."""
    from spair_pytorch_tpu_torch.models.latents import geometry
    _, (gh, gw), _ = geometry(cfg)
    n = gh * gw
    pick = torch.rand((b, n), generator=gen, device=dev).argsort(dim=1)
    pres = torch.full((b, n), 0.001, device=dev)
    pres.scatter_(1, pick[:, :live], 0.9)
    h = torch.arange(gh, device=dev).repeat_interleave(gw)
    w = torch.arange(gw, device=dev).repeat(gh)

    def u(*shape, a=0.0, z=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (z - a) + a
    where = torch.stack([(w + u(b, n, a=-0.5, z=1.5)) / gw,
                         (h + u(b, n, a=-0.5, z=1.5)) / gh,
                         u(b, n, a=0.05, z=0.375), u(b, n, a=0.05, z=0.375)],
                        dim=-1)
    zs = (torch.randn((b, n, cfg.n_attributes), generator=gen, device=dev),
          where, u(b, n, 1, a=0.5, z=3.5), pres[..., None])
    return [z.reshape(b, gh, gw, -1).contiguous() for z in zs]


def render_grads(model, cfg, zs):
    """(recon, d/dz_attr, d/dz_where) of sum(recon^2), the JAX package's
    top-K test's objective."""
    from spair_pytorch_tpu_torch.models.render import render
    a, w = (z.clone().requires_grad_(True) for z in zs[:2])
    out = render(model, cfg, a, w, zs[2], zs[3], cfg.image_shape[1:])
    torch.sum(out ** 2).backward()
    return out.detach(), a.grad, w.grad


def options_phase(K, V, card, dev):
    """Phase 13: the model options that cluttered_fine, quality and
    tpu_throughput need, on the card. Returns nothing; raises on failure."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models import render as R
    from spair_pytorch_tpu_torch.models.kl import (count_prior_kl,
                                                   count_prior_kl_parallel)
    from spair_pytorch_tpu_torch.models.latents import geometry, sample_noise
    from spair_pytorch_tpu_torch.parallel import create_train_state
    from spair_pytorch_tpu_torch.parallel.train_step import train_step
    from spair_pytorch_tpu_torch.train import train
    t_phase = time.perf_counter()

    # (a) K3/K4 past 64 grid rows: band starts in device memory
    gen = torch.Generator(device=dev).manual_seed(1300)
    inputs = tall_glimpses(4, gen, dev)
    dnum, dden = (torch.rand((4, c, *TALL[0]), generator=gen, device=dev)
                  for c in (1, 1))
    band, starts = V.band_geometry(TALL[0], TALL[1], *TALL[3], 14,
                                   TALL[2][0])
    with torch.no_grad():
        check("options", f"K3 gh={TALL[2][0]} (band {band} of "
                         f"{TALL[0][0]} rows, {len(set(starts.tolist()))} "
                         f"starts)", OPT_BAR,
              V.composite_v3_forward(*inputs, *TALL),
              V.composite_v3_plain(*inputs, *TALL))
        check("options", f"K4 gh={TALL[2][0]}", OPT_BAR,
              V.composite_v3_backward(*inputs, *TALL, dnum, dden),
              V.composite_v3_backward_plain(*inputs, *TALL, dnum, dden))
        got = V.composite_v3_forward(*inputs, *TALL)
        want = K.composite_forward(*inputs, TALL[0])
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
    phase("options", f"K3 against K1 at gh={TALL[2][0]}, every box in its "
                     f"band: equal bit for bit: {same}")
    if not same:
        raise AssertionError("K3 past 64 rows differs from K1 in its bands")

    # (b) reference-mode top-K through K1/K2 at cluttered_fine width
    fine = PRESETS["cluttered_fine"](batch_size=FINE_B)
    full = dataclasses.replace(fine, render_topk=0)
    model = init_params(fine, device=dev)
    n_fine = geometry(fine)[1][0] * geometry(fine)[1][1]
    for live in (20, n_fine):
        zs = fine_latents(fine, FINE_B, live, gen, dev)
        want = render_grads(model, full, zs)
        f0, b0 = K.composite_forward.launches, K.composite_backward.launches
        with LaunchSizes(K, R) as rec:
            got = render_grads(model, fine, zs)
            torch.cuda.synchronize()
        launches = (K.composite_forward.launches - f0,
                    K.composite_backward.launches - b0)
        branch = "top-K" if live <= TOPK else "fallback"
        expect_n = TOPK if live <= TOPK else n_fine
        phase("options", f"cluttered_fine render B={FINE_B}, {live} live of "
                         f"{n_fine} an image: {branch} branch; launches K1 "
                         f"{launches[0]}, K2 {launches[1]}, N {rec.sizes}")
        if launches != (1, 1) or rec.sizes["K1"] != [expect_n] or \
                rec.sizes["K2"] != [expect_n]:
            raise AssertionError(f"top-K took the wrong branch: {rec.sizes}")
        errs = [float((got[0] - want[0]).abs().max())]
        for g, w, name in zip(got[1:], want[1:], ("z_attr", "z_where")):
            excess = ((g - w).abs() - (1e-5 + 5e-4 * w.abs())).max()
            errs.append(float((g - w).abs().max()))
            if float(excess) > 0:
                raise AssertionError(f"top-K gradient against {name} is off")
        phase("options", f"  against the full gated grid: recon max abs "
                         f"{errs[0]:.3e} (bar 1e-6 + 1e-6 rel), d z_attr "
                         f"{errs[1]:.3e}, d z_where {errs[2]:.3e} (rtol "
                         f"5e-4, atol 1e-5)")
        if errs[0] > 1e-6 + 1e-6 * float(want[0].abs().max()):
            raise AssertionError("top-K recon differs from the full grid")

    # (c) train() of the three presets at their widths and batches
    import tempfile
    for name, b in (("cluttered_fine", 32), ("quality", 32),
                    ("tpu_throughput", 256)):
        cfg = PRESETS[name]()
        if cfg.batch_size != b:
            raise AssertionError(f"{name}'s batch is {cfg.batch_size}")
        steps = 10
        with tempfile.TemporaryDirectory() as logdir:
            K.composite_forward.launches = K.composite_backward.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with LaunchSizes(K, R) as rec:
                start.record()
                train(cfg, steps=steps, logdir=logdir, checkpoint_every=0,
                      metrics_every=1, steps_per_call=steps, digits="font",
                      verbose=False, device=dev)
                end.record()
                torch.cuda.synchronize()
            launches = (K.composite_forward.launches,
                        K.composite_backward.launches)
            with open(f"{logdir}/metrics.jsonl") as f:
                rows = [json.loads(line) for line in f]
        losses = [r["losses/total"] for r in rows if "losses/total" in r]
        ms = start.elapsed_time(end) / steps
        sizes = rec.sizes["ordered"] if cfg.render_mode == "ordered" \
            else rec.sizes["K1"]
        topk_steps = sum(1 for x in sizes if x == cfg.render_topk)
        branches = (f"; top-K branch {topk_steps} steps, fallback "
                    f"{len(sizes) - topk_steps}" if cfg.render_topk else "")
        phase("options", f"train() {name} b{b} {cfg.inference_mode} "
                         f"{cfg.compute_dtype} {cfg.render_mode}: {steps} "
                         f"steps from random weights, losses "
                         f"{losses[0]:.1f} -> {losses[-1]:.1f}, all finite: "
                         f"{all(math.isfinite(v) for v in losses)}; "
                         f"{ms:.3f} ms/step, {b / ms * 1e3:.1f} img/s (CUDA "
                         f"events around train(), set-up and first step "
                         f"included; {card}); launches K1 {launches[0]}, K2 "
                         f"{launches[1]}; composites on N = "
                         f"{sorted(set(sizes))}{branches}")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses {losses}")
        if cfg.render_mode == "reference" and min(launches) < steps:
            raise AssertionError(f"{name} did not launch K1/K2 every step")

    # (d) one train step with the conv codec and with the self-attention
    base = PRESETS["paper128"]()
    x = torch.rand((B,) + base.image_shape, generator=gen, device=dev)
    noise = sample_noise(torch.Generator(device=dev).manual_seed(13), B,
                         geometry(base)[1], base)
    conv = dataclasses.replace(base, object_codec="conv")
    state = create_train_state(conv, device=dev)
    before = [p.detach().clone() for p in state.model.object_decoder
              .parameters()]
    out = train_step(conv, state, x, noise=noise)
    moved = all(not torch.equal(p, q) for p, q in zip(
        state.model.object_decoder.parameters(), before))
    phase("options", f"conv codec train step, paper128 f32 b{B}: loss "
                     f"{float(out['losses/total']):.3f}, finite; encoder "
                     f"grad norm {float(out['grad_norm/object_encoder']):.3e}"
                     f", decoder {float(out['grad_norm/object_decoder']):.3e}"
                     f", every decoder tensor updated: {moved}")
    if not (math.isfinite(float(out["losses/total"])) and moved
            and float(out["grad_norm/object_encoder"]) > 0):
        raise AssertionError("the conv codec step is off")
    attn = dataclasses.replace(base, vestigial_self_attn=True)
    state = create_train_state(attn, device=dev)
    plain = create_train_state(base, device=dev)
    plain.model.load_state_dict({k: v for k, v in
                                 state.model.state_dict().items()
                                 if not k.startswith("self_attn.")})
    out_attn = train_step(attn, state, x, noise=noise)
    out_plain = train_step(base, plain, x, noise=noise)
    equal = torch.equal(out_attn["losses/total"], out_plain["losses/total"])
    phase("options", f"self-attention train step, paper128 f32 b{B}: loss "
                     f"{float(out_attn['losses/total']):.6f}, without it "
                     f"{float(out_plain['losses/total']):.6f}, equal bit for"
                     f" bit: {equal}; its mean "
                     f"{float(out_attn['debug/self_attn_mean']):.4e}, its "
                     f"grad norm {float(out_attn['grad_norm/self_attn'])}")
    if not equal or float(out_attn["grad_norm/self_attn"]) != 0.0:
        raise AssertionError("the self-attention changed the loss or has a "
                             "gradient")

    # (e) times, both arms in one call
    for b, cfg in ((32, base), (256, base), (32, fine)):
        gh = geometry(cfg)[1][0]
        prob = torch.rand((b, gh, gh, 1), generator=gen, device=dev) * 0.98 \
            + 0.01

        def arm(fn):
            def run():
                p = prob.clone().requires_grad_(True)
                torch.sum(fn(p, p, 1500, cfg)).backward()
            return run
        seq, par = arm(count_prior_kl), arm(count_prior_kl_parallel)
        t = [cuda_ms(f, 3) for f in (seq, par, par, seq)]
        with torch.no_grad():
            a = count_prior_kl(prob, prob, 1500, cfg)
            c = count_prior_kl_parallel(prob, prob, 1500, cfg)
        err = float((a - c).abs().max() / a.abs().max())
        phase("options", f"count prior fwd+bwd b{b} {gh}x{gh}: sequential "
                         f"{t[0]:.3f}, {t[3]:.3f} ms; parallel {t[1]:.3f}, "
                         f"{t[2]:.3f} ms; agreement max |seq - par| / max "
                         f"|seq| {err:.3e} ({card})")
        if not err < 1e-3:
            raise AssertionError("the two count priors disagree")
    quality = PRESETS["quality"]()
    model = init_params(quality, device=dev)
    zs = fine_latents(quality, FINE_B, 20, gen, dev)
    scan = dataclasses.replace(quality, render_topk=0)
    t = [cuda_ms(lambda c=c: render_grads(model, c, zs), 3)
         for c in (scan, quality, quality, scan)]
    got, want = render_grads(model, quality, zs), render_grads(model, scan, zs)
    err = float((got[0] - want[0]).abs().max())
    phase("options", f"ordered compositor fwd+bwd, quality b{FINE_B}, 20 "
                     f"live of {n_fine}: full scan {t[0]:.3f}, {t[3]:.3f} "
                     f"ms; top-{TOPK} {t[1]:.3f}, {t[2]:.3f} ms "
                     f"({(t[0] + t[3]) / (t[1] + t[2]):.2f}x); recon max abs "
                     f"diff {err:.3e} ({card})")
    if err > 1e-6:
        raise AssertionError("ordered top-K differs from the full scan")
    phase("options", f"phase 13 in {time.perf_counter() - t_phase:.1f} s")


# phase 14: the main path's configuration (phase 9's) and its train() runs
INPUT_STEPS = 10


def main_path_config():
    from spair_pytorch_tpu_torch.config import PRESETS
    return PRESETS["paper128"](batch_size=TRAIN_B, inference_mode="wavefront",
                               compute_dtype="bfloat16",
                               pres_gate_threshold=0.01)


def int8_phase(card, dev):
    """Phase 14(a): the int8 detector against f32 and bf16 at B=32, every
    int8 product against the exact one, and serve --quantize int8."""
    from spair_pytorch_tpu_torch import serve
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.ops import quant
    from spair_pytorch_tpu_torch.train import data_config

    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    qparams = quant.quantize_params_int8(params)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    x = generate_batch(torch.Generator(device=dev).manual_seed(14), bank, B,
                       dcfg)[0]
    arms = {"f32": (make_detector(cfg), params),
            "bf16": (make_detector(dataclasses.replace(
                cfg, compute_dtype="bfloat16")), params),
            "int8": (make_detector(cfg), qparams)}

    # every product of one int8 call, on its own operands; these held
    # products are not the detector's launches
    launch, held = quant.int_mm, {}

    def record(a, w):
        out = launch(a, w)
        key = (a.shape[0], a.shape[1], w.shape[0])
        if key not in held:
            held[key] = torch.equal(out, quant.int_mm_plain(a, w.t()))
        return out

    quant.int_mm = record
    try:
        out_q = arms["int8"][0](qparams, x)
    finally:
        quant.int_mm = launch
    padded = sorted(k for k in held
                    if k[0] <= 16 or k[1] % 8 or k[2] % 8)
    phase("int8", f"{len(held)} int8 product shapes (rows, inner, out) at "
                  f"B={B}, every one equal to the exact integer product: "
                  f"{all(held.values())}; padded for _int_mm: {padded}")
    if not all(held.values()):
        raise AssertionError(f"an int8 product is off: {held}")
    out_f = arms["f32"][0](params, x)
    agree = float((out_q["count"] == out_f["count"]).float().mean())
    d_score = float((out_q["scores"] - out_f["scores"]).abs().max())
    d_box = float((out_q["boxes"] - out_f["boxes"]).abs().max())
    if not bool(torch.isfinite(out_q["scores"]).all()):
        raise AssertionError("non-finite int8 scores")
    times = {k: [] for k in arms}
    for k in ("f32", "bf16", "int8", "int8", "bf16", "f32"):
        fn, p = arms[k]
        times[k].append(cuda_ms(lambda: fn(p, x), 5))
    phase("int8", f"int8 against f32 at B={B}, random weights: counts agree "
                  f"on {agree:.3f} of the images, max |score diff| "
                  f"{d_score:.3e}, max |box diff| {d_box:.3e} px")
    for k, t in times.items():
        ms = sum(t) / 2
        phase("int8", f"detector {k} B={B} wavefront: "
                      f"{', '.join(f'{v:.3f}' for v in t)} ms/call, "
                      f"{B / ms * 1e3:.1f} img/s ({card})")
    dets = serve.main(["--quantize", "int8", "--requests", "64", "--batch",
                       "32"])
    if len(dets) != 64:
        raise AssertionError("serve --quantize int8 answered "
                             f"{len(dets)} of 64 requests")


def train_run(K, cfg, **kw):
    """train() of INPUT_STEPS steps in a temporary run directory: (final
    state, ms/step by CUDA events around the call, K1/K2 launches, the
    logged losses)."""
    from spair_pytorch_tpu_torch.train import train
    with tempfile.TemporaryDirectory() as logdir:
        K.composite_forward.launches = K.composite_backward.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = train(cfg, steps=INPUT_STEPS, logdir=logdir,
                      checkpoint_every=0, metrics_every=1, digits="font",
                      verbose=False, **kw)
        end.record()
        torch.cuda.synchronize()
        with open(f"{logdir}/metrics.jsonl") as f:
            losses = [json.loads(line).get("losses/total") for line in f]
    losses = [v for v in losses if v is not None]
    if len(losses) != INPUT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train({kw}): losses {losses}")
    return (state, start.elapsed_time(end) / INPUT_STEPS,
            (K.composite_forward.launches, K.composite_backward.launches),
            losses)


def native_phase(K, card, dev):
    """Phase 14(b): the main path fed by the native C++ generator against
    the on-device generator, one step a call each."""
    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.data.native import (NativeScatteredDigits,
                                                     build_native)
    from spair_pytorch_tpu_torch.train import data_config

    cfg = main_path_config()
    # the library's one-time build stays out of the timed runs
    t0 = time.perf_counter()
    lib = build_native()
    phase("native", f"g++ build of native/scattered_digits.cc: "
                    f"{time.perf_counter() - t0:.2f} s -> {lib.name}")
    # in turns, so a host that slows over the call weighs on both sources
    times = {"device": [], "native": []}
    for source in ("device", "native", "native", "device"):
        _, ms, launches, losses = train_run(K, cfg, data_source=source,
                                            device=dev)
        times[source].append(ms)
        phase("native", f"train() --data {source}, main path b{TRAIN_B}: "
                        f"{INPUT_STEPS} steps, losses {losses[0]:.1f} -> "
                        f"{losses[-1]:.1f}; {ms:.3f} ms/step, "
                        f"{TRAIN_B / ms * 1e3:.1f} img/s (CUDA events around"
                        f" train(), set-up included; {card}); launches K1 "
                        f"{launches[0]}, K2 {launches[1]}")
        if min(launches) < INPUT_STEPS:
            raise AssertionError(f"--data {source} did not launch K1/K2 "
                                 "every step")
    ratio = sum(times["native"]) / sum(times["device"])
    phase("native", f"native / device ms/step over the four runs: "
                    f"{ratio:.3f}")
    dcfg = data_config(cfg)
    gen = NativeScatteredDigits(dcfg, TRAIN_B, bank=glyph_bank(dcfg.patch_hw),
                                device=dev)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(10):
        next(gen)
    torch.cuda.synchronize()
    phase("native", f"native generator b{TRAIN_B}, {gen.n_threads} threads:"
                    f" {(time.perf_counter() - t0) * 100:.3f} ms a batch "
                    f"(host clock, copies to the card included)")


def mesh_phase(K, card, dev):
    """Phase 14(c): train() with --mesh at world size 1 over NCCL against
    train() without, and one step with the NaN hunter on against off, under
    deterministic algorithms. Returns the mesh run's final state."""
    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.train import data_config
    from spair_pytorch_tpu_torch.utils.debug import enable_nan_hunter

    import torch.distributed as dist

    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh

    cfg = main_path_config()
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    # the world of one and its NCCL communicator exist before the timed
    # runs: train() joins the group, so their set-up stays out of its time
    t0 = time.perf_counter()
    world = make_mesh(dev)
    dist.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    phase("mesh", f"NCCL world of {world.world_size} on {world.device}: "
                  f"{time.perf_counter() - t0:.2f} s to start")
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain, ms_p, _, _ = train_run(K, cfg, steps_per_call=10,
                                          device=dev)
            mesh, ms_m, launches, _ = train_run(K, cfg, steps_per_call=10,
                                                use_mesh=True, device=dev)
            losses = []
            for on in (False, True):
                state = create_train_state(cfg, device=dev)
                step = make_train_step(cfg, datagen=(dcfg, bank))
                enable_nan_hunter(on)
                try:
                    losses.append(step(state)[1]["losses/total"])
                finally:
                    enable_nan_hunter(False)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            world.close()
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    pairs = [(p.detach(), q.detach()) for p, q in zip(
        plain.model.parameters(), mesh.model.parameters())]
    equal = sum(torch.equal(p, q) for p, q in pairs)
    diff = max(float((p - q).abs().max()) for p, q in pairs)
    phase("mesh", f"train() --mesh (world 1, NCCL) against train(), "
                  f"{INPUT_STEPS} main-path steps each, deterministic "
                  f"algorithms: {equal} of {len(pairs)} parameter tensors "
                  f"equal bit for bit (max |diff| {diff:.3e}); {ms_m:.3f} "
                  f"against {ms_p:.3f} ms/step (CUDA events around "
                  f"train(), set-up included; {card}); launches K1 "
                  f"{launches[0]}, K2 {launches[1]}; ops without a "
                  f"deterministic form: {nondet or 'none'}")
    if equal != len(pairs):
        raise AssertionError("the world-of-one mesh run differs from the "
                             "plain run")
    same = torch.equal(losses[0], losses[1])
    phase("mesh", f"one main-path step with the NaN hunter off / on: loss "
                  f"{float(losses[0]):.3f} / {float(losses[1]):.3f}, equal "
                  f"bit for bit: {same}")
    if not same:
        raise AssertionError("the NaN hunter changed the loss")
    return mesh


def memory_phase(card, dev):
    """Phase 14(d): peak device memory of one train step, read through
    utils/memory.py."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.train import data_config
    from spair_pytorch_tpu_torch.utils.memory import (device_memory_stats,
                                                      live_array_report)

    gib = 2.0 ** 30
    for name, cfg in (("main path", main_path_config()),
                      ("tpu_throughput", PRESETS["tpu_throughput"]())):
        dcfg = data_config(cfg)
        bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, datagen=(dcfg, bank))
        step(state)  # Adam's moments and the allocator's pools exist
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = device_memory_stats()[str(dev)]["allocated_bytes.all.current"]
        step(state)
        torch.cuda.synchronize()
        stats = device_memory_stats()[str(dev)]
        phase("memory", f"{name} step b{cfg.batch_size} "
                        f"{cfg.compute_dtype}: peak allocated "
                        f"{stats['allocated_bytes.all.peak'] / gib:.3f} GiB "
                        f"({(stats['allocated_bytes.all.peak'] - held) / gib:.3f}"
                        f" GiB above the {held / gib:.3f} GiB held between "
                        f"steps), peak reserved "
                        f"{stats['reserved_bytes.all.peak'] / gib:.3f} GiB "
                        f"({card})")
        if name == "main path":
            print(live_array_report(5), flush=True)
        del state, step


def tools_phase(state, dev):
    """Phase 14(e): export.py writes ``state``'s parameters and imports
    them back bit for bit; profile.py's trace names K1 and K2."""
    from spair_pytorch_tpu_torch import export, profile
    from spair_pytorch_tpu_torch.config import config_to_json
    from spair_pytorch_tpu_torch.parallel import create_train_state
    from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = main_path_config()
    with tempfile.TemporaryDirectory() as d:
        for run in ("run", "fresh"):
            os.makedirs(os.path.join(d, run))
            with open(os.path.join(d, run, "config.json"), "w") as f:
                f.write(config_to_json(cfg))
        CheckpointManager(os.path.join(d, "run", "checkpoints")).save(state)
        pkl = export.main(["--logdir", os.path.join(d, "run"), "--out",
                           os.path.join(d, "s.pkl")])
        export.main(["--import-pkl", pkl, "--logdir",
                     os.path.join(d, "fresh")])
        back = CheckpointManager(os.path.join(d, "fresh", "checkpoints")
                                 ).restore(create_train_state(
                                     dataclasses.replace(cfg, seed=5),
                                     device=dev))
    equal = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                  back.model.parameters()))
    phase("tools", f"export.py of the mesh run, then --import-pkl into a "
                   f"fresh run: parameters equal bit for bit: {equal}")
    if not equal:
        raise AssertionError("the export round trip changed the parameters")
    with tempfile.TemporaryDirectory() as out:
        bench, path = profile.main(["--preset", "paper128", "--steps", "3",
                                    "--warmup", "1", "--out", out])
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = {k: sorted(n for n in names if k in n)
               for k in ("composite_fwd_kernel", "composite_bwd_kernel")}
    phase("tools", f"profile.py, paper128 b32, 3 steps: "
                   f"{', '.join(f'{v * 1e3:.3f}' for v in bench.times('train_step'))}"
                   f" ms/step (CUDA events); its trace names "
                   f"{sum(map(len, kernels.values()))} K1/K2 instantiations: "
                   f"{[demangle(n) for v in kernels.values() for n in v]}")
    if not all(kernels.values()):
        raise AssertionError(f"the trace lacks a kernel: {kernels}")


# phase 15: split refinement and the figure path, at paper128 width
REFINE_M, REFINE_WIN = 12, 32


def refine_phase(K, card, dev):
    """Phase 15(a): the paper128 detector (wavefront, f32, NMS 0.5) and
    ``make_refiner(cfg, top_m=12, window_px=32)`` at B=32 and B=128.
    Returns the K1 launches of one refiner call at each batch, each read
    from its own run with the count set to 0 just before it."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models import init_params, refine, render
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.train import data_config

    cfg = PRESETS["paper128"]()
    plain_cfg = dataclasses.replace(cfg, render_backend="xla")
    params = init_params(cfg, device=dev)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    detect = make_detector(cfg, nms_iou=0.5)
    knobs = dict(top_m=REFINE_M, window_px=REFINE_WIN)
    refiner = refine.make_refiner(cfg, **knobs)
    wins = (REFINE_WIN, REFINE_WIN)
    launches = {}
    for b in (32, 128):
        x = generate_batch(torch.Generator(device=dev).manual_seed(15 + b),
                           bank, b, dcfg)[0]
        det = detect(params, x)
        K.composite_forward.launches = 0
        out = refiner(params, x, det, 0.0, 0.5)
        torch.cuda.synchronize()
        n_launch = launches[b] = K.composite_forward.launches
        n = det["scores"].shape[1]
        if n_launch != 2 or tuple(out["boxes"].shape) != (b, n + REFINE_M, 4) \
                or not bool(torch.isfinite(out["boxes"]).all()):
            raise AssertionError(f"refine B={b}: {n_launch} K1 launches, "
                                 f"boxes {tuple(out['boxes'].shape)}")

        # each K1 launch against the plain compositor on its own inputs
        calls, launch = [], render.composite_forward

        def record(*a, **kw):
            got = launch(*a, **kw)
            calls.append((a, got))
            return got
        render.composite_forward = record
        try:
            gains = refine.split_gains(params, cfg, x, det["boxes"],
                                       det["scores"], **knobs)
        finally:
            render.composite_forward = launch
        for (a, got), what in zip(calls, ("parents", "candidates")):
            check("refine", f"K1 {what} B={b}: {a[0].shape[0]} scenes of "
                            f"{a[0].shape[1]} on {REFINE_WIN}x{REFINE_WIN}",
                  F32_BAR, got, K.composite_plain(*a, chunk=a[0].shape[1]))
        # the whole gains dict through K1 against the plain compositor's
        want = refine.split_gains(params, plain_cfg, x, det["boxes"],
                                  det["scores"], **knobs)
        if not torch.equal(gains["idx"], want["idx"]):
            raise AssertionError(f"refine B={b}: top-M indices differ")
        keys = [k for k in sorted(gains) if k != "idx"]
        check("refine", f"split_gains B={b} through K1 against the plain "
                        f"compositor (idx equal)", F32_BAR,
              [gains[k] for k in keys], [want[k] for k in keys], keys)

        # margin +inf leaves the detections; -inf with the guard open
        # splits every live detection of the top M
        same = refiner(params, x, det, math.inf, 0.5)
        opened = refine.make_refiner(cfg, max_neighbor_iou=1.0, **knobs)(
            params, x, det, -math.inf, 0.5)
        live = torch.sum(det["scores"] >= 0.5, dim=-1)
        live_m = torch.sum(gains["score"] >= 0.5, dim=-1)
        if not (torch.equal(same["boxes"][:, :n], det["boxes"])
                and torch.equal(same["count"], det["count"])
                and int(same["n_split"].sum()) == 0
                and torch.equal(opened["count"], live + live_m)
                and torch.equal(opened["n_split"], live_m)):
            raise AssertionError(f"refine B={b}: the margin's bounds are off")
        phase("refine", f"B={b}: {n_launch} K1 launches a call; margin +inf "
                        f"leaves boxes and counts; margin -inf with "
                        f"max_neighbor_iou 1 counts live + live in the top "
                        f"{REFINE_M}: {int(live.sum())} + "
                        f"{int(live_m.sum())} = {int(opened['count'].sum())};"
                        f" at margin 0 {int(out['n_split'].sum())} splits "
                        f"(random weights)")

        # times: the detector and the refiner in turns, then each launch
        times = {"detector": [], "refiner": []}
        fns = {"detector": lambda: detect(params, x),
               "refiner": lambda: refiner(params, x, det, 0.0, 0.5)}
        for k in ("detector", "refiner", "refiner", "detector"):
            times[k].append(cuda_ms(fns[k], 3))
        phase("refine", f"B={b}: detector "
                        f"{', '.join(f'{v:.3f}' for v in times['detector'])}"
                        f" ms/call, refiner "
                        f"{', '.join(f'{v:.3f}' for v in times['refiner'])} "
                        f"ms/call (CUDA events, in turns; {card})")
        for (a, _), what in zip(calls, ("parents", "candidates")):
            scenes, k = a[0].shape[:2]
            got = {"K1": [], "plain": []}
            kfns = {"K1": lambda: K.composite_forward(*a),
                    "plain": lambda: K.composite_plain(*a, chunk=k)}
            for name in ("plain", "K1", "K1", "plain"):
                got[name].append(cuda_ms(kfns[name], 20))
            t = sum(got["K1"]) / 2
            bms, by, moved = bound(scenes, C, 4, True,
                                   support_pairs(a[3], canvas_hw=wins),
                                   n=k, canvas_hw=wins)
            phase("refine", f"K1 {what} B={b} ({scenes} x {k} objects): "
                            f"{', '.join(f'{v:.4f}' for v in got['K1'])} ms,"
                            f" plain "
                            f"{', '.join(f'{v:.4f}' for v in got['plain'])} "
                            f"ms; bound {bms:.4f} ms ({by}), {bms / t:.1%} "
                            f"of it; achieved {moved / t / 1e6:.1f} GB/s "
                            f"({card})")
    return launches


def figure_phase(K, card, dev):
    """Phase 15(b): ``generative_grad_views`` at paper128, B=32, on the
    latents of an eval forward, through K1/K2 against autograd through the
    plain compositor; K1 and K2 timed on its inputs. Returns the (K1, K2)
    launches of one call."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.render import decode_objects
    from spair_pytorch_tpu_torch.models.spair import forward
    from spair_pytorch_tpu_torch.train import data_config
    from spair_pytorch_tpu_torch.utils.debug import generative_grad_views

    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    gen = torch.Generator(device=dev).manual_seed(151)
    x = generate_batch(gen, bank, B, dcfg)[0]
    with torch.no_grad():
        aux = forward(params, cfg, x, 1500, gen)[1]
    zs = [aux[k] for k in ("z_attr", "z_where", "z_depth", "z_pres")]
    K.composite_forward.launches = K.composite_backward.launches = 0
    got = generative_grad_views(params, cfg, x, *zs)
    torch.cuda.synchronize()
    launches = (K.composite_forward.launches, K.composite_backward.launches)
    if launches != (1, 1):
        raise AssertionError(f"generative_grad_views launched {launches}")
    plain_cfg = dataclasses.replace(cfg, render_backend="xla")
    want = generative_grad_views(params, plain_cfg, x, *zs)
    check("figures", f"generative_grad_views B={B} through K1/K2 against "
                     f"autograd through the plain compositor", GRAD_BAR,
          got, want, ("dec_grad", "attr_grad"))
    views = {"kernels": [], "plain": []}
    vfns = {"kernels": lambda: generative_grad_views(params, cfg, x, *zs),
            "plain": lambda: generative_grad_views(params, plain_cfg, x,
                                                   *zs)}
    for k in ("plain", "kernels", "kernels", "plain"):
        views[k].append(cuda_ms(vfns[k], 3))
    phase("figures", f"generative_grad_views B={B}: K1/K2 "
                     f"{', '.join(f'{v:.3f}' for v in views['kernels'])} "
                     f"ms/call, plain compositor "
                     f"{', '.join(f'{v:.3f}' for v in views['plain'])} "
                     f"ms/call; launches K1 {launches[0]}, K2 {launches[1]} "
                     f"a call ({card})")

    b, _, gh, gw = aux["z_pres"].shape

    def flat(t):
        return t.permute(0, 2, 3, 1).reshape(b, gh * gw, -1)
    with torch.no_grad():
        glimpses = decode_objects(params, cfg, flat(aux["z_attr"]),
                                  flat(aux["z_pres"]), flat(aux["z_depth"]))
    inputs = (*glimpses, flat(aux["z_where"]).contiguous())
    cot = random_cotangents(B, torch.Generator(device=dev).manual_seed(152),
                            dev)
    fns = {"K1": lambda: K.composite_forward(*inputs, HW),
           "plain K1": lambda: K.composite_plain(*inputs, HW),
           "K2": lambda: K.composite_backward(*inputs, HW, *cot),
           "plain K2": lambda: K.composite_backward_plain(*inputs, HW, *cot)}
    times = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("plain K1", "K1", "K1", "plain K1", "plain K2", "K2", "K2",
                  "plain K2"):
            times[k].append(cuda_ms(fns[k], 5 if k.startswith("plain")
                                    else 20))
    for k, fwd in (("K1", True), ("K2", False)):
        bms, by, moved = bound(B, C, 4, fwd, support_pairs(inputs[3]))
        t = sum(times[k]) / 2
        plain = times["plain " + k]
        phase("figures", f"{k} on the figure path's inputs (B={B}, f32, "
                         f"ungated): "
                         f"{', '.join(f'{v:.4f}' for v in times[k])} ms, "
                         f"plain {', '.join(f'{v:.4f}' for v in plain)}"
                         f" ms; bound {bms:.4f} ms ({by}), {bms / t:.1%} of "
                         f"it; achieved {moved / t / 1e6:.1f} GB/s ({card})")
    return launches


def images_phase(K, card):
    """Phase 15(c): train() of the main path for INPUT_STEPS steps with the
    input|output images every 5 steps. Returns its (K1, K2) launches."""
    _, ms, launches, losses = train_run(K, main_path_config(),
                                        log_images_every=5)
    # every step launches K1 and K2 once; each image step's forward K1
    if launches != (INPUT_STEPS + 2, INPUT_STEPS):
        raise AssertionError(f"train(log_images_every=5) launched "
                             f"{launches}")
    phase("figures", f"train() main path b{TRAIN_B}, {INPUT_STEPS} steps, "
                     f"images every 5: {ms:.3f} ms/step, losses "
                     f"{losses[0]:.1f} -> {losses[-1]:.1f}; launches K1 "
                     f"{launches[0]}, K2 {launches[1]} ({card})")
    return launches


# phase 16: the bench's two runs (name, flags)
BENCH_RUNS = (
    ("bench", ["--check", "--steps", "5", "--repeats", "2", "--block-sleep",
               "0", "--pretrain", "10"]),
    ("bench_pallas_v3", ["--render", "pallas_v3", "--count-kl", "par",
                         "--compute-dtype", "float32", "--steps", "2",
                         "--repeats", "1", "--block-sleep", "0",
                         "--pretrain", "0"]),
)
# the child: bench.main with the given flags, then the four kernels'
# launches on stderr, those of run_check (comparisons with the plain
# compositor) apart
BENCH_CHILD = """
import json, sys
from spair_pytorch_tpu_torch import bench
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V
fns = (K.composite_forward, K.composite_backward, V.composite_v3_forward,
       V.composite_v3_backward)
checked = [0] * 4
run_check = bench.run_check
def counted_check(*args, **kw):
    before = [f.launches for f in fns]
    try:
        return run_check(*args, **kw)
    finally:
        checked[:] = [f.launches - n for f, n in zip(fns, before)]
bench.run_check = counted_check
bench.main(sys.argv[1:])
print(json.dumps({"launches": [f.launches for f in fns],
                  "check": checked}), file=sys.stderr)
"""


def bench_phase(card):
    """Phase 16: the bench's runs in child processes. Returns each run's
    launches of K1-K4 outside its check, by run name."""
    from spair_pytorch_tpu_torch.bench import BARS, parse_args, pretrain_calls

    root = os.path.dirname(os.path.abspath(__file__))
    paths = {}
    for name, flags in BENCH_RUNS:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", BENCH_CHILD, *flags],
                             cwd=root, capture_output=True, text=True,
                             timeout=420)
        if res.returncode != 0:
            raise AssertionError(f"bench {' '.join(flags)} exited "
                                 f"{res.returncode}: {res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        counts = json.loads(res.stderr.strip().splitlines()[-1])
        phase("bench", f"{name}: python -m spair_pytorch_tpu_torch.bench "
                       f"{' '.join(flags)}: exit 0 in "
                       f"{time.perf_counter() - t0:.1f} s ({card})")
        phase("bench", json.dumps(line))
        if not line["value"] > 0:
            raise AssertionError(f"bench {name}: value {line['value']}")
        args = parse_args(flags)
        if args.check:
            check = line["check"]
            for k, bar in BARS.items():
                phase("bench", f"  {k}: {check[k]:.3g} (bar {bar:g})")
            if not (check["passed"] and check["k_step_loss_finite"]):
                raise AssertionError(f"bench {name}: check {check}")
            want_check = [3, 3, 0, 0]
        else:
            want_check = [0] * 4
        # warm-up, pretraining, the check's call and 1 + 3 calls a trial of
        # K steps, then the FLOP count's one step; one launch a step of the
        # path's forward and backward kernels
        steps = args.steps * (1 + pretrain_calls(args.pretrain, args.steps)
                              + args.check + 4 * args.repeats) + 1
        v3 = args.render == "pallas_v3"
        path = [a - c for a, c in zip(counts["launches"], counts["check"])]
        want = [0, 0, steps, steps] if v3 else [steps, steps, 0, 0]
        phase("bench", f"{name}: launches K1-K4 {path} in {steps} steps "
                       f"(the check's apart: {counts['check']})")
        if path != want or counts["check"] != want_check:
            raise AssertionError(f"bench {name}: launches {counts}, "
                                 f"expected {want} and {want_check}")
        paths[name] = path
    return paths


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
    card = card_name()
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
    for name in libs:
        print_ptxas(K, name)

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

    # 13. the model options of cluttered_fine, quality and tpu_throughput
    options_phase(K, V, card, dev)

    # 14. the data inputs, int8 serving, data parallelism and the tools
    t_phase = time.perf_counter()
    int8_phase(card, dev)
    native_phase(K, card, dev)
    meshed = mesh_phase(K, card, dev)
    memory_phase(card, dev)
    tools_phase(meshed, dev)
    phase("inputs", f"phase 14 in {time.perf_counter() - t_phase:.1f} s")

    # 15. split refinement and the figure path
    t_phase = time.perf_counter()
    refine_k1 = refine_phase(K, card, dev)
    figure_k = figure_phase(K, card, dev)
    images_k = images_phase(K, card)
    phase("figures", f"phase 15 in {time.perf_counter() - t_phase:.1f} s")

    # 16. the benchmark entry point
    t_phase = time.perf_counter()
    bench_k = bench_phase(card)
    phase("bench", f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    # each path's own launches, from its own run with the counts set to 0
    # just before it: `launches` is the main path's (phase 9, K1/K2) or the
    # 'pallas_v3' path's (phase 12, K3/K4); `path_launches` those of
    # phase 15's paths and of the bench's runs (phase 16, a fresh process
    # each, its check's launches left out)
    paths = ({**{f"refine_b{b}": n for b, n in refine_k1.items()},
              "generative_grad_views": figure_k[0],
              "train_log_images": images_k[0]},
             {"generative_grad_views": figure_k[1],
              "train_log_images": images_k[1]}, {}, {})
    for name, counts in bench_k.items():
        for path, n in zip(paths, counts):
            if n:
                path[name] = n

    # the kernels at the main paths' batch, B=128, on the same inputs; K3
    # and K4 are the same sources' kernels launched with a band
    src = "spair_pytorch_tpu_torch/csrc"
    pallas = "spair_pytorch_tpu/ops/pallas"
    rows = (("composite_fwd", "composite_fwd", "K1", "composite.py:79",
             launches[0], max_abs_err),
            ("composite_bwd", "composite_bwd", "K2", "composite.py:133",
             launches[1], bwd_abs_err),
            ("composite_v3_fwd", "composite_fwd", "K3", "composite_v3.py:151",
             v3_launches[0], v3_errs[0]),
            ("composite_v3_bwd", "composite_bwd", "K4", "composite_v3.py:203",
             v3_launches[1], v3_errs[1]))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{src}/{source}.cu",
         "replaces": f"{pallas}/{where}", "launches": n, "max_abs_err": err,
         "ms": same[k], "plain_ms": same[f"plain {k}"],
         "bound_ms": same["bound"][k][0], "bound_by": same["bound"][k][1],
         "library_ms": None, "path_launches": path}
        for (name, source, k, where, n, err), path in zip(rows, paths)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
