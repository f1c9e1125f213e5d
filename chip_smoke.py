#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spair_pytorch_tpu_torch).

Drives the port's serving path, its training step, its training entry
point through the banded compositor ('pallas_v3') at paper128 width, the
model options of three more presets, the host data inputs, int8 serving,
data-parallel training (world size 1) and the tools, split refinement and
the figure path, the benchmark entry point, the train step captured as a
CUDA graph against the eager step, the forward programs (detector,
eval step, evaluate, calibrate) captured against eager, and the render_topk
presets' train step, eval step and evaluate captured as segments around the
render's top-K branch against eager, and the data-parallel step and the
split refiner captured against eager, the (data, model) mesh at
world size 1 with its NCCL subgroups captured, and the windowed matmul
paste's ablation (K5) through its entry point, on one CUDA card, with
random weights from the preset's seed:

  1. device     the card's name and power limit (nvidia-smi);
  2. build      compiles csrc/composite_fwd.cu (K1, and K3 as its banded
                instantiation), csrc/composite_bwd.cu (K2, and K4 as
                its launch with a band) and csrc/kernel_anatomy.cu (K5),
                one nvcc each, started together;
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
                bf16, wavefront, gate 0.01, batch 128, a captured CUDA
                graph replayed once a step: cold-start steps from random
                weights (dense presence), finite losses, ms/step and
                img/s, the device-busy share of one replayed step; then both
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
                fallback steps (the branch counts of the captured steps
                train() makes); (d) one train step with the conv codec and
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
 17. captured   the main-path step captured as a CUDA graph
                (parallel/captured.py), against the eager step
                (make_train_step(eager=True)): (a) 5 calls of one step and
                one call of 5, 'auto' (K1/K2) and 'pallas_v3' (K3/K4),
                under deterministic kernels: every metric, the step, every
                parameter and Adam tensor and the generator bit for bit;
                the same for 'auto' with the default kernels beside an
                eager-against-eager control; (b) the scenes each replay
                draws, new each step and equal to the eager step's; (c)
                each call's metrics fresh; (d) each kernel's launches in a
                captured call of 5 steps, counted over the replays; (e) a
                captured step refuses another state and Adam's state
                loaded anew; (f) eager against captured ms/step and img/s
                in turns (CUDA events over 2 calls of 10), the first call's
                time and each arm's peak memory; (g) the device's busy
                share of a captured call under the profiler; (h) the first
                call of a captured step (warm-up and capture) beside an
                eager step; (i) a resumed train() against an uninterrupted
                one; (j) a .item() injected into the step makes the capture
                raise, and no step runs eagerly in its place (run last,
                after phase 18: a failed capture leaves the generators
                registered with it mid-capture).
 18. forward    the forward programs captured as CUDA graphs
                (parallel/captured.py::CapturedForward) against eager: (a)
                the paper128 detector at B = 1, 8, 32 and 128 in f32 and at
                B=32 with bf16 compute and int8 weights, NMS off and at 0.5:
                boxes, scores, count and z_depth bit for bit, ms/call and
                img/s in turns, each first call (eager run and capture), the
                device's busy share of one captured call, the N-sweep NMS's
                device time at B=32 and B=128 against the eager early exit,
                and DetectorServer with buckets (1, 8, 32, 128) and NMS 0.5:
                each bucket's capture in warmup, reserved memory before and
                after, 64 requests against the eager detector; (b)
                make_eval_step at B=32 through 'auto' (K1) and 'pallas_v3'
                (K3): loss and every aux tensor bit for bit over 3 calls,
                the kernel's launches over 3 replays, ms in turns; (c)
                evaluate(batches=4) with a calibrated NMS and
                calibrate(batches=2): captured equal to eager, a second
                captured call (the same capture, re-seeded) equal too, and
                their wall times; (d) last, after 17(j): a .item()
                injected into the detector's NMS makes its capture raise,
                and a second call raises without running.
 19. top-K      render_topk's train step, eval step and evaluate captured
                as segments around the render's branch
                (parallel/captured.py::SegmentedStep, SegmentedForward),
                against eager, for cluttered_fine b32 (reference mode, K1/K2
                on N=32 or N=256) and quality b32 (ordered mode) at their
                widths (16x16 grid, 46 fronts): (a) a call of 4 steps from
                the cold, dense state (the full branch), the presence head's
                bias shifted in place, a call on the sparse state (the top-K
                branch), under deterministic kernels: both runs' branch
                sequences, the eager steps' largest live counts, each
                branch's tensors (metrics, the step, parameters, Adam's
                state) bit for bit, the generators, each segment's launches
                a replay and the N of each launch made in Python; (b)
                cluttered_fine's K1 and K2 on the captured path's inputs of
                both branches (segment A's static outputs) against their
                plain versions, timed beside them and their bounds; (c)
                eager against captured ms/step and img/s in turns in each
                branch, the first call's time (warm-up and three captures)
                and the reserved memory it adds; (d) the eval step (3
                calls) and evaluate(batches=4) captured against eager in
                each branch, with their times. Run before the failed-capture
                checks of 20(c), 17(j) and 18(d).
 20. mesh and refiner
                the last two programs that ran eagerly, captured: (a) NCCL
                inside a capture in the default 'global' mode (a fresh
                group's first collective captured, then torch's own
                watchdog check: 10 captures of three all-reduces, each
                after 30 eager ones, replayed 200 times each); the
                data-parallel step at world size 1 over NCCL, captured,
                against the eager mesh step and the captured plain step
                under deterministic kernels: the main path b128 through
                'auto' and 'pallas_v3' (every metric, the step,
                parameters, Adam's state and the generator bit for bit,
                K1-K4 launches over replays) and cluttered_fine b32
                segmented, a call in each branch (both branch sequences,
                every tensor bit for bit); eager mesh, captured mesh and
                captured plain ms/step in turns with their first calls;
                (b) make_refiner captured, one graph per batch size, at
                B=32 and B=128 after the captured detector (NMS 0.5, top_m
                12, 32 px windows) against eager: every output bit for bit
                at margin 0, +inf and -inf (max_neighbor_iou 1), floats
                and 0-d tensors through one graph, K1's launches a replay,
                the first call, ms/call in turns beside the detector; (c)
                last, before 17(j): a .item() injected into the mesh step
                makes its capture raise, and nothing runs eagerly in its
                place.
 21. model axis
                the mesh's 'model' axis on one card: (a) make_mesh(
                n_model=1) at world 1 over NCCL, its captured step equal
                to the captured plain step bit for bit (main path b128,
                'auto', deterministic kernels) and its captured eval step
                over the mesh (loss terms reduced, outputs gathered over
                the data group inside the graph) equal to the captured
                eval step without one; (b) fresh NCCL subgroups from
                parallel/mesh.py::subgroups, their first collectives
                (gather_cells' all-gather and reduce-scatter, an
                all-reduce) inside one capture, replayed. Meshes of 2 and
                4 ranks to a model group need several cards:
                tools/dp_check.py --n-model.
 22. anatomy    the windowed matmul paste of the JAX package's
                benchmarks/kernel_anatomy.py, K5 (csrc/kernel_anatomy.cu,
                built in phase 2, bf16 wgmma products), through its entry
                point, python -m spair_pytorch_tpu_torch.benchmarks.
                kernel_anatomy: (a) each of the five variants (base,
                hoisted, nobuild, nomatmul, noaccum) against its plain
                version at paper shapes (B=32, N=121, 28x28, 128x128, win
                64) on 8 seeds' inputs, at 1e-6 with t's f32 sums
                rounded toward zero as the tensor cores round them and at
                5e-3 rounded to nearest, hoisted against base at 1e-6, and
                a control that must fail 1e-6 (the plain base with t kept
                in f32); base (bf16 operands) and K1 with bf16
                glimpses against the f32 composite at the bf16 bar; the
                objects each 32-column strip's list holds, per variant at
                B=32 and B=128, as the kernel walked them, equal to
                strips_touched; the HGMMA instructions in the built library
                (cuobjdump); (b)
                the entry point at B=32 and B=128, each variant timed over
                a captured graph of 30 launches (best of 3 replays), the
                shares, each variant's bound, K1 on the same glimpses,
                K5's launches over the replays; the plain base timed at
                both batches. Run before the failed-capture checks.
 23. ordered    ordered mode's kernels (csrc/composite_ordered.cu) on the
                objects of a quality b32 step past the training wheel: the
                forward against the plain scan and the backward's two
                kernels against their plain version; each timed over a
                captured graph beside its bound; the composite's forward
                and backward (sort, gather, kernels) against the plain scan
                under autograd, captured, in turns; quality's captured
                train step with the kernels and with the plain scan
                ('xla'), in turns: ms a step, peak memory, and the
                kernels' launches over the replays.
 24. glue       cell_step's ten glue kernels (csrc/cell_glue.cu) at both
                cells' front shapes (paper128 b128 bf16, quality b32 f32):
                each against its plain version (forwards bit for bit,
                backwards at 1e-6), timed over a captured graph beside the
                plain version captured and its bytes at the HBM rate; a
                front's five forwards and five backwards together, kernels
                against plain.

Every phase raises on failure. TF32 is off for the whole run (matmuls and
cuDNN convs in full f32), so kernels and plain versions are compared on the
same arithmetic. The last two lines are a JSON summary of the kernels and
the result line {"ok": true, "device": {...}}. A kernel's "launches" there
are its own path's, K1/K2 from phase 9, K3/K4 from phase 12 and K5 from
phase 22's entry-point runs, and its "path_launches" those of phase 15's
to phase 21's paths, each read from its own run. Launches of a captured
step or program are counted over its replays.

    python3 chip_smoke.py              # on a machine with a CUDA card
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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


def sass_count(library, opcode):
    """Instructions of ``opcode`` in a built library's SASS (cuobjdump
    beside nvcc), or None where the toolkit has no cuobjdump."""
    import shutil
    from spair_pytorch_tpu_torch.ops.kernels import composite as K
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(K._find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return len(re.findall(rf"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?{opcode}\b",
                          sass, flags=re.M))


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


def profile_eval(cfg, params, x, step, eval_step, gen, card):
    """Per-layer times of one eval step (CUDA events, each layer run alone
    and synchronized) and the device-busy share from torch.profiler;
    ``gen`` is the generator the (captured) eval step is bound to."""
    from spair_pytorch_tpu_torch.models.infer import nms_keep_batch
    from spair_pytorch_tpu_torch.models.kl import (count_prior_kl,
                                                   independent_kl)
    from spair_pytorch_tpu_torch.models.render import render
    from spair_pytorch_tpu_torch.models.spair import (infer_latents,
                                                      loss_and_metrics)

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
    one(state)  # its warm-up and capture: the profiled call is a replay
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
    one(state)  # its warm-up and capture: the profiled call is a replay
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
    ``render.py``'s ``composite_over``."""

    def __init__(self, K, R):
        self.targets = [(K, "_launch_forward", "K1"),
                        (K, "_launch_backward", "K2"),
                        (R, "composite_over", "ordered")]
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
    from spair_pytorch_tpu_torch.ops.kernels import composite_ordered as O
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

    # (c) train() of the three presets at their widths and batches; the
    # render_topk presets' steps are replays of the segmented capture, so
    # the branches are read from the step functions train() makes
    import tempfile

    import spair_pytorch_tpu_torch.train as train_module
    for name, b in (("cluttered_fine", 32), ("quality", 32),
                    ("tpu_throughput", 256)):
        cfg = PRESETS[name]()
        if cfg.batch_size != b:
            raise AssertionError(f"{name}'s batch is {cfg.batch_size}")
        steps = 10
        made, real_make = [], train_module.make_train_step

        def keep(*a, **kw):
            made.append(real_make(*a, **kw))
            return made[-1]
        with tempfile.TemporaryDirectory() as logdir:
            K.composite_forward.launches = K.composite_backward.launches = 0
            O.ordered_forward.launches = O.ordered_backward.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            train_module.make_train_step = keep
            try:
                with LaunchSizes(K, R) as rec:
                    start.record()
                    train(cfg, steps=steps, logdir=logdir,
                          checkpoint_every=0, metrics_every=1,
                          steps_per_call=steps, digits="font",
                          verbose=False, device=dev)
                    end.record()
                    torch.cuda.synchronize()
            finally:
                train_module.make_train_step = real_make
            launches = (K.composite_forward.launches,
                        K.composite_backward.launches)
            ordered = (O.ordered_forward.launches,
                       O.ordered_backward.launches)
            with open(f"{logdir}/metrics.jsonl") as f:
                rows = [json.loads(line) for line in f]
        losses = [r["losses/total"] for r in rows if "losses/total" in r]
        ms = start.elapsed_time(end) / steps
        sizes = rec.sizes["ordered"] if cfg.render_mode == "ordered" \
            else rec.sizes["K1"]
        counts = [fn.branches.counts for fn in made if fn.branches]
        branches = (f"; top-K branch {sum(c['topk'] for c in counts)} "
                    f"steps, fallback {sum(c['full'] for c in counts)}"
                    if cfg.render_topk else "")
        if cfg.render_topk and sum(c["topk"] + c["full"]
                                   for c in counts) != steps:
            raise AssertionError(f"{name}: branches {counts}")
        phase("options", f"train() {name} b{b} {cfg.inference_mode} "
                         f"{cfg.compute_dtype} {cfg.render_mode}: {steps} "
                         f"steps from random weights, losses "
                         f"{losses[0]:.1f} -> {losses[-1]:.1f}, all finite: "
                         f"{all(math.isfinite(v) for v in losses)}; "
                         f"{ms:.3f} ms/step, {b / ms * 1e3:.1f} img/s (CUDA "
                         f"events around train(), set-up and first step "
                         f"included; {card}); launches K1 {launches[0]}, K2 "
                         f"{launches[1]}, ordered forward {ordered[0]}, "
                         f"backward {ordered[1]}; composites in Python "
                         f"(eager, "
                         f"warm-up and capture) on N = "
                         f"{sorted(set(sizes))}{branches}")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses {losses}")
        if cfg.render_mode == "reference" and min(launches) < steps:
            raise AssertionError(f"{name} did not launch K1/K2 every step")
        if cfg.render_mode == "ordered" and min(ordered) < steps:
            raise AssertionError(f"{name} did not launch the ordered "
                                 f"kernels every step")

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
        # the eager step: a replay allocates nothing, so phase 17 reads
        # the captured step's peak over its first call
        step = make_train_step(cfg, datagen=(dcfg, bank), eager=True)
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


# phase 17: the train step captured as a CUDA graph (parallel/captured.py)
CAPTURED_K = 5   # the A/B's call of K steps


def run_steps(cfg, datagen, eager, dev, mesh=None):
    """5 calls of one step, then a call of CAPTURED_K steps after that
    step's first call, from a fresh state (``replicate``d over ``mesh``,
    the data-parallel step's world, when given): (state, the 6 calls'
    metrics, K1-K4 launches of the last call)."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.parallel.mesh import replicate
    state = create_train_state(cfg, device=dev)
    if mesh is not None:
        state = replicate(mesh, state)
    one = make_train_step(cfg, mesh, datagen=datagen, eager=eager)
    many = make_train_step(cfg, mesh, datagen=datagen,
                           steps_per_call=CAPTURED_K, eager=eager)
    metrics = [one(state)[1] for _ in range(5)]
    many(state)
    before = [fn.launches for fn in counted_kernels()]
    metrics.append(many(state)[1])
    torch.cuda.synchronize()
    return state, metrics, [fn.launches - n for fn, n in
                            zip(counted_kernels(), before)]


def counted_kernels():
    from spair_pytorch_tpu_torch.ops.kernels import composite as K
    from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V
    return (K.composite_forward, K.composite_backward,
            V.composite_v3_forward, V.composite_v3_backward)


def same_run(a, b):
    """(tensors equal bit for bit, tensors, max |a - b|, generators equal)
    over two runs' metrics, steps, parameters and Adam state."""
    def tensors(run):
        state, metrics, _ = run
        return ([m[k] for m in metrics for k in sorted(m)] + [state.step]
                + list(state.model.parameters())
                + [v for s in state.optimizer.state.values()
                   for v in s.values() if torch.is_tensor(v)])
    pairs = list(zip(tensors(a), tensors(b)))
    equal = sum(torch.equal(x, y) for x, y in pairs)
    diff = max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in pairs)
    return equal, len(pairs), diff, torch.equal(a[0].generator.get_state(),
                                                b[0].generator.get_state())


class Deterministic:
    """Deterministic kernels (cuDNN's and PyTorch's) inside, as phase
    14(c) compares runs."""

    def __enter__(self):
        torch.backends.cudnn.deterministic = True
        self.warnings = warnings.catch_warnings()
        self.warnings.__enter__()
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        self.warnings.__exit__(*exc)


def graph_ms(fn, generator=None, reps: int = 10) -> float:
    """Device ms of ``fn`` captured as one CUDA graph (``generator``
    registered with it): CUDA events over ``reps`` replays after a warm-up
    run on the capture's stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def captured_phase(card, dev):
    """Phase 17: the main-path step captured against eager. Returns the
    K1-K4 launches of one captured call of CAPTURED_K steps by backend."""
    import importlib

    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.train import data_config, train

    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    cfg = main_path_config()
    datagen = (data_config(cfg), torch.as_tensor(glyph_bank((14, 14)),
                                                 device=dev))
    t_phase = time.perf_counter()
    # (a) captured against eager, 'auto' (K1/K2) and 'pallas_v3' (K3/K4),
    # under deterministic kernels; (d) the launches of a captured call
    launches = {}
    for backend in ("auto", "pallas_v3"):
        c = dataclasses.replace(cfg, render_backend=backend)
        with Deterministic():
            eager = run_steps(c, datagen, True, dev)
            captured = run_steps(c, datagen, False, dev)
        equal, total, diff, gen = same_run(captured, eager)
        want = ([CAPTURED_K] * 2 + [0, 0] if backend == "auto"
                else [0, 0] + [CAPTURED_K] * 2)
        phase("captured", f"{backend}: captured against eager, 5 calls of "
                          f"1 step and 1 call of {CAPTURED_K} "
                          f"(deterministic kernels): {equal} of {total} "
                          f"tensors (every metric of every step, the step, "
                          f"parameters, Adam's state) equal bit for bit, max"
                          f" |diff| {diff:.3e}; generators equal: {gen}; "
                          f"launches K1-K4 of the captured {CAPTURED_K}-step"
                          f" call {captured[2]} (eager {eager[2]}, expected "
                          f"{want})")
        if equal != total or not gen:
            raise AssertionError(f"{backend}: the captured step differs "
                                 f"from the eager one")
        if captured[2] != want or eager[2] != want:
            raise AssertionError(f"{backend}: launches {captured[2]}, "
                                 f"{eager[2]}, expected {want}")
        # (c) the metrics the 6 calls returned were held to the end and
        # still equal eager's: no call's overwrote another's
        losses = [float(m["losses/total"]) for m in captured[1][:5]]
        if len(set(losses)) != 5:
            raise AssertionError(f"captured losses repeat: {losses}")
        launches[backend] = captured[2]
    phase("captured", "metrics returned by each call, held across the later "
                      "calls, equal eager's: fresh tensors every call; "
                      f"losses of the 5 one-step calls {losses} ('pallas_v3')")
    # the same without deterministic kernels: eager against eager is the
    # control for captured against eager
    runs = [run_steps(cfg, datagen, e, dev) for e in (True, True, False)]
    for name, (a, b) in (("eager against eager", runs[:2]),
                         ("captured against eager", (runs[2], runs[0]))):
        equal, total, diff, gen = same_run(a, b)
        phase("captured", f"auto, default kernels, {name}: {equal} of "
                          f"{total} tensors equal bit for bit, max |diff| "
                          f"{diff:.3e}; generators equal: {gen}")

    # (b) the scenes each step draws, copied out of the graph by a spy
    real = ts.generate_batch
    seen = torch.zeros((cfg.batch_size, 1) + tuple(cfg.image_shape[1:]),
                       device=dev)

    def spy(*args):
        x, gt_bbox, gt_count = real(*args)
        seen.copy_(x)
        return x, gt_bbox, gt_count
    scenes = {}
    ts.generate_batch = spy
    try:
        for eager in (True, False):
            state = create_train_state(cfg, device=dev)
            step = make_train_step(cfg, datagen=datagen, eager=eager)
            scenes[eager] = []
            for _ in range(4):
                step(state)
                scenes[eager].append(seen.clone())
    finally:
        ts.generate_batch = real
    new = all(not torch.equal(a, b) for a, b in zip(scenes[False],
                                                    scenes[False][1:]))
    same = all(torch.equal(a, b) for a, b in zip(scenes[False],
                                                 scenes[True]))
    phase("captured", f"scenes of 4 steps (1 eager, 3 replays): each "
                      f"differs from the last: {new}; equal to the eager "
                      f"step's, step for step: {same}")
    if not (new and same):
        raise AssertionError("the replays do not draw the eager scenes")

    # (e) bound to its state
    state = create_train_state(cfg, device=dev)
    step = make_train_step(cfg, datagen=datagen)
    step(state)
    refused = []
    for what, arg in (("another state", create_train_state(cfg, device=dev)),
                      ("Adam's state loaded from new tensors", None)):
        if arg is None:
            saved = state.optimizer.state_dict()
            saved["state"] = {i: {k: v.clone() for k, v in t.items()}
                              for i, t in saved["state"].items()}
            state.optimizer.load_state_dict(saved)
            arg = state
        try:
            step(arg)
        except RuntimeError as e:
            refused.append(f"{what}: {str(e)[:60]}...")
    phase("captured", f"a captured step refuses {len(refused)} of 2: "
                      f"{refused}")
    if len(refused) != 2:
        raise AssertionError("a captured step ran with a state it is not "
                             "bound to")
    del state, step

    # (f) eager against captured, in turns: CUDA events over 2 calls of 10
    # steps after a first call; (h) the first call's time and the peak
    # memory of the step of each arm
    times = {"eager": [], "captured": []}
    gib = 2.0 ** 30
    for arm in ("eager", "captured", "captured", "eager"):
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, datagen=datagen,
                               steps_per_call=STEPS_PER_CALL,
                               eager=arm == "eager")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        step(state)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step(state)
        issue = (time.perf_counter() - t0) * 1e3 / (2 * STEPS_PER_CALL)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (2 * STEPS_PER_CALL)
        times[arm].append(ms)
        phase("captured", f"{arm} main-path step: {ms:.3f} ms/step, "
                          f"{TRAIN_B / ms * 1e3:.1f} img/s (CUDA events over "
                          f"2 calls of {STEPS_PER_CALL}; the host returned "
                          f"from them after {issue:.3f} ms a step); first "
                          f"call of "
                          f"{STEPS_PER_CALL} steps {first:.3f} s; peak "
                          f"allocated "
                          f"{torch.cuda.max_memory_allocated(dev) / gib:.3f}"
                          f" GiB ({held / gib:.3f} GiB held before the "
                          f"state was made), reserved "
                          f"{torch.cuda.max_memory_reserved(dev) / gib:.3f} "
                          f"GiB ({card})")
        if arm == "captured" and len(times[arm]) == 1:
            # (g) the device's busy share of one captured call
            wall, busy, n_kernels, events = profiled(lambda: step(state))
            phase("captured", f"one captured call of {STEPS_PER_CALL} steps "
                              f"under the profiler: {wall:.3f} ms wall, "
                              f"device busy {busy:.3f} ms ({busy / wall:.1%}"
                              f" of that wall, "
                              f"{busy / ms / STEPS_PER_CALL:.1%} of the "
                              f"unprofiled {ms:.3f} ms/step), "
                              f"{n_kernels} device kernels ({card})")
            print(events.table(sort_by="self_device_time_total",
                               row_limit=12), flush=True)
        del state, step
    e, c = (sum(times[k]) / 2 for k in ("eager", "captured"))
    phase("captured", f"eager {', '.join(f'{x:.3f}' for x in times['eager'])}"
                      f" against captured "
                      f"{', '.join(f'{x:.3f}' for x in times['captured'])} "
                      f"ms/step in turns (eager, captured, captured, eager):"
                      f" {e / c:.2f}x ({card})")
    # the one-off cost: the first call of one step, warm-up and capture,
    # beside one eager step
    for what in ("an eager step", "the first call of a captured step (its "
                 "eager warm-up step and the capture)"):
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, datagen=datagen,
                               eager=what.startswith("an eager"))
        if what.startswith("an eager"):
            step(state)  # as the captured step's warm-up, after a first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state)
        torch.cuda.synchronize()
        phase("captured", f"{what}: {(time.perf_counter() - t0) * 1e3:.1f} "
                          f"ms (host clock; {card})")
        del state, step

    # (i) a resumed train() equals an uninterrupted one, each train() call
    # capturing its own step after the restore
    run = dict(checkpoint_every=2, steps_per_call=2, digits="font",
               verbose=False, device=dev)
    with tempfile.TemporaryDirectory() as d, Deterministic():
        whole = train(cfg, steps=4, logdir=f"{d}/a", **run)
        train(cfg, steps=2, logdir=f"{d}/b", **run)
        split = train(cfg, steps=2, logdir=f"{d}/b", **run)
        rows = []
        for r in "ab":
            with open(f"{d}/{r}/metrics.jsonl") as f:
                rows.append([json.loads(x).get("losses/total") for x in f])
    equal, total, diff, gen = same_run((split, [], None), (whole, [], None))
    phase("captured", f"train() 2 steps, a resume, 2 more against 4 steps "
                      f"(deterministic kernels): losses equal "
                      f"{rows[0] == rows[1]}, {equal} of {total} state "
                      f"tensors equal bit for "
                      f"bit, generators equal {gen}")
    if rows[0] != rows[1] or equal != total or not gen:
        raise AssertionError("the resumed captured run differs")

    # (k) where the captured step's device time goes: each layer alone,
    # forward and backward, captured and replayed (the state's noise
    # given, so only the scene generator draws)
    from spair_pytorch_tpu_torch.data import generate_batch
    from spair_pytorch_tpu_torch.models.kl import count_prior_kl
    from spair_pytorch_tpu_torch.models.latents import geometry, sample_noise
    from spair_pytorch_tpu_torch.models.spair import (compute_dtype, forward,
                                                      infer_latents)
    state = create_train_state(cfg, device=dev)
    make_train_step(cfg, datagen=datagen, eager=True)(state)
    model, gen = state.model, torch.Generator(device=dev).manual_seed(3)
    x = generate_batch(gen, datagen[1], cfg.batch_size, datagen[0])[0]
    noise = sample_noise(gen, cfg.batch_size, geometry(cfg)[1], cfg, dev)
    gh, gw = geometry(cfg)[1]
    prob = torch.rand((cfg.batch_size, gh, gw, 1), generator=gen,
                      device=dev) * 0.98 + 0.01

    def backbone():
        model.backbone(x, compute_dtype(cfg)).float().sum().backward()

    def inference():
        z = infer_latents(model, cfg, x, state.step, noise=noise)
        sum(z[k].float().sum() for k in ("z_where", "z_attr", "z_depth",
                                         "z_pres_prob")).backward()

    def count_prior():
        p = prob.clone().requires_grad_(True)
        count_prior_kl(p, prob, state.step, cfg).sum().backward()

    def loss():
        forward(model, cfg, x, state.step, noise=noise)[0].backward()
    pieces = {"scene generation": (lambda: generate_batch(
                  gen, datagen[1], cfg.batch_size, datagen[0]), gen),
              "backbone fwd+bwd": (backbone, None),
              "inference fwd+bwd (backbone and 31 fronts)": (inference, None),
              "count-prior KL fwd+bwd (121-step chain)": (count_prior, None),
              "loss fwd+bwd (the whole model)": (loss, None),
              "Adam": (state.optimizer.step, None)}
    for name, (fn, g) in pieces.items():
        t = graph_ms(fn, g)
        phase("captured", f"{name}, captured alone: {t:.3f} ms "
                          f"({t / c:.1%} of the captured step's {c:.3f} ms;"
                          f" {card})")
    del state, model

    phase("captured", f"phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return launches



# phase 18: the forward programs captured as CUDA graphs
# (parallel/captured.py::CapturedForward)
DET_BUCKETS = (1, 8, 32, 128)
DET_KEYS = ("boxes", "scores", "count", "z_depth")


def same_tree(a, b):
    """(leaves equal bit for bit, leaves) of two trees of tensors."""
    from torch.utils._pytree import tree_flatten
    pairs = list(zip(tree_flatten(a)[0], tree_flatten(b)[0]))
    return sum(torch.equal(x, y) for x, y in pairs), len(pairs)


def host_timed(fn):
    """(fn(), host seconds to the end of its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def forward_phase(card, dev):
    """Phase 18: the detector, the eval step, evaluate and calibrate
    captured against eager. Returns the K1-K4 launches of the captured
    eval paths, each read from its own run with the counts set to 0 just
    before it."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.eval import calibrate, evaluate
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.models.infer import (make_detector,
                                                      nms_keep_batch)
    from spair_pytorch_tpu_torch.ops.quant import quantize_params_int8
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_eval_step)
    from spair_pytorch_tpu_torch.serve import DetectorServer
    from spair_pytorch_tpu_torch.train import data_config

    t_phase = time.perf_counter()
    api = sorted(f"{where}.{n}" for where, names in (
        ("CUDAGraph", dir(torch.cuda.CUDAGraph)),
        ("torch.cuda.graphs", dir(torch.cuda.graphs)),
        ("torch._C", [n for n in dir(torch._C) if "graph" in n.lower()]))
        for n in names if any(w in n.lower() for w in (
            "conditional", "while", "if_node")))
    phase("forward", f"torch {torch.__version__}, CUDA {torch.version.cuda}"
                     f": CUDA graph conditional or while nodes exposed to "
                     f"Python: {api or 'none'}; the captured NMS runs a "
                     f"fixed N sweeps")
    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    qparams = quantize_params_int8(params)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    xs = {b: generate_batch(torch.Generator(device=dev).manual_seed(180 + b),
                            bank, b, dcfg)[0] for b in DET_BUCKETS}

    # (a) the detector captured against eager, NMS off and at 0.5
    arms = [(f"f32 B={b}", cfg, params, b) for b in DET_BUCKETS] + [
        ("bf16 B=32", dataclasses.replace(cfg, compute_dtype="bfloat16"),
         params, 32), ("int8 B=32", cfg, qparams, 32)]
    det_ms, kept = {}, None
    for name, c, p, b in arms:
        for nms in (None, 0.5):
            x = xs[b]
            eager = make_detector(c, nms_iou=nms, eager=True)
            captured = make_detector(c, nms_iou=nms)
            _, first = host_timed(lambda: captured(p, x))
            got, want = captured(p, x), eager(p, x)
            equal = [k for k in DET_KEYS if torch.equal(got[k], want[k])]
            t = [cuda_ms(lambda: f(p, x), n, warmup=1) for f, n in (
                (eager, 3), (captured, 10), (captured, 10), (eager, 3))]
            e, g = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            det_ms[name, nms] = e, g
            phase("forward", f"detector {name}, NMS {nms}: captured against"
                             f" eager, {len(equal)} of {len(DET_KEYS)} "
                             f"outputs ({', '.join(equal)}) equal bit for "
                             f"bit; eager {t[0]:.3f}, {t[3]:.3f} against "
                             f"captured {t[1]:.3f}, {t[2]:.3f} ms/call in "
                             f"turns ({e / g:.2f}x; {b / g * 1e3:.1f} "
                             f"against {b / e * 1e3:.1f} img/s); first call"
                             f" (eager run and capture) {first:.3f} s "
                             f"({card})")
            if len(equal) != len(DET_KEYS):
                raise AssertionError(f"captured detector {name}, NMS {nms}"
                                     f" differs from eager")
            if name == "f32 B=32" and nms is None:
                kept = (captured, p, x, g)
    fn, p, x, g = kept
    wall, busy, n_kernels, events = profiled(lambda: fn(p, x))
    phase("forward", f"one captured f32 B=32 detector call under the "
                     f"profiler: {wall:.3f} ms wall, device busy "
                     f"{busy:.3f} ms ({busy / wall:.1%} of that wall, "
                     f"{busy / g:.1%} of the unprofiled {g:.3f} ms), "
                     f"{n_kernels} device kernels ({card})")
    print(events.table(sort_by="self_device_time_total", row_limit=8),
          flush=True)
    for b in (32, 128):
        out = make_detector(cfg, eager=True)(params, xs[b])
        boxes, scores = out["boxes"], out["scores"]
        fixed = graph_ms(lambda: nms_keep_batch(boxes, scores, 0.5,
                                                early_exit=False))
        early = cuda_ms(lambda: nms_keep_batch(boxes, scores, 0.5), 5)
        on, off = det_ms[f"f32 B={b}", 0.5][1], det_ms[f"f32 B={b}", None][1]
        phase("forward", f"NMS 0.5 at B={b}: the {N} sweeps captured alone"
                         f" {fixed:.3f} ms of device time; the eager early "
                         f"exit {early:.3f} ms (CUDA events, host reads "
                         f"included); captured detector with NMS {on:.3f} "
                         f"against without {off:.3f} ms ({card})")

    # the server: every bucket captured at warmup into one memory pool
    gib = 2.0 ** 30
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    server = DetectorServer(cfg, params, batch_sizes=DET_BUCKETS,
                            nms_iou=0.5)
    seconds = server.warmup()
    after = torch.cuda.memory_reserved(dev)
    requests = generate_batch(torch.Generator(device=dev).manual_seed(18),
                              bank, 64, dcfg)[0]
    dets, dt = host_timed(lambda: server.detect(requests))
    padded = torch.cat([requests, requests.new_zeros((64,) + tuple(
        requests.shape[1:]))])
    want = make_detector(cfg, nms_iou=0.5, eager=True)(params, padded)
    scores = want["scores"].cpu().numpy()
    same = sum(d["count"] == int((scores[i] >= 0.5).sum())
               and (d["scores"] == scores[i][scores[i] >= 0.5]).all()
               for i, d in enumerate(dets))
    phase("forward", f"DetectorServer buckets {DET_BUCKETS}, NMS 0.5: "
                     f"warmup captures each in "
                     + ", ".join(f"{b}: {v:.3f} s" for b, v in
                                 seconds.items())
                     + f"; reserved {before / gib:.3f} GiB before warmup, "
                     f"{after / gib:.3f} GiB after; 64 requests in "
                     f"{dt * 1e3:.1f} ms ({64 / dt:.1f} img/s, host clock, "
                     f"bucket 128); {same} of 64 equal to the eager "
                     f"detector's ({card})")
    if len(dets) != 64 or same != 64:
        raise AssertionError("the captured server's answers differ")
    del server

    # (b) the eval step captured against eager: K1 ('auto') or K3
    # ('pallas_v3') inside
    launches = {}
    x = xs[32]
    for backend, k in (("auto", 0), ("pallas_v3", 2)):
        c = dataclasses.replace(cfg, render_backend=backend)
        runs = {}
        with Deterministic():
            for eager in (True, False):
                step = make_eval_step(c, eager=eager)
                gen = torch.Generator(device=dev).manual_seed(7)
                runs[eager] = [step(params, x, 1500, gen) for _ in range(3)]
        equal, total = same_tree(runs[False], runs[True])
        losses = [float(r[0]) for r in runs[False]]
        step = make_eval_step(c)
        gen = torch.Generator(device=dev).manual_seed(7)
        step(params, x, 1500, gen)
        for fn in counted_kernels():
            fn.launches = 0
        for _ in range(3):
            step(params, x, 1500, gen)
        torch.cuda.synchronize()
        launches[f"captured_eval_{backend}"] = [
            fn.launches for fn in counted_kernels()]
        eager_step = make_eval_step(c, eager=True)
        t = [cuda_ms(lambda: f(params, x, 1500, gen), n, warmup=1)
             for f, n in ((eager_step, 3), (step, 10), (step, 10),
                          (eager_step, 3))]
        e, g = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        phase("forward", f"eval step {backend} B=32 f32: captured against "
                         f"eager over 3 calls (deterministic kernels): "
                         f"{equal} of {total} tensors (loss and every aux "
                         f"tensor) equal bit for bit, losses {losses}; "
                         f"launches K1-K4 of 3 replays "
                         f"{launches[f'captured_eval_{backend}']}; eager "
                         f"{t[0]:.3f}, {t[3]:.3f} against captured "
                         f"{t[1]:.3f}, {t[2]:.3f} ms/call in turns "
                         f"({e / g:.2f}x; {card})")
        want = [0, 0, 0, 0]
        want[k] = 3
        if equal != total or len(set(losses)) != 3:
            raise AssertionError(f"captured eval step {backend} differs")
        if launches[f"captured_eval_{backend}"] != want:
            raise AssertionError(f"eval step {backend}: launches "
                                 f"{launches[f'captured_eval_{backend}']}")

    # (c) evaluate and calibrate captured against eager; the second
    # captured evaluate reuses the first's capture, re-seeded
    state = create_train_state(cfg, device=dev)
    kw = dict(digits="font", det_threshold=0.5, det_nms=0.5)
    (want, _, _), t_e = host_timed(lambda: evaluate(cfg, state, 4,
                                                    eager=True, **kw))
    (got, _, _), t_1 = host_timed(lambda: evaluate(cfg, state, 4, **kw))
    for fn in counted_kernels():
        fn.launches = 0
    (again, _, _), t_2 = host_timed(lambda: evaluate(cfg, state, 4, **kw))
    launches["captured_evaluate"] = [fn.launches for fn in counted_kernels()]
    phase("forward", f"evaluate(batches=4) B=32, calibrated NMS 0.5: "
                     f"captured equal to eager {got == want}, twice with "
                     f"one seed equal {again == got}; eager {t_e:.3f} s, "
                     f"captured {t_1:.3f} s (first call, 1 capture), "
                     f"{t_2:.3f} s (the same capture, re-seeded); launches "
                     f"K1-K4 of the second {launches['captured_evaluate']} "
                     f"(host clock; {card})")
    if not (got == want == again):
        raise AssertionError(f"captured evaluate differs: {got} {want} "
                             f"{again}")
    cal_want, c_e = host_timed(lambda: calibrate(cfg, state, 2,
                                                 digits="font", eager=True))
    cal, c_1 = host_timed(lambda: calibrate(cfg, state, 2, digits="font"))
    cal_2, c_2 = host_timed(lambda: calibrate(cfg, state, 2, digits="font"))
    phase("forward", f"calibrate(batches=2) B=32: captured equal to eager "
                     f"{cal == cal_want}, again {cal_2 == cal}; eager "
                     f"{c_e:.3f} s, captured {c_1:.3f} s (4 captures), "
                     f"{c_2:.3f} s (reused) (host clock; {card})")
    if not (cal == cal_want == cal_2):
        raise AssertionError("captured calibrate differs")
    phase("forward", f"phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 19: render_topk captured as segments around the render's top-K
# branch (parallel/captured.py::SegmentedStep, SegmentedForward), at the
# presets' widths and batch: cluttered_fine (reference mode, K1/K2 on N = 32
# or 256) and quality (ordered mode, its kernels)
TOPK_RUNS = (("cluttered_fine", "reference"), ("quality", "ordered"))
TOPK_SPARSE_BIAS = -8.0  # the presence head's bias shift: ~8 of 256 live
TOPK_STEPS = 4           # steps a call


class Segments:
    """While active, keeps every SegmentedStep that make_train_step builds
    (its static carry holds segment A's outputs of the last replay), and the
    largest live count of every step that runs ``render_objects`` eagerly
    (an eager step, a captured step's warm-up; not a capture)."""

    def __enter__(self):
        import importlib

        from spair_pytorch_tpu_torch.models import spair
        self.ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                          "train_step")
        self.spair = spair
        self.made, self.live = [], []
        self.saved = (self.ts.SegmentedStep, spair.render_objects)
        real_step, real_objects = self.saved
        made, live = self.made, self.live

        def kept(*a, **kw):
            made.append(real_step(*a, **kw))
            return made[-1]

        def objects(*a, **kw):
            out = real_objects(*a, **kw)
            if out[0]["gate"] is not None and \
                    not torch.cuda.is_current_stream_capturing():
                live.append(int((out[0]["gate"] > 0).sum(1).max()))
            return out
        self.ts.SegmentedStep, spair.render_objects = kept, objects
        return self

    def __exit__(self, *exc):
        self.ts.SegmentedStep, self.spair.render_objects = self.saved


def shift_presence_(model, bias):
    """The presence head's output bias shifted in place, at its address
    (to which a captured step is bound)."""
    with torch.no_grad():
        model.obj_network.out.bias += bias


def state_snapshot(state, metrics):
    """Clones of a call's metrics, the step, the parameters and Adam's
    state."""
    return [v.clone() for k, v in sorted(metrics.items())] + [
        t.detach().clone() for t in [state.step]
        + list(state.model.parameters())
        + [v for s in state.optimizer.state.values()
           for v in s.values() if torch.is_tensor(v)]]


def carry_objects(seg):
    """Clones of segment A's decoded objects from the last replay."""
    objects = seg.carry[0]["objects"]
    return {k: objects[k].detach().clone() for k in
            ("color", "alpha", "importance", "boxes", "gate", "scores")}


def topk_kernel_rows(K, objects, k, card, dev):
    """K1 and K2 on the compositor inputs of one branch of the captured
    path (``objects`` as segment A left them): held against their plain
    versions (f32 1e-4, gradients 1e-3), then timed in turns beside the
    plain versions and their bound. Returns {kernel: (ms, bound ms, bound
    by, N)}."""
    from spair_pytorch_tpu_torch.models import render as R
    o = objects
    inputs = (o["color"], o["alpha"], o["importance"], o["boxes"])
    gate, n = o["gate"], o["color"].shape[1]
    floor = None
    if k:
        take = R._top_k(o["scores"], k)
        inputs, gate, floor = tuple(map(take, inputs)), take(gate), n
    b, kn = inputs[0].shape[:2]
    glimpse = tuple(inputs[0].shape[-2:])
    cot = random_cotangents(b, torch.Generator(device=dev).manual_seed(19),
                            dev)
    name = f"{'top-K' if k else 'full'} N={kn}"
    with torch.no_grad():
        check("topk", f"K1 {name}", F32_BAR,
              K.composite_forward(*inputs, HW, WIN, pres_gate=gate,
                                  den_floor_n=floor),
              K.composite_plain(*inputs, HW, pres_gate=gate,
                                den_floor_n=floor))
        check("topk", f"K2 {name}", GRAD_BAR,
              K.composite_backward(*inputs, HW, *cot, pres_gate=gate),
              K.composite_backward_plain(*inputs, HW, *cot, pres_gate=gate))
        fns = {"K1": lambda: K.composite_forward(
                   *inputs, HW, WIN, pres_gate=gate, den_floor_n=floor),
               "plain K1": lambda: K.composite_plain(
                   *inputs, HW, pres_gate=gate, den_floor_n=floor),
               "K2": lambda: K.composite_backward(*inputs, HW, *cot,
                                                  pres_gate=gate),
               "plain K2": lambda: K.composite_backward_plain(
                   *inputs, HW, *cot, pres_gate=gate)}
        got = {key: [] for key in fns}
        for key in ("plain K1", "K1", "K1", "plain K1", "plain K2", "K2",
                    "K2", "plain K2"):
            got[key].append(cuda_ms(fns[key], 5 if key.startswith("plain")
                                    else 20))
    rows = {}
    for key, fwd in (("K1", True), ("K2", False)):
        live = float(gate.sum())
        bms, by, moved = bound(b, C, inputs[0].element_size(), fwd,
                               support_pairs(inputs[3], gate=gate,
                                             glimpse=glimpse),
                               live=live, n=kn, glimpse=glimpse)
        t = sum(got[key]) / 2
        rows[key] = (t, bms, by, kn)
        phase("topk", f"{key} {name} on the captured path's inputs (b{b}, "
                      f"{int(live)} live, {glimpse[0]}x{glimpse[1]}): "
                      f"{', '.join(f'{x:.4f}' for x in got[key])} ms, plain "
                      f"{', '.join(f'{x:.4f}' for x in got['plain ' + key])}"
                      f" ms; bound {bms:.4f} ms ({by}), {bms / t:.1%} of "
                      f"it ({card})")
    return rows


def topk_phase(K, card, dev):
    """Phase 19: the train step, the eval step and evaluate of the two
    render_topk presets captured as segments, against eager, in both
    branches. Returns the K1-K4 launches of each preset's captured A/B run
    and K1/K2's rows on the captured path's inputs."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.eval import _CAPTURES, evaluate
    from spair_pytorch_tpu_torch.models import render as R
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_eval_step,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.train import data_config

    t_phase = time.perf_counter()
    launches, rows = {}, {}
    for name, mode in TOPK_RUNS:
        cfg = PRESETS[name]()
        k = cfg.render_topk
        dcfg = data_config(cfg)
        datagen = (dcfg, torch.as_tensor(glyph_bank(dcfg.patch_hw),
                                         device=dev))
        tag = f"{name} b{cfg.batch_size} {mode}"

        # (a) captured against eager: a call of TOPK_STEPS steps from the
        # cold, dense state (the full composite), the presence bias shifted
        # in place, a call on the sparse state (the top-K composite)
        runs = {}
        for arm in ("eager", "captured"):
            with Deterministic(), Segments() as seg, LaunchSizes(K, R) as rec:
                state = create_train_state(cfg, device=dev)
                fn = make_train_step(cfg, datagen=datagen,
                                     steps_per_call=TOPK_STEPS,
                                     eager=arm == "eager")
                for w in counted_kernels():
                    w.launches = 0
                calls = []
                for sparse in (False, True):
                    if sparse:
                        shift_presence_(state.model, TOPK_SPARSE_BIAS)
                    m = fn(state)[1]
                    calls.append((list(fn.branches.last),
                                  state_snapshot(state, m),
                                  None if arm == "eager"
                                  else carry_objects(seg.made[0])))
                torch.cuda.synchronize()
            runs[arm] = dict(calls=calls, gen=state.generator.get_state(),
                             launches=[w.launches for w in counted_kernels()],
                             live=list(seg.live), sizes=rec.sizes,
                             counts=dict(fn.branches.counts),
                             seg=seg.made[0] if seg.made else None)
            del state, fn
        e, c = runs["eager"], runs["captured"]
        launches[f"captured_topk_{name}"] = c["launches"]
        seqs = [(ce[0], cc[0]) for ce, cc in zip(e["calls"], c["calls"])]
        phase("topk", f"{tag}: branches of {2 * TOPK_STEPS} steps, eager "
                      f"{[s[0] for s in seqs]}, captured "
                      f"{[s[1] for s in seqs]} (True = top-K); counts "
                      f"captured {c['counts']}, eager {e['counts']}; the "
                      f"eager steps' largest live count an image "
                      f"{e['live']} (K = {k})")
        if any(a != b for a, b in seqs) or seqs[0][0] != [False] * \
                TOPK_STEPS or seqs[1][0] != [True] * TOPK_STEPS:
            raise AssertionError(f"{tag}: the branch sequences differ or "
                                 f"miss a branch: {seqs}")
        for (name_b, i) in (("full", 0), ("top-K", 1)):
            pairs = list(zip(c["calls"][i][1], e["calls"][i][1]))
            equal = sum(torch.equal(x, y) for x, y in pairs)
            diff = max(float((x.float() - y.float()).abs().max())
                       for x, y in pairs)
            phase("topk", f"{tag}, {name_b} branch: captured against eager "
                          f"(deterministic kernels): {equal} of "
                          f"{len(pairs)} tensors (metrics of {TOPK_STEPS} "
                          f"steps, the step, parameters, Adam's state) "
                          f"equal bit for bit, max |diff| {diff:.3e}")
            if equal != len(pairs):
                raise AssertionError(f"{tag}: the captured {name_b} branch "
                                     f"differs from eager")
        seg = c["seg"]
        per_replay = {("top-K" if t else "full"): p
                      for t, (_, p) in seg.tails.items()}
        phase("topk", f"{tag}: generators equal "
                      f"{torch.equal(c['gen'], e['gen'])}; launches K1-K4 "
                      f"of the captured run {c['launches']} (eager "
                      f"{e['launches']}); per replay of A {seg.per_replay},"
                      f" of each B {per_replay}; N of each Python launch "
                      f"(the warm-up, then the B captures) K1 "
                      f"{c['sizes']['K1']}, ordered {c['sizes']['ordered']}")
        if not torch.equal(c["gen"], e["gen"]) or \
                c["launches"] != e["launches"]:
            raise AssertionError(f"{tag}: generator or launches differ")
        if mode == "reference":
            # (b) K1/K2 on the captured path's compositor inputs, both
            # branches, against their plain versions, timed with bounds
            for i, kk in ((0, 0), (1, k)):
                rows[f"{name} N={kk or 256}"] = topk_kernel_rows(
                    K, c["calls"][i][2], kk, card, dev)
        del runs, seg

        # (c) eager against captured ms/step in turns, in each branch; the
        # first call's time (warm-up and three captures) and memory
        gib = 2.0 ** 30
        for sparse in (False, True):
            times = {"eager": [], "captured": []}
            for arm in ("eager", "captured", "captured", "eager"):
                state = create_train_state(cfg, device=dev)
                if sparse:
                    shift_presence_(state.model, TOPK_SPARSE_BIAS)
                fn = make_train_step(cfg, datagen=datagen,
                                     steps_per_call=TOPK_STEPS,
                                     eager=arm == "eager")
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                t0 = time.perf_counter()
                fn(state)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                grown = torch.cuda.memory_reserved(dev) - reserved
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(state)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / TOPK_STEPS
                times[arm].append(ms)
                if arm == "captured" and len(times[arm]) == 1:
                    phase("topk", f"{tag}, {'top-K' if sparse else 'full'}"
                                  f": the first call of a captured step "
                                  f"({TOPK_STEPS} steps: the eager warm-up "
                                  f"step, the captures of A and both Bs, "
                                  f"{TOPK_STEPS - 1} replays) {first:.3f} "
                                  f"s; reserved memory +{grown / gib:.3f} "
                                  f"GiB over it (host clock; {card})")
                if fn.branches.last != [sparse] * TOPK_STEPS:
                    raise AssertionError(f"{tag}: timed steps took "
                                         f"{fn.branches.last}")
                del state, fn
            ea, ca = (sum(times[a]) / 2 for a in ("eager", "captured"))
            b = cfg.batch_size
            eager_ms, captured_ms = (', '.join(f"{x:.3f}" for x in times[a])
                                     for a in ("eager", "captured"))
            phase("topk", f"{tag}, {'top-K' if sparse else 'full'} branch: "
                          f"eager {eager_ms} against captured {captured_ms}"
                          f" ms/step in turns (eager, captured, captured, "
                          f"eager; CUDA events over a call of {TOPK_STEPS} "
                          f"after the first): {ea / ca:.2f}x, "
                          f"{b / ca * 1e3:.1f} against {b / ea * 1e3:.1f} "
                          f"img/s ({card})")

        # (d) the eval step and evaluate, captured against eager, each
        # branch
        x = generate_batch(torch.Generator(device=dev).manual_seed(190),
                           datagen[1], cfg.batch_size, dcfg)[0]
        for sparse in (False, True):
            state = create_train_state(cfg, device=dev)
            if sparse:
                shift_presence_(state.model, TOPK_SPARSE_BIAS)
            which = "top-K" if sparse else "full"
            out, steps, gens = {}, {}, {}
            with Deterministic():
                for eager in (True, False):
                    steps[eager] = make_eval_step(cfg, eager=eager)
                    gens[eager] = torch.Generator(device=dev).manual_seed(7)
                    out[eager] = [steps[eager](state.model, x, 1500,
                                               gens[eager])
                                  for _ in range(3)]
            equal, total = same_tree(out[False], out[True])
            counts = dict(steps[False].branches.counts)
            t = [cuda_ms(lambda e=e: steps[e](state.model, x, 1500,
                                              gens[e]), n, warmup=1)
                 for e, n in ((True, 2), (False, 10), (False, 10),
                              (True, 2))]
            phase("topk", f"{tag} eval step, {which} branch: captured "
                          f"against eager over 3 calls (deterministic "
                          f"kernels): {equal} of {total} tensors equal bit "
                          f"for bit; captured branches {counts}; eager "
                          f"{t[0]:.3f}, {t[3]:.3f} against captured "
                          f"{t[1]:.3f}, {t[2]:.3f} ms/call in turns "
                          f"({(t[0] + t[3]) / (t[1] + t[2]):.2f}x; {card})")
            if equal != total or counts["topk" if sparse else "full"] != 3:
                raise AssertionError(f"{tag}: the captured eval step "
                                     f"differs or took {counts}")
            kw = dict(digits="font", det_threshold=0.5, det_nms=0.5)
            (want, _, _), t_e = host_timed(lambda: evaluate(
                cfg, state, 4, eager=True, **kw))
            (got, _, _), t_1 = host_timed(lambda: evaluate(cfg, state, 4,
                                                           **kw))
            (again, _, _), t_2 = host_timed(lambda: evaluate(cfg, state, 4,
                                                             **kw))
            (program,) = _CAPTURES[state.model]["programs"].values()
            phase("topk", f"{tag} evaluate(batches=4), {which} branch: "
                          f"captured equal to eager {got == want}, again "
                          f"{again == got}; captured branches "
                          f"{program.branches.counts}; eager {t_e:.3f} s, "
                          f"captured {t_1:.3f} s (first call, 3 captures), "
                          f"{t_2:.3f} s (reused) (host clock; {card})")
            if not (got == want == again) or program.branches.counts[
                    "topk" if sparse else "full"] != 8:
                raise AssertionError(f"{tag}: captured evaluate differs or "
                                     f"took {program.branches.counts}")
            del state, steps, out, program
    phase("topk", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return launches, rows


# phase 20: the last two eager programs captured: the data-parallel step
# (world size 1 over NCCL, its collectives inside the graph) and the split
# refiner (one graph per batch size)
MESH_PROBES = 10  # captures in torch's own check of the NCCL watchdog


def nccl_capture_probe(dev):
    """Phase 20(a), first: NCCL inside a capture in torch's default
    'global' capture-error mode, on a fresh group. (1) The group's first
    collective inside a capture: it needs the communicator made at init
    (``make_mesh``'s ``device_id``), as a communicator made inside a
    capture fails it. (2) torch's own check of ProcessGroupNCCL's watchdog
    thread against a capture on the main thread (its
    ``test_nccl_watchdog_cudagraph``): MESH_PROBES captures of three
    all-reduces, each after 30 eager ones that the watchdog polls, each
    graph replayed 200 times. Returns the seconds it took."""
    import torch.distributed as dist

    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    world = make_mesh(dev)
    try:
        x = torch.ones(1, device=dev)
        stream = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            dist.all_reduce(x)
        graph.replay()
        for _ in range(MESH_PROBES):
            for _ in range(30):
                dist.all_reduce(x)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                x += 0.0
                for _ in range(3):
                    dist.all_reduce(x)
                x += 0.0
            for _ in range(200):
                graph.replay()
        torch.cuda.synchronize()
        if float(x) != 1.0:
            raise AssertionError(f"world-of-one all-reduces gave {float(x)}")
    finally:
        world.close()
    return time.perf_counter() - t0


def topk_mesh_run(cfg, datagen, eager, dev, mesh=None):
    """cluttered_fine's segmented step (``mesh``'s data-parallel step when
    given): a call of TOPK_STEPS steps from the cold, dense state, the
    presence bias shifted in place, a call on the sparse state. Returns
    (per call: its branches and state snapshot; the generator's state;
    K1-K4 launches of the two calls)."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.parallel.mesh import replicate
    state = create_train_state(cfg, device=dev)
    if mesh is not None:
        state = replicate(mesh, state)
    fn = make_train_step(cfg, mesh, datagen=datagen,
                         steps_per_call=TOPK_STEPS, eager=eager)
    for w in counted_kernels():
        w.launches = 0
    calls = []
    for sparse in (False, True):
        if sparse:
            shift_presence_(state.model, TOPK_SPARSE_BIAS)
        m = fn(state)[1]
        calls.append((list(fn.branches.last), state_snapshot(state, m)))
    torch.cuda.synchronize()
    return (calls, state.generator.get_state(),
            [w.launches for w in counted_kernels()])


def first_and_steady_ms(cfg, datagen, dev, mesh, eager):
    """(the first call's host seconds, then ms/step by CUDA events over one
    call of STEPS_PER_CALL steps) of a fresh main-path step."""
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.parallel.mesh import replicate
    state = create_train_state(cfg, device=dev)
    if mesh is not None:
        state = replicate(mesh, state)
    step = make_train_step(cfg, mesh, datagen=datagen,
                           steps_per_call=STEPS_PER_CALL, eager=eager)
    _, first = host_timed(lambda: step(state))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(state)
    end.record()
    torch.cuda.synchronize()
    return first, start.elapsed_time(end) / STEPS_PER_CALL


def mesh_capture_phase(card, dev):
    """Phase 20(a): the data-parallel step at world size 1 over NCCL,
    captured, against the eager mesh step and the captured plain step, bit
    for bit under deterministic kernels: the main path through 'auto' and
    'pallas_v3', and cluttered_fine b32 segmented in both branches; ms/step
    in turns; the first call. Returns the K1-K4 launches of each captured
    mesh run, counted over its replays."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh
    from spair_pytorch_tpu_torch.train import data_config

    probe_s = nccl_capture_probe(dev)
    phase("mesh-captured", f"NCCL in captures, torch's default 'global' "
                           f"capture-error mode: a fresh group's first "
                           f"collective captured and replayed; "
                           f"{MESH_PROBES} captures of 3 all-reduces, each "
                           f"after 30 eager ones the watchdog polls, 200 "
                           f"replays each: none failed ({probe_s:.2f} s)")
    cfg = main_path_config()
    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    datagen = (data_config(cfg), bank)
    launches = {}
    world = make_mesh(dev)
    try:
        for backend in ("auto", "pallas_v3"):
            c = dataclasses.replace(cfg, render_backend=backend)
            with Deterministic():
                runs = {"mesh eager": run_steps(c, datagen, True, dev, world),
                        "mesh captured": run_steps(c, datagen, False, dev,
                                                   world),
                        "plain captured": run_steps(c, datagen, False, dev)}
            got = runs["mesh captured"]
            want = ([CAPTURED_K] * 2 + [0, 0] if backend == "auto"
                    else [0, 0] + [CAPTURED_K] * 2)
            for other in ("mesh eager", "plain captured"):
                equal, total, diff, gen = same_run(got, runs[other])
                phase("mesh-captured", f"{backend} b{TRAIN_B}: captured mesh "
                                       f"step (world 1, NCCL) against the "
                                       f"{other} step, 5 calls of 1 step and"
                                       f" 1 of {CAPTURED_K} (deterministic "
                                       f"kernels): {equal} of {total} "
                                       f"tensors equal bit for bit, max "
                                       f"|diff| {diff:.3e}; generators "
                                       f"equal: {gen}")
                if equal != total or not gen:
                    raise AssertionError(f"{backend}: the captured mesh step"
                                         f" differs from the {other} step")
            phase("mesh-captured", f"{backend}: launches K1-K4 of the "
                                   f"captured mesh call of {CAPTURED_K} "
                                   f"steps {got[2]}, counted over replays "
                                   f"(eager mesh {runs['mesh eager'][2]}, "
                                   f"expected {want})")
            if got[2] != want or runs["mesh eager"][2] != want:
                raise AssertionError(f"{backend}: mesh launches {got[2]}")
            launches[f"mesh_{backend}"] = got[2]
            del runs, got

        # cluttered_fine b32, segmented: the global predicate's MAX
        # all-reduce in segment A, NCCL's gradient all-reduce and metrics
        # all-gather in each B
        fine = PRESETS["cluttered_fine"]()
        fdcfg = data_config(fine)
        fgen = (fdcfg, torch.as_tensor(glyph_bank(fdcfg.patch_hw),
                                       device=dev))
        with Deterministic():
            runs = {"mesh eager": topk_mesh_run(fine, fgen, True, dev, world),
                    "mesh captured": topk_mesh_run(fine, fgen, False, dev,
                                                   world),
                    "plain captured": topk_mesh_run(fine, fgen, False, dev)}
        got = runs["mesh captured"]
        branches = [b for b, _ in got[0]]
        if branches != [[False] * TOPK_STEPS, [True] * TOPK_STEPS]:
            raise AssertionError(f"cluttered_fine mesh branches {branches}")
        for other in ("mesh eager", "plain captured"):
            run = runs[other]
            pairs = [(x, y) for (_, a), (_, b) in zip(got[0], run[0])
                     for x, y in zip(a, b)]
            equal = sum(torch.equal(x, y) for x, y in pairs)
            same = ([b for b, _ in run[0]] == branches
                    and torch.equal(got[1], run[1]))
            phase("mesh-captured", f"cluttered_fine b{fine.batch_size} "
                                   f"segmented, captured mesh step against "
                                   f"the {other} step, a call of "
                                   f"{TOPK_STEPS} steps in each branch "
                                   f"(deterministic kernels): branches "
                                   f"{branches} in both: {same}; {equal} of "
                                   f"{len(pairs)} tensors equal bit for bit;"
                                   f" launches K1-K4 {got[2]} ({other} "
                                   f"{run[2]})")
            if equal != len(pairs) or not same or got[2] != run[2]:
                raise AssertionError(f"cluttered_fine: the captured mesh "
                                     f"step differs from the {other} step")
        launches["mesh_cluttered_fine"] = got[2]
        del runs, got

        # ms/step in turns, the first call of each arm
        arms = ("mesh eager", "mesh captured", "plain captured",
                "plain captured", "mesh captured", "mesh eager")
        times = {a: [] for a in arms}
        for arm in arms:
            first, ms = first_and_steady_ms(
                cfg, datagen, dev, world if arm.startswith("mesh") else None,
                arm.endswith("eager"))
            times[arm].append((first, ms))
        rows = "; ".join(
            f"{a} " + ", ".join(f"{ms:.3f}" for _, ms in times[a])
            + " ms/step (first call "
            + ", ".join(f"{f:.3f}" for f, _ in times[a]) + " s)"
            for a in arms[:3])
        ea, ca, pa = (sum(ms for _, ms in times[a]) / 2 for a in arms[:3])
        phase("mesh-captured", f"main path b{TRAIN_B} 'auto', in turns "
                               f"({', '.join(arms)}; CUDA events over a "
                               f"call of {STEPS_PER_CALL} after the first, "
                               f"whose host time is given): {rows}; "
                               f"captured mesh {ea / ca:.2f}x the eager "
                               f"mesh step, {ca / pa:.3f}x the captured "
                               f"plain step's time; {TRAIN_B / ca * 1e3:.1f}"
                               f" img/s ({card})")
    finally:
        world.close()
    return launches


class CaptureCount:
    """While active, counts the captures ``parallel/captured.py`` makes."""

    def __enter__(self):
        from spair_pytorch_tpu_torch.parallel import captured
        self.captured, self.real = captured, captured._capture
        self.n = 0

        def counted(*a, **kw):
            self.n += 1
            return self.real(*a, **kw)
        captured._capture = counted
        return self

    def __exit__(self, *exc):
        self.captured._capture = self.real


def refine_capture_phase(K, card, dev):
    """Phase 20(b): ``make_refiner`` captured (one graph per batch size)
    against eager at B=32 and B=128 after the captured detector (NMS 0.5,
    top_m 12, 32 px windows): every output bit for bit at margin 0, +inf
    and -inf (with max_neighbor_iou 1), the numbers as floats and as 0-d
    tensors through one graph; K1's launches a replay; ms/call in turns
    beside the captured detector; the first call. Returns K1-K4 launches of
    one replay at each batch."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models import init_params, refine
    from spair_pytorch_tpu_torch.models.infer import make_detector
    from spair_pytorch_tpu_torch.train import data_config

    cfg = PRESETS["paper128"]()
    params = init_params(cfg, device=dev)
    dcfg = data_config(cfg)
    bank = torch.as_tensor(glyph_bank(dcfg.patch_hw), device=dev)
    detect = make_detector(cfg, nms_iou=0.5)
    knobs = dict(top_m=REFINE_M, window_px=REFINE_WIN)
    launches = {}
    for b in (32, 128):
        x = generate_batch(torch.Generator(device=dev).manual_seed(200 + b),
                           bank, b, dcfg)[0]
        det = detect(params, x)
        eager = refine.make_refiner(cfg, eager=True, **knobs)
        opened_e = refine.make_refiner(cfg, max_neighbor_iou=1.0,
                                       eager=True, **knobs)
        with CaptureCount() as made:
            captured = refine.make_refiner(cfg, **knobs)
            opened = refine.make_refiner(cfg, max_neighbor_iou=1.0, **knobs)
            first_out, first = host_timed(
                lambda: captured(params, x, det, 0.0, 0.5))
            for w in counted_kernels():
                w.launches = 0
            got = captured(params, x, det, 0.0, 0.5)
            torch.cuda.synchronize()
            launches[f"refine_captured_b{b}"] = [
                w.launches for w in counted_kernels()]
            as_tensors = captured(params, x, det,
                                  torch.zeros((), device=dev),
                                  torch.full((), 0.5, device=dev))
            inf = captured(params, x, det, math.inf, 0.5)
            opened(params, x, det, -math.inf, 0.5)
            neg = opened(params, x, det, -math.inf, 0.5)
        want = eager(params, x, det, 0.0, 0.5)
        arms = {"margin 0": (got, want), "first call": (first_out, want),
                "0-d tensors": (as_tensors, want),
                "margin +inf": (inf, eager(params, x, det, math.inf, 0.5)),
                "margin -inf, max_neighbor_iou 1": (
                    neg, opened_e(params, x, det, -math.inf, 0.5))}
        results = {k: same_tree(a, w) for k, (a, w) in arms.items()}
        n = det["scores"].shape[1]
        live = torch.sum(det["scores"] >= 0.5, dim=-1)
        live_m = torch.sum(refine._stable_top_k(det["scores"], REFINE_M)[0]
                           >= 0.5, dim=-1)
        bounds = (torch.equal(inf["boxes"][:, :n], det["boxes"])
                  and torch.equal(inf["count"], det["count"])
                  and int(inf["n_split"].sum()) == 0
                  and torch.equal(neg["count"], live + live_m)
                  and torch.equal(neg["n_split"], live_m))
        phase("refine-captured", f"B={b}: captured against eager, outputs "
                                 f"equal bit for bit of 4: "
                                 f"{ {k: v[0] for k, v in results.items()} }"
                                 f"; {made.n} captures for the two refiners"
                                 f" (floats, 0-d tensors and infinities "
                                 f"through one graph each); margin +inf "
                                 f"leaves the detections, -inf splits the "
                                 f"{int(live_m.sum())} live of the top "
                                 f"{REFINE_M}: {bounds}; launches K1-K4 of "
                                 f"a replay {launches[f'refine_captured_b{b}']}"
                                 f"; the first call (eager run and capture) "
                                 f"{first:.3f} s ({card})")
        if any(e != t for e, t in results.values()) or made.n != 2 \
                or not bounds or launches[f"refine_captured_b{b}"] != [
                    2, 0, 0, 0]:
            raise AssertionError(f"refine B={b}: the captured refiner "
                                 f"differs from eager")
        fns = {"detector": lambda: detect(params, x),
               "eager refiner": lambda: eager(params, x, det, 0.0, 0.5),
               "captured refiner": lambda: captured(params, x, det, 0.0,
                                                    0.5)}
        t = {k: [] for k in fns}
        for k in ("detector", "eager refiner", "captured refiner",
                  "captured refiner", "eager refiner", "detector"):
            t[k].append(cuda_ms(fns[k], 3 if k == "eager refiner" else 10))
        phase("refine-captured", f"B={b}, in turns (CUDA events): " + "; ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in t[k])} ms/call"
            for k in fns) + f" ({card})")
    return launches


# phase 21: the mesh's 'model' axis on one card: the (data, model) mesh at
# world 1 (n_model = 1) and NCCL subgroups inside a capture
def subgroup_capture_probe(dev):
    """Phase 21(b): the subgroups ``parallel/mesh.py::subgroups`` makes, at
    world 1 (a model group and a data group of one rank each), their first
    collectives inside a capture: the model axis's all-gather and
    reduce-scatter (``gather_cells`` forward and backward, through
    ``shard_cells``) on the model group and an all-reduce on the data
    group, captured together, replayed on new values. Returns (the replay's
    max |diff| from what one rank computes, the seconds it took)."""
    import types

    import torch.distributed as dist

    from spair_pytorch_tpu_torch.parallel.constraints import (gather_cells,
                                                              shard_cells)
    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh, subgroups
    t0 = time.perf_counter()
    world = make_mesh(dev)
    try:
        data_group, model_group = subgroups(1, dev)
        axis = types.SimpleNamespace(n_model=1, model_rank=0,
                                     model_group=model_group)
        x = torch.randn(4, 121, 56, device=dev, requires_grad=True)
        cot = torch.randn(4, 121, 56, device=dev)
        total = torch.zeros((), device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            y = gather_cells(shard_cells(x, axis) * 2.0, axis, 121)
            grad, = torch.autograd.grad(y, x, cot)
            total.copy_(y.detach().sum())
            dist.all_reduce(total, group=data_group)
        with torch.no_grad():
            x.copy_(torch.randn_like(x))
        cot.copy_(torch.randn_like(cot))
        graph.replay()
        torch.cuda.synchronize()
        y, x = y.detach(), x.detach()
        diff = max(float((y - 2.0 * x).abs().max()),
                   float((grad - 2.0 * cot).abs().max()),
                   float((total - (2.0 * x).sum()).abs()) / float(
                       (2.0 * x).abs().sum()))
        del graph
        for group in (data_group, model_group):
            dist.destroy_process_group(group)
    finally:
        world.close()
    return diff, time.perf_counter() - t0


def model_axis_phase(card, dev):
    """Phase 21(a): ``make_mesh(n_model=1)`` at world 1 over NCCL (the
    'model' axis's mesh, one rank to a model group) against phase 20's
    result: its captured step equal to the captured plain step bit for bit
    (main path b128, 'auto', deterministic kernels), and its captured eval
    step over the mesh (the loss terms reduced and the outputs gathered
    over the data group, inside the graph) equal to the captured eval step
    without one. (b) ``subgroup_capture_probe``. Returns the K1-K4 launches
    of the captured mesh call, counted over its replays."""
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models import init_params
    from spair_pytorch_tpu_torch.parallel import make_eval_step
    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from spair_pytorch_tpu_torch.train import data_config

    t_phase = time.perf_counter()
    cfg = main_path_config()
    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    dcfg = data_config(cfg)
    world = make_mesh(dev, n_model=1)
    try:
        coords = (world.n_data, world.n_model, world.data_rank,
                  world.model_rank)
        with Deterministic():
            got = run_steps(cfg, (dcfg, bank), False, dev, world)
            want = run_steps(cfg, (dcfg, bank), False, dev)
        equal, total, diff, gen = same_run(got, want)
        phase("model-axis", f"make_mesh(n_model=1) at world 1 (n_data, "
                            f"n_model, data rank, model rank {coords}): "
                            f"captured mesh step b{TRAIN_B} 'auto' against "
                            f"the captured plain step, 5 calls of 1 step and"
                            f" 1 of {CAPTURED_K} (deterministic kernels): "
                            f"{equal} of {total} tensors equal bit for bit, "
                            f"max |diff| {diff:.3e}; generators equal: "
                            f"{gen}; launches K1-K4 {got[2]} (plain "
                            f"{want[2]})")
        if equal != total or not gen or got[2] != want[2]:
            raise AssertionError("the n_model=1 mesh step differs from the "
                                 "plain step")
        launches = got[2]
        del got, want

        params = init_params(cfg, device=dev)
        x = generate_batch(torch.Generator(device=dev).manual_seed(5), bank,
                           B, dcfg)[0]
        outs = {}
        with Deterministic():
            for name, mesh in (("mesh", world), ("plain", None)):
                gen = torch.Generator(device=dev).manual_seed(6)
                step = make_eval_step(cfg, mesh)
                xs = x if mesh is None else shard_batch(mesh, (x,))[0]
                outs[name] = [step(params, xs, 1500, gen) for _ in range(3)]
            torch.cuda.synchronize()
        pairs = [(a, b) for (la, aa), (lb, ab) in zip(outs["mesh"],
                                                      outs["plain"])
                 for a, b in [(la, lb)] + [
                     (aa[k], ab[k]) for k in sorted(ab) if k != "losses"]
                 + [(aa["losses"][k], ab["losses"][k])
                    for k in sorted(ab["losses"])]]
        equal = sum(torch.equal(a, b) for a, b in pairs)
        phase("model-axis", f"captured eval step over the mesh (world 1) "
                            f"against the captured eval step, B={B}, 3 "
                            f"calls (the first eager, then replays): "
                            f"{equal} of {len(pairs)} tensors equal bit for "
                            f"bit")
        if equal != len(pairs):
            raise AssertionError("the eval step over the mesh differs")
    finally:
        world.close()
    diff, probe_s = subgroup_capture_probe(dev)
    phase("model-axis", f"fresh NCCL subgroups (model and data, one rank "
                        f"each, made by parallel/mesh.py::subgroups): their "
                        f"first collectives captured (gather_cells' "
                        f"all-gather and its backward's reduce-scatter on "
                        f"the model group, an all-reduce on the data group)"
                        f" and replayed on new values: max rel diff "
                        f"{diff:.3e} from one rank's result ({probe_s:.2f} "
                        f"s); the (data, model) meshes of 2 and 4 ranks run "
                        f"on four cards (tools/dp_check.py --n-model)")
    if diff > 1e-6:
        raise AssertionError(f"subgroup capture gave diff {diff}")
    phase("model-axis", f"phase 21 in {time.perf_counter() - t_phase:.1f} s"
                        f" ({card})")
    return launches


# phase 22: the windowed matmul paste of the JAX package's
# benchmarks/kernel_anatomy.py (K5), its five variants on bf16 wgmma products
# Each variant's kernel against its plain version with t's f32 sums rounded
# toward zero, as the tensor cores round them (t_sum='toward_zero'); the
# hoisted kernel against the base kernel. The kernel rounds the weights and
# t to bf16 where the plain version does, and a hat row has at most two
# nonzeros, so each sum is exact before its one rounding: the card read at
# most 1.3e-7. The control, the plain base with t kept in f32, reads ~1e-3.
ANATOMY_BAR = 1e-6
# against the plain version that rounds t's sums to nearest, as the JAX
# package's product does: where the two roundings straddle a bf16 rounding
# boundary, t's bf16 rounding flips (the card read at most 2.6e-4, 4 pixels
# in 524288); one flip moves a pixel by at most a bf16 ulp's share of it
ANATOMY_NEAREST_BAR = 5e-3
ANATOMY_SEEDS = range(8)  # the inputs' seeds held at B=32
ANATOMY_K = 30      # launches in a captured graph (the JAX script's --k)
ANATOMY_BATCHES = (32, 128)


def anatomy_phase(K, card, dev):
    """Phase 22: (a) each variant's kernel against its plain version at
    paper shapes (B=32, N=121, 28x28, 128x128, win 64; the entry point's
    inputs from each of ANATOMY_SEEDS; t's sums rounded toward zero, as
    the tensor cores round them, and to nearest), the hoisted kernel
    against the base kernel, and the control that must fail the first bar
    (the plain base with t kept in f32); base (bf16) and K1 with bf16 glimpses
    against the f32 composite_plain truth; (b) the
    entry point, python -m spair_pytorch_tpu_torch.benchmarks.
    kernel_anatomy, at B=32 and B=128 (its five lines and JSON line), with
    the kernel's launches counted from 0 over its graphs' replays; the
    shares and each variant's bound; the plain base timed at both batches
    (the kernels line takes B=128's).
    Returns K5's row of the kernels line."""
    from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
    t_phase = time.perf_counter()
    cases = [(v, "toward_zero", ANATOMY_BAR) for v in A.VARIANTS] + [
        ("hoisted_vs_base", None, ANATOMY_BAR)] + [
        (v, "nearest", ANATOMY_NEAREST_BAR) for v in A.VARIANTS]
    worst = {(v, t): [0.0, 0.0, 0] for v, t, _ in cases}
    control, errs = math.inf, []

    def hold(key, got, want):
        """The worst rel err of each output and the pixels off by more than
        1e-5 of their output's scale, over the seeds."""
        rels, err = rel_err(got, want)
        off = sum(int(((x - y).abs() > 1e-5 * y.abs().max()).sum())
                  for x, y in zip(got, want))
        w = worst[key]
        worst[key] = [max(w[0], rels[0]), max(w[1], rels[1]), max(w[2], off)]
        return err

    with torch.no_grad():
        for seed in ANATOMY_SEEDS:
            color, alpha, imp, boxes, hw, win = A.paper_inputs(B, seed, dev)
            g = A.pack(color, alpha, imp).to(torch.bfloat16).contiguous()
            weights = A.hoisted_weights(boxes, hw, (OH, OW), win)
            outs = {}
            for v in A.VARIANTS:
                w = weights if v == "hoisted" else (None, None)
                outs[v] = A.kernel_anatomy(v, g, boxes, hw, win, *w)
                for t_sum in ("toward_zero", "nearest"):
                    err = hold((v, t_sum), outs[v], A.kernel_anatomy_plain(
                        v, g, boxes, hw, win, *w, t_sum=t_sum))
                    if t_sum == "toward_zero":
                        errs.append(err)
            hold(("hoisted_vs_base", None), outs["hoisted"], outs["base"])
            # the control: a base that kept t in f32 must fail the bar
            rels, _ = rel_err(outs["base"], A.kernel_anatomy_plain(
                "base", g, boxes, hw, win, t_sum="toward_zero",
                round_t=False))
            control = min(control, max(rels))
    for v, t_sum, bar in cases:
        rel_num, rel_den, off = worst[(v, t_sum)]
        what = ("hoisted kernel against base kernel" if t_sum is None else
                f"{v}: kernel against plain, t's sums rounded "
                f"{t_sum.replace('_', ' ')}")
        phase("anatomy", f"{what}, B={B}, seeds {ANATOMY_SEEDS.start}-"
                         f"{ANATOMY_SEEDS.stop - 1}: worst rel err num "
                         f"{rel_num:.3e}, den {rel_den:.3e} (bar {bar:g}); "
                         f"at most {off} pixels off by more than 1e-5 of "
                         f"scale")
        if not max(rel_num, rel_den) < bar:
            raise AssertionError(f"anatomy case {what} disagrees: "
                                 f"{rel_num}, {rel_den}")
    phase("anatomy", f"control, base kernel against the plain base with t "
                     f"kept in f32: least rel err over the seeds "
                     f"{control:.3e}, must be at or above the bar "
                     f"{ANATOMY_BAR:g}")
    if not control >= ANATOMY_BAR:
        raise AssertionError(f"the anatomy bar {ANATOMY_BAR:g} does not tell "
                             f"t kept in f32 apart: {control}")
    with torch.no_grad():
        for b in ANATOMY_BATCHES:
            color, alpha, imp, boxes, hw, win = A.paper_inputs(b, 7, dev)
            g = A.pack(color, alpha, imp).to(torch.bfloat16).contiguous()
            weights = A.hoisted_weights(boxes, hw, (OH, OW), win)
            for v in A.VARIANTS:
                w = weights if v == "hoisted" else (None, None)
                *_, listed = A.kernel_anatomy_listed(v, g, boxes, hw, win, *w)
                if not torch.equal(listed, A.strips_touched(v, boxes, hw,
                                                            (OH, OW))):
                    raise AssertionError(f"K5's {v} lists at B={b} are not "
                                         f"strips_touched's")
                per = listed.sum(1).float()  # (B, strips)
                phase("anatomy", f"{v} B={b}: objects listed a 32-column "
                                 f"strip (of {N}): mean {per.mean():.2f}, "
                                 f"max {int(per.max())}, by strip " + ", ".join(
                                     f"{x:.2f}" for x in per.mean(0).tolist())
                      + "; equal to strips_touched")
    lib = K.load_library("kernel_anatomy")
    phase("anatomy", "shared memory a block at paper shapes: " + ", ".join(
        f"{v} {lib.spair_kernel_anatomy_smem(C, OH, OW, HW[0], WIN, i)} B"
        for i, v in enumerate(A.VARIANTS)))
    hgmma = sass_count(K.library_path("kernel_anatomy"), "HGMMA")
    phase("anatomy", "HGMMA instructions in the built kernel_anatomy library: "
          + ("cuobjdump not found" if hgmma is None else str(hgmma)))
    if hgmma == 0:
        raise AssertionError("the kernel_anatomy library holds no HGMMA")
    with torch.no_grad():
        color, alpha, imp, boxes, hw, win = A.paper_inputs(B, 7, dev)
        g = A.pack(color, alpha, imp).to(torch.bfloat16).contiguous()
        truth = K.composite_plain(color, alpha, imp, boxes, hw)
        check("anatomy", f"base B={B} (bf16 operands) against the f32 "
                         f"composite", BF16_BAR,
              A.kernel_anatomy("base", g, boxes, hw, win), truth)
        bf = [t.to(torch.bfloat16) for t in (color, alpha, imp)]
        check("anatomy", f"K1 B={B}, bf16 glimpses, against the f32 "
                         f"composite", BF16_BAR,
              K.composite_forward(*bf, boxes, hw, win), truth)

    lines = {}
    A.kernel_anatomy.launches = 0
    for b in ANATOMY_BATCHES:
        lines[b] = A.main(["--batch", str(b), "--k", str(ANATOMY_K)])
    launches = A.kernel_anatomy.launches
    want = len(ANATOMY_BATCHES) * len(A.VARIANTS) * (1 + 4 * ANATOMY_K)
    phase("anatomy", f"the entry point at B={ANATOMY_BATCHES}: {launches} "
                     f"kernel launches counted over the graphs' replays "
                     f"(each variant one eager call and 4 replays of "
                     f"{ANATOMY_K}: {want})")
    if launches != want:
        raise AssertionError(f"K5 launched {launches} times, not {want}")
    for b, line in lines.items():
        ms, bounds = line["ms"], line["bound_ms"]
        if not all(math.isfinite(x) and x > 0 for x in ms.values()):
            raise AssertionError(f"anatomy times at B={b}: {ms}")
        for v in A.VARIANTS:
            phase("anatomy", f"{v} B={b}: {ms[v]:.4f} ms, bound "
                             f"{bounds[v]:.4f} ms ({line['bound_by'][v]}), "
                             f"{bounds[v] / ms[v]:.1%} of it ({card})")
        phase("anatomy", f"B={b} shares (ms): " + ", ".join(
            f"{k} {x:.4f}" for k, x in line["shares_ms"].items())
            + "; K1 (composite_forward) on the same glimpses: " + ", ".join(
                f"{k} {x:.4f}" for k, x in line["composite_forward_ms"]
                .items()) + f" ms ({card})")

    plain_ms = {}
    for b in ANATOMY_BATCHES:
        color, alpha, imp, boxes, hw, win = A.paper_inputs(b, 7, dev)
        g = A.pack(color, alpha, imp).to(torch.bfloat16).contiguous()
        with torch.no_grad():
            plain_ms[b] = cuda_ms(lambda: A.kernel_anatomy_plain(
                "base", g, boxes, hw, win), 3, warmup=1)
        phase("anatomy", f"plain base B={b}: {plain_ms[b]:.4f} ms against "
                         f"the kernel's {lines[b]['ms']['base']:.4f} "
                         f"({card})")
    b = ANATOMY_BATCHES[-1]
    line = lines[b]
    phase("anatomy", f"phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return {"name": "kernel_anatomy", "route": "cuda",
            "source": "spair_pytorch_tpu_torch/csrc/kernel_anatomy.cu",
            "replaces": "benchmarks/kernel_anatomy.py:43",
            "launches": launches, "max_abs_err": max(errs),
            "ms": line["ms"]["base"], "plain_ms": plain_ms[b],
            "bound_ms": line["bound_ms"]["base"],
            "bound_by": line["bound_by"]["base"], "library_ms": None,
            "path_launches": {}}


# phase 23: ordered mode's kernels (csrc/composite_ordered.cu) on the
# objects a quality b32 step hands its compositor
ORDERED_BAR, ORDERED_GRAD_BAR = 1e-5, 1e-4
ORDERED_REPS = 10    # launches a captured graph when timing one kernel
ORDERED_STEPS = 5    # captured quality steps a call in the step's timing


def quality_objects(dev, seed=2300):
    """(cfg, (color, alpha, depth, boxes, gate)) as ``render_objects``
    hands them to ordered mode's compositor: one quality b32 batch from the
    port's random weights at step 1000, past the training wheel."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.data import generate_batch, glyph_bank
    from spair_pytorch_tpu_torch.models.render import render_objects
    from spair_pytorch_tpu_torch.models.spair import (compute_dtype,
                                                      infer_latents)
    from spair_pytorch_tpu_torch.parallel import create_train_state
    from spair_pytorch_tpu_torch.train import data_config
    cfg = PRESETS["quality"]()
    state = create_train_state(cfg, seed=seed, device=dev)
    state.step.fill_(1000)
    bank = torch.as_tensor(glyph_bank((14, 14)), device=dev)
    x, _, _ = generate_batch(state.generator, bank, cfg.batch_size,
                             data_config(cfg))
    with torch.no_grad():
        z = infer_latents(state.model, cfg, x, state.step, state.generator)
        objects, _ = render_objects(state.model, cfg, z["z_attr"],
                                    z["z_where"], z["z_depth"], z["z_pres"],
                                    compute_dtype(cfg))
    return cfg, bank, tuple(objects[k] for k in ("color", "alpha", "depth",
                                                 "boxes", "gate"))


def ordered_bound(b, n, c, live, pairs, forward, glimpse=(OH, OW),
                  canvas_hw=HW):
    """(least ms, 'bytes' or 'operations', bytes moved) of ordered mode's
    forward, or of its backward's two kernels: the glimpses of the ``live``
    objects read once, boxes and gate read, the canvas (forward) or its
    cotangent and every object's glimpse gradient and box gradient
    (backward) written or read once, against the HBM rate; and an estimate
    of the arithmetic per (object, support pixel) pair, (C + 1) pasted
    values of 7 operations and ~4 C + 4 for the over operator (three times
    that in the backward: its two walks and the transposed taps) against
    the f32 peak."""
    plane = glimpse[0] * glimpse[1]
    glimpses = live * (c + 1) * plane * 4
    small = b * n * (4 + 1) * 4
    canvas = b * c * canvas_hw[0] * canvas_hw[1] * 4
    ops = pairs * (7 * (c + 1) + 4 * c + 4)
    if forward:
        moved = glimpses + small + canvas
    else:
        moved = glimpses + small + canvas + b * n * ((c + 1) * plane + 4) * 4
        ops *= 3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", moved
    return t_ops, "operations", moved


def ordered_phase(card, dev):
    """Phase 23: ordered mode's forward kernel and its backward's two
    kernels at quality's b32 shapes, on the objects of a quality step past
    the training wheel: held against their plain versions; timed alone,
    CUDA events over a captured graph of ORDERED_REPS launches, beside
    their bound; the whole composite forward and backward (sort, gather,
    kernels) against the plain scan under autograd, each captured, in
    turns; then quality's captured train step with the kernels
    (render_backend 'auto') and with the plain scan ('xla'), in turns: ms a
    step, peak memory and the kernels' launches over the replays. Returns
    the summary row of the ordered kernels."""
    from spair_pytorch_tpu_torch.ops.kernels import composite as K
    from spair_pytorch_tpu_torch.ops.kernels import composite_ordered as O
    from spair_pytorch_tpu_torch.parallel import make_train_step
    from spair_pytorch_tpu_torch.parallel.train_step import \
        create_train_state
    from spair_pytorch_tpu_torch.train import data_config
    t_phase = time.perf_counter()
    cfg, bank, (color, alpha, depth, boxes, gate) = quality_objects(dev)
    hw, glimpse = tuple(cfg.image_shape[1:]), tuple(cfg.object_shape)
    b, n, c = color.shape[:3]
    order = torch.argsort(-depth[..., 0], dim=1, stable=True)

    def take(t):
        return torch.take_along_dim(
            t, order.reshape((b, n) + (1,) * (t.ndim - 2)), dim=1).contiguous()
    sc, sa, sb, sg = take(color), take(alpha), take(boxes), take(gate)
    dout = torch.randn((b, c) + hw, generator=torch.Generator(
        device=dev).manual_seed(23), device=dev)
    listed = K.cull_tiles(sb, hw, glimpse, O.TILE, sg).sum(-1).float()
    live = int(gate.sum())
    pairs = support_pairs(sb, gate=sg, glimpse=glimpse, canvas_hw=hw)
    phase("ordered", f"quality b{b}: {live} live objects of {b * n}, "
                     f"pasted alpha up to {float(sa.max()):.6f} (glimpse); "
                     f"a 32x8 tile lists {float(listed.mean()):.1f} objects "
                     f"on average, {int(listed.max())} at most; "
                     f"{pairs:.0f} (object, support pixel) pairs")

    with torch.no_grad():
        err_f = check("ordered", f"forward B={b} N={n}", ORDERED_BAR,
                      (O.ordered_forward(sc, sa, sb, hw, sg),),
                      (O.composite_ordered(color, alpha, depth, boxes, hw,
                                           cfg.render_chunk),),
                      names=("out",))
        err_b = check("ordered", f"backward B={b} N={n}", ORDERED_GRAD_BAR,
                      O.ordered_backward(sc, sa, sb, hw, dout, sg),
                      O.ordered_backward_plain(sc, sa, sb, hw, dout, sg),
                      names=("dcolor", "dalpha", "dbox"))

    def reps(fn):
        return lambda: [fn() for _ in range(ORDERED_REPS)]
    with torch.no_grad():
        kernels = {
            "forward": reps(lambda: O.ordered_forward(sc, sa, sb, hw, sg)),
            "backward": reps(lambda: O.ordered_backward(sc, sa, sb, hw, dout,
                                                        sg))}
        times = {k: [graph_ms(fn, reps=3) / ORDERED_REPS for _ in range(3)]
                 for k, fn in kernels.items()}
    bounds = {k: ordered_bound(b, n, c, live, pairs, k == "forward",
                               glimpse, hw) for k in kernels}
    for k, ts in times.items():
        t = min(ts)
        bms, by, moved = bounds[k]
        phase("ordered", f"{k} kernel{'s' if k == 'backward' else ''} "
                         f"B={b} N={n}: "
                         f"{', '.join(f'{x:.4f}' for x in ts)} ms (CUDA "
                         f"events over a graph of {ORDERED_REPS} launches, "
                         f"3 replays, three times); bound {bms:.4f} ms "
                         f"({by}, {moved / 1e6:.1f} MB), {bms / t:.1%} of "
                         f"it; achieved {moved / t / 1e6:.1f} GB/s ({card})")

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (color, alpha, boxes)]

    def plain_fb():
        out = O.composite_ordered(leaves[0], leaves[1], depth, leaves[2], hw,
                                  cfg.render_chunk)
        torch.autograd.grad(out, leaves, dout)

    def over_fb():
        out = O.composite_over(leaves[0], leaves[1], depth, leaves[2], hw,
                               pres_gate=gate, chunk=cfg.render_chunk)
        torch.autograd.grad(out, leaves, dout)
    fb = [graph_ms(f, reps=3) for f in (plain_fb, over_fb, over_fb,
                                        plain_fb)]
    phase("ordered", f"composite forward + backward B={b} N={n}, captured:"
                     f" plain scan {fb[0]:.3f}, {fb[3]:.3f} ms; kernels "
                     f"(sort, gather, kernels) {fb[1]:.4f}, {fb[2]:.4f} ms "
                     f"({(fb[0] + fb[3]) / (fb[1] + fb[2]):.1f}x) ({card})")
    del leaves
    torch.cuda.empty_cache()

    # the captured quality step, kernels ('auto') and plain scan ('xla')
    dcfg = data_config(cfg)
    step_ms, peaks, launches = {}, {}, {}
    for backend in ("xla", "auto", "auto", "xla"):
        run = dataclasses.replace(cfg, render_backend=backend)
        state = create_train_state(run, seed=2301, device=dev)
        state.step.fill_(1000)
        O.ordered_forward.launches = O.ordered_backward.launches = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(run, datagen=(dcfg, bank),
                               steps_per_call=ORDERED_STEPS)
        state, _ = step(state)
        state, _ = step(state)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            state, m = step(state)
        end.record()
        torch.cuda.synchronize()
        step_ms.setdefault(backend, []).append(
            start.elapsed_time(end) / (2 * ORDERED_STEPS))
        peaks[backend] = torch.cuda.max_memory_allocated(dev)
        launches[backend] = (O.ordered_forward.launches,
                             O.ordered_backward.launches)
        if not bool(torch.isfinite(m["losses/total"]).all()):
            raise AssertionError(f"quality {backend}: a loss is not finite")
        del step, state, m
    steps = 4 * ORDERED_STEPS   # the first call's eager step, replays
    phase("ordered", f"quality b{b} captured train step, past the wheel: "
                     f"kernels ('auto') "
                     f"{', '.join(f'{x:.3f}' for x in step_ms['auto'])} ms, "
                     f"plain scan ('xla') "
                     f"{', '.join(f'{x:.3f}' for x in step_ms['xla'])} ms a "
                     f"step; peak memory allocated {peaks['auto']} B against "
                     f"{peaks['xla']} B; ordered launches (forward, "
                     f"backward) over {steps} steps: 'auto' "
                     f"{launches['auto']}, 'xla' {launches['xla']} ({card})")
    if launches["auto"] != (steps, steps) or launches["xla"] != (0, 0):
        raise AssertionError(f"ordered launches {launches}")
    phase("ordered", f"phase 23 in {time.perf_counter() - t_phase:.1f} s")
    return {"name": "composite_ordered", "route": "cuda",
            "source": "spair_pytorch_tpu_torch/csrc/composite_ordered.cu",
            "replaces": "none: the JAX scan is plain jnp "
                        "(spair_pytorch_tpu/models/render.py:136)",
            "launches": launches["auto"][0],
            "max_abs_err": max(err_f, err_b),
            "ms": min(times["forward"]), "bwd_ms": min(times["backward"]),
            "plain_ms": (fb[0] + fb[3]) / 2,
            "bound_ms": bounds["forward"][0],
            "bwd_bound_ms": bounds["backward"][0],
            "bound_by": bounds["forward"][1], "library_ms": None}


# phase 24: cell_step's glue kernels (csrc/cell_glue.cu) at the two cells'
# front shapes: paper128 b128 bf16 (6 lanes) and quality b32 f32 (8 lanes)
GLUE_REPS = 20       # launches in a captured graph when timing one kernel
GLUE_CELLS = (("paper128", 128, 6, torch.bfloat16), ("quality", 32, 8, None))
GLUE_FWD_BAR, GLUE_GRAD_BAR = 0.0, 1e-6


def glue_front(cfg, b, k, compute, dev, seed=24):
    """One front's inputs of every glue segment in the layouts the scan
    hands over (head outputs sliced from packed products, features and noise
    per-front views), random, presence noise logistic."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    head = torch.float32 if compute is None else compute
    nf, nc = cfg.n_backbone_features, cfg.context_dim
    npass, na = cfg.n_passthrough_features, cfg.n_attributes

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    box_packed = rnd(b, k, 8 + npass, dtype=head, scale=2.0)
    z_packed = rnd(b, k, 1, 2 + npass, dtype=head, scale=2.0)
    u = torch.rand((b, k, 1), generator=gen, device=dev)
    return dict(feat=rnd(b, 31, k, nf)[:, 7], context=rnd(b, k, nc),
                hb=box_packed[..., :8], passthru=box_packed[..., 8:],
                noise_box=rnd(b, 31, k, 4)[:, 7],
                cell_hw=torch.randint(0, 11, (k, 2), generator=gen,
                                      device=dev),
                lat=rnd(b, k, 2 * na, dtype=head, scale=2.0),
                noise_attr=rnd(b, 31, k, na)[:, 7], fc=rnd(b, k, nf + nc),
                box=rnd(b, k, 1, 4), dl=z_packed[..., :2],
                pass2=z_packed[..., 2:], noise_depth=rnd(b, 31, k, 1)[:, 7],
                fc3=rnd(b, k, nf + nc), attr=rnd(b, k, 1, na),
                po=rnd(b, k, 1, 1, dtype=head, scale=4.0),
                noise_pres=torch.log(u + 1e-9) - torch.log(1 - u + 1e-9),
                depth=rnd(b, k, 1), tw=torch.zeros((), device=dev))


def glue_segments(cfg, x, compute):
    """{segment: (forward, plain forward, backward(cots), plain
    backward(cots), the tensors each forward reads)} at one front."""
    from spair_pytorch_tpu_torch.models.latents import geometry
    from spair_pytorch_tpu_torch.ops.kernels import cell_glue as G
    g = G.geometry_of(cfg, geometry(cfg))
    nf, w1 = cfg.n_backbone_features, cfg.n_backbone_features + \
        cfg.context_dim
    npass, na = cfg.n_passthrough_features, cfg.n_attributes
    shape = tuple(x["feat"].shape[:2]) + (w1,)
    tw = x["tw"]

    def flat(out):
        return (*out[0], *out[1], *out[2:])
    box_args = (x["hb"], x["noise_box"], tw, x["cell_hw"], g, 1)
    attr_args = (x["lat"], x["noise_attr"], x["fc"], x["passthru"], x["box"])
    depth_args = (x["dl"], x["pass2"], x["noise_depth"], tw, x["fc3"],
                  x["box"], x["attr"])
    pres_args = (x["po"], x["noise_pres"], tw, x["box"], x["attr"],
                 x["depth"], False)
    return {
        "box_in": (lambda: G.box_in_forward(x["feat"], x["context"], compute),
                   lambda: G.box_in_plain(x["feat"], x["context"], compute),
                   lambda c: G.box_in_backward(c[0], c[1], nf, shape),
                   lambda c: G.box_in_backward_plain(c[0], c[1], nf),
                   (x["feat"], x["context"])),
        "box": (lambda: flat(G.box_forward(*box_args, compute)),
                lambda: flat(G.box_plain(*box_args, compute)),
                lambda c: (G.box_backward(*box_args, c[:4], c[4:8], *c[8:]),),
                lambda c: (G.box_backward_plain(*box_args, c[:4], c[4:8],
                                                *c[8:]),),
                (x["hb"], x["noise_box"])),
        "attr_z": (lambda: G.attr_z_forward(*attr_args, compute),
                   lambda: G.attr_z_plain(*attr_args, compute),
                   lambda c: G.attr_z_backward(
                       x["lat"], x["noise_attr"], *c, w1, npass,
                       x["passthru"].dtype),
                   lambda c: G.attr_z_backward_plain(
                       x["lat"], x["noise_attr"], *c, w1, npass,
                       x["passthru"].dtype), attr_args),
        "depth_obj": (lambda: G.depth_obj_forward(*depth_args, compute),
                      lambda: G.depth_obj_plain(*depth_args, compute),
                      lambda c: G.depth_obj_backward(
                          x["dl"], x["pass2"].dtype, x["noise_depth"], tw,
                          *c, w1, npass, na),
                      lambda c: G.depth_obj_backward_plain(
                          x["dl"], x["pass2"].dtype, x["noise_depth"], tw,
                          *c, w1, npass, na),
                      [t for t in depth_args if torch.is_tensor(t)]),
        "pres": (lambda: G.pres_forward(*pres_args),
                 lambda: G.pres_plain(*pres_args),
                 lambda c: G.pres_backward(x["po"], x["noise_pres"], tw, *c,
                                           False, na),
                 lambda c: G.pres_backward_plain(x["po"], x["noise_pres"], tw,
                                                 *c, False, na),
                 [t for t in pres_args if torch.is_tensor(t)]),
    }


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def glue_bytes(seg, reads, outs, cots, grads, oh_ow):
    """(forward, backward) bytes each input read once and each output
    written once. The box backward reads 3 taps of each hat-weight row of
    its cotangents, not the rows: it is counted so."""
    fwd = nbytes(reads) + nbytes(outs)
    cot = list(cots)
    taps = 0
    if seg == "box":
        rows = cots[10].shape[0] * cots[10].shape[1]   # objects
        taps = rows * sum(oh_ow) * 3 * cots[10].element_size()
        cot = cot[:10]
    bwd = nbytes(reads) + nbytes(cot) + taps + nbytes(grads)
    return fwd, bwd


def glue_phase(card, dev):
    """Phase 24: cell_step's ten glue kernels at both cells' front shapes
    (paper128 b128 bf16, 6 lanes; quality b32 f32, 8 lanes): each held
    against its plain version (forwards bit for bit, backwards within
    GLUE_GRAD_BAR in float32 and a bf16 step in bf16), each timed alone
    (CUDA events over a captured graph of GLUE_REPS launches, 3 replays,
    best of three) beside its plain version captured the same way and a
    bound of its bytes at the HBM rate (chip_smoke.py::bound's rule: each
    input read once, each output written once); then the five forwards
    and the five backwards of a front together, kernels against plain.
    Returns a row per kernel."""
    from spair_pytorch_tpu_torch.config import PRESETS
    from spair_pytorch_tpu_torch.ops.kernels import cell_glue as G
    t_phase = time.perf_counter()
    rows = []
    for name, b, k, compute in GLUE_CELLS:
        cfg = PRESETS[name]()
        x = glue_front(cfg, b, k, compute, dev)
        segs = glue_segments(cfg, x, compute)
        gen = torch.Generator(device=dev).manual_seed(240)
        cots_of, front = {}, {"kernels": [], "plain": []}
        for seg, (fwd, fwd_p, bwd, bwd_p, reads) in segs.items():
            with torch.no_grad():
                out, want = fwd(), fwd_p()
                same = all(torch.equal(o, w) for o, w in zip(out, want))
                cots = [torch.randn(o.shape, generator=gen,
                                    device=dev).to(o.dtype) for o in out]
                cots_of[seg] = cots
                got, ref = bwd(cots), bwd_p(cots)
            errs = []
            for gt, rf in zip(got, ref):
                scale = float(rf.float().abs().max())
                errs.append(float((gt.float() - rf.float()).abs().max())
                            / max(scale, 1e-30))
            f32 = [e for e, gt in zip(errs, got) if gt.dtype == torch.float32]
            bf = [e for e, gt in zip(errs, got) if gt.dtype != torch.float32]
            if not same or (f32 and max(f32) > GLUE_GRAD_BAR) \
                    or (bf and max(bf) > 2.0 ** -7):
                raise AssertionError(f"{name} {seg}: forward equal {same}, "
                                     f"backward errors {errs}")
            fb, bb = glue_bytes(seg, reads, out, cots, got, cfg.object_shape)

            def reps(fn, *a):
                return lambda: [fn(*a) for _ in range(GLUE_REPS)]
            with torch.no_grad():
                t = {key: min(graph_ms(fn, reps=3) / GLUE_REPS
                              for _ in range(3))
                     for key, fn in (("fwd", reps(fwd)), ("fwd_plain",
                                                          reps(fwd_p)),
                                     ("bwd", reps(bwd, cots)),
                                     ("bwd_plain", reps(bwd_p, cots)))}
            for d, moved in (("fwd", fb), ("bwd", bb)):
                bound = moved / HBM_BYTES_PER_S * 1e3
                phase("glue", f"{name} b{b} {seg} {d}: kernel "
                              f"{t[d] * 1e3:.2f} us, plain "
                              f"{t[d + '_plain'] * 1e3:.2f} us "
                              f"({t[d + '_plain'] / t[d]:.1f}x); bound "
                              f"{bound * 1e3:.2f} us (bytes, "
                              f"{moved / 1e6:.3f} MB), {bound / t[d]:.1%} "
                              f"of it ({card})")
                rows.append({"name": f"glue_{seg}_{d}", "cell": name,
                             "ms": t[d], "plain_ms": t[d + "_plain"],
                             "bound_ms": bound, "bound_by": "bytes",
                             "max_abs_err": max(errs) if d == "bwd" else 0.0})
            front["kernels"].append((fwd, bwd, cots))
            front["plain"].append((fwd_p, bwd_p, cots))

        def whole(parts):
            def run():
                for fwd, _, _ in parts:
                    fwd()
                for _, bwd, cots in reversed(parts):
                    bwd(cots)
            return run
        with torch.no_grad():
            fr = [min(graph_ms(whole(front[key]), reps=10) for _ in range(3))
                  for key in ("plain", "kernels", "kernels", "plain")]
        phase("glue", f"{name} b{b} a front's glue, five forwards and five "
                      f"backwards, captured: kernels {fr[1] * 1e3:.1f}, "
                      f"{fr[2] * 1e3:.1f} us; plain {fr[0] * 1e3:.1f}, "
                      f"{fr[3] * 1e3:.1f} us ({card})")
    phase("glue", f"phase 24 in {time.perf_counter() - t_phase:.1f} s")
    return rows


def failed_capture_phase(dev):
    """Phases 20(c), 17(j) and 18(d), last in the run since each leaves a
    failed capture behind: a host read injected into the captured mesh
    step, the captured train step and the captured detector makes each
    capture raise, and nothing runs eagerly in its place."""
    import importlib

    from spair_pytorch_tpu_torch.data import glyph_bank
    from spair_pytorch_tpu_torch.models import infer, init_params
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    from spair_pytorch_tpu_torch.parallel.mesh import make_mesh, replicate
    from spair_pytorch_tpu_torch.train import data_config

    ts = importlib.import_module("spair_pytorch_tpu_torch.parallel."
                                 "train_step")
    cfg = main_path_config()
    datagen = (data_config(cfg), torch.as_tensor(glyph_bank((14, 14)),
                                                 device=dev))
    # 20(c) a host read in the mesh step's scenes, before its collectives:
    # both calls raise, and only the warm-up step ran
    real_scenes = ts.generate_host_local

    def read(*a):
        x, gt_bbox, gt_count = real_scenes(*a)
        return x * (x.sum().item() > -1), gt_bbox, gt_count
    ts.generate_host_local = read
    world = make_mesh(dev)
    try:
        state = replicate(world, create_train_state(cfg, device=dev))
        step = make_train_step(cfg, world, datagen=datagen,
                               steps_per_call=3)
        errors = []
        for _ in range(2):
            try:
                step(state)
            except RuntimeError as e:
                errors.append(type(e).__name__ + ": "
                              + str(e).strip().splitlines()[0][:80])
        torch.cuda.synchronize()
    finally:
        ts.generate_host_local = real_scenes
        world.close()
    phase("mesh-captured", f"a .item() injected into the mesh step: both "
                           f"calls raise ({errors}); steps run: "
                           f"{int(state.step)} (the warm-up)")
    if len(errors) != 2 or int(state.step) != 1:
        raise AssertionError("a failed mesh capture ran the step eagerly")
    del state, step
    # 17(j) a host read in the step: the capture raises, nothing runs eagerly
    # in its place
    real_norm = ts.global_norm
    ts.global_norm = lambda g: real_norm(g) * (real_norm(g).item() > 0)
    try:
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, datagen=datagen, steps_per_call=3)
        errors = []
        for _ in range(2):
            try:
                step(state)
            except RuntimeError as e:
                errors.append(type(e).__name__ + ": "
                              + str(e).strip().splitlines()[0][:80])
        torch.cuda.synchronize()
    finally:
        ts.global_norm = real_norm
    phase("captured", f"a .item() injected into the step: both calls raise "
                      f"({errors}); steps run: {int(state.step)} (the "
                      f"warm-up)")
    if len(errors) != 2 or int(state.step) != 1:
        raise AssertionError("a failed capture ran the step eagerly")
    # 18(d) the same in the detector's NMS: the warm-up runs, the capture
    # raises, a second call raises without running
    real_iou = infer.pairwise_iou
    infer.pairwise_iou = lambda b: real_iou(b) * (real_iou(b).sum().item()
                                                  > -1)
    try:
        c = dataclasses.replace(cfg, compute_dtype="float32")
        params = init_params(c, device=dev)
        # from a generator of its own: the failed capture of the step left
        # the ones registered with it (the default generator among them)
        # mid-capture
        x = torch.rand((8, 1) + tuple(c.image_shape[1:]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
        detect = infer.make_detector(c, nms_iou=0.5)
        errors = []
        for _ in range(2):
            try:
                detect(params, x)
            except RuntimeError as e:
                errors.append(type(e).__name__ + ": "
                              + str(e).strip().splitlines()[0][:80])
        torch.cuda.synchronize()
    finally:
        infer.pairwise_iou = real_iou
    phase("forward", f"a .item() injected into the detector's NMS: both "
                     f"calls raise ({errors})")
    if len(errors) != 2 or "capture failed" not in errors[1]:
        raise AssertionError("a failed detector capture ran eagerly")


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

    profile_eval(cfg, params, x, step, eval_auto, gen, card)

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

    # 17. the train step captured as a CUDA graph
    captured_k = captured_phase(card, dev)

    # 18. the forward programs captured as CUDA graphs
    forward_k = forward_phase(card, dev)

    # 19. render_topk captured as segments around the render's branch
    topk_k, _ = topk_phase(K, card, dev)

    # 20. the data-parallel step and the split refiner captured
    t_phase = time.perf_counter()
    mesh_k = mesh_capture_phase(card, dev)
    refine_graph_k = refine_capture_phase(K, card, dev)
    phase("refine-captured", f"phase 20 in "
                             f"{time.perf_counter() - t_phase:.1f} s")

    # 21. the mesh's 'model' axis at world 1 and NCCL subgroups captured
    model_axis_k = model_axis_phase(card, dev)

    # 22. the windowed matmul paste (K5) through its entry point
    anatomy_row = anatomy_phase(K, card, dev)

    # 23. ordered mode's kernels at quality's shapes and in its step
    ordered_row = ordered_phase(card, dev)

    # 24. cell_step's glue kernels at both cells' front shapes
    glue_rows = glue_phase(card, dev)
    failed_capture_phase(dev)
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
    for name, counts in {**bench_k,
                         **{f"captured_k{CAPTURED_K}_{b}": n
                            for b, n in captured_k.items()},
                         **forward_k, **topk_k, **mesh_k,
                         **refine_graph_k,
                         "model_axis_mesh_n_model_1": model_axis_k}.items():
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
        for (name, source, k, where, n, err), path in zip(rows, paths)]
        + [anatomy_row, ordered_row] + glue_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
