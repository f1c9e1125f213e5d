#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (spair_pytorch_tpu_torch).

Drives the port's forward path once at paper128 width on one CUDA card, with
random weights from the preset's seed:

  1. device     the card's name and power limit (nvidia-smi);
  2. build      compiles csrc/composite_fwd.cu with nvcc;
  3. kernel     the composite kernel against its plain PyTorch version at
                paper128 shapes (B=32, N=121, C=1, 28x28 glimpses, 128x128
                canvas): f32 ungated, f32 gated, all gated, bf16 glimpses,
                den_floor_n; error = max |kernel - plain| / max |plain|;
  4. eval step  make_eval_step on a generated batch of 32, through the
                kernel ('auto') and through the plain compositor ('xla');
                ungated and with pres_gate_threshold=0.01;
  5. serving    DetectorServer with buckets (1, 8, 32) answers 64 requests;
  6. times      CUDA-event times after warmup: kernel vs plain compositor at
                B=32 and B=128, the eval step and the detector at B=32;
                each layer of the eval step alone; the device-busy share
                of one eval step under torch.profiler.

Every phase raises on failure. TF32 is off for the whole run (matmuls and
cuDNN convs in full f32), so the two compositors are compared on the same
arithmetic. The last two lines are a JSON summary of the kernels and the
result line {"ok": true, "device": {...}}.

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
B, N, C, OH, OW, HW, WIN = 32, 121, 1, 28, 28, (128, 128), 64


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


def random_glimpses(b, n, gen, dev):
    """Inputs drawn as the JAX package's bench check draws them: uniform
    glimpses, importance >= 0.01, centres in [0.05, 0.95], scales in
    [0.05, anchor/H]."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    color = u(b, n, C, OH, OW)
    alpha = u(b, n, 1, OH, OW)
    imp = u(b, n, 1, OH, OW, lo=0.01)
    boxes = torch.cat([u(b, n, 2, lo=0.05, hi=0.95),
                       u(b, n, 2, lo=0.05, hi=48 / HW[0])], dim=-1)
    return color, alpha, imp, boxes.contiguous()


def rel_err(got, want):
    """(max |got - want| / max |want|, max |got - want|) over num and den."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return abs_err / scale, abs_err


def kernel_phase(K, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    color, alpha, imp, boxes = random_glimpses(B, N, gen, dev)
    gate = (torch.rand((B, N), generator=gen, device=dev) > 0.7).float()
    cases = {}

    def case(name, bar, got, want):
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, want)
        cases[name] = abs_err
        phase("kernel", f"{name}: rel err {rel:.3e} (bar {bar:g}), "
                        f"max abs err {abs_err:.3e}")
        if not rel < bar:
            raise AssertionError(f"kernel case {name} disagrees: {rel}")

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


def profile_eval(cfg, params, x, step, eval_step, card):
    """Per-layer times of one eval step (CUDA events, each layer run alone
    and synchronized) and the device-busy share from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eval_step(params, x, step, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # device rows (kernels, memcpy, memset) carry device time and no aten::
    # name; the aten:: rows repeat their kernels' time
    events = prof.key_averages()
    device_rows = [e for e in events if not e.key.startswith("aten::")
                   and getattr(e, "self_device_time_total", 0.0) > 0]
    busy = sum(e.self_device_time_total for e in device_rows) / 1e3
    n_kernels = sum(e.count for e in device_rows)
    phase("layer", f"eval step under the profiler: {wall:.3f} ms wall, "
                   f"device busy {busy:.3f} ms ({busy / wall:.1%}), "
                   f"{n_kernels} device kernels ({card})")
    print(events.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)


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
    lib_path = K.build_library()
    K.load_library()
    phase("build", f"{lib_path.name} in {time.perf_counter() - t0:.2f} s")

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

    launches = None
    for thr in (0.0, 0.01):
        c_auto = dataclasses.replace(cfg, render_backend="auto",
                                     pres_gate_threshold=thr)
        c_xla = dataclasses.replace(c_auto, render_backend="xla")
        K.composite_forward.launches = 0
        loss, aux = run(c_auto)
        n_launch = K.composite_forward.launches
        if launches is None:
            launches = n_launch
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
            inputs = random_glimpses(
                b, N, torch.Generator(device=dev).manual_seed(b), dev)

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

    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "spair_pytorch_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "spair_pytorch_tpu/ops/pallas/composite.py:79",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": times[32][0], "plain_ms": times[32][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
