#!/usr/bin/env python3
"""Data-parallel training across ranks, and the mesh's 'model' axis,
against one process, and its steady-state time.

Run once under ``torchrun``: every rank trains the ROADMAP main path
(``--preset`` paper128, wavefront, gate 0.01, global batch ``--batch``)
through ``make_train_step(cfg, mesh, datagen=...)`` for ``--steps`` steps,
one step a call, from a state ``replicate`` gave every rank.
``--n-model M`` lays the world out as a (data, model) mesh of M ranks to a
model group (``make_mesh(n_model=M)``): each model group trains on one
data slice with the inference's cells split over its ranks; ``--mode
independent`` runs independent inference instead of the wavefront. On the
card the step is captured as a CUDA graph with NCCL's collectives inside it
(``parallel/captured.py``); ``--eager`` runs the eager mesh step instead.
Rank 0 writes its final parameters and the logged losses (each step's
reduced over the ranks, as the mesh logs it) to ``--out``. Every rank
then checks that Adam stays ``capturable`` with its step counts on its
device after ``replicate`` of a trained state, as a resume gives it.

Then run it with ``--compare`` and one or more such files: one process
trains the same steps without a mesh (captured on the card) and holds each
file against itself: each step's loss, as max |mesh - one| / max |one
process's loss|, and each parameter tensor, as max |mesh - one| / max
|one|. It exits with 1 when a loss differs by more than ``LOSS_BAR`` or a
parameter tensor by more than ``PARAM_BAR``. Given two files (the captured
and the eager mesh run), it also says whether they agree bit for bit.

``--time K`` measures the steady state instead: every rank runs calls of
K steps (``steps_per_call=K``) and, after the first call, CUDA events time
``--calls`` more on each rank (3; 1 keeps the eager step's run short). The
mesh step is timed in turns with another step (mesh, other, other, mesh):
with M = 1 the plain step at the rank's own batch, each rank's plain step
on its own card with no collective; with M > 1 the data-only mesh of the
same world at the same global batch. One flat all-reduce of the
gradients' size is timed alone; rank 0 prints one JSON line with each
rank's ms/step of each, and the img/s of the global batch at the slowest
rank's mean mesh ms/step, beside the card's name and power limit.

TF32 is off. ``--dtype float32`` (the default) makes the comparison tight;
``--dtype bfloat16`` is the main path's compute type.

    torchrun --nproc-per-node 4 tools/dp_check.py --out runs/dp4.pt
    torchrun --nproc-per-node 4 tools/dp_check.py --eager --out runs/e4.pt
    python tools/dp_check.py --compare runs/dp4.pt runs/e4.pt
    torchrun --nproc-per-node 4 tools/dp_check.py --time 10 \\
        --dtype bfloat16 --batch 512
    torchrun --nproc-per-node 4 tools/dp_check.py --n-model 2 --out m22.pt
    python tools/dp_check.py --compare m22.pt
    torchrun --nproc-per-node 4 tools/dp_check.py --n-model 2 --time 10 \\
        --dtype bfloat16 --batch 512
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spair_pytorch_tpu_torch.config import PRESETS  # noqa: E402
from spair_pytorch_tpu_torch.data import digit_bank, resolve_source  # noqa
from spair_pytorch_tpu_torch.parallel.captured import COUNTED  # noqa: E402
from spair_pytorch_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                                   replicate)
from spair_pytorch_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step)
from spair_pytorch_tpu_torch.train import data_config  # noqa: E402

LOSS_BAR = 1e-6    # each step's loss, relative to max |one process's|
PARAM_BAR = 1e-4   # the worst parameter tensor, relative to its max |one|


def make_step(cfg, mesh, device, eager, steps_per_call=1):
    dcfg = data_config(cfg)
    bank = torch.as_tensor(digit_bank(resolve_source("font"),
                                      dcfg.patch_hw), device=device)
    return make_train_step(cfg, mesh, datagen=(dcfg, bank),
                           steps_per_call=steps_per_call, eager=eager)


def fresh_state(cfg, mesh, device):
    state = create_train_state(cfg, device=device)
    return state if mesh is None else replicate(mesh, state)


def run(cfg, steps, mesh, device, eager=False):
    """(state, each step's logged loss as a float, the launches of the
    run's compositor kernels (K1-K4, ordered mode's forward and backward),
    counted over a captured step's replays)."""
    for w in COUNTED:
        w.launches = 0
    state = fresh_state(cfg, mesh, device)
    step = make_step(cfg, mesh, device, eager)
    losses = [step(state)[1]["losses/total"] for _ in range(steps)]
    return (state, [float(x) for x in losses],
            [w.launches for w in COUNTED])


def adam_on_device(mesh, state):
    """Whether Adam is ``capturable`` with every step count on the
    parameters' device after ``replicate`` of this trained state, on this
    rank (the CPU's Adam is not capturable: True there)."""
    replicate(mesh, state)
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        return True
    return (all(g["capturable"] for g in state.optimizer.param_groups)
            and all(s["step"].device == device
                    for s in state.optimizer.state.values()))


def card(device):
    if torch.device(device).type != "cuda":
        return str(device)
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name()


def ms_per_call(fn, calls, device):
    """fn's ms a call over ``calls`` calls: CUDA events on the card, the
    host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    if not cuda:
        return (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def timed(cfg, mesh, device, k, calls, eager):
    """This rank's ms/step over ``calls`` calls of ``k`` steps after the
    first call (``mesh`` None: the plain step)."""
    state = fresh_state(cfg, mesh, device)
    step = make_step(cfg, mesh, device, eager, steps_per_call=k)
    step(state)
    return ms_per_call(lambda: step(state), calls, device) / k


def all_reduce_ms(cfg, device, reps=20):
    """(ms of one flat f32 all-reduce of the gradients' size, eager, after
    3 warm-up ones; its MiB)."""
    n = sum(p.numel() for p in create_train_state(
        cfg, device=device).model.parameters())
    flat = torch.ones(n, device=device)
    for _ in range(3):
        dist.all_reduce(flat)
    return (ms_per_call(lambda: dist.all_reduce(flat), reps, device),
            n * 4 / 2 ** 20)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--out", help="rank 0 writes the mesh run here")
    p.add_argument("--compare", nargs="+", help="files --out wrote")
    p.add_argument("--eager", action="store_true",
                   help="the eager mesh step, not the captured one")
    p.add_argument("--time", type=int, metavar="K",
                   help="time calls of K steps instead of checking")
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-model", type=int, default=1,
                   help="ranks to a model group: a (data, model) mesh")
    p.add_argument("--mode", default="wavefront",
                   choices=["wavefront", "independent"])
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PRESETS[args.preset](batch_size=args.batch,
                              inference_mode=args.mode,
                              compute_dtype=args.dtype,
                              pres_gate_threshold=0.01)
    captured = not args.eager and torch.device(args.device).type == "cuda"
    arm = "captured" if captured else "eager"
    if args.compare is not None:
        return compare(cfg, args)
    mesh = make_mesh(args.device, n_model=args.n_model)
    try:
        if args.time:
            if mesh.n_model == 1:  # each rank's plain step at its batch
                other, other_cfg, other_mesh = "plain", dataclasses.replace(
                    cfg, batch_size=args.batch // mesh.world_size), None
            else:  # the data-only mesh of the same world
                other, other_cfg = "data_mesh", cfg
                other_mesh = make_mesh(args.device)
            ms = {"mesh": [], other: []}
            for name in ("mesh", other, other, "mesh"):
                ms[name].append(timed(
                    cfg if name == "mesh" else other_cfg,
                    mesh if name == "mesh" else other_mesh, mesh.device,
                    args.time, args.calls, args.eager))
            reduce_ms, mib = all_reduce_ms(cfg, mesh.device)
            every = [None] * mesh.world_size
            dist.all_gather_object(every, (ms, reduce_ms))
            if mesh.is_main:
                slowest = max(sum(m["mesh"]) / 2 for m, _ in every)
                print(json.dumps({
                    "preset": args.preset, "mode": args.mode,
                    "dtype": args.dtype, "arm": arm,
                    "world": mesh.world_size, "n_model": mesh.n_model,
                    "global_batch": args.batch,
                    "per_rank_batch": args.batch // mesh.n_data,
                    "steps_per_call": args.time, "calls": args.calls,
                    "ms_per_step_by_rank": [m["mesh"] for m, _ in every],
                    f"{other}_ms_per_step_by_rank": [m[other]
                                                     for m, _ in every],
                    "all_reduce_ms_by_rank": [r for _, r in every],
                    "grad_mib": mib,
                    "img_per_s": args.batch / slowest * 1e3,
                    "card": card(mesh.device)}))
            return 0
        state, losses, launches = run(cfg, args.steps, mesh, mesh.device,
                                      args.eager)
        params = [t.detach().cpu() for t in state.model.parameters()]
        every = [None] * mesh.world_size
        dist.all_gather_object(every, (adam_on_device(mesh, state),
                                       launches))
        ok = [good for good, _ in every]
        if mesh.is_main:
            print(f"{arm} mesh step, world {mesh.world_size} (data "
                  f"{mesh.n_data}, model {mesh.n_model}): Adam "
                  f"capturable with its step counts on the device after "
                  f"replicate, by rank: {ok}; K1-K4 and ordered launches of "
                  f"the {args.steps} steps by rank: "
                  f"{[n for _, n in every]}")
            torch.save({"params": params, "losses": losses, "arm": arm,
                        "world": mesh.world_size, "n_model": mesh.n_model},
                       args.out)
        return 0 if all(ok) else 1
    finally:
        mesh.close()


def compare(cfg, args):
    state, losses, _ = run(cfg, args.steps, None, args.device)
    params = [w.detach().cpu() for w in state.model.parameters()]
    scale = max(abs(x) for x in losses)
    runs = [torch.load(f) for f in args.compare]
    ok = True
    for got in runs:
        loss_err = max(abs(a - b) for a, b in zip(got["losses"],
                                                  losses)) / scale
        param_err = max(float((g - w).abs().max()) / float(w.abs().max())
                        for g, w in zip(got["params"], params))
        same = all(torch.equal(g, w) for g, w in zip(got["params"], params))
        good = (len(got["losses"]) == len(losses) and loss_err <= LOSS_BAR
                and param_err <= PARAM_BAR)
        ok = ok and good
        print(f"{args.steps} steps of {args.preset} ({args.mode}, "
              f"{args.dtype}, global batch {args.batch}): the {got['arm']} "
              f"mesh step of world {got['world']} (model axis "
              f"{got.get('n_model', 1)}) against one process: losses "
              f"{got['losses'][0]:.3f} -> {got['losses'][-1]:.3f} against "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}, worst step diff "
              f"{loss_err:.3e} of max |loss| (bar {LOSS_BAR:g}); worst "
              f"parameter tensor rel diff {param_err:.3e} (bar "
              f"{PARAM_BAR:g}); parameters equal bit for bit: {same}; "
              f"{'pass' if good else 'FAIL'} ({card(args.device)})")
    if len(runs) == 2:
        a, b = runs
        same = (a["losses"] == b["losses"] and all(
            torch.equal(x, y) for x, y in zip(a["params"], b["params"])))
        print(f"the {a['arm']} and the {b['arm']} mesh runs agree bit for "
              f"bit (losses and parameters): {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
