"""Closed-loop training: the program's captured train step, fed by scenes
it draws on the device, called back to back.

Set-up makes the weights (``reference/inputs.py::init_weights``) and the
digit bank from the seed, builds one train state whose generator is seeded
with the seed, loads the weights into it, sets its step counter to the
mix's ``first_step`` and builds the step with
``make_train_step(cfg, datagen=(dcfg, bank), steps_per_call=1)``. The
counter drives the training wheel and the count prior's schedule: from
step 1000 on the wheel is off and every leaf has a gradient. The first
three calls are the step's first three steps (the first runs one step
eagerly and captures the graph): their losses, Adam's first moment after
the first and the parameters after the third are kept for the comparison
with the reference. ``warmup_calls`` more calls follow, a fixed number a
mix, which wait out the card's slow phase after a process starts
(``PERF.md``), then the window:
calls until ``--seconds`` have passed, each call's loss read one call
behind (the host keeps a step queued), ended by a synchronise after the
last. ``train_img_s`` is the window's steps times the batch over its
seconds. A traced run then profiles ``profile_steps`` more steps.

Traffic parameters: ``overrides`` (the batch, the compute dtype),
``first_step``, ``warmup_calls``, ``profile_steps``.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from perfbench import common
from perfbench.counts import train_step_flops
from perfbench.reference import runs, spair
from perfbench.reference.inputs import PATCH_HW, digit_bank, init_weights
from perfbench.stats import rate

N_CHECKED = 3


def run(r: common.Run):
    from spair_pytorch_tpu_torch.data import DataConfig
    from spair_pytorch_tpu_torch.parallel import (create_train_state,
                                                  make_train_step)
    pcfg = common.program_config(r.fields)
    rcfg = spair.Config(r.fields)
    device, batch = r.device, rcfg.batch_size
    common.stage(r, "the program's modules imported")
    bank = torch.as_tensor(digit_bank(), device=device)
    weights = init_weights(rcfg, r.seed, device)
    common.sync(device)
    common.stage(r, "weights made")
    state = create_train_state(pcfg, seed=r.seed, device=device)
    state.model.load_state_dict(weights)
    first_step = int(r.traffic.get("first_step", 0))
    state.step.fill_(first_step)
    common.sync(device)
    common.stage(r, "train state made")
    generator0 = state.generator.get_state().clone()
    dcfg = DataConfig(image_hw=tuple(rcfg.image_shape[1:]),
                      patch_hw=PATCH_HW,
                      min_objects=rcfg.min_scene_objects,
                      max_objects=rcfg.max_scene_objects,
                      channels=rcfg.image_shape[0])
    step = make_train_step(pcfg, datagen=(dcfg, bank), steps_per_call=1)
    params = dict(state.model.named_parameters())
    common.stage(r, "weights, train state and step made")

    t = time.perf_counter()
    state, m = step(state)
    common.sync(device)
    capture_s = time.perf_counter() - t
    common.stage(r, "first call (eager step and capture) done")
    moment1 = {k: state.optimizer.state[p]["exp_avg"].detach().clone()
               for k, p in params.items()}
    losses = [m["losses/total"]]
    for _ in range(N_CHECKED - 1):
        state, m = step(state)
        losses.append(m["losses/total"])
    params3 = {k: p.detach().clone() for k, p in params.items()}
    losses = [float(v) for v in losses]
    for _ in range(int(r.traffic.get("warmup_calls", 2))):
        state, m = step(state)
    float(m["losses/total"])
    common.sync(device)
    common.stage(r, "warm-up calls done")
    before = dict(step.branches.counts) if step.branches else None

    t0 = time.perf_counter()
    setup_s = t0 - r.t_process
    steps = failed = 0
    pending = None
    host_call = host_read = 0.0
    done = []  # host clock when each step's loss was read
    with common.Clocks(device) as clocks:
        while True:
            ta = time.perf_counter()
            state, m = step(state)
            tb = time.perf_counter()
            steps += 1
            if pending is not None and not math.isfinite(float(pending)):
                failed += 1
            tc = time.perf_counter()
            done.append(tc)
            host_call += tb - ta
            host_read += tc - tb
            pending = m["losses/total"]
            if tc - t0 >= r.seconds:
                break
        if not math.isfinite(float(pending)):
            failed += 1
        common.sync(device)
        t1 = time.perf_counter()
    window_s = t1 - t0
    slices = [0] * (int(window_s // 5) + 1)
    for t in done:
        slices[int((t - t0) // 5)] += 1
    print(f"# steps done in each 5 s of the window: {slices}",
          file=sys.stderr)
    print(f"# host a step: {host_call / steps * 1e3!r} ms in the call, "
          f"{host_read / steps * 1e3!r} ms waiting for the loss before; "
          f"{window_s / steps * 1e3!r} ms a step", file=sys.stderr)
    branches = None
    if before is not None:
        branches = {k: step.branches.counts[k] - before[k] for k in before}
        print(f"# render branches over the window: {branches}",
              file=sys.stderr)

    trace = None
    if r.trace:
        n_prof = int(r.traffic.get("profile_steps", 4))

        def steps_fn():
            nonlocal state
            from torch.profiler import record_function
            for _ in range(n_prof):
                with record_function("perfbench.step"):
                    state, _ = step(state)
        trace = common.profiled(device, steps_fn)
        trace["steps"] = n_prof

    peak = common.memory_peak(device)
    record = {
        "kind": "train", "batch": batch, "steps": steps,
        "window_s": window_s, "step_s": window_s / steps,
        "capture_s": capture_s, "setup_s": setup_s,
        "flops_per_step": train_step_flops(r.fields, batch),
        "peak_flops": common.peak_flops(device, rcfg.compute_dtype),
        "clocks": clocks.summary(), "branches": branches, "trace": trace,
    }
    program = {"losses": losses, "moment1": moment1, "params0": weights,
               "params": params3}
    del step, state, params, m, pending
    common.free(device)
    return {
        "end_to_end": {"train_img_s": rate(steps * batch, window_s),
                       "setup_s": setup_s},
        "record": record, "attempted": steps, "failed": failed,
        "memory_peak_bytes": peak, "program": program,
        "inputs": {"weights": weights, "generator0": generator0,
                   "bank": bank, "first_step": first_step},
    }


def reference(r: common.Run, out, prec: spair.Precision):
    """The reference's first three steps from the program's start."""
    inputs = out["inputs"]
    return runs.train_steps(spair.Config(r.fields), inputs["weights"],
                            inputs["generator0"], inputs["bank"],
                            r.fields["batch_size"], N_CHECKED, r.device,
                            prec, first_step=inputs["first_step"])


def as_program(ref, out):
    """A reference run put in the program's place (the control)."""
    return {"losses": ref["losses"],
            "moment1": {k: g * 0.1 for k, g in ref["grad1"].items()},
            "params0": out["inputs"]["weights"], "params": ref["params"]}


def numbers(r: common.Run, program, ref):
    from perfbench.judge import train_numbers
    return train_numbers(program, ref)
