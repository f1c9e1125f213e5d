"""Training loop + CLI (counterpart of ``spair_pytorch_tpu/train.py``).

The run-dir layout, cadences and scalar tags of the JAX package's loop:
``config.json``, ``metrics.jsonl`` (and TensorBoard events where a writer
imports) under the reference's tag names, checkpoints every
``checkpoint_every`` steps with resume from the latest, held-out evaluation
every ``eval_every`` steps, and a calibrated detector operating point at the
end on request. By default scenes are generated on the device from the
train state's generator, ``steps_per_call`` steps per call; metrics stay on
the device and reach the host ``log_flush_every`` steps at a time. On the
card every step is a replay of one CUDA graph that ``make_train_step``
captures at its first call, after a restore (``parallel/captured.py``):
``render_topk`` runs as segments around the render's branch, and
``--mesh`` runs with NCCL's collectives inside the graph.

As in the JAX package, ``--data native`` (the C++ generator, ``data/
native.py``) and ``--hdf5`` (a reference-schema file, ``data/
scattered_mnist.py::ScatteredMNISTFile``; needs h5py) feed the step from
the host, one step per call, and the held-out evaluation reads the same
source. ``--mesh`` trains data parallel over the world the environment
describes (``parallel/mesh.py``; ``torchrun`` for more than one rank):
every rank trains on its slice of the global batch, rank 0 alone writes
logs, checkpoints and evaluations, and the logged scalars are reduced over
the ranks. ``log_images_every`` and ``log_figures_every`` write the
input|output image pair and the six renderer-analysis figures
(``utils/viz.py``; figures need matplotlib) for a fixed batch.

Usage, on a machine with a CUDA card:
    python -m spair_pytorch_tpu_torch.train --preset paper128 --steps 2000 \
        --logdir runs/paper128
    python -m spair_pytorch_tpu_torch.train --data native --steps 2000
    torchrun --nproc-per-node 4 -m spair_pytorch_tpu_torch.train --mesh

The ``'pallas_v3'`` compositor (K3/K4) is reached through the config, as in
the JAX package: ``train(PRESETS['paper128'](render_backend='pallas_v3'))``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from spair_pytorch_tpu_torch.config import (COUNT_PRIOR, PRESETS,
                                            SpairConfig, config_to_json,
                                            free_box_priors)
from spair_pytorch_tpu_torch.data import (DataConfig, OnDeviceScatteredDigits,
                                          ScatteredMNISTFile, digit_bank,
                                          resolve_source)
from spair_pytorch_tpu_torch.data.native import NativeScatteredDigits
from spair_pytorch_tpu_torch.eval import calibrate, evaluate
from spair_pytorch_tpu_torch.models.render import decode_objects
from spair_pytorch_tpu_torch.models.spair import forward
from spair_pytorch_tpu_torch.ops.stn import crop_glimpses
from spair_pytorch_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                   shard_batch)
from spair_pytorch_tpu_torch.parallel.train_step import (create_train_state,
                                                         make_train_step)
from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager
from spair_pytorch_tpu_torch.utils.debug import generative_grad_views
from spair_pytorch_tpu_torch.utils.logging import MetricWriter


def data_config(cfg: SpairConfig, max_objects: Optional[int] = None):
    _, ih, iw = cfg.image_shape
    return DataConfig(image_hw=(ih, iw),
                      patch_hw=(14, 14) if ih >= 64 else (10, 10),
                      min_objects=cfg.min_scene_objects,
                      max_objects=(cfg.max_scene_objects if max_objects is None
                                   else max_objects),
                      channels=cfg.n_channels)


def _file_batches(path: str, batch_size: int, device):
    """Endless epochs of a reference-schema HDF5 file's batches, as tensors
    on ``device``."""
    file = ScatteredMNISTFile(path)
    try:
        while True:
            for batch in file.batches(batch_size):
                yield tuple(torch.from_numpy(a).to(device) for a in batch)
    finally:
        file.close()


def make_data(cfg: SpairConfig, hdf5: Optional[str] = None,
              max_objects: Optional[int] = None, seed: int = 0,
              source: str = "device", digits: str = "auto", device="cuda"):
    """An iterator of (image, bbox, count) batches of cfg.batch_size scenes
    on ``device``: read from the HDF5 file ``hdf5`` when given, else
    generated from ``seed`` on the device (``source='device'``) or by the
    C++ generator on the host (``source='native'``)."""
    if hdf5:
        return _file_batches(hdf5, cfg.batch_size, device)
    dcfg = data_config(cfg, max_objects)
    bank = digit_bank(digits, dcfg.patch_hw)
    if source == "native":
        return NativeScatteredDigits(dcfg, cfg.batch_size, bank=bank,
                                     seed=seed, device=device)
    if source != "device":
        raise ValueError(f"unknown data source {source!r}")
    return OnDeviceScatteredDigits(dcfg, cfg.batch_size, bank=bank,
                                   seed=seed, device=device)


def _run_dir() -> str:
    """logs_v2/<Mon-DD>-<adjective>-<noun>-<HHMMSS>, the JAX package's
    naming (the reference's coolname slug plus the time)."""
    adjectives = ("amber", "brisk", "calm", "daring", "eager", "fuzzy",
                  "gentle", "hollow", "ivory", "jolly", "keen", "lucid",
                  "mellow", "nimble", "opal", "plucky", "quiet", "rustic",
                  "sunny", "tidy", "vivid", "witty")
    nouns = ("otter", "falcon", "maple", "comet", "harbor", "lantern",
             "meadow", "pebble", "quill", "ridge", "sparrow", "thicket",
             "violet", "walnut", "yarrow", "zephyr", "badger", "cinder",
             "dune", "ember")
    rng = random.Random()
    now = datetime.datetime.now()
    return os.path.join("logs_v2", f"{now.strftime('%b-%d')}-"
                        f"{rng.choice(adjectives)}-{rng.choice(nouns)}-"
                        f"{now.strftime('%H%M%S')}")


def train(cfg: SpairConfig,
          steps: int = 10000,
          logdir: Optional[str] = None,
          hdf5: Optional[str] = None,
          data_source: str = "device",
          use_mesh: bool = False,
          checkpoint_every: int = 1000,
          metrics_every: int = 5,
          log_images_every: int = 0,
          log_figures_every: int = 0,
          log_flush_every: int = 25,
          halt_on_nan: bool = True,
          resume: bool = True,
          verbose: bool = True,
          digits: str = "auto",
          eval_every: int = 0,
          eval_batches: int = 4,
          steps_per_call: int = 1,
          calibrate_at_end: bool = False,
          device="cuda"):
    """Train ``cfg`` for ``steps`` steps on ``device``; returns the final
    TrainState. Arguments as the JAX package's ``train``. With
    ``use_mesh`` the process joins the data-parallel world of
    ``parallel/mesh.py::make_mesh`` (and ends it on return if it started
    it); ``device`` then names the device type, each rank computing on its
    own device."""
    mesh = make_mesh(device) if use_mesh else None
    try:
        return _train(cfg, steps, logdir, hdf5, data_source, mesh,
                      checkpoint_every, metrics_every, log_images_every,
                      log_figures_every, log_flush_every, halt_on_nan,
                      resume, verbose, digits, eval_every, eval_batches,
                      steps_per_call, calibrate_at_end,
                      mesh.device if mesh is not None else device)
    finally:
        if mesh is not None:
            mesh.close()


def _train(cfg, steps, logdir, hdf5, data_source, mesh, checkpoint_every,
           metrics_every, log_images_every, log_figures_every,
           log_flush_every, halt_on_nan, resume, verbose, digits, eval_every,
           eval_batches, steps_per_call, calibrate_at_end, device):
    # data generated on the device runs steps_per_call steps a call; the
    # host sources (HDF5, native) one, as in the JAX package
    fused = hdf5 is None and data_source == "device"
    spc = max(1, steps_per_call) if fused else 1
    if spc > 1:
        # a mid-window cadence hit would label the end-of-window state with
        # a step that is not round (breaking `eval --step N`)
        for nm, every in (("checkpoint_every", checkpoint_every),
                          ("eval_every", eval_every),
                          ("log_images_every", log_images_every),
                          ("log_figures_every", log_figures_every)):
            if every and every % spc != 0:
                raise ValueError(
                    f"{nm}={every} must be a multiple of "
                    f"steps_per_call={spc} (cadence hits must land on "
                    "dispatch boundaries)")
    main_rank = mesh is None or mesh.is_main
    verbose = verbose and main_rank
    if logdir is None:
        logdir = _run_dir()

    writer = None
    if main_rank:
        writer = MetricWriter(logdir)
        # the exact config, so eval can rebuild the run (eval.py prefers it)
        with open(os.path.join(logdir, "config.json"), "w") as f:
            f.write(config_to_json(cfg))

    state = create_train_state(cfg, device=device)
    ckpt = None
    if checkpoint_every and main_rank:
        ckpt = CheckpointManager(os.path.join(logdir, "checkpoints"))
        restored = ckpt.restore(state) if resume else None
        if restored is not None:
            state = restored
            if verbose:
                print(f"resumed from step {int(state.step)}")
    if mesh is not None:
        state = replicate(mesh, state)

    if fused:
        dcfg = data_config(cfg)
        src = resolve_source(digits)
        if verbose:
            print(f"digit source: {src}")
        bank = torch.as_tensor(digit_bank(src, dcfg.patch_hw), device=device)
        step_fn = make_train_step(cfg, mesh, datagen=(dcfg, bank),
                                  steps_per_call=spc)
        data = None
    else:
        step_fn = make_train_step(cfg, mesh, with_detection=True)
        data = make_data(cfg, hdf5, source=data_source, digits=digits,
                         device=device)
    rem_step_fn = None  # built for a last window shorter than spc
    viz_data = None
    eval_set = None
    last_loss = float("nan")

    def write_scalars(pit, pvals):
        nonlocal last_loss
        # the reference's cadence for detection metrics: past step 1000,
        # every metrics_every steps (they are computed in every step)
        if not (metrics_every and pit > 1000 and pit % metrics_every == 0):
            pvals = {k: v for k, v in pvals.items()
                     if not k.startswith("accuracy/")}
        if writer is not None:
            writer.scalars(pit, pvals)
        if "losses/total" in pvals:
            last_loss = float(pvals["losses/total"])

    pending = []  # (step, n, metrics on the device) awaiting one transfer

    def flush():
        if not pending:
            return
        keys = list(pending[0][2])
        host = torch.cat([torch.stack([m[k].reshape(n) for k in keys])
                          for _, n, m in pending], dim=1).cpu().tolist()
        col = 0
        for pit, n, _ in pending:
            for j in range(n):
                write_scalars(pit + j, {k: host[i][col]
                                        for i, k in enumerate(keys)})
                col += 1
        pending.clear()

    t_last = time.perf_counter()
    images_done = 0
    it = int(state.step)  # host-side mirror of the step
    done = 0
    while done < steps:
        if not fused:
            batch = next(data)
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            n_sub = 1
            state, scalars = step_fn(state, batch)
        elif steps - done < spc:
            # the last window: exactly the steps asked for
            if rem_step_fn is None:
                rem_step_fn = make_train_step(cfg, mesh, datagen=(dcfg, bank),
                                              steps_per_call=steps - done)
            n_sub = steps - done
            state, scalars = rem_step_fn(state)
        else:
            n_sub = spc
            state, scalars = step_fn(state)

        pending.append((it, n_sub, scalars))
        if sum(p[1] for p in pending) >= max(1, log_flush_every):
            flush()
            if halt_on_nan and not np.isfinite(last_loss):
                # the last checkpoint predates the NaN: resume from there
                # (every rank reads the same reduced loss and stops)
                if verbose:
                    print(f"NaN loss at step ~{it}; halting "
                          f"(resume from {logdir}/checkpoints)")
                break

        def window_hits(every, offset=0):
            # does any step in [it, it + n_sub) hit the cadence?
            return bool(every) and any(
                (j + offset) % every == 0 for j in range(it, it + n_sub))

        # input/output images and the renderer-analysis figures (the
        # reference plots them every 50 steps), on a fixed batch from seed
        # 4242, by rank 0
        log_images = main_rank and window_hits(log_images_every)
        log_figures = main_rank and window_hits(log_figures_every)
        if log_images or log_figures:
            if viz_data is None:
                viz_data = make_data(cfg, hdf5, seed=4242,
                                     source=data_source, digits=digits,
                                     device=device)
            _log_viz(cfg, state, next(viz_data)[0], writer, it, log_images,
                     log_figures)

        # held-out evaluation on a fixed set of scenes from a seed disjoint
        # from the training stream, from the training data's source, logged
        # under eval/* (by rank 0)
        if main_rank and window_hits(eval_every, offset=1):
            if eval_set is None:
                gen = make_data(cfg, hdf5, seed=99999, source=data_source,
                                digits=digits, device=device)
                eval_set = [next(gen) for _ in range(eval_batches)]
            held, _, _ = evaluate(cfg, state, batches=len(eval_set),
                                  data=eval_set)
            # the state is at the end of this window, step it + n_sub
            writer.scalars(it + n_sub, {f"eval/{k}": v
                                        for k, v in held.items()
                                        if k != "step"})
            if verbose:
                print(f"step {it + n_sub}: eval count_acc "
                      f"{held['count_exact_accuracy']:.3f} ap50 "
                      f"{held['ap_at_50']:.3f}")

        # on the post-step count, so checkpoints land on round steps
        if ckpt and window_hits(checkpoint_every, offset=1):
            ckpt.save(state)

        images_done += cfg.batch_size * n_sub
        it += n_sub
        done += n_sub
        if verbose and it % 50 < n_sub:
            dt = time.perf_counter() - t_last
            ips = images_done / dt if dt > 0 else 0.0
            print(f"step {it}: loss {last_loss:.2f} ({ips:.1f} img/s)")
            t_last, images_done = time.perf_counter(), 0
    flush()
    if ckpt:
        ckpt.save(state)
        ckpt.wait()
    calibration_error = None
    if calibrate_at_end and main_rank:
        # leave the run serving-ready: the detector's operating point from
        # held-out scenes, next to the checkpoints (serve.py reads it). A
        # failure here must not take the run with it: the checkpoints and
        # metrics are already on disk, so report it and exit nonzero.
        try:
            cal = calibrate(cfg, state,
                            batches=max(eval_batches,
                                        512 // cfg.batch_size),
                            digits=digits)
            with open(os.path.join(logdir, "calibration.json"), "w") as f:
                json.dump(cal, f, indent=2)
            if verbose:
                print(f"calibrated pres_threshold = {cal['pres_threshold']} "
                      f"({cal['scenes']} scenes) -> calibration.json")
        except Exception as e:  # noqa: BLE001 - reported, then exit nonzero
            calibration_error = e
            print(f"calibrate-at-end FAILED ({type(e).__name__}: {e}); "
                  f"checkpoints and metrics are intact under {logdir} - "
                  f"rerun via: python -m spair_pytorch_tpu_torch.eval "
                  f"--logdir {logdir} --calibrate")
    if writer is not None:
        writer.close()
    if calibration_error is not None:
        raise SystemExit(f"calibrate-at-end failed: {calibration_error!r} "
                         f"(training artifacts under {logdir} are complete)")
    return state


@torch.no_grad()
def _log_viz(cfg: SpairConfig, state, x, writer: MetricWriter, it: int,
             images: bool, figures: bool):
    """Write step ``it``'s input|output image pair and/or the six figures
    and latent statistics under the JAX package's tags. The forward draws
    its noise from a copy of the state's generator, so the training stream
    is left as it was; the extras (decoded objects, glimpse crops,
    gradient views) are computed on the training device."""
    gen = torch.Generator(device=x.device)
    gen.set_state(state.generator.get_state())
    aux = forward(state.model, cfg, x, state.step, gen)[1]
    host = {k: aux[k].cpu().numpy() for k in ("recon", "z_attr", "z_where",
                                              "z_pres", "z_depth")}
    xnp = x.cpu().numpy()
    if images:
        writer.image_pair(it, "SPAIR input_output", xnp[0], host["recon"][0])
    if not figures:
        return
    from spair_pytorch_tpu_torch.utils import viz

    b, _, gh, gw = aux["z_pres"].shape

    def flat(t):  # NCHW grid -> (B, N, D)
        return t.permute(0, 2, 3, 1).reshape(b, gh * gw, -1)

    color, alpha, imp = decode_objects(state.model, cfg, flat(aux["z_attr"]),
                                       flat(aux["z_pres"]),
                                       flat(aux["z_depth"]))
    glimpses = crop_glimpses(x, flat(aux["z_where"]), cfg.object_shape)
    dec_grad, attr_grad = generative_grad_views(
        state.model, cfg, x, aux["z_attr"], aux["z_where"], aux["z_depth"],
        aux["z_pres"])
    ex = {k: v.cpu().numpy() for k, v in (
        ("color", color), ("alpha", alpha), ("importance", imp),
        ("glimpses", glimpses), ("dec_grad", dec_grad),
        ("attr_grad", attr_grad))}
    writer.figure(it, "analysis/renderer", viz.render_analysis_figure(
        xnp, host["recon"], host["z_where"], host["z_pres"],
        host["z_depth"]))
    # the reference's debug surface, under its tag names
    writer.figure(it, "renderer_analysis", viz.prerender_components_figure(
        ex["color"], ex["alpha"], ex["importance"], host["z_where"],
        host["z_pres"], host["z_depth"], xnp))
    writer.figure(it, "debug_cropped_input_images",
                  viz.glimpse_grid_figure(ex["glimpses"]))
    writer.figure(it, "z_attr/heatmap", viz.attr_stats_figure(host["z_attr"]))
    writer.figure(it, "grad_visualization/decoder_out",
                  viz.decoder_grad_figure(ex["dec_grad"], (gh, gw)))
    writer.figure(it, "grad_visualization/z_attr",
                  viz.attr_stats_figure(ex["attr_grad"]))
    writer.latent_stats(it, host["z_where"], host["z_pres"], host["z_depth"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--logdir", default=None)
    p.add_argument("--hdf5", default=None,
                   help="reference-schema scattered-MNIST file (needs h5py)")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over the ranks the environment "
                        "describes (torchrun; one rank without it)")
    p.add_argument("--data", default="device", choices=["device", "native"],
                   help="on-device generator or native C++ pipeline")
    p.add_argument("--digits", default="auto",
                   choices=["auto", "mnist", "sklearn", "font"],
                   help="digit patch source: local MNIST idx files, "
                        "sklearn's handwritten digits, or the procedural "
                        "font (auto = best available)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clipping (0/unset = off)")
    p.add_argument("--mode", default=None,
                   choices=["independent", "raster", "wavefront", "rowscan"])
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate on a fixed held-out scene set every N "
                        "steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--calibrate-at-end", action="store_true",
                   help="after the final checkpoint, sweep the detector "
                        "presence threshold on held-out scenes and write "
                        "<logdir>/calibration.json (serve.py uses it)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="run K steps per call, per-step logging preserved; "
                        "keep cadences multiples of K")
    p.add_argument("--render-mode", default=None,
                   choices=[None, "reference", "ordered"],
                   help="compositing semantics: the reference's "
                        "importance-normalized blend, or depth-ordered "
                        "alpha-over")
    p.add_argument("--pres-gate", type=float, default=None,
                   help="presence-gate threshold for the compositor "
                        "(cfg.pres_gate_threshold)")
    p.add_argument("--render-topk", type=int, default=None,
                   help="composite only the K highest-presence objects "
                        "(cfg.render_topk; needs --pres-gate; exact, with "
                        "the full grid when an image has more live)")
    p.add_argument("--pres-entropy", type=float, default=None,
                   help="weight of the Bernoulli-entropy penalty on the "
                        "relaxed presence probabilities "
                        "(cfg.pres_entropy_weight)")
    p.add_argument("--count-prior-end", type=float, default=None,
                   help="final annealed count-prior odds (reference: 0.0125)")
    p.add_argument("--slots", type=int, default=None,
                   help="objects inferred per grid cell (cfg.n_object_slots)")
    p.add_argument("--slot-coupling", default=None, choices=["none", "stick"],
                   help="inter-slot presence coupling for --slots > 1")
    p.add_argument("--box-prior", default="reference",
                   choices=["reference", "free"],
                   help="'reference': the N(7.0, 0.5) h/w-logit prior; "
                        "'free': N(0, 1) (config.free_box_priors)")
    args = p.parse_args(argv)

    overrides = {}
    if args.batch:
        overrides["batch_size"] = args.batch
    if args.mode:
        overrides["inference_mode"] = args.mode
    if args.grad_clip is not None:
        overrides["grad_clip_norm"] = args.grad_clip
    if args.render_mode:
        overrides["render_mode"] = args.render_mode
    if args.pres_gate is not None:
        overrides["pres_gate_threshold"] = args.pres_gate
    if args.render_topk is not None:
        overrides["render_topk"] = args.render_topk
    if args.pres_entropy is not None:
        overrides["pres_entropy_weight"] = args.pres_entropy
    if args.slots is not None:
        overrides["n_object_slots"] = args.slots
    if args.slot_coupling is not None:
        overrides["slot_coupling"] = args.slot_coupling
    if args.box_prior == "free":
        overrides["priors"] = free_box_priors()
    if args.count_prior_end is not None:
        overrides["count_prior"] = dataclasses.replace(
            COUNT_PRIOR, end=args.count_prior_end)
    cfg = PRESETS[args.preset](**overrides)
    return train(cfg, steps=args.steps, logdir=args.logdir, hdf5=args.hdf5,
                 data_source=args.data, use_mesh=args.mesh,
                 resume=not args.no_resume, digits=args.digits,
                 eval_every=args.eval_every, eval_batches=args.eval_batches,
                 steps_per_call=args.steps_per_call,
                 calibrate_at_end=args.calibrate_at_end)


if __name__ == "__main__":
    main()
