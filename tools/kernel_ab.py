#!/usr/bin/env python3
"""The compositor kernels K1-K4 on one CUDA card: held against their plain
versions, timed beside their bound, and, with ``--parent DIR``
(repeatable), timed in turns against the kernels of other checkouts of the
repository (an unpacked ``git archive``, or a copy with an edited kernel)
on the same inputs: each other checkout, this one twice, then the others
again in reverse order. Each kernel's outputs are also compared with each
other checkout's: each output's max |this - other| / max |other| and
whether all are equal bit for bit.

Inputs are chip_smoke.py's: paper128 shapes (N=121, C=1, 28x28 glimpses,
128x128 canvas), f32, ungated, at B=32 and B=128, with boxes as phase 11
draws them (the model's parameterization) and as phase 6 draws them
(uniform centres). K3 and K4 take paper128's bands. ``--sweep`` also
times K2's dP tile sizes on the B=128 phase-11 inputs.

    python tools/kernel_ab.py [--parent chip_checkout/PARENT ...] [--sweep]
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from spair_pytorch_tpu_torch.ops.kernels import composite as K  # noqa: E402
from spair_pytorch_tpu_torch.ops.kernels import composite_v3 as V  # noqa: E402

KERNEL_MODULE = "spair_pytorch_tpu_torch.ops.kernels.composite"


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_checkout(root: Path):
    """Another checkout's ops/kernels/composite.py and composite_v3.py, as
    modules of their own: its kernels build from its csrc/ into its _build/,
    and its composite_v3 imports its own composite."""
    base = root / "spair_pytorch_tpu_torch" / "ops" / "kernels"
    theirs = load_module(f"composite_of_{root.name}", base / "composite.py")
    mine = sys.modules[KERNEL_MODULE]
    sys.modules[KERNEL_MODULE] = theirs
    try:
        theirs_v3 = load_module(f"composite_v3_of_{root.name}",
                                base / "composite_v3.py")
    finally:
        sys.modules[KERNEL_MODULE] = mine
    return theirs, theirs_v3


def fns(M, M3, inputs, cot):
    return {"K1": lambda: M.composite_forward(*inputs, S.HW, S.WIN),
            "K2": lambda: M.composite_backward(*inputs, S.HW, *cot),
            "K3": lambda: M3.composite_v3_forward(*inputs, *S.V3_GEOM),
            "K4": lambda: M3.composite_v3_backward(*inputs, *S.V3_GEOM,
                                                   *cot)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = S.card_name()
    print(card, flush=True)

    K.build_library()
    for name in K.SOURCES:
        K.load_library(name)
        S.print_ptxas(K, name)
    others = {root.name: load_checkout(root) for root in args.parent}
    for label, (M, _) in others.items():
        M.build_library()
        if hasattr(M, "ptxas_report"):
            for name in M.SOURCES:
                S.print_ptxas(M, name, label)

    band_rows = S.band_rows(dev)
    for draw in ("phase 11", "phase 6"):
        for b in (32, 128):
            gen = torch.Generator(device=dev).manual_seed(400 + b)
            inputs = (S.banded_glimpses(b, gen, dev) if draw == "phase 11"
                      else S.random_glimpses(b, S.N, gen, dev))
            cot = S.random_cotangents(b, gen, dev)
            S.held_at(K, inputs, S.random_gate(b, gen, dev), cot)
            S.v3_held(V, "ab", inputs, cot)
            mine = fns(K, V, inputs, cot)
            theirs = {name: fns(*Ms, inputs, cot)
                      for name, Ms in others.items()}
            full = S.support_pairs(inputs[3])
            clipped = S.support_pairs(inputs[3], band_rows)
            with torch.no_grad():
                for k in ("K1", "K2", "K3", "K4"):
                    bar = S.F32_BAR if k in ("K1", "K3") else S.GRAD_BAR
                    names = list(theirs)
                    for name in names:
                        got, want = mine[k](), theirs[name][k]()
                        S.check("ab", f"{draw} {k} B={b} against {name}",
                                bar, got, want)
                        same = all(torch.equal(g, w)
                                   for g, w in zip(got, want))
                        print(f"[ab] {draw} {k} B={b} against {name}: "
                              f"equal bit for bit: {same}", flush=True)
                    order = names + ["this", "this"] + names[::-1]
                    t = {name: [] for name in order}
                    for name in order:
                        f = mine if name == "this" else theirs[name]
                        t[name].append(S.cuda_ms(f[k], 20))
                    new = t["this"]
                    old = "".join(f"; {name} {t[name][0]:.4f}, "
                                  f"{t[name][1]:.4f} ms" for name in names)
                    ms, by, moved = S.bound(
                        b, S.C, 4, k in ("K1", "K3"),
                        clipped if k in ("K3", "K4") else full)
                    mean = sum(new) / len(new)
                    print(f"[ab] {draw} {k} B={b}: "
                          f"{', '.join(f'{x:.4f}' for x in new)} ms{old}; "
                          f"bound {ms:.4f} ms ({by}), {ms / mean:.1%} of it,"
                          f" {moved / mean / 1e6:.1f} GB/s ({card})",
                          flush=True)

    if args.sweep:
        gen = torch.Generator(device=dev).manual_seed(528)
        inputs = S.banded_glimpses(128, gen, dev)
        cot = S.random_cotangents(128, gen, dev)
        px = K.BWD_TILE_PX
        with torch.no_grad():
            for K.BWD_TILE_PX in (256, 512, 1024, 2048):
                K._bwd_tile_px.cache_clear()
                S.held_at(K, inputs, S.random_gate(128, gen, dev), cot)
                ms = S.cuda_ms(fns(K, V, inputs, cot)["K2"], 20)
                print(f"[sweep] K2 B=128 dP tile {K.BWD_TILE_PX} px: "
                      f"{ms:.4f} ms ({card})", flush=True)
            K.BWD_TILE_PX = px
            K._bwd_tile_px.cache_clear()


if __name__ == "__main__":
    main()
