"""Where K5's time goes: per-phase cycles, and configurations it did not keep.

K5 (``spair_pytorch_tpu_torch/csrc/kernel_anatomy.cu``) is built here from
copies of its source edited at fixed anchors, in a temporary directory, one
``nvcc`` each, all started together, and the wrapper
(``benchmarks/kernel_anatomy.py``) is pointed at each build in turn:

  --profile K[,K]  clock64 marks around each phase of a consumer warpgroup's
                   entry (walk, build, wait for the glimpse, relay and
                   barrier, first product, second product, wait for its
                   turn, read-modify-write), K consumer warpgroups; prints
                   the cycles a warpgroup spends a listed object in each,
                   averaged over every warpgroup of one launch, and each
                   warpgroup's set-up and write-out. C = 1 at paper shapes.
  --variants V,..  the entry point's times (``kernel_anatomy.main``: CUDA
                   events over a captured graph of 30 launches, best of 3)
                   of the source as committed ('as_is') and of the
                   configurations named in VARIANTS, in turns.

Each edit must find its anchor in the source, or the tool stops: it is
written against the source as committed. Needs the card:

    env PYTHONPATH=. python tools/anatomy_variants.py --profile 1,3 \\
        --variants as_is,consumers2,consumers4,stages4,two_blocks
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import tempfile

import torch

from spair_pytorch_tpu_torch.benchmarks import kernel_anatomy as A
from spair_pytorch_tpu_torch.ops.kernels import composite as K

SOURCE = K.SOURCES["kernel_anatomy"]


def consumers(k):
    return ("constexpr int kConsumers = 3;", f"constexpr int kConsumers = {k};")


STAGES4 = ("constexpr int kStages = 8;", "constexpr int kStages = 4;")
TWO_BLOCKS = ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")
VARIANTS = {  # name: edits
    "as_is": [],
    "consumers2": [consumers(2)],
    "consumers4": [consumers(4)],
    "stages4": [STAGES4],
    "two_blocks": [consumers(2), TWO_BLOCKS, STAGES4],  # two blocks a SM
}
PHASES = ("walk", "build", "wait_glimpse", "relay_and_barrier", "first",
          "second", "wait_turn", "add")
# the profile's marks: prof[k] += cycles since the last mark
PROFILE = [
    ("  const Layout L = layout(a.c, a.oh, a.ow, a.ih, a.win, kVariant);",
     "  const long long k0 = clock64();\n"
     "  const Layout L = layout(a.c, a.oh, a.ow, a.ih, a.win, kVariant);"),
    ("        if (a.listed != nullptr && lane == 0)\n"
     "          a.listed[((size_t)b * gridDim.x + blockIdx.x) * a.n + o] = 1;\n",
     ""),
    ("  auto entry = [&](int e, float4 box, int local) {",
     "  unsigned long long prof[11] = {0ull};\n"
     "  long long last = clock64();\n"
     "  prof[8] += last - k0;\n"
     "  auto mark = [&](int k) {\n"
     "    const long long now = clock64();\n"
     "    prof[k] += now - last;\n"
     "    last = now;\n"
     "  };\n"
     "  auto entry = [&](int e, float4 box, int local) {\n"
     "    mark(0);"),
    ("    mbar_wait(&full[s], (e / kStages) & 1);\n",
     "    mark(1);\n    mbar_wait(&full[s], (e / kStages) & 1);\n    mark(2);\n"),
    ("    if (wt == 0) mbar_arrive(&empty[s]);\n",
     "    if (wt == 0) mbar_arrive(&empty[s]);\n    mark(3);\n"),
    ("          first_c1(t, py, g_tiles);",
     "          first_c1(t, py, g_tiles);\n          mark(4);"),
    ("            second<3>(pl, at, px_tile);\n          }\n          in_order();",
     "            second<3>(pl, at, px_tile);\n          }\n          mark(5);\n"
     "          in_order();\n          mark(6);"),
    ("            add_num<kHalves>(canvas, row, col, pl[0], pl[1], pl[2]);\n"
     "          }\n",
     "            add_num<kHalves>(canvas, row, col, pl[0], pl[1], pl[2]);\n"
     "          }\n          mark(7);\n"),
    ("  bar_sync(kBarConsumers, kConsumers * kWg);\n",
     "  bar_sync(kBarConsumers, kConsumers * kWg);\n  mark(9);\n"),
    ("    *reinterpret_cast<float4*>(dst + x0 + xv) = v;\n  }\n",
     "    *reinterpret_cast<float4*>(dst + x0 + xv) = v;\n  }\n  mark(10);\n"
     "  if (wt == 0) {\n"
     "    unsigned long long* out =\n"
     "        reinterpret_cast<unsigned long long*>(a.listed);\n"
     "    for (int k = 0; k < 11; ++k) atomicAdd(out + k, prof[k]);\n"
     "    atomicAdd(out + 11, (unsigned long long)local);\n"
     "    atomicAdd(out + 12, 1ull);\n"
     "  }\n"),
]


def edited(edits):
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"anchor not in {SOURCE.name}: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def build_all(sources, out_dir):
    """{name: ctypes library} of {name: source text}, one nvcc each."""
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        out = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [K._find_nvcc(), *K.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
             out, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err[-3000:]}")
        base = re.search(r"ILi0ELi1ELb1E.*?(\d+) bytes spill stores.*?Used "
                         r"(\d+) registers", err, flags=re.S)
        print(json.dumps({"build": name,
                          "base_registers": base and int(base[2]),
                          "base_spill_stores": base and int(base[1])}),
              flush=True)
        lib = ctypes.CDLL(out)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spair_kernel_anatomy.argtypes = [ptr] * 7 + [i32] * 9 + [f32, ptr]
        lib.spair_kernel_anatomy.restype = i32
        lib.spair_kernel_anatomy_smem.argtypes = [i32] * 6
        lib.spair_kernel_anatomy_smem.restype = ctypes.c_size_t
        lib.spair_cuda_error_string.argtypes = [i32]
        lib.spair_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def profile(lib, k, variant, batch, dev):
    """One launch of the profiled build on the entry point's inputs: the
    cycles a warpgroup spends a listed object in each phase, and a
    warpgroup's set-up and write-out."""
    color, alpha, imp, boxes, hw, win = A.paper_inputs(batch, 7, dev)
    g = A.pack(color, alpha, imp).to(torch.bfloat16).contiguous()
    py = pxt = None
    if variant == "hoisted":
        py, pxt = A.hoisted_weights(boxes, hw, (28, 28), win)
    n = boxes.shape[1]
    num = torch.empty((batch, 1) + hw, device=dev)
    den = torch.empty_like(num)
    for _ in range(2):  # the second launch is read
        out = torch.zeros(16, dtype=torch.int64, device=dev)
        err = lib.spair_kernel_anatomy(
            g.data_ptr(), boxes.data_ptr(),
            None if py is None else py.data_ptr(),
            None if pxt is None else pxt.data_ptr(), num.data_ptr(),
            den.data_ptr(), out.data_ptr(), batch, n, 1, 28, 28, hw[0],
            hw[1], win, A.VARIANTS.index(variant), n * 1e-9,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
        torch.cuda.synchronize(dev)
    c = out.tolist()
    entries, groups = c[11], c[12]
    line = {"profile": variant, "consumers": k, "batch": batch,
            "entries": entries,
            "cycles_an_entry": {p: c[i] / entries
                                for i, p in enumerate(PHASES)},
            "setup_cycles": c[8] / groups,
            "writeout_cycles": (c[9] + c[10]) / groups}
    line["cycles_an_entry_total"] = sum(line["cycles_an_entry"].values())
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile", default="",
                   help="consumer warpgroup counts to profile, e.g. 1,3")
    p.add_argument("--variants", default="",
                   help=f"configurations to time: {', '.join(VARIANTS)}")
    p.add_argument("--batches", default="32,128")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    batches = [int(b) for b in args.batches.split(",")]
    profiles = [int(k) for k in args.profile.split(",") if k]
    timed = [v for v in args.variants.split(",") if v]
    sources = {f"profile{k}": edited([consumers(k)] + PROFILE)
               for k in profiles}
    sources.update({v: edited(VARIANTS[v]) for v in timed})
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build_all(sources, out_dir)
        for k in profiles:
            for batch in batches:
                for variant in ("base", "nobuild", "hoisted"):
                    print(json.dumps(profile(libs[f"profile{k}"], k, variant,
                                             batch, dev)), flush=True)
        for r in range(args.rounds):
            for v in timed:
                A.load_library = lambda name, lib=libs[v]: lib
                for batch in batches:
                    with contextlib.redirect_stdout(io.StringIO()):
                        line = A.main(["--batch", str(batch)])
                    print(json.dumps({"variant": v, "round": r,
                                      "batch": batch, "ms": line["ms"],
                                      "card": line["card"]}), flush=True)


if __name__ == "__main__":
    main()
