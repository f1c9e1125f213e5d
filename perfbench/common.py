"""What every driver shares: the run's parameters, the program's
configuration, synchronising and freeing the card, profiling a stretch."""

from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Callable, Dict, Optional

import torch

from perfbench import device as dev

# dense peak FLOP/s by card name and compute dtype (data sheet, 700 W;
# float32 is the rate outside the tensor cores, TF32 off)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}


@dataclasses.dataclass
class Run:
    """One run of one cell: the configuration as run (``fields``, the
    traffic's overrides applied), the traffic mix, the seed, the window's
    seconds, whether the run is traced, the device, and the host clock's
    reading (``time.perf_counter``) at the process's start."""
    cell: str
    fields: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float


def stage(r: "Run", name: str):
    """Writes on standard error how far into the process set-up is."""
    import sys
    print(f"# set-up: {name} at {time.perf_counter() - r.t_process:.3f} s",
          file=sys.stderr)


def program_config(fields: Dict):
    """The program's ``SpairConfig`` of the configuration ``fields``."""
    from spair_pytorch_tpu_torch.config import config_from_json
    return config_from_json(json.dumps(fields))


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device):
    """Collects what the caller dropped and gives the cache back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def peak_flops(device: torch.device, dtype: str) -> Optional[float]:
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(dtype)


class Clocks:
    """``device.ClockSampler`` on a card, nothing on the CPU."""

    def __init__(self, device: torch.device):
        self.sampler = (dev.ClockSampler(device.index or 0)
                        if device.type == "cuda" else None)

    def __enter__(self):
        if self.sampler is not None:
            self.sampler.__enter__()
        return self

    def __exit__(self, *exc):
        if self.sampler is not None:
            self.sampler.__exit__(*exc)

    def summary(self) -> Dict:
        return self.sampler.summary() if self.sampler is not None else {}


def profiled(device: torch.device, fn: Callable[[], None]):
    """``fn()`` under ``torch.profiler``, inside the host annotation
    'perfbench.window' that ends after a synchronise: {'records', 't0',
    't1'} (microseconds on the trace's clock)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        with record_function("perfbench.window"):
            fn()
            sync(device)
    records = dev.profiler_records(prof)
    t0, t1 = dev.window_of(records, "perfbench.window")
    return {"records": records, "t0": t0, "t1": t1}
