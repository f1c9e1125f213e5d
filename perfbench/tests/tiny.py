"""A cell of the manifest shrunk to a size the CPU runs in seconds: the
same drivers, program and reference, 48x48 scenes and a few images."""

from __future__ import annotations

import time

import torch

from perfbench import common
from perfbench.registry import Registry

TINY = {"image_shape": [1, 48, 48], "anchor_shape": [24, 24],
        "object_shape": [14, 14],
        "backbone_topology": [[128, 4, 3], [128, 4, 2], [128, 4, 2],
                              [128, 1, 1], [128, 1, 1], [128, 1, 1]]}


def tiny_run(cell: str, seed: int = 2 ** 31 + 5, seconds: float = 1.0,
             trace: bool = False, registry: Registry = None, batch: int = 4,
             **fields):
    """(registry, Run, limits) of ``cell`` at the tiny size."""
    registry = registry or Registry()
    w = registry.workload(cell)
    cfg = registry.config(w["config"])
    traffic = dict(registry.traffic(w["traffic"]))
    if traffic["kind"] == "train":
        traffic["warmup_calls"] = 2
    f = {**cfg["config"], **traffic.get("overrides", {}), **TINY,
         "batch_size": batch, **fields}
    r = common.Run(cell=cell, fields=f, traffic=traffic, seed=seed,
                   seconds=seconds, trace=trace, device=torch.device("cpu"),
                   t_process=time.perf_counter())
    return registry, r, registry.limits(cell)
