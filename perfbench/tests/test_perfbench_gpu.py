"""On the card, at each cell's own size: the program's first steps or
answers pass the cell's limits and the control (the reference in the
program's place, one precision below the configuration's) fails them.
``python -m pytest perfbench/tests -m gpu`` on a machine with a card."""

import time

import pytest
import torch

from perfbench import common
from perfbench.calibrate import control_precision
from perfbench.judge import verdict
from perfbench.reference.spair import F32, Precision
from perfbench.registry import Registry

CELLS = ["train.paper128.b128", "train.quality.b32"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.run import set_cache_dirs
    set_cache_dirs()
    reg = Registry()
    w = reg.workload(cell)
    traffic = reg.traffic(w["traffic"])
    fields = dict(reg.config(w["config"])["config"],
                  **traffic.get("overrides", {}))
    cuda = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = common.Run(cell=cell, fields=fields, traffic=traffic,
                   seed=2 ** 31 + 77, seconds=3.0, trace=False, device=cuda,
                   t_process=time.perf_counter())
    driver = reg.driver(traffic["kind"])
    out = driver.run(r)
    ref = driver.reference(r, out, F32)
    limits = reg.limits(cell)
    ok, rows = verdict(driver.numbers(r, out["program"], ref), limits)
    assert ok, rows
    ctrl = driver.reference(r, out, Precision(control_precision(fields)))
    ok, rows = verdict(driver.numbers(r, driver.as_program(ctrl, out), ref),
                       limits)
    assert not ok, rows
