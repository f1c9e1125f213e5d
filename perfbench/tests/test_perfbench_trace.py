"""The reduction of a trace to device time, on synthetic records."""

import pytest

from perfbench import device as dev


def rec(name, kind, start, end):
    return {"name": name, "kind": kind, "start": start, "end": end}


RECORDS = [
    rec("perfbench.window", "annotation", 0, 100),
    rec("perfbench.step", "annotation", 10, 40),
    rec("perfbench.step", "annotation", 60, 90),
    rec("aten::copy_", "cpu", 30, 45),
    rec("cudaGraphLaunch", "cpu", 55, 58),
    rec("void composite_fwd_kernel<float, 0>", "kernel", 10, 20),
    rec("gemm", "kernel", 15, 25),          # overlaps the one before
    rec("Memcpy DtoH", "memcpy", 35, 38),
    rec("void composite_bwd_kernel<float, 1, 28, 28>", "kernel", 60, 80),
    rec("Optimizer.step", "kernel", 70, 75),
    rec("outside", "kernel", 120, 130),     # after the window
]


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    assert dev.busy_us(RECORDS, 0, 100) == (25 - 10) + (38 - 35) + (80 - 60)
    assert dev.busy_us(RECORDS, 0, 200) == 38 + 10
    assert dev.window_of(RECORDS, "perfbench.window") == (0, 100)


def test_idle_share_and_kernel_counts():
    record = {"trace": {"records": RECORDS, "t0": 0, "t1": 100, "steps": 2},
              "step_s": 40e-6}
    read_idle = load("device_idle_pct.train")
    read_kernels = load("kernels_per_step.train")
    # 38 us busy over 2 traced steps, against 40 us a step untraced
    assert read_idle(record) == pytest.approx(100 * (1 - 19 / 40))
    assert read_kernels(record) == 4 / 2
    assert dev.kernel_time_us(RECORDS, "composite_fwd_kernel", 0, 100) \
        == (1, 10)


def test_gaps_are_labelled_by_what_the_host_was_doing():
    gaps = dict(dev.idle_gaps(RECORDS, 0, 100))
    # idle [0, 10), [25, 35), [38, 60), [80, 100); at each middle the
    # innermost host event: the window, the copy, the window, a step
    assert gaps == pytest.approx({"perfbench.window": 32e-6,
                                  "aten::copy_": 10e-6,
                                  "perfbench.step": 20e-6})
    ops = dict(dev.top_device_ops(RECORDS, 0, 100))
    assert ops["void composite_bwd_kernel<float, 1, 28, 28>"] == 20 / 1e6


def test_the_compositor_time_is_its_kernels_over_the_steps():
    record = {"trace": {"records": RECORDS, "t0": 0, "t1": 100, "steps": 2}}
    # composite_fwd_kernel 10 us, composite_bwd_kernel 20 us, two steps
    assert load("compositor_ms.train")(record) == pytest.approx(15e-3)
    quiet = [r for r in RECORDS if "composite" not in r["name"]]
    assert load("compositor_ms.train")(
        {"trace": {"records": quiet, "t0": 0, "t1": 100, "steps": 2}}) \
        is None


def test_readers_find_nothing_without_a_trace():
    for name in ("device_idle_pct.train", "kernels_per_step.train",
                 "compositor_ms.train"):
        assert load(name)({"trace": None}) is None


def load(name):
    from perfbench.registry import Registry
    return Registry().reader(name)
