"""The ordered compositor's reader on synthetic records."""

import pytest

from perfbench.registry import Registry


def rec(name, kind, start, end):
    return {"name": name, "kind": kind, "start": start, "end": end}


RECORDS = [
    rec("perfbench.window", "annotation", 0, 100),
    rec("(anonymous namespace)::ordered_fwd_kernel(float const*)", "kernel",
        10, 14),
    rec("(anonymous namespace)::ordered_bwd_pixel_kernel(float const*)",
        "kernel", 20, 26),
    rec("(anonymous namespace)::ordered_bwd_object_kernel(float const*)",
        "kernel", 30, 40),
    rec("void composite_fwd_kernel<float, 0>", "kernel", 50, 60),
    rec("ordered_fwd_kernel", "kernel", 120, 130),  # after the window
]


def test_the_ordered_compositor_time_is_its_kernels_over_the_steps():
    read = Registry().reader("ordered_composite_ms.train")
    record = {"trace": {"records": RECORDS, "t0": 0, "t1": 100, "steps": 2}}
    assert read(record) == pytest.approx(10e-3)
    quiet = [r for r in RECORDS if "ordered" not in r["name"]]
    assert read({"trace": {"records": quiet, "t0": 0, "t1": 100,
                           "steps": 2}}) is None
    assert read({"trace": None}) is None
