"""The cell glue kernels' reader on synthetic records."""

import pytest

from perfbench.registry import Registry


def rec(name, kind, start, end):
    return {"name": name, "kind": kind, "start": start, "end": end}


GLUE = [f"(anonymous namespace)::cell_glue_{seg}_{d}((anonymous "
        f"namespace)::Args)" for seg in ("box_in", "box", "attr_z",
                                         "depth_obj", "pres")
        for d in ("fwd", "bwd")]
RECORDS = ([rec("perfbench.window", "annotation", 0, 1000)]
           + [rec(name, "kernel", 10 * i, 10 * i + 2)
              for i, name in enumerate(GLUE)]
           + [rec("void at::native::vectorized_elementwise_kernel<4>",
                  "kernel", 200, 260),
              rec(GLUE[0], "kernel", 1200, 1210)])  # after the window


def test_the_glue_time_is_its_ten_kernels_over_the_steps():
    read = Registry().reader("cell_glue_ms.train")
    record = {"trace": {"records": RECORDS, "t0": 0, "t1": 1000,
                        "steps": 4}}
    assert read(record) == pytest.approx(10 * 2 / 1e3 / 4)
    quiet = [r for r in RECORDS if "cell_glue" not in r["name"]]
    assert read({"trace": {"records": quiet, "t0": 0, "t1": 1000,
                           "steps": 4}}) is None
    assert read({"trace": None}) is None
