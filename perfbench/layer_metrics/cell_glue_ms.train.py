"""Device milliseconds a step in the ten kernels of ``cell_step``'s glue
(``csrc/cell_glue.cu``: the forward and backward of the ``box_in``,
``box``, ``attr_z``, ``depth_obj`` and ``pres`` segments, every front of
the wavefront scan), over the traced steps; None where none ran, as in a
program that runs the glue as PyTorch's own kernels."""

from perfbench import device as dev
from perfbench.layer_metrics._trace import stretch

KERNELS = tuple(f"cell_glue_{seg}_{d}" for seg in (
    "box_in", "box", "attr_z", "depth_obj", "pres") for d in ("fwd", "bwd"))


def read(record):
    s = stretch(record)
    if s is None:
        return None
    found = [dev.kernel_time_us(s[0], k, s[1], s[2]) for k in KERNELS]
    if sum(n for n, _ in found) == 0:
        return None
    return sum(us for _, us in found) / 1e3 / record["trace"]["steps"]
