"""Device milliseconds a step in ordered mode's compositor kernels
(``csrc/composite_ordered.cu``: ``ordered_fwd_kernel``, and the backward's
``ordered_bwd_pixel_kernel`` and ``ordered_bwd_object_kernel``), over the
traced steps; None where none ran, as in a program that composites ordered
mode in plain PyTorch."""

from perfbench import device as dev
from perfbench.layer_metrics._trace import stretch

KERNELS = ("ordered_fwd_kernel", "ordered_bwd_pixel_kernel",
           "ordered_bwd_object_kernel")


def read(record):
    s = stretch(record)
    if s is None:
        return None
    found = [dev.kernel_time_us(s[0], k, s[1], s[2]) for k in KERNELS]
    if sum(n for n, _ in found) == 0:
        return None
    return sum(us for _, us in found) / 1e3 / record["trace"]["steps"]
