"""Device kernels launched a step, over the traced steps."""

from perfbench import device as dev
from perfbench.layer_metrics._trace import stretch


def read(record):
    s = stretch(record)
    if s is None:
        return None
    return dev.count_kernels(*s) / record["trace"]["steps"]
