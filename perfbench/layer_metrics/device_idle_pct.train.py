"""Share (%) of a step's time in which no kernel, copy or fill ran on the
device: one minus the device-busy seconds a traced step (from the trace)
over the seconds a step of the untraced window (host clock). The traced
stretch's own wall time is not the denominator: the profiler slows each
graph launch and would count its own overhead as idle time. A reading
a little under 0 means the profiler lengthened the kernels themselves."""

from perfbench import device as dev
from perfbench.layer_metrics._trace import stretch


def read(record):
    s = stretch(record)
    if s is None:
        return None
    busy_s = dev.busy_us(*s) / 1e6 / record["trace"]["steps"]
    return 100.0 * (1.0 - busy_s / record["step_s"])
