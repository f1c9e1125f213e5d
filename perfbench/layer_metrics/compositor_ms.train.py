"""Device milliseconds a step in the compositor's kernels, K1 and K2
(``composite_fwd_kernel``, ``composite_bwd_kernel``), over the traced
steps; None where neither ran. Both kernels skip the objects under the
presence gate, so past the training wheel their work falls as presence
does: a share of a bound counted over every object would overstate them."""

from perfbench import device as dev
from perfbench.layer_metrics._trace import stretch

KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel")


def read(record):
    s = stretch(record)
    if s is None:
        return None
    found = [dev.kernel_time_us(s[0], k, s[1], s[2]) for k in KERNELS]
    if sum(n for n, _ in found) == 0:
        return None
    return sum(us for _, us in found) / 1e3 / record["trace"]["steps"]
