"""How ``correct`` is decided: the numbers compared with the reference, and
their limits.

Training. The program's first three steps against the reference's three
from the same weights and the same generator state:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the three steps;
- ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from Adam's first moment after one step (m = (1 - beta1) g): over
  the parameter tensors ("leaves"), the largest gap between the norm of
  the program's gradient and the reference's, over the larger of the
  reference's norm of that leaf and the median leaf's;
- ``grad_gap_median``: the median of the same gaps over every leaf;
- ``grad_gap_presence_decoder``: their median over the presence head's
  and the object decoder's leaves (``SMOOTH``). The crop's and the
  paste's hat weights have a derivative that jumps at whole pixels, so a
  rounding that moves a box coordinate across one changes the gradient of
  every leaf the boxes feed back into. In bfloat16 the median over every
  leaf swings 50x from seed to seed, while these leaves, whose gradients
  come mostly from the reconstruction and the KLs, stay steady
  (``PERF.md``);
- ``change_gap``: the largest such gap of the change of each leaf over the
  three steps; leaves whose reference gradient is under a thousandth of
  the median leaf's are left out (Adam moves them by round-off alone).

A cell's limits file names the numbers it compares.

A number passes when it is at most its limit; a number that is not finite
fails.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

BETA1 = 0.9
SMOOTH = ("obj_network.", "object_decoder.")


def _median(xs: Sequence[float]) -> float:
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def leaf_gaps(got: Dict, want: Dict, keys) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and the median leaf's."""
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    floor = _median(list(w.values()))
    return {k: abs(g[k] - w[k]) / max(w[k], floor, 1e-30) for k in keys}


def _split(program: Dict, reference: Dict):
    """(every leaf, the gradients from the first moment, the leaves the
    change counts)."""
    keys = sorted(reference["grad1"])
    grad = {k: program["moment1"][k] / (1.0 - BETA1) for k in keys}
    norms = {k: float(torch.linalg.vector_norm(
        reference["grad1"][k].double())) for k in keys}
    floor = 1e-3 * _median(list(norms.values()))
    return keys, grad, [k for k in keys if norms[k] >= floor]


def leaves(program: Dict, reference: Dict) -> Dict:
    """Every leaf's gradient and change gaps, the losses' gaps step by
    step, and the leaves the change leaves out (for the record)."""
    keys, grad, moved = _split(program, reference)
    p0 = program["params0"]
    return {"grad": leaf_gaps(grad, reference["grad1"], keys),
            "change": leaf_gaps(
                {k: program["params"][k] - p0[k] for k in moved},
                {k: reference["params"][k] - p0[k] for k in moved}, moved),
            "losses": [abs(a - b) / abs(b) for a, b in
                       zip(program["losses"], reference["losses"])],
            "left_out": sorted(set(reference["grad1"]) - set(moved))}


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """``program``: {'losses', 'moment1' (Adam's first moment after one
    step), 'params0', 'params'}; ``reference``: {'losses', 'grad1',
    'params'} (``reference/runs.py::train_steps``), tensors by name."""
    losses = [abs(a - b) / abs(b) for a, b in
              zip(program["losses"], reference["losses"])]
    if len(losses) != len(reference["losses"]) or not all(
            math.isfinite(x) for x in program["losses"]):
        losses.append(math.inf)
    keys, grad, moved = _split(program, reference)
    p0 = program["params0"]
    grads = leaf_gaps(grad, reference["grad1"], keys)
    change = leaf_gaps({k: program["params"][k] - p0[k] for k in moved},
                       {k: reference["params"][k] - p0[k] for k in moved},
                       moved)
    return {"loss_gap": max(losses), "grad_gap": max(grads.values()),
            "grad_gap_median": _median(list(grads.values())),
            "grad_gap_presence_decoder": _median(
                [v for k, v in grads.items() if k.startswith(SMOOTH)]
                or [math.inf]),
            "change_gap": max(change.values())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]) over the limits' names."""
    rows = [(k, numbers.get(k, math.nan), limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
