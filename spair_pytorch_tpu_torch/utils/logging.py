"""Host-side metric logging with the reference's TensorBoard tag names
(the port's copy of ``spair_pytorch_tpu/utils/logging.py``).

The reference threads a tensorboardX SummaryWriter INTO the model
constructor and writes from inside forward (reference models.py:16-19,60,
548-560; train.py:21,73,79-82 — SURVEY.md section 1 "the model owns the
logger"). This rebuild inverts that: the model is pure and returns a metric
pytree; this writer consumes it host-side, preserving every tag the
reference emits ('training_wheel', 'losses/reconst', 'losses/KL<name>',
'losses/total', 'accuracy/bbox_average_precision',
'accuracy/object_count_accuracy', image pairs).

Backends: tensorboardX or torch.utils.tensorboard when importable,
always accompanied by a JSONL event log (machine-readable, no deps).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


def _try_tb_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        return SummaryWriter(logdir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter  # type: ignore
        return SummaryWriter(logdir)
    except ImportError:
        return None


class MetricWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._tb = _try_tb_writer(logdir) if use_tensorboard else None
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]):
        """One row of scalars: numbers, or 0-d tensors already on the host
        (a device tensor's float() is one device sync per value, so callers
        move them in one transfer first)."""
        rec = {"step": int(step), "time": time.time()}
        for tag, v in values.items():
            v = float(v)
            rec[tag] = v
            if self._tb is not None:
                self._tb.add_scalar(tag, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def image_pair(self, step: int, tag: str, image_in, image_out):
        """Side-by-side input|output image (reference train.py:70-73)."""
        if self._tb is None:
            return
        combined = np.concatenate(
            [np.asarray(image_in), np.asarray(image_out)], axis=-1)
        self._tb.add_image(tag, np.clip(combined, 0.0, 1.0), step)

    def histogram(self, step: int, tag: str, values):
        """Histogram logging (reference models.py:586-589 box histograms)."""
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), step)

    def latent_stats(self, step: int, z_where, z_pres, z_depth):
        """The reference's _debug_logging quantities (models.py:565-604):
        per-axis box histograms and z_pres / z_depth min-mean-max scalars,
        under the same tag names."""
        z_where = np.asarray(z_where)
        for i, name in enumerate(["x", "y", "w", "h"]):
            self.histogram(step, f"box/{name}", z_where[0, i])
        scal = {}
        for name, t in [("z_presence", np.asarray(z_pres)[0]),
                        ("z_depth", np.asarray(z_depth)[0])]:
            scal[f"{name}/max"] = float(t.max())
            scal[f"{name}/mean"] = float(t.mean())
            scal[f"{name}/min"] = float(t.min())
        self.scalars(step, scal)

    def figure(self, step: int, tag: str, fig):
        """Write a matplotlib figure (reference debug_tools.py:104)."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)
        else:
            import os
            d = os.path.join(self.logdir, "figures")
            os.makedirs(d, exist_ok=True)
            fig.savefig(os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"))

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
