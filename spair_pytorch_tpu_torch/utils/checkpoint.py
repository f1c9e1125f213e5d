"""Checkpoints of the full training state, with retention and resume
(counterpart of ``spair_pytorch_tpu/utils/checkpoint.py``).

The reference saves bare ``state_dict`` pickles and has no resume path. As
in the JAX package, the whole ``TrainState`` round-trips here: the model's
``state_dict``, Adam's ``state_dict``, the step and the generator's state
(a CUDA or a CPU generator). Each checkpoint is a directory named by its
step, as the JAX package's Orbax manager names them
(``<directory>/<step>/state.pt``), written under a temporary name and
renamed when complete; the newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from spair_pytorch_tpu_torch.parallel.train_step import TrainState

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        """Write ``state`` as checkpoint ``step`` (its own step when omitted).
        As with Orbax, a step at or below the latest saved one is not
        written again."""
        step = int(state.step if step is None else step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return step
        payload = {"step": step,
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "generator": state.generator.get_state()}
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return step

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load checkpoint ``step`` (the latest when omitted) into
        ``template``, whose model, optimizer and generator take the saved
        values on their own devices; returns it, or None when there is no
        checkpoint to restore."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location="cpu", weights_only=True)
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        template.generator.set_state(payload["generator"])
        template.step.fill_(payload["step"])
        return template

    def wait(self):
        """Saves are synchronous: nothing to wait for (API parity)."""

    def close(self):
        """Nothing is held open (API parity)."""
