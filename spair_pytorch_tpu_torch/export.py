"""Export a checkpoint as a reference-format ``state_dict`` pickle, and
import one (counterpart of ``spair_pytorch_tpu/export.py``).

The reference saves and loads bare ``state_dict`` pickles (``step_N.pkl``).
The port names its modules after the reference's keys, so the export is the
model's ``state_dict`` with exactly the keys and values of the JAX
package's ``utils/interop.py::to_torch_state_dict``: float32 tensors on the
CPU, without the vestigial self-attention, which the JAX package keeps out
as well. The reference loads it with ``load_state_dict(torch.load(path),
strict=False)``. An import loads such a pickle (unknown keys, such as the
reference's discarded ``attn.*``, are ignored; a missing key raises) into a
fresh train state and writes it as a checkpoint of the run directory.

Usage:
    python -m spair_pytorch_tpu_torch.export --logdir runs/paper128 \\
        --out step_50000.pkl
    python -m spair_pytorch_tpu_torch.export --import-pkl their.pkl \\
        --logdir runs/from_ref --preset paper128
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from spair_pytorch_tpu_torch.config import PRESETS, config_from_json
from spair_pytorch_tpu_torch.parallel import create_train_state
from spair_pytorch_tpu_torch.utils.checkpoint import CheckpointManager

# module prefixes the reference's state_dict does not carry
_NOT_EXPORTED = ("self_attn.",)


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference's keys, as CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if not k.startswith(_NOT_EXPORTED)}


def load_reference_state_dict(model: torch.nn.Module, sd) -> torch.nn.Module:
    """Load a reference-format state_dict into ``model``: every key
    ``reference_state_dict`` would write must be there; other keys are
    ignored."""
    want = reference_state_dict(model)
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"the state_dict lacks {missing}")
    model.load_state_dict({k: sd[k] for k in want}, strict=False)
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logdir", required=True)
    p.add_argument("--preset", default="paper128", choices=sorted(PRESETS))
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="write the reference-format .pkl here")
    p.add_argument("--import-pkl", default=None,
                   help="reference state_dict pickle to import instead")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    saved = os.path.join(args.logdir, "config.json")
    if os.path.exists(saved):
        # prefer the run's own config (see eval.py)
        with open(saved) as f:
            cfg = config_from_json(f.read())
    else:
        cfg = PRESETS[args.preset]()
    state = create_train_state(cfg, device=args.device)
    mgr = CheckpointManager(os.path.join(args.logdir, "checkpoints"))

    if args.import_pkl:
        sd = torch.load(args.import_pkl, map_location="cpu",
                        weights_only=True)
        load_reference_state_dict(state.model, sd)
        step = mgr.save(state)
        print(f"imported {args.import_pkl} -> {args.logdir} @ step {step}")
        return args.logdir

    restored = mgr.restore(state, step=args.step)
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.logdir}")
    out = args.out or f"step_{int(restored.step)}.pkl"
    torch.save(reference_state_dict(restored.model), out)
    print(f"wrote {out} (load into the reference with "
          f"model.load_state_dict(torch.load(...), strict=False))")
    return out


if __name__ == "__main__":
    main()
