"""Training diagnostics (counterpart of ``grad_norms_by_head`` in
``spair_pytorch_tpu/utils/debug.py``)."""

from __future__ import annotations

from typing import Dict

import torch

# the JAX package's top-level parameter groups, by the port's module names
HEAD_NAMES = {
    "backbone": "backbone",
    "box_network": "box_net",
    "object_encoder": "object_encoder",
    "z_network": "z_net",
    "obj_network": "obj_net",
    "object_decoder": "object_decoder",
    "virtual_edge_element": "edge",
    "self_attn": "self_attn",
}


def grad_norms_by_head(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{'grad_norm/<head>': global norm of that group's gradients}, keyed
    by the JAX package's group names so the logged tags match. Parameters
    without a gradient count as zero. Stays on the device."""
    sq = {}
    for name, p in model.named_parameters():
        head = HEAD_NAMES[name.split(".")[0]]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        sq[head] = sq.get(head, 0.0) + torch.sum(torch.square(g.float()))
    return {f"grad_norm/{head}": torch.sqrt(v) for head, v in sq.items()}
