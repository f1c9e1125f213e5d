"""Parameters and optimizer state carried over from the JAX package,
without jax.

``state_dict_from_jax`` maps the JAX parameter pytree (as numpy arrays) to
the reference state_dict layout, exactly as ``spair_pytorch_tpu/utils/
interop.py::to_torch_state_dict`` does: conv kernels HWIO -> OIHW, linear
weights (in, out) -> (out, in). The port's modules carry those names, so
the result loads with ``load_state_dict(strict=True)``. ``adam_state_from_
jax`` maps optax's Adam moments through the same transposes onto torch
Adam's per-parameter state.

Two option groups have no reference names, and the JAX converter covers
neither; the port names them (``ops/convcodec.py`` states its names):
the conv codec (``cfg.object_codec='conv'``) as ``object_encoder.convs.<i>``
(HWIO -> OIHW), ``object_encoder.out``, ``object_decoder.inp`` and
``object_decoder.deconvs.<i>``, whose transposed-conv kernels go HWIO ->
(in, out, kh, kw) flipped in both spatial axes (the JAX transposed conv
does not flip its kernel, ``F.conv_transpose2d`` does); and the vestigial
self-attention (``cfg.vestigial_self_attn``) as ``self_attn.query.out``,
``self_attn.key.out``, ``self_attn.value.out`` and ``self_attn.gamma``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_MLPS = (  # (state_dict name, JAX name, multi-head?)
    ("box_network", "box_net", True),
    ("object_encoder", "object_encoder", False),
    ("z_network", "z_net", True),
    ("obj_network", "obj_net", False),
    ("object_decoder", "object_decoder", False),
)


def _linear(prefix: str, layer, out: Dict[str, np.ndarray]):
    out[f"{prefix}.weight"] = np.asarray(layer["w"]).T.copy()
    out[f"{prefix}.bias"] = np.asarray(layer["b"]).copy()


def _conv(prefix: str, layer, out: Dict[str, np.ndarray]):
    out[f"{prefix}.weight"] = np.asarray(layer["w"]).transpose(
        3, 2, 0, 1).copy()
    out[f"{prefix}.bias"] = np.asarray(layer["b"]).copy()


def _conv_transpose(prefix: str, layer, out: Dict[str, np.ndarray]):
    w = np.flip(np.asarray(layer["w"]), (0, 1))        # (k, k, in, out)
    out[f"{prefix}.weight"] = w.transpose(2, 3, 0, 1).copy()
    out[f"{prefix}.bias"] = np.asarray(layer["b"]).copy()


def _conv_codec(sd_name: str, p, out: Dict[str, np.ndarray]):
    for i, layer in enumerate(p.get("convs", ())):
        _conv(f"{sd_name}.convs.{i}", layer, out)
    for i, layer in enumerate(p.get("deconvs", ())):
        _conv_transpose(f"{sd_name}.deconvs.{i}", layer, out)
    for name in ("out", "inp"):
        if name in p:
            _linear(f"{sd_name}.{name}", p[name], out)


def state_dict_from_jax(params_np) -> Dict[str, np.ndarray]:
    """JAX param pytree (numpy leaves) -> {state_dict key: numpy array}."""
    out: Dict[str, np.ndarray] = {}
    layers = params_np["backbone"]["layers"]
    for i, layer in enumerate(layers):
        name = f"conv_{i}" if i < len(layers) - 1 else "conv_out"
        _conv(f"backbone.net.{name}", layer, out)
    for sd_name, jax_name, multi in _MLPS:
        p = params_np[jax_name]
        if "trunk" not in p:  # the conv codec's encoder or decoder
            _conv_codec(sd_name, p, out)
            continue
        body = f"{sd_name}.body" if multi else sd_name
        for i, layer in enumerate(p["trunk"]):
            _linear(f"{body}.dense{i}", layer, out)
        if multi:
            for j, head in enumerate(p["heads"]):
                _linear(f"{sd_name}.output_layers.{j}", head, out)
        else:
            _linear(f"{sd_name}.out", p["heads"][0], out)
    out["virtual_edge_element"] = np.asarray(params_np["edge"]).copy()
    if "self_attn" in params_np:
        attn = params_np["self_attn"]
        for name in ("query", "key", "value"):
            _linear(f"self_attn.{name}.out", attn[name]["heads"][0], out)
        out["self_attn.gamma"] = np.asarray(attn["gamma"]).copy()
    return out


def load_jax_params(model: torch.nn.Module, params_np) -> torch.nn.Module:
    """Copy JAX parameters (numpy leaves) into ``model``, strictly."""
    sd = {k: torch.from_numpy(v) for k, v in
          state_dict_from_jax(params_np).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _find_adam_state(tree):
    """The ScaleByAdamState (count, mu, nu) inside an optax state tree."""
    if all(hasattr(tree, f) for f in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state_np, model: torch.nn.Module):
    """optax Adam state (numpy leaves, alone or inside a chain) -> the
    ``state`` entry of torch Adam's state_dict for an optimizer over
    ``model.parameters()``: {index: {step, exp_avg, exp_avg_sq}}."""
    adam = _find_adam_state(opt_state_np)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState in the given state")
    mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {i: {"step": step.clone(),
                "exp_avg": torch.from_numpy(mu[name]).to(p.device),
                "exp_avg_sq": torch.from_numpy(nu[name]).to(p.device)}
            for i, (name, p) in enumerate(model.named_parameters())}


def load_jax_adam_state(optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, opt_state_np):
    """Load optax Adam moments into a torch Adam over ``model``."""
    sd = optimizer.state_dict()
    sd["state"] = adam_state_from_jax(opt_state_np, model)
    optimizer.load_state_dict(sd)
    return optimizer
