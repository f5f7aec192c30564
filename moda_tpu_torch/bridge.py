"""Parameters between the JAX package and the port.

The JAX parameter pytree (``MoDAModel.init``) and its checkpoint layout
(``/``-joined keys, moda_tpu/train/ckpt.py) name every leaf the way the
port's ``named_parameters()`` does with "." for "/", and Dense kernels are
[in, out] on both sides, so no leaf is transposed. Arrays cross as numpy.

The pose CNN (fields/cnn.py) is a torch conv net: ``load_pose_cnn`` and
``export_pose_cnn`` move its Flax parameters by name, with conv kernels
HWIO <-> OIHW, Dense kernels transposed and GroupNorm scale <-> weight.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": numpy array} (the checkpoint npz layout)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params(model: torch.nn.Module, params: Mapping[str, Any], strict: bool = True):
    """Copy a JAX parameter tree (nested or "/"-flattened) into ``model``.
    strict: every parameter of the model must be present with its shape."""
    flat = flatten(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            if key not in flat:
                if strict:
                    raise KeyError(f"{key} missing from the JAX parameters")
                continue
            v = flat[key]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{key}: JAX shape {v.shape} != port shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(v), dtype=p.dtype))


def export_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's nested numpy tree."""
    return unflatten({n.replace(".", "/"): p.detach().cpu().numpy()
                      for n, p in model.named_parameters()})


def load_mvars(model, mvars) -> None:
    """Copy the JAX ModelVars (any object with the same field names, or a
    dict) into ``model.mvars``."""
    for f in ("near_far", "alpha", "obj_bound", "vis_min", "vis_len", "beta_is_active"):
        v = mvars[f] if isinstance(mvars, Mapping) else getattr(mvars, f)
        setattr(model.mvars, f, torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                                device=model.device))


def _pose_cnn_leaves(module: torch.nn.Module):
    """(JAX key, torch parameter, layout) of every leaf of a
    fields/cnn.py module: Conv kernels HWIO <-> OIHW ("conv"), Dense kernels
    [in, out] <-> [out, in] ("dense"), GroupNorm scale <-> weight."""
    for mname, mod in module.named_modules():
        prefix = mname.replace(".", "/") + "/" if mname else ""
        if isinstance(mod, torch.nn.Conv2d):
            yield prefix + "kernel", mod.weight, "conv"
        elif isinstance(mod, torch.nn.Linear):
            yield prefix + "kernel", mod.weight, "dense"
        elif isinstance(mod, torch.nn.GroupNorm):
            yield prefix + "scale", mod.weight, None
        else:
            continue
        yield prefix + "bias", mod.bias, None


def load_pose_cnn(module: torch.nn.Module, params: Mapping[str, Any]):
    """Copy the JAX PoseCNN's parameter tree (nested or "/"-flattened) into
    ``module`` (fields/cnn.py); every leaf must be present with its shape."""
    flat = flatten(params)
    with torch.no_grad():
        for key, p, layout in _pose_cnn_leaves(module):
            v = np.asarray(flat[key])
            if layout == "conv":
                v = v.transpose(3, 2, 0, 1)
            elif layout == "dense":
                v = v.T
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{key}: JAX shape {v.shape} != port shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(v), dtype=p.dtype))


def export_pose_cnn(module: torch.nn.Module) -> Dict[str, Any]:
    """The PoseCNN's parameters as the JAX package's nested numpy tree."""
    flat = {}
    for key, p, layout in _pose_cnn_leaves(module):
        v = p.detach().cpu().numpy()
        if layout == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif layout == "dense":
            v = v.T
        flat[key] = np.ascontiguousarray(v)
    return unflatten(flat)
