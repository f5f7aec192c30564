"""Parameters between the JAX package and the port.

The JAX parameter pytree (``MoDAModel.init``) and its checkpoint layout
(``/``-joined keys, moda_tpu/train/ckpt.py) name every leaf the way the
port's ``named_parameters()`` does with "." for "/", and Dense kernels are
[in, out] on both sides, so no leaf is transposed. Arrays cross as numpy.

The conv nets (the pose CNN of fields/cnn.py, the CSE net of
fields/cse.py) are torch modules: their Flax parameters move by name too,
with conv kernels HWIO <-> OIHW, Dense kernels transposed and GroupNorm
scale <-> weight, whether alone or inside ``MoDAModel`` (``csenet``). The
reference posenet (preproc/posenet.py) moves the same way:
``posenet_from_jax`` builds it from the JAX package's converted parameters.
VCN+ (preproc/vcn_flow.py) is functional on both sides, with torch's conv
layouts in the JAX tree too: ``vcn_from_jax`` turns each leaf into a tensor.
The detectron2 preprocessing graphs move by name as well:
``resnet_fpn_from_jax`` (the ResNet-50 + FPN backbone), ``cse_from_jax``
(backbone + CSE head, whose ConvTranspose crosses as the JAX head's
spatially flipped ``predictor_kernel``) and ``pointrend_from_jax``
(backbone, RPN, box, coarse and point heads; the box and coarse ``fc1``
rows go from the JAX tree's HWC flatten back to torch's CHW).
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


def _leaves(module: torch.nn.Module):
    """(JAX key, torch parameter, layout) of every parameter of ``module``.
    Parameters of the port's own modules (``nets.Dense``, tables) keep the
    JAX name and layout; torch conv nets (fields/cnn.py, fields/cse.py) map
    Conv kernels HWIO <-> OIHW ("conv"), Linear kernels [in, out] <->
    [out, in] ("dense") and GroupNorm scale <-> weight; a conv without a
    bias has none on either side. A ConvTranspose2d ``m`` is the JAX CSE
    head's input-dilated conv, with its parameters beside the module's:
    ``m_kernel`` [kh, kw, I, O] spatially flipped <-> [I, O, kh, kw]
    ("deconv") and ``m_bias``."""
    for mname, mod in module.named_modules():
        prefix = mname.replace(".", "/") + "/" if mname else ""
        if isinstance(mod, torch.nn.ConvTranspose2d):
            yield prefix[:-1] + "_kernel", mod.weight, "deconv"
            yield prefix[:-1] + "_bias", mod.bias, None
            continue
        if isinstance(mod, torch.nn.Conv2d):
            yield prefix + "kernel", mod.weight, "conv"
        elif isinstance(mod, torch.nn.Linear):
            yield prefix + "kernel", mod.weight, "dense"
        elif isinstance(mod, torch.nn.GroupNorm):
            yield prefix + "scale", mod.weight, None
        else:
            for n, p in mod.named_parameters(recurse=False):
                yield prefix + n, p, None
            continue
        if mod.bias is not None:
            yield prefix + "bias", mod.bias, None


def load_params(model: torch.nn.Module, params: Mapping[str, Any], strict: bool = True):
    """Copy a JAX parameter tree (nested or "/"-flattened) into ``model``.
    strict: every parameter of the model must be present with its shape."""
    flat = flatten(params)
    with torch.no_grad():
        for key, p, layout in _leaves(model):
            if key not in flat:
                if strict:
                    raise KeyError(f"{key} missing from the JAX parameters")
                continue
            v = np.asarray(flat[key])
            if layout == "conv":
                v = v.transpose(3, 2, 0, 1)
            elif layout == "dense":
                v = v.T
            elif layout == "deconv":
                v = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{key}: JAX shape {v.shape} != port shape {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(v), dtype=p.dtype))


def export_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's nested numpy tree."""
    flat = {}
    for key, p, layout in _leaves(model):
        v = p.detach().cpu().numpy()
        if layout == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif layout == "dense":
            v = v.T
        elif layout == "deconv":
            v = v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        flat[key] = np.ascontiguousarray(v)
    return unflatten(flat)


def posenet_from_jax(params: Mapping[str, Any], device="cpu"):
    """The port's RefPoseNet, in eval mode on ``device``, holding the JAX
    package's RefPoseNet parameters (``moda_tpu.preproc.posenet.
    convert_posenet_checkpoint``'s tree, as numpy)."""
    from moda_tpu_torch.preproc.posenet import RefPoseNet

    net = RefPoseNet()
    load_params(net, params)
    return net.eval().to(device)


def vcn_from_jax(params: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """The JAX package's VCN+ parameter tree (``moda_tpu.preproc.vcn_flow.
    convert_vcn_checkpoint``'s, as numpy) with float32 tensors on ``device``
    for leaves, as ``moda_tpu_torch.preproc.vcn_flow`` takes them."""
    return unflatten({k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in flatten(params).items()})


def resnet_fpn_from_jax(params: Mapping[str, Any], device="cpu"):
    """The port's ResNetFPN, in eval mode on ``device``, holding the JAX
    package's tree (``convert_resnet50_fpn``'s, as numpy)."""
    from moda_tpu_torch.fields.resnet_fpn import ResNetFPN

    net = ResNetFPN()
    load_params(net, params)
    return net.eval().to(device)


def cse_from_jax(params: Mapping[str, Any], device="cpu"):
    """cse.npz's {backbone, head} trees -> (ResNetFPN, CSEHead) in eval mode
    on ``device``; the head's depth and widths are read from its tree."""
    from moda_tpu_torch.preproc.cse_infer import CSEHead

    hp = params["head"]
    n_convs = sum(1 for k in hp if k.startswith("conv"))
    k1 = np.asarray(hp["conv1"]["kernel"])
    head = CSEHead(n_convs, hidden=k1.shape[3], embed_dim=np.asarray(hp["predictor_bias"]).size,
                   cin=k1.shape[2])
    load_params(head, hp)
    return resnet_fpn_from_jax(params["backbone"], device), head.eval().to(device)


def pointrend_from_jax(params: Mapping[str, Any], device="cpu"):
    """pointrend.npz's tree -> the port's PointRendNet (backbone, rpn,
    box_head, coarse, point) in eval mode on ``device``; the class count and
    head widths are read from the tree."""
    from moda_tpu_torch.preproc.pointrend_infer import PointRendNet, chw_rows

    tree = unflatten(flatten(params))
    for head in ("box_head", "coarse"):
        tree[head]["fc1"]["kernel"] = chw_rows(tree[head]["fc1"]["kernel"])
    point = tree["point"]
    net = PointRendNet(num_classes=np.asarray(point["predictor"]["bias"]).size,
                       fc_dim=np.asarray(tree["box_head"]["fc2"]["bias"]).size,
                       point_dim=np.asarray(point["fc1"]["bias"]).size,
                       point_fc=sum(1 for k in point if k.startswith("fc")))
    load_params(net, tree)
    return net.eval().to(device)


def load_mvars(model, mvars) -> None:
    """Copy the JAX ModelVars (any object with the same field names, or a
    dict) into ``model.mvars``."""
    for f in ("near_far", "alpha", "obj_bound", "vis_min", "vis_len", "beta_is_active"):
        v = mvars[f] if isinstance(mvars, Mapping) else getattr(mvars, f)
        setattr(model.mvars, f, torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                                device=model.device))
