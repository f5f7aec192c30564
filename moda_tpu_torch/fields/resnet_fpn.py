"""The frozen-BatchNorm pieces of moda_tpu/fields/resnet_fpn.py that the
pretrained posenet (preproc/posenet.py) needs: ``FrozenBN``, the inference
affine standing in for BatchNorm, and the helpers that read a torch
checkpoint into it (``_fold_bn``, ``_cv``).

The ResNet-50 + FPN backbone itself (``Bottleneck``, ``ResNet50``, ``FPN``,
``ResNetFPN``, ``convert_resnet50_fpn``) serves the preprocessing models
(PointRend, DensePose-CSE) and is ported with them, in a later slice of
moda_tpu_torch (ROADMAP.md, the preprocessing graphs).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


class FrozenBN(nn.Module):
    """Inference-time BatchNorm over NCHW: y = x * scale + bias per channel.
    ``scale`` and ``bias`` keep the JAX module's names (``bridge`` moves
    them by name) and take no gradient."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _cv(w) -> torch.Tensor:
    """A torch checkpoint's conv weight [O, I, kh, kw] as the port's float32
    kernel. torch's layout is the port's own, so nothing moves (the JAX
    package's ``_cv`` transposes it to Flax's [kh, kw, I, O])."""
    return torch.as_tensor(np.ascontiguousarray(w), dtype=torch.float32)


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str, eps: float = 1e-5):
    """A checkpoint's BatchNorm at ``prefix`` -> FrozenBN's (scale, bias) in
    numpy float32: scale = gamma / sqrt(var + eps), bias = beta - mean *
    scale; missing running statistics read as mean 0 and variance 1."""
    g = sd[prefix + ".weight"]
    b = sd[prefix + ".bias"]
    mean = sd.get(prefix + ".running_mean", np.zeros_like(g))
    var = sd.get(prefix + ".running_var", np.ones_like(g))
    scale = g / np.sqrt(var + eps)
    return scale.astype(np.float32), (b - mean * scale).astype(np.float32)
