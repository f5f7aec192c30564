"""Pose CNN: image-space 16-ch CSE features -> global SE(3). The port of
moda_tpu/fields/cnn.py (the TPU-native stand-in for the reference's
torchvision ResNet18 encoder + RTHead, nerf.py:513-556, moda.py:358-373),
trained from scratch on rasterized CSE-feature renderings, with GroupNorm
instead of BatchNorm.

The modules keep Flax's semantics and parameter names, so
``bridge.load_params`` / ``bridge.export_params`` move weights between
the packages by name:
- convolutions pad as Flax's ``padding="SAME"``: asymmetric under stride 2
  (on even sizes (0, 1) for 3x3, (2, 3) for 7x7), not torch's k // 2;
- the stem's max pool pads its SAME border with -inf;
- GroupNorm's epsilon is Flax's 1e-6, not torch's 1e-5;
- kernels start as Flax's lecun_normal (truncated normal, fan-in) and every
  bias at zero, the head's included.
``PoseCNN`` takes NHWC features [N, H, W, 16], as the JAX module does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from moda_tpu_torch.core import quat as Q

GN_EPS = 1e-6  # flax.linen.GroupNorm's epsilon
GN_GROUPS = 8


def same_pads(size: int, k: int, stride: int):
    """Flax/XLA "SAME" padding (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = (same_pads(x.shape[-2], k, stride), same_pads(x.shape[-1], k, stride))
    return F.pad(x, (l, r, t, b), value=value)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    # jax.nn.initializers.lecun_normal: truncated normal at +-2 std, with
    # the std corrected for the truncation
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty_like(w), std=std, a=-2 * std, b=2 * std,
                                            generator=generator))


class SameConv(nn.Conv2d):
    """Conv2d with Flax's SAME padding and initializers."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, k, stride=stride, padding=0)
        _lecun_normal_(self.weight, cin * k * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return super().forward(_pad_same(x, self.kernel_size[0], self.stride[0]))


def _dense(cin: int, cout: int, generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    _lecun_normal_(lin.weight, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, c, eps=GN_EPS)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(cin, features, 3, stride, generator)
        self.GroupNorm_0 = _gn(features)
        self.Conv_1 = SameConv(features, features, 3, 1, generator)
        self.GroupNorm_1 = _gn(features)
        self.Conv_2 = (SameConv(cin, features, 1, stride, generator)
                       if cin != features or stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + y)


class PoseEncoder(nn.Module):
    """[N, C, H, W] feature crops -> [N, out_dim] code."""

    def __init__(self, in_ch: int = 16, out_dim: int = 128,
                 widths: Sequence[int] = (64, 64, 128, 256, 512),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, widths[0], 7, 2, generator)
        self.GroupNorm_0 = _gn(widths[0])
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"ConvBlock_{i}", ConvBlock(a, b, 2, generator))
        self.n_blocks = len(widths) - 1
        self.Conv_1 = SameConv(widths[-1], 128, 3, 1, generator)
        self.GroupNorm_1 = _gn(128)
        self.Dense_0 = _dense(128, out_dim, generator)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"ConvBlock_{i}")(x)
        x = F.leaky_relu(self.GroupNorm_1(self.Conv_1(x)), 0.2)
        return self.Dense_0(x.mean(dim=(2, 3)))  # global pool


class PoseCNN(nn.Module):
    """Encoder + quaternion/translation head (RTHead D=1 equivalent):
    [N, H, W, 16] -> [N, 12] (row-major rotation, translation)."""

    def __init__(self, in_ch: int = 16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = PoseEncoder(in_ch, generator=generator)
        self.Dense_0 = _dense(128, 128, generator)
        self.head = _dense(128, 7, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        code = self.encoder(feats.permute(0, 3, 1, 2))
        out = self.head(F.relu(self.Dense_0(code)))
        tmat = out[..., 0:3] * 0.1
        rquat = Q.q_normalize(out[..., 3:7] + out.new_tensor([1.0, 0, 0, 0]))
        rmat = Q.q_to_matrix(rquat)
        return torch.cat([rmat.reshape(out.shape[:-1] + (9,)), tmat], -1)
