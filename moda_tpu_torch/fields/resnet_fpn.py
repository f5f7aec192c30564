"""The ResNet-50 + FPN backbone of the detectron2 preprocessing models
(PointRend, DensePose-CSE): counterpart of moda_tpu/fields/resnet_fpn.py.

The inference graph in NCHW, with detectron2's structural choices, as the
JAX package has them:

- ``FrozenBN``, the inference affine standing in for BatchNorm (y = x *
  scale + bias, scale = gamma / sqrt(var + eps), folded by the converter);
- stride 2 on the 3x3 conv of a bottleneck (torchvision/d2 style), with
  torch's symmetric padding;
- the stem's 3x3 max-pool pads by 1 (with -inf, as Flax's does);
- FPN: 1x1 laterals and 3x3 output convs, levels p2..p5. The top-down path
  repeats each pixel 2x2 and crops to the lateral's size (``_up2``), as
  the JAX package does; that is not ``F.interpolate(size=...)``, which
  picks other rows where a size is odd (4 -> 6: rows 0,0,1,2,2,3 against
  repeat-and-crop's 0,0,1,1,2,2).

Every convolution is ``F.conv2d`` (cuDNN on the card), as the JAX package
runs them through XLA; no Pallas kernel lies on this path. Modules carry
the JAX module's names, so ``bridge.load_params`` fills them from the JAX
package's converted tree (``bridge.resnet_fpn_from_jax``), and
``convert_resnet50_fpn`` writes that tree, bit-equal to the JAX
package's, so an npz written by either package loads in the other. The
pretrained posenet (preproc/posenet.py) shares ``FrozenBN``, ``_fold_bn``
and ``_cv``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the std of mean-subtracted 8-bit pixels the seeded stem's BatchNorm
# normalises (a trained stem's running variance does the same)
PIXEL_STD = 64.0
STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_CHANNELS = (256, 512, 1024, 2048)
FPN_CHANNELS = 256


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


class Bottleneck(nn.Module):
    def __init__(self, cin: int, out_channels: int, stride: int = 1,
                 has_shortcut: bool = False):
        super().__init__()
        mid = out_channels // 4
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = FrozenBN(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(mid)
        self.conv3 = nn.Conv2d(mid, out_channels, 1, bias=False)
        self.bn3 = FrozenBN(out_channels)
        if has_shortcut:
            self.shortcut = nn.Conv2d(cin, out_channels, 1, stride, bias=False)
            self.shortcut_bn = FrozenBN(out_channels)
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.shortcut is None else self.shortcut_bn(self.shortcut(x))
        return F.relu(out + sc)


class ResNet50(nn.Module):
    """[N, 3, H, W] -> {res2, res3, res4, res5} (NCHW, strides 4..32)."""

    def __init__(self):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = FrozenBN(64)
        cin = 64
        for si, (nblocks, out_ch) in enumerate(zip(STAGE_BLOCKS, STAGE_CHANNELS)):
            for bi in range(nblocks):
                stride = 2 if si > 0 and bi == 0 else 1
                setattr(self, f"res{si + 2}_{bi}",
                        Bottleneck(cin, out_ch, stride, has_shortcut=bi == 0))
                cin = out_ch

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.stem_bn(self.stem_conv(x))), 3, 2, 1)
        outs = {}
        for si, nblocks in enumerate(STAGE_BLOCKS):
            for bi in range(nblocks):
                x = getattr(self, f"res{si + 2}_{bi}")(x)
            outs[f"res{si + 2}"] = x
        return outs


def _up2(x, like):
    """Each pixel repeated 2x2, cropped to ``like``'s height and width."""
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, :like.shape[2], :like.shape[3]]


class FPN(nn.Module):
    def __init__(self, out_channels: int = FPN_CHANNELS):
        super().__init__()
        for lvl, cin in zip((2, 3, 4, 5), STAGE_CHANNELS):
            setattr(self, f"lateral_res{lvl}", nn.Conv2d(cin, out_channels, 1))
            setattr(self, f"output_p{lvl}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, feats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        prev = self.lateral_res5(feats["res5"])
        out = {"p5": self.output_p5(prev)}
        for lvl in (4, 3, 2):
            lat = getattr(self, f"lateral_res{lvl}")(feats[f"res{lvl}"])
            prev = lat + _up2(prev, lat)
            out[f"p{lvl}"] = getattr(self, f"output_p{lvl}")(prev)
        return out


class ResNetFPN(nn.Module):
    """[N, 3, H, W] -> {p2, p3, p4, p5}, 256 channels each."""

    def __init__(self):
        super().__init__()
        self.bottom_up = ResNet50()
        self.fpn = FPN()

    def forward(self, x):
        return self.fpn(self.bottom_up(x))


# ----------------------------------------------------------------- converter
def _cv(w) -> torch.Tensor:
    """A torch checkpoint's conv weight [O, I, kh, kw] as the port's float32
    kernel. torch's layout is the port's own, so nothing moves (the JAX
    package's ``_cv`` transposes it to Flax's [kh, kw, I, O])."""
    return torch.as_tensor(np.ascontiguousarray(w), dtype=torch.float32)


def _hwio(w: np.ndarray) -> np.ndarray:
    """torch conv weight [O, I, kh, kw] -> the JAX tree's Flax [kh, kw, I, O]
    (moda_tpu's ``_cv``)."""
    return np.transpose(w, (2, 3, 1, 0))


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


def convert_resnet50_fpn(sd: Mapping[str, np.ndarray], prefix: str = "backbone.") -> Dict:
    """A detectron2 state dict (numpy values; keys ``backbone.bottom_up.
    stem.conv1.*``, ``backbone.bottom_up.res{2..5}.{i}.conv{1..3}.*`` with
    ``.norm``, ``backbone.fpn_lateral{2..5}.*``, ``backbone.fpn_output
    {2..5}.*``) -> the JAX package's ResNetFPN tree (Flax kernels [kh, kw,
    I, O], BatchNorm folded), bit-equal to moda_tpu's converter. A missing
    key raises KeyError."""
    bu = prefix + "bottom_up."
    s, b = _fold_bn(sd, bu + "stem.conv1.norm")
    p: Dict = {"stem_conv": {"kernel": _hwio(sd[bu + "stem.conv1.weight"])},
               "stem_bn": {"scale": s, "bias": b}}
    for si, nblocks in enumerate(STAGE_BLOCKS):
        res = f"res{si + 2}"
        for bi in range(nblocks):
            d2b = f"{bu}{res}.{bi}."
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = {"kernel": _hwio(sd[d2b + f"conv{ci}.weight"])}
                s, b = _fold_bn(sd, d2b + f"conv{ci}.norm")
                blk[f"bn{ci}"] = {"scale": s, "bias": b}
            if bi == 0:
                blk["shortcut"] = {"kernel": _hwio(sd[d2b + "shortcut.weight"])}
                s, b = _fold_bn(sd, d2b + "shortcut.norm")
                blk["shortcut_bn"] = {"scale": s, "bias": b}
            p[f"{res}_{bi}"] = blk
    f: Dict = {}
    for lvl in (2, 3, 4, 5):
        for kind, name in (("lateral", f"lateral_res{lvl}"), ("output", f"output_p{lvl}")):
            f[name] = {"kernel": _hwio(sd[f"{prefix}fpn_{kind}{lvl}.weight"]),
                       "bias": sd[f"{prefix}fpn_{kind}{lvl}.bias"].astype(np.float32)}
    return {"bottom_up": p, "fpn": f}


# ------------------------------------------------- seeded reference weights
def reference_backbone_sd(rng: np.random.Generator, prefix: str = "backbone.") -> Dict:
    """A detectron2 R50-FPN state dict at the published widths with seeded
    random weights: convolutions normal with std 1/sqrt(fan_in), FPN biases
    and BatchNorm shifts small, BatchNorm scales and variances in [0.5,
    1.5), so folding is exercised (the draws of tests/test_cse_infer.py,
    from ``rng``). The stem's running variance is also scaled by
    PIXEL_STD^2, as a trained one holds the variance of convolved pixels:
    the FPN levels then read a few units, not hundreds, and the heads on
    them stay out of saturation."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name, o, i, k, bias=False):
        sd[name + ".weight"] = (rng.standard_normal((o, i, k, k))
                                / np.sqrt(i * k * k)).astype(np.float32)
        if bias:
            sd[name + ".bias"] = (rng.standard_normal(o) * 0.1).astype(np.float32)

    def bn(name, c, var=1.0):
        sd[name + ".weight"] = (rng.random(c) + 0.5).astype(np.float32)
        sd[name + ".bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        sd[name + ".running_mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        sd[name + ".running_var"] = ((rng.random(c) + 0.5) * var).astype(np.float32)

    bu = prefix + "bottom_up."
    conv(bu + "stem.conv1", 64, 3, 7)
    bn(bu + "stem.conv1.norm", 64, var=PIXEL_STD ** 2)
    cin = 64
    for si, (nblocks, out_c) in enumerate(zip(STAGE_BLOCKS, STAGE_CHANNELS)):
        mid = out_c // 4
        for bi in range(nblocks):
            p = f"{bu}res{si + 2}.{bi}."
            c = cin if bi == 0 else out_c
            for ci, (o, i, k) in enumerate(((mid, c, 1), (mid, mid, 3), (out_c, mid, 1))):
                conv(p + f"conv{ci + 1}", o, i, k)
                bn(p + f"conv{ci + 1}.norm", o)
            if bi == 0:
                conv(p + "shortcut", out_c, c, 1)
                bn(p + "shortcut.norm", out_c)
        cin = out_c
    for lvl, c in zip((2, 3, 4, 5), STAGE_CHANNELS):
        conv(f"{prefix}fpn_lateral{lvl}", FPN_CHANNELS, c, 1, bias=True)
        conv(f"{prefix}fpn_output{lvl}", FPN_CHANNELS, FPN_CHANNELS, 3, bias=True)
    return sd
