"""CSE surface-embedding network: image crop -> per-pixel 16-d unit
embedding. The port of moda_tpu/fields/cse.py, the trainable net of the
``ft_cse`` branch and of ``train/cse_distill.py``: an encoder-decoder
convnet, [N, H, W, 3] -> [N, H/2, W/2, 16] (NHWC in and out, as the JAX
module).

It keeps Flax's conv semantics and parameter names through the modules of
``fields/cnn.py`` (asymmetric SAME padding, GroupNorm eps 1e-6, lecun-normal
kernels, zero biases), so ``bridge.load_params`` / ``bridge.export_params``
move its weights by name. The decoder's nearest x2 upsampling is
``jnp.repeat`` on both spatial axes there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from moda_tpu_torch.fields.cnn import SameConv, _gn


class DownBlock(nn.Module):
    def __init__(self, cin: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(cin, features, 3, 2, generator)
        self.GroupNorm_0 = _gn(features)
        self.Conv_1 = SameConv(features, features, 3, 1, generator)
        self.GroupNorm_1 = _gn(features)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class UpBlock(nn.Module):
    def __init__(self, cin: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(cin, features, 3, 1, generator)
        self.GroupNorm_0 = _gn(features)

    def forward(self, x, skip):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.relu(self.GroupNorm_0(self.Conv_0(torch.cat([x, skip], 1))))


class CSENet(nn.Module):
    def __init__(self, embed_dim: int = 16, widths: Sequence[int] = (32, 64, 128, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(3, widths[0], 7, 1, generator)
        self.GroupNorm_0 = _gn(widths[0])
        cin = widths[0]
        for i, w in enumerate(widths):
            setattr(self, f"DownBlock_{i}", DownBlock(cin, w, generator))
            cin = w
        # a skip's width: the stem's for the shallowest, else the DownBlock's
        skip_w = [widths[0]] + list(widths[:-1])
        self.n_up = len(widths) - 1
        for i, w in enumerate(reversed(widths[:-1])):
            setattr(self, f"UpBlock_{i}", UpBlock(cin + skip_w[self.n_up - i], w, generator))
            cin = w
        self.Conv_1 = SameConv(cin, embed_dim, 1, 1, generator)
        self.n_down = len(widths)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(img.permute(0, 3, 1, 2))))
        skips = [x]
        for i in range(self.n_down):
            x = getattr(self, f"DownBlock_{i}")(x)
            skips.append(x)
        skips.pop()  # the deepest level has no skip
        for i in range(self.n_up):
            x = getattr(self, f"UpBlock_{i}")(x, skips.pop())
        feat = self.Conv_1(x)
        norm = torch.sqrt(torch.clamp((feat * feat).sum(1, keepdim=True), min=1e-12))
        return (feat / norm).permute(0, 2, 3, 1)
