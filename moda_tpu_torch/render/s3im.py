"""S3IM: stochastic structural similarity over shuffled virtual patches.
The port of moda_tpu/render/s3im.py: masked ray colours are tiled into a
32 x 32 virtual patch, permuted ``repeat_time`` times (the identity, then
drawn permutations), laid side by side and compared with a strided,
depthwise SSIM. Plain PyTorch: XLA convolutions in the JAX package.

The permutations are the caller's (``perms`` [repeat_time - 1, 1024]), or
drawn from ``generator``; JAX's PRNG stream cannot be reproduced.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from moda_tpu_torch.fields.cnn import same_pads


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int = 4, stride: int = 4,
          sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of [C, H, W] images: a depthwise window conv with stride,
    XLA's SAME padding (the extra row or column of an odd pad at the end)."""
    C, H, W = img1.shape
    k = torch.as_tensor(_gaussian_kernel(kernel_size, sigma), device=img1.device)
    kern = k[None, None].expand(C, 1, kernel_size, kernel_size)
    (t, b), (l, r) = same_pads(H, kernel_size, stride), same_pads(W, kernel_size, stride)

    def conv(x):
        return F.conv2d(F.pad(x[None], (l, r, t, b)), kern, stride=stride, groups=C)[0]

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return ssim_map.mean()


def s3im_loss(src: torch.Tensor, tar: torch.Tensor, mask: torch.Tensor,
              perms: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None, kernel_size: int = 4,
              stride: int = 4, repeat_time: int = 10, patch_height: int = 32,
              patch_width: int = 32) -> torch.Tensor:
    """src/tar [R, 3] ray colours, mask [R, 1]. Returns 1 - SSIM."""
    src = (src * mask).reshape(-1, 3)
    tar = (tar * mask).reshape(-1, 3)
    need = patch_height * patch_width
    reps = -(-need // src.shape[0])
    src = src.repeat(reps, 1)[:need]
    tar = tar.repeat(reps, 1)[:need]
    if perms is None:
        gdev = generator.device if generator is not None else src.device
        perms = torch.stack([torch.randperm(need, generator=generator, device=gdev)
                             for _ in range(repeat_time - 1)])
    idx = torch.cat([torch.arange(need, device=src.device), perms.to(src.device).reshape(-1)])
    src_all = src[idx].T.reshape(3, patch_height, patch_width * repeat_time)
    tar_all = tar[idx].T.reshape(3, patch_height, patch_width * repeat_time)
    return 1.0 - _ssim(src_all, tar_all, kernel_size=kernel_size, stride=stride)
