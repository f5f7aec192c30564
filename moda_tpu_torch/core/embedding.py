"""Positional (Fourier) embedding with coarse-to-fine windowing in PyTorch.

Counterpart of moda_tpu/core/embedding.py. Output layout:
[x, then for each freq j the (sin, cos) slots of all C channels], i.e.
column C + j*2C + s*C + c holds sin/cos(x_c * f_j).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def embed_dim(in_channels: int, n_freqs: int) -> int:
    return in_channels * (2 * n_freqs + 1)


def _freqs(n_freqs: int, logscale: bool) -> np.ndarray:
    if logscale:
        return 2.0 ** np.arange(n_freqs, dtype=np.float32)
    return np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs, dtype=np.float32)


def scatter_matrix(in_channels: int, n_freqs: int, logscale: bool = True) -> np.ndarray:
    """[C, F*2*C] constant with W[c, j*2C + s*C + c] = f_j: maps raw x to the
    flat (freq, sin/cos slot, channel) layout of the embedding."""
    C, F = in_channels, n_freqs
    freqs = _freqs(n_freqs, logscale)
    W = np.zeros((C, F * 2 * C), np.float32)
    j, s, c = np.meshgrid(np.arange(F), np.arange(2), np.arange(C), indexing="ij")
    W[c.ravel(), (j * 2 * C + s * C + c).ravel()] = freqs[j.ravel()]
    return W


def window_vec(n_freqs: int, in_channels: int, alpha, device=None):
    """Coarse-to-fine window as a flat [1, F*2*C] vector (None if alpha is
    None), multiplying the sin/cos block of the embedding."""
    if alpha is None:
        return None
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    window = torch.clamp(
        alpha - torch.arange(n_freqs, dtype=torch.float32, device=alpha.device), 0.0, 1.0)
    window = 0.5 * (1.0 + torch.cos(math.pi * window + math.pi))
    return window.repeat_interleave(2 * in_channels).reshape(1, -1)


def positional_embed(x: torch.Tensor, n_freqs: int, alpha=None,
                     logscale: bool = True) -> torch.Tensor:
    """Embed x [..., C] -> [..., C*(1+2*n_freqs)].

    x * f_j is exact in fp32 for the power-of-two frequencies, so this is
    bit-equal to the JAX package's scatter-matmul form."""
    if n_freqs <= 0:
        return x
    C = x.shape[-1]
    freqs = torch.as_tensor(_freqs(n_freqs, logscale), device=x.device, dtype=x.dtype)
    xf = x[..., None, :] * freqs[:, None]  # [..., F, C]
    out = torch.stack([torch.sin(xf), torch.cos(xf)], -2)  # [..., F, 2, C]
    out = out.reshape(x.shape[:-1] + (n_freqs * 2 * C,))
    win = window_vec(n_freqs, C, alpha, device=x.device)
    if win is not None:
        out = out * win.reshape(-1)
    return torch.cat([x, out], -1)
