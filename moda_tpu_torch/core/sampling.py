"""Depth sampling along rays: stratified and importance (sample_pdf).

Counterpart of moda_tpu/core/sampling.py. Where the JAX code takes a PRNG
key, these take the uniform draw ``u`` itself, or a ``torch.Generator``
to draw it from.
"""
from __future__ import annotations

from typing import Optional

import torch


def stratified_zvals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                     u: Optional[torch.Tensor] = None, perturb: float = 0.0,
                     use_disp: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """near/far [N,1] -> z_vals [N, n_samples]. With perturb > 0 the depths
    are jittered inside their strata by ``u`` ([N, n_samples] in [0, 1)),
    drawn from ``generator`` when not given; with neither, no jitter."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    if perturb > 0 and u is None and generator is not None:
        u = torch.rand(z_vals.shape, generator=generator, device=z_vals.device,
                       dtype=z_vals.dtype)
    if perturb > 0 and u is not None:
        mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mid, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mid], -1)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: Optional[torch.Tensor] = None, det: bool = False,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling of n_importance depths.

    bins [N, M+1] midpoints, weights [N, M]; u [N, n_importance] uniform
    draws (ignored when det). Same masked prefix max/min lookup as the JAX
    version, so ties resolve identically."""
    n_rays = weights.shape[0]
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if det or u is None:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=bins.dtype, device=bins.device)
        u = u.expand(n_rays, n_importance)
    mask = cdf[:, None, :] <= u[:, :, None]
    neg = torch.finfo(bins.dtype).max
    big = torch.full((), neg, dtype=bins.dtype, device=bins.device)
    cdf_b = torch.where(mask, cdf[:, None, :], -big).amax(-1)
    cdf_a = torch.where(mask, big, cdf[:, None, :]).amin(-1)
    cdf_a = torch.where(cdf_a == neg, cdf[:, -1:], cdf_a)
    maskb = mask[..., : bins.shape[1]]
    bins_b = torch.where(maskb, bins[:, None, :], -big).amax(-1)
    bins_b = torch.where(bins_b == -neg, bins[:, :1], bins_b)
    bins_a = torch.where(maskb, big, bins[:, None, :]).amin(-1)
    bins_a = torch.where(bins_a == neg, bins[:, -1:], bins_a)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
