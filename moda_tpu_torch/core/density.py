"""SDF -> density -> alpha compositing (VolSDF) in PyTorch.

Counterpart of moda_tpu/core/density.py.
"""
from __future__ import annotations

import torch


def sdf_to_sigma(raw_sigma: torch.Tensor, beta: torch.Tensor,
                 beta_min=2e-3) -> torch.Tensor:
    """sdf = -raw; sigma = ib*(0.5 + 0.5*sign(sdf)*expm1(-|sdf|*ib)),
    ib = 1/max(|beta|, beta_min) (the floor keeps the density transition
    wider than the sample spacing)."""
    ibeta = 1.0 / torch.maximum(torch.abs(beta), torch.as_tensor(beta_min, dtype=beta.dtype,
                                                                  device=beta.device))
    sdf = -raw_sigma
    sigma = 0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) * ibeta)
    return sigma * ibeta


def ray_deltas(z_vals: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """z_vals [N, S]; dirs [N, 3] -> [N, S] (last delta 1e10)."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, 1e10 * torch.ones_like(deltas[:, :1])], -1)
    return deltas * torch.linalg.norm(dirs, dim=-1, keepdim=True)


def compositing_weights(sigmas: torch.Tensor, deltas: torch.Tensor):
    """Returns (alphas, weights, visibility) [N, S]."""
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], -1)
    alpha_prod = torch.cumprod(shifted, -1)[:, :-1]
    return alphas, alphas * alpha_prod, alpha_prod
