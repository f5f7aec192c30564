"""K-means (Lloyd iterations) for the bone re-initialization
(geom_utils.py:857-903): counterpart of moda_tpu/ops/kmeans.py.

The initial centres are ``k`` distinct points, chosen by ``init_idx`` when
given (tests pass the JAX package's draw) or else drawn from
``generator``.
"""
from __future__ import annotations

from typing import Optional

import torch


def kmeans(points: torch.Tensor, k: int, iters: int = 100,
           init_idx: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """points [N,3] -> centers [k,3]. kmeans++-free: random init + Lloyd;
    an empty cluster keeps its old centre."""
    N = points.shape[0]
    if init_idx is None:
        gdev = generator.device if generator is not None else points.device
        init_idx = torch.randperm(N, generator=generator, device=gdev)[:k]
    centers = points[init_idx.to(points.device)]
    sq = (points * points).sum(-1)[:, None]
    for _ in range(iters):
        d = sq + (centers * centers).sum(-1)[None, :] - 2.0 * points @ centers.T
        assign = torch.argmin(d, -1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(points.dtype)  # [N,k]
        counts = one_hot.sum(0)
        sums = one_hot.T @ points
        new_centers = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    return centers
