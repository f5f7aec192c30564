"""Bidirectional chamfer distance and F-score in plain PyTorch: counterpart
of moda_tpu/ops/chamfer.py (the reference's brute-force CUDA extension
third_party/chamfer3D and third_party/fscore.py:28-41). The all-pairs
squared distances are computed in tiles of ``tile`` points, so memory
stays bounded; ``x @ y.T`` is one matmul per tile.
"""
from __future__ import annotations

import torch


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 per row of p [N,3] (float32), summed as the JAX package's CPU
    program does: the first square, then two fused multiply-adds. The
    squared distances below cancel |x|^2 + |y|^2 against 2 x.y, so the
    rounding of these sums shows in the distances of near neighbours
    (~1e-4 relative). A float32 product is exact in float64, so each fused
    step is one rounding (a float64 tie in between is ~2^-29 rare)."""
    s = p[:, 0] * p[:, 0]
    for i in (1, 2):
        c = p[:, i].double()
        s = (c * c + s.double()).float()
    return s


def _min_dist_sq(x: torch.Tensor, y: torch.Tensor, tile: int = 4096):
    """For each x_i, min_j |x_i - y_j|^2 and its argmin (the first on ties).
    x [N,3], y [M,3] float32."""
    y_sq = _sq_norm(y)
    ds, idx = [], []
    for i in range(0, x.shape[0], tile):
        xt = x[i:i + tile]
        sq = _sq_norm(xt)[:, None] + y_sq[None, :] - 2.0 * xt @ y.T
        d, j = sq.min(-1)
        ds.append(d)
        idx.append(j)
    return torch.clamp(torch.cat(ds), min=0.0), torch.cat(idx)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, tile: int = 4096):
    """(dist_x [N], dist_y [M], idx_x [N], idx_y [M]): squared distances to
    the nearest neighbour in the other set (dist_chamfer_3D.py:69-117 for
    one batch entry)."""
    dx, ix = _min_dist_sq(x, y, tile)
    dy, iy = _min_dist_sq(y, x, tile)
    return dx, dy, ix, iy


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float):
    """(F-score, precision_1, precision_2) at a squared-distance threshold."""
    precision_1 = (dist1 < threshold).float().mean()
    precision_2 = (dist2 < threshold).float().mean()
    f = 2 * precision_1 * precision_2 / torch.clamp(precision_1 + precision_2, min=1e-9)
    return f, precision_1, precision_2
