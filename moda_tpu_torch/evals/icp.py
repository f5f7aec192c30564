"""Point-cloud ICP alignment in plain PyTorch: counterpart of
moda_tpu/evals/icp.py (the reference's pytorch3d
iterative_closest_point, scripts/visualize/render_vis.py:390)."""
from __future__ import annotations

import torch

from moda_tpu_torch.ops.chamfer import _min_dist_sq


def _procrustes(x: torch.Tensor, y: torch.Tensor):
    """Best-fit rigid transform mapping x -> y (Kabsch/Umeyama, no scale)."""
    mx = x.mean(0)
    my = y.mean(0)
    H = (x - mx).T @ (y - my)
    if not bool(torch.isfinite(H).all()):
        # an empty mesh's points are NaN (its centre is the mean of no
        # vertex): the transform is NaN, as LAPACK's SVD gives it in the JAX
        # package, where torch's SVD would raise
        R = torch.full_like(H, float("nan"))
        return R, my - R @ mx
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    return R, my - R @ mx


def icp_align(src: torch.Tensor, dst: torch.Tensor, iters: int = 20):
    """Iteratively align src [N,3] to dst [M,3]. Returns (R, t) with
    aligned = src @ R.T + t."""
    R = torch.eye(3, dtype=src.dtype, device=src.device)
    t = torch.zeros(3, dtype=src.dtype, device=src.device)
    for _ in range(iters):
        cur = src @ R.T + t
        _, idx = _min_dist_sq(cur, dst)
        dR, dt = _procrustes(cur, dst[idx])
        R, t = dR @ R, dR @ t + dt
    return R, t
