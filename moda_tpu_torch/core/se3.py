"""SE(3) / rtk-vector algebra in PyTorch.

Counterpart of moda_tpu/core/se3.py: a 12-vector (r1..r9, t1..t3) per
transform, or a 3x4 / 4x4 matrix.
"""
from __future__ import annotations

import torch

from moda_tpu_torch.core import quat as Q


def rts_invert(rts: torch.Tensor) -> torch.Tensor:
    rmat = rts[..., :3, :3]
    tmat = rts[..., :3, 3:]
    rmat_i = rmat.transpose(-1, -2)
    return torch.cat([rmat_i, -rmat_i @ tmat], -1)


def vec_to_rts(rtk: torch.Tensor) -> torch.Tensor:
    rmat = rtk[..., :9].reshape(rtk.shape[:-1] + (3, 3))
    return torch.cat([rmat, rtk[..., 9:12, None]], -1)


def rts_to_vec(rts: torch.Tensor) -> torch.Tensor:
    rvec = rts[..., :3, :3].reshape(rts.shape[:-2] + (9,))
    return torch.cat([rvec, rts[..., :3, 3]], -1)


def rtk_invert(rtk: torch.Tensor) -> torch.Tensor:
    return rts_to_vec(rts_invert(vec_to_rts(rtk)))


def rtk_to_4x4(rtk: torch.Tensor) -> torch.Tensor:
    rts = vec_to_rts(rtk)
    bottom = torch.zeros(rts.shape[:-2] + (1, 4), dtype=rtk.dtype, device=rtk.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([rts, bottom], -2)


def rtk_compose(rtk1: torch.Tensor, rtk2: torch.Tensor) -> torch.Tensor:
    m = rtk_to_4x4(rtk1) @ rtk_to_4x4(rtk2)
    return rts_to_vec(m[..., :3, :])


def vec_to_sim3(vec: torch.Tensor):
    """Bone 10-vector -> (center, orient [...,3,3], scale = exp(log-scale))."""
    center = vec[..., :3]
    orient = Q.q_to_matrix(Q.q_normalize(vec[..., 3:7]))
    scale = torch.exp(vec[..., 7:10])
    return center, orient, scale


def se3_refine(rt_base: torch.Tensor, rmat_delta: torch.Tensor,
               tmat_delta: torch.Tensor) -> torch.Tensor:
    """t' = t + R dt ; R' = R dR on rows 0..2 of [..., 3/4, 4] matrices."""
    rmat = rt_base[..., :3, :3]
    tmat = rt_base[..., :3, 3] + (rmat @ tmat_delta[..., None])[..., 0]
    top = torch.cat([rmat @ rmat_delta, tmat[..., None]], -1)
    return torch.cat([top, rt_base[..., 3:, :]], -2)
