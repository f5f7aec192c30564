"""Dual-quaternion algebra (real-first; dq = [q_r(4), q_d(4)]) in PyTorch.

Counterpart of moda_tpu/core/dualquat.py.
"""
from __future__ import annotations

import torch

from moda_tpu_torch.core import quat as Q

_EPS = 1e-9


def dq_mul(dq1: torch.Tensor, dq2: torch.Tensor) -> torch.Tensor:
    r1, d1 = dq1[..., :4], dq1[..., 4:]
    r2, d2 = dq2[..., :4], dq2[..., 4:]
    r = Q.q_mul(r1, r2)
    d = Q.q_mul(r1, d2) + Q.q_mul(d1, r2)
    return torch.cat([r, d], -1)


def dq_normalize(dq: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return dq / torch.clamp(Q.safe_norm(dq[..., :4], keepdims=True), min=eps)


def dq_quaternion_conjugate(dq: torch.Tensor) -> torch.Tensor:
    return dq * dq.new_tensor([1, -1, -1, -1, 1, -1, -1, -1])


def dq_inverse(dq: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    sq = (dq[..., :4] ** 2).sum(-1, keepdim=True)
    return dq_quaternion_conjugate(dq) / torch.clamp(sq, min=eps)


def rt_to_dq(rquat: torch.Tensor, tmat: torch.Tensor) -> torch.Tensor:
    """Unit rotation quaternion + translation -> dq; dq_d = 1/2 (0,t) q_r."""
    tquat = torch.cat([torch.zeros_like(tmat[..., :1]), tmat], -1)
    dq_d = 0.5 * Q.q_mul(tquat, rquat)
    return torch.cat([rquat, dq_d], -1)


def dq_to_rt(dq: torch.Tensor):
    """dq [...,8] -> (Rmat [...,3,3], Tmat [...,3]); T = vec(2 q_d q_r^-1)."""
    dq_r, dq_d = dq[..., :4], dq[..., 4:]
    rmat = Q.q_to_matrix(dq_r)
    tquat = 2.0 * Q.q_mul(dq_d, Q.q_invert(dq_r))
    return rmat, tquat[..., 1:]


def dq_apply(dq: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply normalized dual quaternion(s) [...,8] to points [...,3]."""
    a0 = dq[..., 0:1]
    d0 = dq[..., 1:4]
    ae = dq[..., 4:5]
    de = dq[..., 5:8]
    d0, pts = torch.broadcast_tensors(d0, pts)
    trans = 2.0 * (a0 * de - ae * d0 + torch.linalg.cross(d0, de))
    rotated = pts + 2.0 * torch.linalg.cross(
        d0, torch.linalg.cross(d0, pts) + a0 * pts)
    return rotated + trans
