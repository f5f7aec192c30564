"""Quaternion algebra (real-first, wxyz convention) in PyTorch.

Counterpart of moda_tpu/core/quat.py. All functions broadcast over
leading dims.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def safe_norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a zero-safe gradient: sqrt(max(sum(x^2), eps^2)) takes
    the constant branch at exactly 0, so the gradient there is 0, not NaN."""
    sq = (x * x).sum(dim=axis, keepdim=keepdims)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def q_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return q / torch.clamp(safe_norm(q, keepdims=True), min=eps)


def q_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1*q2 for [..., 4] real-first quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([w, x, y, z], -1)


def q_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def q_invert(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    sq = (q * q).sum(-1, keepdim=True)
    return q_conjugate(q) / torch.clamp(sq, min=eps)


def q_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by unit quaternion(s) q [..., 4]."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv + qw * v)
    return v + 2.0 * uuv


def q_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / torch.clamp((q * q).sum(-1), min=_EPS)
    m = torch.stack([
        1 - two_s * (y * y + z * z),
        two_s * (x * y - z * w),
        two_s * (x * z + y * w),
        two_s * (x * y + z * w),
        1 - two_s * (x * x + z * z),
        two_s * (y * z - x * w),
        two_s * (x * z - y * w),
        two_s * (y * z + x * w),
        1 - two_s * (x * x + y * y),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_q(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (4-branch)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qabs_sq = torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1)
    qabs = torch.sqrt(torch.clamp(qabs_sq, min=0.0))
    cand_w = torch.stack([qabs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1)
    cand_x = torch.stack([m21 - m12, qabs[..., 1] ** 2, m10 + m01, m02 + m20], -1)
    cand_y = torch.stack([m02 - m20, m10 + m01, qabs[..., 2] ** 2, m12 + m21], -1)
    cand_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, qabs[..., 3] ** 2], -1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)  # [...,4cand,4]
    denom = 2.0 * torch.clamp(qabs, min=0.1 * _EPS ** 0.5)
    cands = cands / denom[..., :, None]
    best = torch.argmax(qabs_sq, -1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q_normalize(q)


def axis_angle_to_q(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion [..., 4], Taylor-guarded at 0."""
    angle = safe_norm(aa, keepdims=True)
    half = 0.5 * angle
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - angle ** 2 / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), aa * sin_half_over_angle], -1)


def so3_exp(aa: torch.Tensor) -> torch.Tensor:
    return q_to_matrix(axis_angle_to_q(aa))


def rot_angle(m: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos)

