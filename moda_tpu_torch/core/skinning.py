"""Skinning: Gaussian-bone weights, LBS and neural dual-quaternion blend.

Counterpart of moda_tpu/core/skinning.py. Conventions:
  bones    [B, 10]  (center 3, orient quat wxyz 4, log-scale 3)
  bone_dqs [bs, B, 8]; bone_rts [bs, B, 12]; pts [bs, N, 3]; skin [bs, N, B]
"""
from __future__ import annotations

from typing import Optional

import torch

from moda_tpu_torch.core import dualquat as DQ
from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.core import se3 as SE3


def generate_bones(num_bones_x: int, num_bones: int, bound: float,
                   device=None) -> torch.Tensor:
    """Bones on a regular grid (identity orientation, unit scale)."""
    c = torch.linspace(-bound, bound, num_bones_x, device=device)
    grid = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    center = grid[:num_bones]
    if center.shape[0] < num_bones:
        center = torch.zeros((num_bones, 3), device=device)
    orient = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device).repeat(num_bones, 1)
    scale = torch.zeros((num_bones, 3), device=device)
    return torch.cat([center, orient, scale], -1)


def _broadcast_bs(x: torch.Tensor, bs: int) -> torch.Tensor:
    return x.expand((bs,) + x.shape[-2:])


def bone_transform_dq(bones: torch.Tensor, dqs: torch.Tensor) -> torch.Tensor:
    """bones [B,10] or [bs,B,10]; dqs [bs,B,8] -> moved bones [bs,B,10]."""
    if bones.dim() == 2:
        bones = bones[None]
    center, orient, scale = bones[..., :3], bones[..., 3:7], bones[..., 7:10]
    rmat, tmat = DQ.dq_to_rt(dqs)
    center = (rmat @ center[..., None])[..., 0] + tmat
    orient = Q.q_mul(dqs[..., :4], orient)
    bs = dqs.shape[0]
    return torch.cat([_broadcast_bs(center, bs), _broadcast_bs(orient, bs),
                      _broadcast_bs(scale, bs)], -1)


def bone_transform_rts(bones: torch.Tensor, rts_vec: torch.Tensor) -> torch.Tensor:
    """LBS variant: rts_vec [bs, B, 12]."""
    if bones.dim() == 2:
        bones = bones[None]
    center, orient, scale = bones[..., :3], bones[..., 3:7], bones[..., 7:10]
    rmat = rts_vec[..., :9].reshape(rts_vec.shape[:-1] + (3, 3))
    center = (rmat @ center[..., None])[..., 0] + rts_vec[..., 9:12]
    orient = Q.q_mul(Q.matrix_to_q(rmat), orient)
    bs = rts_vec.shape[0]
    return torch.cat([_broadcast_bs(center, bs), _broadcast_bs(orient, bs),
                      _broadcast_bs(scale, bs)], -1)


def skinning_weights(bones: torch.Tensor, pts: torch.Tensor,
                     dskin: Optional[torch.Tensor], log_scale: torch.Tensor) -> torch.Tensor:
    """Gaussian-bone skinning weights softmax(-1000 e^ls (p-c)^T M (p-c)
    [+ dskin]) with M = R diag(s) R^T, as one [N,10] @ [10,B] product per
    batch entry against f(p) = (p^2, cross terms, p, 1)."""
    if bones.dim() == 2:
        bones = bones[None]
    q = bones[..., 3:7]
    w, x, y, z = q.unbind(-1)
    ts = 2.0 / torch.clamp((q * q).sum(-1), min=1e-12)
    r00 = 1.0 - ts * (y * y + z * z)
    r01 = ts * (x * y - z * w)
    r02 = ts * (x * z + y * w)
    r10 = ts * (x * y + z * w)
    r11 = 1.0 - ts * (x * x + z * z)
    r12 = ts * (y * z - x * w)
    r20 = ts * (x * z - y * w)
    r21 = ts * (y * z + x * w)
    r22 = 1.0 - ts * (x * x + y * y)
    s0, s1, s2 = (torch.exp(bones[..., 7 + i]) for i in range(3))
    m00 = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    m11 = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    m22 = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    m01 = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    m02 = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    m12 = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    c0, c1, c2 = (bones[..., i] for i in range(3))
    mc0 = m00 * c0 + m01 * c1 + m02 * c2
    mc1 = m01 * c0 + m11 * c1 + m12 * c2
    mc2 = m02 * c0 + m12 * c1 + m22 * c2
    cmc = c0 * mc0 + c1 * mc1 + c2 * mc2
    G = torch.stack([m00, m11, m22, 2.0 * m01, 2.0 * m02, 2.0 * m12,
                     -2.0 * mc0, -2.0 * mc1, -2.0 * mc2, cmc], -1)  # [bs,B,10]
    f = torch.cat([pts * pts,
                   pts[..., 0:1] * pts[..., 1:2], pts[..., 0:1] * pts[..., 2:3],
                   pts[..., 1:2] * pts[..., 2:3],
                   pts, torch.ones_like(pts[..., :1])], -1)  # [bs,N,10]
    G = G.transpose(-1, -2).expand(pts.shape[0], 10, G.shape[1])
    mdis = torch.bmm(f, G)  # fp32 (TF32 off: see runtime.resolve_device)
    mdis = mdis * (-1000.0 * torch.exp(log_scale))
    if dskin is not None:
        mdis = mdis + dskin
    return torch.softmax(mdis, -1)


def lbs_blend(rts: torch.Tensor, skin: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    rmat_w = torch.einsum("bnk,bkij->bnij", skin, rts[..., :3, :3])
    tmat_w = torch.einsum("bnk,bki->bni", skin, rts[..., :3, 3])
    return (rmat_w @ pts[..., None])[..., 0] + tmat_w


def dq_blend(dqs: torch.Tensor, skin: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    weighted = torch.bmm(skin, dqs)  # [bs,N,8]
    return DQ.dq_apply(DQ.dq_normalize(weighted), pts)


def lbs(bones, rts_fw_vec, skin, pts, backward=True):
    rts_fw = SE3.vec_to_rts(rts_fw_vec)
    bones_dfm = bone_transform_rts(bones, rts_fw_vec)
    rts = SE3.rts_invert(rts_fw) if backward else rts_fw
    return lbs_blend(rts, skin, pts), bones_dfm


def neu_dbs(bones, dqs_fw, skin, pts, dis: Optional[torch.Tensor] = None, backward=True):
    """Neural dual-quaternion blend skinning; backward=True maps frame ->
    canonical. Returns (xyz [bs,N,3], bones_dfm [bs,B,10])."""
    bones_dfm = bone_transform_dq(bones, dqs_fw)
    if backward:
        xyz = dq_blend(DQ.dq_inverse(dqs_fw), skin, pts)
        if dis is not None:
            xyz = xyz - dis
    else:
        if dis is not None:
            pts = pts + dis
        xyz = dq_blend(dqs_fw, skin, pts)
    return xyz, bones_dfm


def correct_bones_dq(bones: torch.Tensor, dq_rst: torch.Tensor) -> torch.Tensor:
    """bones* = (Jb*)^-1 . bones; dq_rst [1,B,8]."""
    return bone_transform_dq(bones, DQ.dq_inverse(dq_rst))[0]


def correct_rest_pose_dq(dqs_fw: torch.Tensor, dq_rst: torch.Tensor) -> torch.Tensor:
    """delta(Jb) = (Jb*)^-1 . Jb; dqs_fw [..., B, 8], dq_rst [B,8] or [1,B,8]."""
    inv = DQ.dq_inverse(dq_rst)
    inv = inv.reshape((1,) * (dqs_fw.dim() - 2) + inv.shape[-2:]).expand(dqs_fw.shape)
    return DQ.dq_mul(inv, dqs_fw)


def correct_bones_rts(bones: torch.Tensor, rts_rst_vec: torch.Tensor) -> torch.Tensor:
    rts_inv = SE3.rtk_invert(rts_rst_vec)
    return bone_transform_rts(bones, rts_inv.reshape(1, -1, 12))[0]


def correct_rest_pose_rts(rts_fw_vec: torch.Tensor, rts_rst_vec: torch.Tensor) -> torch.Tensor:
    rst_inv = SE3.rtk_invert(rts_rst_vec)
    rst_inv = rst_inv.reshape((1,) * (rts_fw_vec.dim() - 2) + rst_inv.shape[-2:]).expand(
        rts_fw_vec.shape)
    return SE3.rtk_compose(rst_inv, rts_fw_vec)
