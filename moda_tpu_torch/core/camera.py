"""Pinhole camera math and ray casting in PyTorch.

Counterpart of moda_tpu/core/camera.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def K2mat(K: torch.Tensor) -> torch.Tensor:
    """Intrinsics 4-vector [..., 4] (fx,fy,px,py) -> [..., 3, 3]."""
    fx, fy, px, py = K.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, px], -1),
                        torch.stack([z, fy, py], -1),
                        torch.stack([z, z, o], -1)], -2)


def mat2K(Kmat: torch.Tensor) -> torch.Tensor:
    return torch.stack([Kmat[..., 0, 0], Kmat[..., 1, 1],
                        Kmat[..., 0, 2], Kmat[..., 1, 2]], -1)


def K2inv(K: torch.Tensor) -> torch.Tensor:
    fx, fy, px, py = K.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, z, -px / fx], -1),
                        torch.stack([z, 1.0 / fy, -py / fy], -1),
                        torch.stack([z, z, o], -1)], -2)


def Kmatinv(Kmat: torch.Tensor) -> torch.Tensor:
    return K2inv(mat2K(Kmat))


def obj_to_cam(verts: torch.Tensor, Rmat: torch.Tensor, Tmat: torch.Tensor) -> torch.Tensor:
    """v_cam = v @ R^T + T for verts [..., N, 3]."""
    return verts @ Rmat.transpose(-1, -2) + Tmat[..., None, :]


def pinhole_cam(verts: torch.Tensor, K: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Project camera-space points [..., N, 3] -> (x_px, y_px, Z)."""
    v = verts @ K2mat(K).transpose(-1, -2)
    z = v[..., 2:3]
    return torch.cat([v[..., :2] / (eps + z), z], -1)


class Rays(NamedTuple):
    rays_o: torch.Tensor
    rays_d: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    rtk_vec: torch.Tensor
    xys: torch.Tensor


def raycast(xys: torch.Tensor, Rmat: torch.Tensor, Tmat: torch.Tensor,
            Kinv: torch.Tensor, near_far: Optional[torch.Tensor]) -> Rays:
    """Cast rays through pixels xys [B, N, 2]."""
    B, N = xys.shape[0], xys.shape[1]
    xy1 = torch.cat([xys, torch.ones_like(xys[..., :1])], -1)
    xyz3d = xy1 @ Kinv.transpose(-1, -2)
    rays_d = xyz3d @ Rmat
    rays_o = -(Tmat[:, None, :] @ Rmat)
    rays_o = rays_o.expand(B, N, 3)
    if near_far is not None:
        znear = near_far[:, 0, None, None].expand(B, N, 1)
        zfar = near_far[:, 1, None, None].expand(B, N, 1)
    else:
        tz = Tmat[:, None, 2:3]
        znear = torch.clamp(tz - 1.5, min=1e-5).expand(B, N, 1)
        zfar = (tz + 1.5).expand(B, N, 1)
    rtk_vec = torch.cat([Rmat.reshape(B, 1, 9), Tmat.reshape(B, 1, 3),
                         Kinv.reshape(B, 1, 9)], -1).expand(B, N, 21)
    return Rays(rays_o=rays_o, rays_d=rays_d, near=znear, far=zfar,
                rtk_vec=rtk_vec, xys=xys)


def prepare_ray_cams(rtk: torch.Tensor, kaug: torch.Tensor):
    """rtk [B,4,4] (rows 0-2 SE3, row 3 intrinsics) + kaug [B,4]
    -> (Rmat [B,3,3], Tmat [B,3], Kinv [B,3,3])."""
    Rmat = rtk[:, :3, :3]
    Tmat = rtk[:, :3, 3]
    Kmat = K2mat(rtk[:, 3, :])
    Kaug = K2inv(kaug)
    Kinv = Kmatinv(Kaug @ Kmat)
    return Rmat, Tmat, Kinv
