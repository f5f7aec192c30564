"""Network zoo in PyTorch: counterpart of moda_tpu/fields/nets.py.

Parameters keep the JAX package's names and layouts: a ``Dense`` holds
``kernel [in, out]`` and ``bias [out]`` exactly like flax.linen.Dense, so
``model.named_parameters()`` with "." read as "/" is the flax parameter
path, and weights move between the packages without transposes.
Initializers draw from the same distributions as the flax modules
(lecun-normal kernels, zero biases, N(0, 1) embedding tables) from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from moda_tpu_torch.core import dualquat as DQ
from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.core.embedding import positional_embed

# flax's lecun_normal: truncated normal on (-2, 2) std, rescaled so the
# truncated distribution has variance 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        std = math.sqrt(1.0 / self.kernel.shape[0]) / _TRUNC_STD_CORRECTION
        with torch.no_grad():
            w = torch.empty(self.kernel.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            self.kernel.copy_(w)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


def reset_denses(module: nn.Module, generator: Optional[torch.Generator]):
    """Initialize every Dense under ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)


class NeRFMLP(nn.Module):
    """Embedded xyz (+codes) -> sigma and rgb/feature, the flax NeRFMLP.

    forward(x, sigma_only) with x = [xyz_embed | dir_embed+codes];
    raw_feat=True returns the rgb branch raw, else [sigmoid(rgb), sigma]."""

    def __init__(self, D: int = 8, W: int = 256, in_channels_xyz: int = 63,
                 in_channels_dir: int = 27, out_channels: int = 3,
                 skips: Sequence[int] = (4,), raw_feat: bool = False, device=None):
        super().__init__()
        self.D, self.W = D, W
        self.in_channels_xyz = in_channels_xyz
        self.in_channels_dir = in_channels_dir
        self.out_channels = out_channels
        self.skips = tuple(skips)
        self.raw_feat = raw_feat
        for i in range(D):
            fan_in = in_channels_xyz if i == 0 else W
            if i in self.skips:
                fan_in = in_channels_xyz + W
            self.add_module(f"xyz_{i + 1}", Dense(fan_in, W, device))
        self.sigma = Dense(W, 1, device)
        self.xyz_final = Dense(W, W, device)
        self.add_module("dir", Dense(W + in_channels_dir, W // 2, device))
        self.rgb = Dense(W // 2, out_channels, device)

    def layer_names(self):
        return [f"xyz_{i + 1}" for i in range(self.D)] + ["sigma", "xyz_final", "dir", "rgb"]

    def flat_weights(self):
        """(k1, b1, k2, b2, ...) in the kernel's layer order."""
        out = []
        for n in self.layer_names():
            layer = getattr(self, n)
            out += [layer.kernel, layer.bias]
        return out

    def forward(self, x: torch.Tensor, sigma_only: bool = False) -> torch.Tensor:
        input_xyz = x[..., :self.in_channels_xyz]
        h = input_xyz
        for i in range(self.D):
            if i in self.skips:
                h = torch.cat([input_xyz, h], -1)
            h = torch.relu(getattr(self, f"xyz_{i + 1}")(h))
        sigma = self.sigma(h)
        if sigma_only:
            return sigma
        input_dir = x[..., self.in_channels_xyz:self.in_channels_xyz + self.in_channels_dir]
        h_dir = torch.cat([self.xyz_final(h), input_dir], -1)
        h_dir = torch.relu(getattr(self, "dir")(h_dir))
        rgb = self.rgb(h_dir)
        if self.raw_feat:
            return rgb
        return torch.cat([torch.sigmoid(rgb), sigma], -1)


class Transhead(nn.Module):
    """Translation field: a D5 W128 NeRF trunk (``trunk``) whose raw output
    is scaled by 0.1. It runs as plain PyTorch, as the JAX package runs it
    through flax (never through the fused kernel)."""

    def __init__(self, in_channels_xyz: int = 63, D: int = 5, W: int = 128,
                 out_channels: int = 3, device=None):
        super().__init__()
        self.trunk = NeRFMLP(D=D, W=W, in_channels_xyz=in_channels_xyz, in_channels_dir=0,
                             out_channels=out_channels, raw_feat=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x) * 0.1


class RTHead(nn.Module):
    """Code -> B rigid transforms as 12-vectors (quat or so3 parameters)."""

    def __init__(self, num_bodies: int = 1, use_quat: bool = True, D: int = 8,
                 W: int = 256, in_channels: int = 128, device=None):
        super().__init__()
        self.num_bodies, self.use_quat = num_bodies, use_quat
        per = 7 if use_quat else 6
        self.trunk = NeRFMLP(D=D, W=W, in_channels_xyz=in_channels, in_channels_dir=0,
                             out_channels=per * num_bodies, raw_feat=True, device=device)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        per = 7 if self.use_quat else 6
        rts = self.trunk(code).reshape(code.shape[:-1] + (self.num_bodies, per))
        tmat = rts[..., 0:3] * 0.1
        if self.use_quat:
            rmat = Q.q_to_matrix(Q.q_normalize(rts[..., 3:7]))
        else:
            rmat = Q.so3_exp(rts[..., 3:6])
        return torch.cat([rmat.reshape(rts.shape[:-1] + (9,)), tmat], -1)


class DQRTHead(nn.Module):
    """Code -> B dual-quaternion bone transforms [..., B, 8]."""

    def __init__(self, num_bodies: int = 25, D: int = 8, W: int = 256,
                 in_channels: int = 128, device=None):
        super().__init__()
        self.num_bodies = num_bodies
        self.trunk = NeRFMLP(D=D, W=W, in_channels_xyz=in_channels, in_channels_dir=0,
                             out_channels=7 * num_bodies, raw_feat=True, device=device)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        rts = self.trunk(code).reshape(code.shape[:-1] + (self.num_bodies, 7))
        tmat = rts[..., 0:3] * 0.1
        rquat = Q.q_normalize(rts[..., 3:7])
        return DQ.rt_to_dq(rquat, tmat)


def fid_reindex(fid: torch.Tensor, vid_offset: torch.Tensor):
    """Absolute frame id -> (video id, normalized relative time)."""
    num_vids = vid_offset.shape[0] - 1
    fidf = fid.float()
    max_ts = (vid_offset[1:] - vid_offset[:-1]).max().float()
    vid = torch.clamp(torch.searchsorted(vid_offset[1:], fid, right=True), 0, num_vids - 1)
    start = vid_offset[vid].float()
    dur = (vid_offset[vid + 1] - vid_offset[vid]).float()
    tid = (fidf - start - dur / 2.0) / max_ts * 2.0
    return vid, tid


class FrameCode(nn.Module):
    """(video id, relative frame id) -> latent code, via a Fourier embed of
    the normalized time scattered into a per-video slot and one Dense."""

    def __init__(self, num_freq: int = 10, embedding_dim: int = 128,
                 vid_offset: tuple = (0, 1), scale: float = 1.0, device=None):
        super().__init__()
        self.num_freq = num_freq
        self.vid_offset = tuple(int(o) for o in vid_offset)
        self.scale = scale
        num_vids = len(self.vid_offset) - 1
        self.basis = Dense((2 * num_freq + 1) * num_vids, embedding_dim, device)

    def forward(self, fid: torch.Tensor) -> torch.Tensor:
        offset = torch.as_tensor(self.vid_offset, device=fid.device)
        num_vids = len(self.vid_offset) - 1
        vid, tid = fid_reindex(fid, offset)
        tid = tid * self.scale
        coeff = positional_embed(tid[:, None], self.num_freq, alpha=self.num_freq)
        one_hot = torch.nn.functional.one_hot(vid, num_vids).to(coeff.dtype)
        mixed = (coeff[..., None] * one_hot[:, None, :]).reshape(fid.shape[0], -1)
        return self.basis(mixed)


class RTExplicit(nn.Module):
    """Per-frame explicit SE(3) table (identity at init)."""

    def __init__(self, max_t: int = 1, delta: bool = False, device=None):
        super().__init__()
        self.delta = delta
        per = 6 if delta else 7
        se3 = torch.zeros(max_t, per, device=device)
        if not delta:
            se3[:, 3] = 1.0
        self.se3 = nn.Parameter(se3)

    def forward(self, fid: torch.Tensor) -> torch.Tensor:
        rts = self.se3[fid]
        tmat = rts[..., 0:3] * 0.1
        if self.delta:
            rmat = Q.so3_exp(rts[..., 3:6])
        else:
            rmat = Q.q_to_matrix(Q.q_normalize(rts[..., 3:7]))
        return torch.cat([rmat.reshape(rts.shape[:-1] + (9,)), tmat], -1)[..., None, :]


class RTExpMLP(nn.Module):
    """Root pose: explicit base table x MLP delta. The base's gradient is
    magnified 10x by base*10 - detach(base*9)."""

    def __init__(self, max_t: int = 1, num_freqs: int = 10, t_embed_dim: int = 128,
                 vid_offset: tuple = (0, 1), delta: bool = False, device=None):
        super().__init__()
        self.base_rt = RTExplicit(max_t=max_t, delta=delta, device=device)
        self.root_code = FrameCode(num_freq=num_freqs, embedding_dim=t_embed_dim,
                                   vid_offset=vid_offset, scale=0.1, device=device)
        self.mlp_rt = RTHead(num_bodies=1, use_quat=False, in_channels=t_embed_dim,
                             device=device)

    def forward(self, fid: torch.Tensor) -> torch.Tensor:
        base = self.base_rt(fid)
        delt = self.mlp_rt(self.root_code(fid))
        base = base * 10.0 - (base * 9.0).detach()
        rmat = base[:, 0, :9].reshape(-1, 3, 3)
        tmat = base[:, 0, 9:12]
        d_rmat = delt[:, 0, :9].reshape(-1, 3, 3)
        d_tmat = delt[:, 0, 9:12]
        tmat = tmat + (rmat @ d_tmat[..., None])[..., 0]
        rmat = rmat @ d_rmat
        return torch.cat([rmat.reshape(-1, 9), tmat], -1)[:, None, :]


class EmbedCode(nn.Module):
    """Plain embedding table, N(0, 1) at init."""

    def __init__(self, num: int = 1, dim: int = 128, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx]
