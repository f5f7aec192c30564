"""Pose-CNN warmup: self-supervised camera initialization. The port of
moda_tpu/train/warmup_pose.py (train_utils.py:871-921 + moda.py:812-848,
931-1022):

1. ``render_pose_batch``: rasterize the canonical prior mesh with its 16-d
   surface embeddings from random SE(3) cameras (host, the native z-buffer
   rasterizer) into 112x112 feature crops; its draws come from a numpy
   Generator, so both packages render the same batch from the same seed;
2. ``PoseWarmup`` trains the PoseCNN (fields/cnn.py) on the device to
   regress the rotation, with optax.adamw's update (b1 0.9, b2 0.999, eps
   1e-8, decoupled weight decay 1e-4) under optax's
   cosine_decay_schedule(lr, total, alpha=0.05), counted from 0;
3. ``predict`` and the helpers of extract_cams (``ood_check_features``,
   ``nearest_valid_substitution``, and ``process_so3_seq``, which neither
   package calls).

``save``/``load`` use the JAX package's npz layout (``cnn/...`` keys), so a
``pose_cnn.npz`` moves between the packages; ``load`` of a ``.pth`` takes
the reference's pretrained posenet (preproc/posenet.py) instead, whose
``predict`` gives the full rotation and translation.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from moda_tpu_torch import bridge
from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.fields.cnn import PoseCNN
from moda_tpu_torch.native import rasterize
from moda_tpu_torch.preproc.posenet import load_posenet, predict_rtk
from moda_tpu_torch.runtime import Device, resolve_device

CROP = 112


def render_pose_batch(verts: np.ndarray, faces: np.ndarray, embeds: np.ndarray,
                      d_mean: float, bs: int, rng: np.random.Generator,
                      img_size: int = 256):
    """Random-camera feature renderings (render_dp, moda.py:931-1022).

    verts: unit prior mesh [V,3]; embeds [V,16]. Returns
    (feats [bs,112,112,16], rtk [bs,4,4])."""
    from scipy.spatial.transform import Rotation as R

    std_rot, std_dep, focal = 6.28, 0.5, 2.0
    v = verts / 3.0 * d_mean
    feats_out = np.zeros((bs, CROP, CROP, embeds.shape[1]), np.float32)
    rtk_out = np.zeros((bs, 4, 4), np.float32)
    f_px = focal * img_size / 2.0
    for b in range(bs):
        Rmat = R.from_rotvec(rng.normal(0, std_rot, 3)).as_matrix()
        d_obj = max(d_mean * (1 + rng.normal(0, std_dep)), 1.2 * d_mean / 3)
        T = np.asarray([0.0, 0.0, d_obj])
        cam = v @ Rmat.T + T
        x = cam[:, 0] / cam[:, 2] * f_px + img_size / 2
        y = cam[:, 1] / cam[:, 2] * f_px + img_size / 2
        img, _, mask = rasterize(np.stack([x, y, cam[:, 2]], -1), faces, embeds,
                                 img_size, img_size)
        ys, xs = np.where(mask > 0)
        if len(xs) < 4:
            feats = np.zeros((CROP, CROP, embeds.shape[1]), np.float32)
        else:
            cx, cy = (xs.max() + xs.min()) // 2, (ys.max() + ys.min()) // 2
            lx = max((xs.max() - xs.min()) // 2, 8)
            ly = max((ys.max() - ys.min()) // 2, 8)
            x0, x1 = max(cx - lx, 0), min(cx + lx, img_size)
            y0, y1 = max(cy - ly, 0), min(cy + ly, img_size)
            feats = IO.resize(img[y0:y1, x0:x1], (CROP, CROP), IO.INTER_LINEAR)
            # random mask augmentation (geom_utils.py:1369-1379)
            if rng.random() < 0.5:
                sx = int(rng.uniform(0.1, 0.3) * CROP)
                sy = int(rng.uniform(0.1, 0.3) * CROP)
                cx2 = int(rng.uniform(sx, CROP - sx))
                cy2 = int(rng.uniform(sy, CROP - sy))
                feats[cy2 - sy:cy2 + sy, cx2 - sx:cx2 + sx] = feats.mean((0, 1))
        n = np.linalg.norm(feats, axis=-1, keepdims=True)
        feats_out[b] = feats / np.maximum(n, 1e-9)
        rtk_out[b, :3, :3] = Rmat
        rtk_out[b, :3, 3] = T
        rtk_out[b, 3] = [f_px, f_px, img_size / 2, img_size / 2]
    return feats_out, rtk_out


def rotation_loss(net: PoseCNN, feats: torch.Tensor, rtk_gt: torch.Tensor):
    """(0.01 x mean rotation error, mean rotation error) of the CNN's
    rotations against the cameras' (moda.py:841; translation not trained)."""
    rmat = net(feats)[:, :9].reshape(-1, 3, 3)
    rot = Q.rot_angle(rmat @ rtk_gt[:, :3, :3].transpose(-1, -2)).mean()
    return 0.01 * rot, rot


class PoseWarmup:
    def __init__(self, verts: np.ndarray, faces: np.ndarray, embeds: np.ndarray,
                 d_mean: float, lr: float = 3e-4, seed: int = 0, total_steps: int = 2000,
                 device: Device = None):
        """Runs on the card unless device="cpu" is passed. The CNN's initial
        weights come from a torch Generator seeded with ``seed``, the batches
        from a numpy Generator seeded with it (as the JAX package's)."""
        self.verts, self.faces, self.embeds = verts, faces, embeds
        self.d_mean = d_mean
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.net = PoseCNN(embeds.shape[1], generator=torch.Generator().manual_seed(seed)
                           ).to(self.device)
        self.ref_net = None  # the pretrained posenet, once a .pth is loaded
        # cosine decay over the full warmup (the reference reuses its
        # OneCycle init_training for the warmup phase, train_utils.py:886)
        total = max(total_steps, 1)
        self.opt = torch.optim.AdamW(self.net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda t: 0.95 * 0.5 * (1 + math.cos(math.pi * min(t, total) / total))
            + 0.05)

    def step(self, feats: np.ndarray, rtk: np.ndarray) -> torch.Tensor:
        """One optimizer step on one batch; returns the batch's mean rotation
        error (a device scalar)."""
        loss, rot = rotation_loss(self.net, torch.as_tensor(feats, device=self.device),
                                  torch.as_tensor(rtk, device=self.device))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.sched.step()
        return rot.detach()

    def train(self, steps: int, bs: int = 16):
        # the host rasterizes batch i+1 while the device runs step i: the
        # losses stay on the device until the end
        rots = [self.step(*render_pose_batch(self.verts, self.faces, self.embeds,
                                             self.d_mean, bs, self.rng))
                for _ in range(steps)]
        return torch.stack(rots).cpu().tolist() if rots else []

    def save(self, path: str):
        """Persist the pose CNN (pose_cnn_path artifact equivalent)."""
        np.savez(path, **bridge.flatten({"cnn": bridge.export_params(self.net)}))

    def load(self, path: str):
        """npz: a self-trained PoseCNN of either package. .pth: the
        reference's pretrained posenet (template.sh --pose_cnn_path,
        train_utils.py:899-904), as a RefPoseNet on the warmup's device."""
        if path.endswith(".pth"):
            self.ref_net = load_posenet(path, self.device)
        else:
            bridge.load_params(self.net, bridge.unflatten(dict(np.load(path)))["cnn"])

    @torch.no_grad()
    def predict(self, feats: np.ndarray) -> np.ndarray:
        """feats [N,112,112,16] -> rtk [N,4,4]. The pretrained posenet (once
        a .pth is loaded): its full rotation and translation composed with
        the base, as refine_rt does (``predict_rtk``). The self-trained CNN:
        its rotation with the base z=0.3 translation, since the from-scratch
        warmup trains the rotation loss only (moda.py:841)."""
        if self.ref_net is not None:
            return predict_rtk(self.ref_net, feats)
        rts = self.net(torch.as_tensor(np.asarray(feats, np.float32), device=self.device))
        rts = rts.cpu().numpy()
        out = np.zeros((len(feats), 4, 4), np.float32)
        out[:, :3, :3] = rts[:, :9].reshape(-1, 3, 3)
        out[:, :3, 3] = [0, 0, 0.3]
        return out


def ood_check_features(dp_feats: np.ndarray, dp_embed: np.ndarray,
                       dp_idx: np.ndarray, err_threshold: float = 12.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """CSE forward-backward consistency check (ood_check_cse,
    geom_utils.py:1610-1663). dp_feats [bs,16,h,w]; dp_embed [N,16];
    dp_idx [bs,h,w] vertex assignment. Returns (valid [bs], err [bs])."""
    bs, C, h, w = dp_feats.shape
    valid, errs = [], []
    xs, ys = np.meshgrid(range(w), range(h))
    for i in range(bs):
        cost = dp_embed @ dp_feats[i].reshape(C, -1)  # [N, h*w]
        max_idx = cost.argmax(-1)  # best pixel per vertex
        rpj = max_idx[dp_idx[i]]
        rx, ry = rpj % w, rpj // w
        err = np.sqrt((rx - xs) ** 2 + (ry - ys) ** 2)
        m = dp_idx[i] != 0
        mean_err = err[m].mean() if m.any() else 1e9
        errs.append(mean_err)
        valid.append(mean_err < err_threshold)
    return np.asarray(valid), np.asarray(errs)


def nearest_valid_substitution(rtks: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Replace invalid rotations by the nearest valid frame's
    (save_cams, train_utils.py:752-761)."""
    out = rtks.copy()
    idx_valid = np.where(valid)[0]
    if len(idx_valid) == 0:
        return out
    for i in range(len(rtks)):
        if not valid[i]:
            j = idx_valid[np.abs(idx_valid - i).argmin()]
            out[i, :3, :3] = rtks[j, :3, :3]
    return out


def process_so3_seq(scores: np.ndarray, grid: np.ndarray,
                    smooth: bool = True, sigma: float = 0.4) -> np.ndarray:
    """Temporally-smoothed rotation decoding from per-frame score
    distributions (geom_utils.py:1381-1461): forward-backward message
    passing on the frame chain with a rotation-distance pairwise potential,
    in place of the reference's dense CRF.

    scores [T, N]; grid [N, 3, 3] -> rotations [T, 3, 3]."""
    T, N = scores.shape
    logp = scores - scores.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    if smooth and T > 1:
        g = torch.as_tensor(grid)
        drot = Q.rot_angle(g[None] @ g[:, None].transpose(-1, -2)).numpy()
        trans = -0.5 * (drot / sigma) ** 2  # [N, N] transition log-potential
        # forward pass
        alpha = logp.copy()
        for t in range(1, T):
            m = alpha[t - 1][:, None] + trans
            alpha[t] += m.max(0)
        # backtrack
        idx = np.zeros(T, int)
        idx[-1] = alpha[-1].argmax()
        for t in range(T - 2, -1, -1):
            idx[t] = (alpha[t] + trans[:, idx[t + 1]]).argmax()
    else:
        idx = logp.argmax(-1)
    return grid[idx]
