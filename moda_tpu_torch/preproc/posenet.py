"""The reference's pretrained pose CNN (posenet): 16-channel CSE crops ->
camera SE(3). Counterpart of moda_tpu/preproc/posenet.py.

The reference's published camera-initialization route loads a pretrained
torch checkpoint ``mesh_material/posenet/{quad,human}.pth``
(scripts/template.sh:13-17, consumed at nnutils/train_utils.py:884-921)
into ``Sequential(Encoder, RTHead)`` (nnutils/moda.py:361-366):

- Encoder (nnutils/nerf.py:536-556): torchvision ResNet18 with a 16-channel
  stem (nerf.py:513-534) -> conv3x3 512->128 + BN + LeakyReLU(0.2)
  (nerf.py:559-573) -> 4x4 max-pool -> a flat 128 code;
- RTHead(use_quat=True, D=1, in 128, out 7) (nerf.py:307-344): a one-layer
  NeRF-MLP trunk giving [tmat * 0.1 | normalized quaternion -> rmat].

``RefPoseNet`` is that inference graph in NCHW, with every BatchNorm folded
into a ``FrozenBN`` affine; its convolutions are ``F.conv2d`` (cuDNN on the
card), as the JAX package runs them through XLA. Its parameters carry the
JAX module's names, so ``bridge.posenet_from_jax`` loads the JAX package's
converted Flax parameters, and ``convert_posenet_checkpoint`` reads the
reference's state dict straight into it (torch's conv layout needs no
transpose). ``predict_rtk`` composes the CNN's delta with the base pose
(identity R, z = 0.3), as create_base_se3 + refine_rt do (moda.py:1432,
1448-1466).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.fields.resnet_fpn import FrozenBN, _cv, _fold_bn

CKPT_PREFIX = "module.nerf_root_rts."  # save_network's DDP prefix (train_utils.py:899-901)


class BasicBlock(nn.Module):
    """torchvision's ResNet BasicBlock (inference)."""

    def __init__(self, cin: int, features: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = FrozenBN(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = FrozenBN(features)
        if has_downsample:
            self.downsample = nn.Conv2d(cin, features, 1, stride, 0, bias=False)
            self.downsample_bn = FrozenBN(features)
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.downsample is None else self.downsample_bn(self.downsample(x))
        return F.relu(out + sc)


class ResNet18Conv(nn.Module):
    """ResNet18's feature trunk with a 16-channel stem (ResNetConv,
    nerf.py:513-534): [N, 16, H, W] -> [N, 512, H/32, W/32]."""

    def __init__(self, in_channels: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for li, (feats, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            setattr(self, f"layer{li + 1}_0", BasicBlock(cin, feats, stride, li > 0))
            setattr(self, f"layer{li + 1}_1", BasicBlock(feats, feats))
            cin = feats

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}_1")(getattr(self, f"layer{li}_0")(x))
        return x


class RefPoseNet(nn.Module):
    """[N, 16, 112, 112] feature crops -> [N, 12] (rmat 9 | tmat 3): the
    reference's Sequential(Encoder, RTHead) at inference."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18Conv()
        self.enc_conv1 = nn.Conv2d(512, 128, 3, 1, 1)
        self.enc_bn1 = FrozenBN(128)
        # RTHead's trunk (NeRF D=1 with the raw_feat head, nerf.py:147-198,324-343)
        self.xyz_encoding_1 = nn.Linear(128, 256)
        self.xyz_encoding_final = nn.Linear(256, 256)
        self.dir_encoding = nn.Linear(256, 128)
        self.rgb = nn.Linear(128, 7)

    def forward(self, feats):
        x = self.resnet(feats)                                       # [N, 512, 4, 4]
        x = F.leaky_relu(self.enc_bn1(self.enc_conv1(x)), 0.2)
        x = F.max_pool2d(x, 4, 4)
        code = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)        # [N, 128]
        h = F.relu(self.xyz_encoding_1(code))
        d = F.relu(self.dir_encoding(self.xyz_encoding_final(h)))
        out = self.rgb(d)
        tmat = out[:, 0:3] * 0.1
        rquat = out[:, 3:7]
        rquat = rquat / torch.clamp(torch.linalg.norm(rquat, dim=-1, keepdim=True), min=1e-12)
        rmat = Q.q_to_matrix(rquat).reshape(-1, 9)
        return torch.cat([rmat, tmat], -1)


# ----------------------------------------------------------------- converter
def convert_posenet_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The reference posenet's state dict -> RefPoseNet's state dict.

    Takes the raw ``torch.load`` dict of the .pth (keys prefixed
    ``module.nerf_root_rts.``) or the stripped layout
    (``0.resnet_conv.resnet.*`` / ``1.xyz_encoding_1.*``), with torch
    tensors or numpy arrays as values. BatchNorms fold with eps 1e-5."""
    sd = {k.replace(CKPT_PREFIX, ""): np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def bn(name, prefix):
        s, b = _fold_bn(sd, prefix)
        out[name + ".scale"], out[name + ".bias"] = torch.from_numpy(s), torch.from_numpy(b)

    def lin(name, key):
        out[name + ".weight"] = torch.as_tensor(sd[key + ".weight"], dtype=torch.float32)
        out[name + ".bias"] = torch.as_tensor(sd[key + ".bias"], dtype=torch.float32)

    r = "0.resnet_conv.resnet."
    out["resnet.conv1.weight"] = _cv(sd[r + "conv1.weight"])
    bn("resnet.bn1", r + "bn1")
    for li in range(1, 5):
        for bi in range(2):
            t, m = f"{r}layer{li}.{bi}.", f"resnet.layer{li}_{bi}."
            for ci in (1, 2):
                out[m + f"conv{ci}.weight"] = _cv(sd[t + f"conv{ci}.weight"])
                bn(m + f"bn{ci}", t + f"bn{ci}")
            if bi == 0 and li > 1:
                out[m + "downsample.weight"] = _cv(sd[t + "downsample.0.weight"])
                bn(m + "downsample_bn", t + "downsample.1")
    out["enc_conv1.weight"] = _cv(sd["0.conv1.0.weight"])
    out["enc_conv1.bias"] = torch.as_tensor(sd["0.conv1.0.bias"], dtype=torch.float32)
    bn("enc_bn1", "0.conv1.1")
    lin("xyz_encoding_1", "1.xyz_encoding_1.0")
    lin("xyz_encoding_final", "1.xyz_encoding_final")
    lin("dir_encoding", "1.dir_encoding.0")
    lin("rgb", "1.rgb.0")
    return out


def load_posenet(path: str, device="cpu") -> RefPoseNet:
    """A reference posenet .pth -> RefPoseNet on ``device``, in eval mode."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    net = RefPoseNet()
    net.load_state_dict(convert_posenet_checkpoint(sd))
    return net.eval().to(device)


@torch.no_grad()
def predict_rtk(net: RefPoseNet, feats: np.ndarray) -> np.ndarray:
    """feats [N, 112, 112, 16] (NHWC, as the JAX function takes them) ->
    rtk [N, 4, 4]: the CNN's delta composed with the canonical base
    (identity R, T = [0, 0, 0.3]) as refine_rt does for the CNN basis:
    R = rmat, T = tmat + [0, 0, 0.3], rtk[3, 3] = 1."""
    dev = next(net.parameters()).device
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev).permute(0, 3, 1, 2)
    rts = net(x.contiguous()).cpu().numpy()
    out = np.zeros((len(feats), 4, 4), np.float32)
    out[:, :3, :3] = rts[:, :9].reshape(-1, 3, 3)
    out[:, :3, 3] = rts[:, 9:12] + np.asarray([0, 0, 0.3], np.float32)
    out[:, 3, 3] = 1
    return out
