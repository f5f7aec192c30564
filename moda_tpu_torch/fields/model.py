"""Model assembly: counterpart of moda_tpu/fields/model.py.

``MoDAModel`` is an ``nn.Module`` whose top-level children and parameters
are the optimizer groups of the JAX package's parameter pytree
(nerf_coarse, nerf_beta, bones, pose_code, ...); ``ModelVars`` holds the
non-optimized device state. The ``apply_*`` methods route the NeRF MLPs
through the fused CUDA kernels when the tensors are on CUDA and
``cfg.use_pallas`` is set, and through the plain fp32 version otherwise.
Their ``site`` argument names the call site in the kernels' launch
counters.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch
from torch import nn

from moda_tpu_torch.config import DataInfo, MoDAConfig
from moda_tpu_torch.core import skinning as SK
from moda_tpu_torch.core.embedding import embed_dim, positional_embed, window_vec
from moda_tpu_torch.fields import nets
from moda_tpu_torch.fields.cse import CSENet
from moda_tpu_torch.ops.fused_mlp import nerf_mlp_fused
from moda_tpu_torch.runtime import Device, resolve_device

NUM_FREQS = 10
IN_XYZ = embed_dim(3, NUM_FREQS)  # 63
IN_DIR = embed_dim(3, 4)  # 27
ENV_DIM = 64
APP_DIM = 128
VID_DIM = 32
NUM_FEAT = 16


@dataclass
class ModelVars:
    """Non-optimized device-side state."""

    near_far: torch.Tensor  # [num_fr, 2]
    alpha: torch.Tensor
    obj_bound: torch.Tensor  # [3]
    vis_min: torch.Tensor
    vis_len: torch.Tensor
    beta_is_active: torch.Tensor

    def to(self, device) -> "ModelVars":
        return ModelVars(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


class MoDAModel(nn.Module):
    def __init__(self, cfg: MoDAConfig, data_info: DataInfo, *, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        """Builds every component with its initializer on the host from
        ``generator`` (seed 0 when None) and moves it to ``device``: the
        card by default; pass device="cpu" to build on the CPU."""
        super().__init__()
        dev = resolve_device(device)
        if cfg.flowbw and (cfg.lbs or cfg.neudbs):
            # the JAX package builds no bones under flowbw, and then fails
            # where it reads them (build_rays)
            raise ValueError("flowbw replaces the bones: pass --nolbs --noneudbs with it")
        self.cfg = cfg
        self.data_info = data_info
        self.num_fr = data_info.num_fr
        self.num_vid = data_info.num_vid
        self.max_ts = data_info.max_ts
        self.offset = tuple(int(o) for o in data_info.offset)

        dir_extra = (ENV_DIM if cfg.env_code else 0) + (APP_DIM if cfg.appearance_code else 0)
        self.nerf_coarse = nets.NeRFMLP(D=8, W=256, in_channels_xyz=IN_XYZ,
                                        in_channels_dir=IN_DIR + dir_extra, out_channels=3,
                                        raw_feat=False)
        self.nerf_beta = nn.Parameter(torch.tensor([cfg.init_beta], dtype=torch.float32))
        if cfg.use_embed:
            self.nerf_feat = nets.NeRFMLP(D=5, W=128, in_channels_xyz=IN_XYZ, in_channels_dir=0,
                                          out_channels=NUM_FEAT, raw_feat=True)
            self.nerf_beta_feat = nn.Parameter(torch.tensor([1.0]))
        if cfg.nerf_vis:
            self.nerf_vis = nets.NeRFMLP(D=5, W=64, in_channels_xyz=IN_XYZ, in_channels_dir=0,
                                         out_channels=1, raw_feat=True)
        if cfg.use_unc:
            # the video code rides on the dir branch
            self.nerf_unc = nets.NeRFMLP(D=8, W=256, in_channels_xyz=IN_XYZ,
                                         in_channels_dir=VID_DIM, out_channels=1, raw_feat=True)
            self.vid_code = nets.EmbedCode(num=self.num_vid, dim=VID_DIM)
        # scale bookkeeping: near/far starts at [0, 6]; obj_scale maps the
        # scene to a bound of ~0.3
        near_far0 = np.zeros((self.num_fr, 2), np.float32)
        near_far0[:, 1] = 6.0
        self.obj_scale = float((near_far0[:, 1] - near_far0[:, 0]).mean() / 2.0) / 0.3
        self.near_far_init = near_far0 / self.obj_scale
        in_code = IN_XYZ + cfg.t_embed_dim
        if self.has_bones or cfg.flowbw:
            self.pose_code = nets.FrameCode(num_freq=NUM_FREQS, embedding_dim=cfg.t_embed_dim,
                                            vid_offset=self.offset)
        if self.has_bones:
            self.bones = nn.Parameter(SK.generate_bones(cfg.num_bones, cfg.num_bones, 0.0))
            self.skin_aux = nn.Parameter(torch.tensor([0.0, self.obj_scale]))
            if cfg.neudbs:
                self.nerf_body_rts = nets.DQRTHead(num_bodies=cfg.num_bones,
                                                   in_channels=cfg.t_embed_dim)
            else:
                self.nerf_body_rts = nets.RTHead(num_bodies=cfg.num_bones, use_quat=False,
                                                 in_channels=cfg.t_embed_dim)
            self.rest_pose_code = nets.EmbedCode(num=1, dim=cfg.t_embed_dim)
            if cfg.nerf_skin:
                self.nerf_skin = nets.NeRFMLP(D=5, W=64, in_channels_xyz=in_code,
                                              in_channels_dir=0, out_channels=cfg.num_bones,
                                              raw_feat=True)
            if cfg.nerf_dis:
                # displacement field: a K1/K2 call site with a per-ray trunk code
                self.nerf_dis = nets.NeRFMLP(D=5, W=128, in_channels_xyz=in_code,
                                             in_channels_dir=0, out_channels=3, raw_feat=True)
        if cfg.flowbw:
            # the free-form 3D flow fields that replace the bones
            self.nerf_flowbw = nets.Transhead(in_channels_xyz=in_code)
            self.nerf_flowfw = nets.Transhead(in_channels_xyz=in_code)
        if cfg.env_code:
            self.env_code = nets.FrameCode(num_freq=NUM_FREQS, embedding_dim=ENV_DIM,
                                           vid_offset=self.offset)
        if cfg.appearance_code:
            self.appearance_code = nets.FrameCode(num_freq=NUM_FREQS, embedding_dim=APP_DIM,
                                                  vid_offset=self.offset)
        if cfg.root_opt:
            self.nerf_root_rts = nets.RTExpMLP(max_t=self.num_fr, num_freqs=NUM_FREQS,
                                               t_embed_dim=cfg.t_embed_dim,
                                               vid_offset=self.offset, delta=cfg.use_cam)
        if cfg.ks_opt:
            self.ks_param = nn.Parameter(torch.tensor(data_info.intrinsics, dtype=torch.float32))

        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nets.Dense):
                m.reset_parameters(gen)
            elif isinstance(m, nets.EmbedCode):
                m.reset_parameters(gen)
        if cfg.ft_cse:
            # the trainable CSE net of the ft_cse branch (initialized last, so
            # the other components draw as without it)
            self.csenet = CSENet(generator=gen)
        self.to(dev)
        bound = float((self.near_far_init[:, 1] - self.near_far_init[:, 0]).mean() / 2.0)
        self.mvars = ModelVars(
            near_far=torch.as_tensor(self.near_far_init, device=dev),
            alpha=torch.tensor(float(cfg.alpha), device=dev),
            obj_bound=torch.full((3,), bound, device=dev),
            vis_min=torch.zeros(3, device=dev),
            vis_len=torch.full((3,), bound / 2.0, device=dev),
            beta_is_active=torch.tensor(0.0, device=dev))

    @property
    def has_bones(self) -> bool:
        """Bones, skinning and their codes exist (lbs or neudbs); without
        them the model is rigid, or deforms by the flowbw flow fields."""
        return self.cfg.lbs or self.cfg.neudbs

    @property
    def device(self) -> torch.device:
        return self.nerf_beta.device

    def precise(self) -> "MoDAModel":
        """A view of this model on the plain fp32 path (``use_pallas`` off):
        it shares the parameters and launches no kernel. Extraction and the
        eval renders run on it, as on the JAX package's ``precise()``."""
        view = copy.copy(self)  # shares parameters and state; only cfg differs
        view.cfg = self.cfg.replace(use_pallas=False)
        return view

    # ------------------------------------------------------------ applies
    def embed_xyz(self, xyz, alpha=None):
        return positional_embed(xyz, NUM_FREQS, alpha=alpha)

    def embed_dir(self, d, alpha=None):
        return positional_embed(d, 4, alpha=alpha)

    def _fused(self, specs, x, code_trunk=None, code_dir=None, need_dx=True,
               embed_raw=False, embed_alpha=None, site=None):
        kernel = self.cfg.use_pallas and x.is_cuda
        S = x.shape[1] if (x.dim() == 3 and (code_trunk is not None or
                                             code_dir is not None)) else 1
        ef, ew = 0, None
        if embed_raw:
            ef = NUM_FREQS
            ew = window_vec(NUM_FREQS, x.shape[-1], embed_alpha, device=x.device)
        return nerf_mlp_fused(specs, x, code_trunk=code_trunk, code_dir=code_dir,
                              samples_per_ray=S, need_dx=need_dx, embed_freqs=ef,
                              embed_window=ew,
                              compute_dtype=torch.bfloat16 if kernel else torch.float32,
                              kernel=kernel, site=site)

    def _apply_mlp(self, mod: nets.NeRFMLP, x, sigma_only=False, code_trunk=None,
                   code_dir=None, need_dx=True, embed_raw=False, embed_alpha=None, site=None):
        """Kernel route for CUDA tensors under cfg.use_pallas, plain fp32
        otherwise. sigma_only (eikonal, shape init) always stays on the
        module's plain forward: it needs grad-of-grad, which the kernel's
        custom backward does not give."""
        if sigma_only:
            if embed_raw:
                x = positional_embed(x, NUM_FREQS, alpha=embed_alpha)
            return mod(x, sigma_only=True)
        return self._fused([(mod, code_trunk is not None, code_dir is not None)], x,
                           code_trunk=code_trunk, code_dir=code_dir, need_dx=need_dx,
                           embed_raw=embed_raw, embed_alpha=embed_alpha, site=site)[0]

    def apply_coarse(self, x, sigma_only=False, code_dir=None, embed_raw=False,
                     embed_alpha=None, site=None):
        return self._apply_mlp(self.nerf_coarse, x, sigma_only=sigma_only, code_dir=code_dir,
                               embed_raw=embed_raw, embed_alpha=embed_alpha, site=site)

    def apply_feat(self, x, need_dx=True, embed_raw=False, embed_alpha=None, site=None):
        return self._apply_mlp(self.nerf_feat, x, need_dx=need_dx, embed_raw=embed_raw,
                               embed_alpha=embed_alpha, site=site)

    def apply_coarse_feat(self, x, code_dir=None, embed_raw=False, embed_alpha=None,
                          site=None):
        """Coarse rgb/sigma and the CSE feature head at the same points in
        one fused launch. Returns (coarse [.., 4], feat [.., NUM_FEAT])."""
        out, feat = self._fused([(self.nerf_coarse, False, code_dir is not None),
                                 (self.nerf_feat, False, False)], x, code_dir=code_dir,
                                embed_raw=embed_raw, embed_alpha=embed_alpha, site=site)
        return out, feat

    def apply_vis(self, x, need_dx=True, embed_raw=False, embed_alpha=None, site=None):
        return self._apply_mlp(self.nerf_vis, x, need_dx=need_dx, embed_raw=embed_raw,
                               embed_alpha=embed_alpha, site=site)

    def apply_unc(self, xyt_code, code_dir=None, embed_raw=False, embed_alpha=None,
                  site=None):
        """Uncertainty MLP. The video code belongs on the dir branch: either
        concatenated per point after the embedded xyt (the legacy layout of
        the candidate scores) or as a separate per-ray code_dir."""
        return self._apply_mlp(self.nerf_unc, xyt_code, code_dir=code_dir, embed_raw=embed_raw,
                               embed_alpha=embed_alpha, site=site)

    def apply_skin(self, x, code_trunk=None, embed_raw=False, embed_alpha=None, site=None):
        """Delta-skin MLP: per-point logits over the bones, with a per-ray
        trunk code (the frame's pose code or the rest-pose code)."""
        return self._apply_mlp(self.nerf_skin, x, code_trunk=code_trunk, embed_raw=embed_raw,
                               embed_alpha=embed_alpha, site=site)

    def apply_dis(self, x, code_trunk=None, embed_raw=False, embed_alpha=None, site=None):
        """Displacement field nerf_dis: per-point 3-d offsets, with a per-ray
        trunk code (the frame's pose code or the rest-pose code)."""
        return self._apply_mlp(self.nerf_dis, x, code_trunk=code_trunk, embed_raw=embed_raw,
                               embed_alpha=embed_alpha, site=site)

    def apply_csenet(self, imgs):
        """[N, H, W, 3] crops -> [N, H/2, W/2, 16] unit embeddings (ft_cse)."""
        return self.csenet(imgs)

    def apply_pose_code(self, fid):
        return self.pose_code(fid)

    def apply_env_code(self, fid):
        return self.env_code(fid)

    def apply_appearance_code(self, fid):
        return self.appearance_code(fid)

    def apply_vid_code(self, vid):
        return self.vid_code(vid)

    def apply_rest_pose_code(self, idx):
        return self.rest_pose_code(idx)

    def body_rts(self, fid):
        """frame ids [N] -> bone transforms [N, B, 8] (neudbs) or [N, B, 12]."""
        return self.nerf_body_rts(self.apply_pose_code(fid))

    def body_rts_rest(self):
        code = self.apply_rest_pose_code(torch.zeros(1, dtype=torch.long, device=self.device))
        return self.nerf_body_rts(code)

    def root_rts(self, fid):
        return self.nerf_root_rts(fid)

    def compute_rts(self, base_rt: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Root poses of all frames [num_fr, 3, 4]."""
        fid = torch.arange(self.num_fr, device=self.device)
        rt = create_base_se3(self.num_fr, self.device) if base_rt is None else base_rt
        if self.cfg.root_opt:
            delta = self.root_rts(fid)
            rmat_d = delta[:, 0, :9].reshape(-1, 3, 3)
            tmat_d = delta[:, 0, 9:12]
            tmat = rt[:, :3, 3] + (rt[:, :3, :3] @ tmat_d[..., None])[..., 0]
            rmat = rt[:, :3, :3] @ rmat_d
            rt = torch.cat([rmat, tmat[..., None]], -1)
        return rt


def create_base_se3(bs: int, device=None) -> torch.Tensor:
    """Canonical base camera: identity R, T = (0, 0, 0.3)."""
    rt = torch.zeros(bs, 3, 4, device=device)
    rt[:, :3, :3] = torch.eye(3, device=device)
    rt[:, 2, 3] = 0.3
    return rt
