"""Configuration for moda_tpu_torch.

The same frozen dataclass as the JAX package's config (same field names
and defaults), so a config serialized by either package loads in the
other. ``use_pallas`` keeps its name and means "run the hand-written
CUDA kernels" here. ``load_seq_config`` reads the sequence ``.config``
INI files (utils/io.py:277-332 format) the same way.
"""
from __future__ import annotations

import configparser
import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoDAConfig:
    # data io
    accu_steps: int = 1
    seqname: str = "syn-spot-40"
    logname: str = "exp_name"
    checkpoint_dir: str = "logdir/"
    model_path: str = ""
    pose_cnn_path: str = ""
    # canonical template mesh pkl {'vertices','faces'[,'embeddings']}: the
    # reference's mesh_material CSE template (moda.py:405-445)
    prior_mesh_path: str = ""
    rtk_path: str = ""
    config_dir: str = "configs"
    lineload: bool = False
    use_rtk_file: bool = False
    debug: bool = False          # per-step timing + profiler hooks
    # optimizer steps per XLA dispatch (lax.scan chain): amortizes the
    # per-step dispatch + fetch round trips of the remote-TPU transport.
    # 0 = auto (10 on TPU, 1 elsewhere); must divide 50 so the 50-step
    # near-far refresh cadence (moda.py:485-491) lands on chunk edges
    steps_chunk: int = 0

    # model: shape, appearance, feature
    use_human: bool = False
    symm_shape: bool = False
    env_code: bool = True
    appearance_code: bool = False
    env_fourier: bool = True
    appearance_fourier: bool = True
    use_unc: bool = False
    nerf_vis: bool = True
    anneal_freq: bool = False
    alpha: float = 10.0
    use_cc: bool = True

    # model: motion
    lbs: bool = False
    neudbs: bool = True
    num_bones: int = 25
    nerf_skin: bool = True
    t_embed_dim: int = 128
    frame_code: bool = True
    flowbw: bool = False
    se3_flow: bool = False
    nerf_dis: bool = False

    # model: cameras
    use_cam: bool = False
    root_basis: str = "expmlp"  # {mlp, cnn, exp, expmlp}
    root_opt: bool = True
    ks_opt: bool = True

    # optimization: hyperparams
    num_epochs: int = 1000
    learning_rate: float = 5e-4
    batch_size: int = 2
    n_data_workers: int = 8      # loader prefetch threads (moda.py:54)
    seed: int = 0                # PRNG seed (reference fixes 0, main.py:31)
    img_size: int = 512
    nsample: int = 6
    perturb: float = 1.0
    noise_std: float = 0.0
    nactive: float = 0.5
    ndepth: int = 128
    clip_scale: float = 10.0
    # Registration-stability guards (round-5 additions; the reference's
    # analogue is reloading params_latest.pth whenever the root grad norm
    # exceeds clip_scale, train_utils.py:971-974 — which reverts the WHOLE
    # epoch's progress on every hot step. These re-express that intent at
    # step granularity and extend it to the density-collapse case the
    # reference has no guard for; disable both for reference-exact
    # dynamics):
    #  root_stab_reject: in-graph rejection of a step's root update when
    #    the root grad norm exceeds clip_scale (after the same 200-step
    #    grace period)
    #  root_stab_density: freeze root for one epoch when the occupied
    #    density fraction collapses below half its running max
    root_stab_reject: bool = True
    root_stab_density: bool = True
    warmup_steps: float = 0.4
    reinit_bone_steps: float = 0.667
    dskin_steps: float = 0.8
    init_beta: float = 0.1
    reset_beta: bool = False
    fine_steps: float = 1.1
    nf_reset: float = 0.5
    bound_reset: float = 0.5
    bound_factor: float = 2.0

    # optimization: initialization
    init_ellips: bool = False
    warmup_pose_ep: int = 0
    warmup_shape_ep: int = 0
    warmup_rootmlp: bool = False
    unc_filter: bool = True

    # optimization: fine-tuning
    keep_pose_basis: bool = True
    freeze_coarse: bool = False
    freeze_root: bool = False
    root_stab: bool = True
    freeze_cvf: bool = False
    freeze_shape: bool = False
    freeze_proj: bool = False
    freeze_body_mlp: bool = False
    proj_start: float = 0.0
    frzroot_start: float = 0.0
    frzbody_end: float = 0.0
    proj_end: float = 0.2

    # CSE fine-tuning
    ft_cse: bool = False
    mt_cse: bool = True
    mtcse_steps: float = 0.0
    ftcse_steps: float = 0.0

    # render / eval
    render_size: int = 64
    frame_chunk: int = 20
    chunk: int = 32 * 1024
    rnd_frame_chunk: int = 3
    queryfw: bool = True
    mc_threshold: float = -0.002
    full_mesh: bool = False
    ce_color: bool = True
    sample_grid3d: int = 64
    test_frames: str = "9"
    # NVS (scripts/visualize/nvs.py:33-39 script flags)
    rootdir: str = ""            # saved ctraj prefix (…-ctrajs-)
    nvs_outpath: str = "tmp/nvs-"
    bullet_time: int = -1        # frame id for bullet time (-1 = off)
    vidid: int = 0               # video id for env/pose codes
    maxframe: int = 0            # cap on rendered frames (0 = all)
    scale: float = 0.1           # render scale wrt saved intrinsics

    # losses
    use_embed: bool = True
    use_proj: bool = True
    use_corresp: bool = True
    dist_corresp: bool = True
    total_wt: float = 1.0
    sil_wt: float = 0.1
    img_wt: float = 0.1
    feat_wt: float = 0.0
    use_corr: bool = False
    corr_wt: float = 0.01
    frnd_wt: float = 1.0
    proj_wt: float = 0.02
    flow_wt: float = 1.0
    cyc_wt: float = 1.0
    rig_loss: bool = False
    root_sm: bool = True
    eikonal_wt: float = 0.0
    bone_loc_reg: float = 0.1
    loss_flt: bool = True
    rm_novp: bool = True
    use_ot: bool = True
    s3im_loss: bool = False
    s3im_wt: float = 0.01
    ppr_eikonal: bool = False
    rgb_filter: bool = False
    scale_rgb: float = 1.3

    # device-specific
    dtype: str = "float32"       # compute dtype for field MLPs
    data_parallel: int = 1       # data-parallel mesh size (pjit over "data")
    feat_ndepth_grid: int = 20   # feat_match grid size
    use_pallas: bool = True      # hand-written bf16 fused-MLP kernels on
                                 # the training hot path for CUDA tensors
                                 # (eval stays fp32 via MoDAModel.precise())

    def replace(self, **kw) -> "MoDAConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "MoDAConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(MoDAConfig)}
        return MoDAConfig(**{k: v for k, v in d.items() if k in known})


@dataclass
class SeqData:
    """One [data_i] block of a sequence .config file."""

    datapath: str
    ks: Tuple[float, float, float, float]
    dframe: List[int]
    init_frame: int = 0
    end_frame: int = -1
    can_frame: int = -1
    rtk_path: Optional[str] = None
    flip: int = 0

    def image_list(self) -> List[str]:
        imgs = sorted(glob.glob(os.path.join(self.datapath, "*")))
        if self.end_frame > 0:
            imgs = imgs[: self.end_frame]
        return imgs


def load_seq_config(seqname: str, config_dir: str = "configs") -> List[SeqData]:
    """Parse configs/<seqname>.config (drop-in compatible with the reference
    format: utils/io.py:292-332 + moda.py:388-396)."""
    path = os.path.join(config_dir, f"{seqname}.config")
    cfg = configparser.RawConfigParser()
    read = cfg.read(path)
    if not read:
        raise FileNotFoundError(path)
    num_vid = len(cfg.sections()) - 1

    def get(section, key, fallback=None):
        try:
            return cfg.get(section, key)
        except (configparser.NoOptionError, configparser.NoSectionError):
            return fallback

    out = []
    for i in range(num_vid):
        sec = f"data_{i}"
        datapath = get(sec, "datapath", get("data", "datapath", ""))
        if num_vid == 1 and not cfg.has_option(sec, "datapath"):
            datapath = os.path.join(datapath, seqname)
        ks = tuple(float(x) for x in get(sec, "ks", get("data", "ks", "1 1 0 0")).split())
        dframe = [int(x) for x in str(get(sec, "dframe", get("data", "dframe", "1"))).split(",")]
        out.append(
            SeqData(
                datapath=datapath,
                ks=ks,  # type: ignore[arg-type]
                dframe=dframe,
                init_frame=int(get(sec, "init_frame", get("data", "init_frame", 0))),
                end_frame=int(get(sec, "end_frame", get("data", "end_frame", -1))),
                can_frame=int(get(sec, "can_frame", get("data", "can_frame", -1))),
                rtk_path=get(sec, "rtk_path", get("data", "rtk_path", None)),
                flip=int(get(sec, "flip", 0)),
            )
        )
    return out


@dataclass(frozen=True)
class DataInfo:
    """Static dataset facts needed to build the model (reference data_info,
    utils/io.py:537-548): per-video frame offsets and image paths."""

    offset: Tuple[int, ...]  # len num_vid+1, cumulative frame counts
    impath: Tuple[str, ...] = ()
    intrinsics: Tuple[Tuple[float, float, float, float], ...] = ((1.0, 1.0, 0.0, 0.0),)

    @property
    def num_fr(self) -> int:
        return self.offset[-1]

    @property
    def num_vid(self) -> int:
        return len(self.offset) - 1

    @property
    def max_ts(self) -> int:
        return max(b - a for a, b in zip(self.offset[:-1], self.offset[1:]))
