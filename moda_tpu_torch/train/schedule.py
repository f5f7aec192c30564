"""Training schedule indicators, as pure functions of (progress, step, cfg):
the port's copy of moda_tpu/train/schedule.py.

Mirrors the indicator logic of train_utils.py:994-1092:
- cvf_update / shape_update: 1 = freeze
- root_update / body_update: 1 = update
- loss_select: 0 = flow-only warmup step, 1 = all losses

``counter_frz_rebone`` (freeze-after-bone-reinit countdown,
train_utils.py:980,1116) is tracked by the trainer and passed in.
"""
from __future__ import annotations

from dataclasses import dataclass

from moda_tpu_torch.config import MoDAConfig


@dataclass
class Indicators:
    root_update: float
    body_update: float
    shape_update: float
    cvf_update: float
    loss_select: int


def compute_indicators(cfg: MoDAConfig, progress: float, step_in_epoch: int,
                       counter_frz_rebone: float, is_fine_tune: bool) -> Indicators:
    """is_fine_tune: model loaded from checkpoint (opts.model_path != '')."""
    # cvf (train_utils.py:994-1014)
    cvf = 0.0
    if cfg.freeze_proj and cfg.proj_start <= progress < (cfg.proj_start + cfg.proj_end):
        cvf = 1.0
    if counter_frz_rebone > 0:
        cvf = 1.0
    if cfg.freeze_cvf:
        cvf = 1.0

    # shape (train_utils.py:1016-1038)
    shape = 0.0
    if (is_fine_tune and progress < cfg.warmup_steps) or (
        cfg.freeze_proj and cfg.proj_start <= progress < (cfg.proj_start + cfg.proj_end)
    ):
        shape = 1.0
    if counter_frz_rebone > 0:
        shape = 1.0
    if cfg.freeze_shape:
        shape = 1.0

    # root (train_utils.py:1040-1061)
    root = 1.0
    if cfg.freeze_proj and cfg.root_stab and (
        cfg.frzroot_start <= progress <= cfg.proj_start + cfg.proj_end + 0.01
    ):
        root = 0.0
    if counter_frz_rebone > 0:
        root = 0.0
    if cfg.freeze_root:
        root = 0.0

    # body (train_utils.py:1063-1074)
    body = 1.0
    if cfg.freeze_proj and progress <= cfg.frzbody_end:
        body = 0.0

    # loss select (train_utils.py:1077-1089)
    if not cfg.root_opt or progress > cfg.warmup_steps:
        loss_select = 1
    elif step_in_epoch % 2 == 0:
        loss_select = 0
    else:
        loss_select = 1

    return Indicators(root_update=root, body_update=body, shape_update=shape,
                      cvf_update=cvf, loss_select=loss_select)


def use_fine_samples(cfg: MoDAConfig, progress: float) -> bool:
    """moda.py:879-883."""
    return progress > cfg.fine_steps


def use_dskin(cfg: MoDAConfig, epoch: int, num_epochs: int) -> bool:
    """nerf_skin delta weights activate at dskin_steps (train_utils.py:1129-1131)."""
    return cfg.nerf_skin and epoch >= int(num_epochs * cfg.dskin_steps)


def use_bones(cfg: MoDAConfig, epoch: int, is_fine_tune: bool) -> bool:
    """Bones are disabled only during the (pre-epoch-loop) warmups; the
    epoch-0 reinit_bones call re-enables them before the first main epoch
    (train_utils.py:637-641 + 1108-1112), so every main epoch trains with
    the deformation model."""
    return cfg.lbs or cfg.neudbs


def embedding_alpha(cfg: MoDAConfig, progress: float, num_freqs: int = 10) -> float:
    """Coarse-to-fine frequency annealing (moda.py:1535-1541)."""
    if not cfg.anneal_freq:
        return float(cfg.alpha)
    alpha = num_freqs * progress / max(cfg.warmup_steps, 1e-9)
    return float(min(max(6.0, alpha), num_freqs))
