"""Optimizer: Adam with per-group LR multipliers and decoupled weight decay,
one-cycle schedule, per-group gradient clipping, freeze masks and
non-finite-step rejection. Counterpart of moda_tpu/train/optim.py.

Parameters and gradients are dicts keyed by the parameter's dotted name
("nerf_coarse.xyz_1.kernel"); the group is the first component, which is
the top-level key of the JAX package's parameter pytree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

# group -> (lr multiplier, clip multiplier); clip multiplies cfg.clip_scale
GROUP_TABLE: Dict[str, Tuple[float, float]] = {
    "nerf_coarse": (1.0, 1.0),
    "nerf_beta": (1.0, 1.0),
    "nerf_feat": (1.0, 0.1),
    "nerf_beta_feat": (10.0, 0.1),
    "nerf_fine": (1.0, 0.1),
    "nerf_unc": (1.0, 0.1),
    "nerf_flowbw": (1.0, 0.1),
    "nerf_flowfw": (1.0, 0.1),
    "nerf_skin": (1.0, 0.1),
    "nerf_dis": (1.0, 0.1),
    "nerf_vis": (1.0, 0.1),
    "nerf_root_rts": (1.0, 100.0),
    "nerf_body_rts": (1.0, 100.0),
    "root_code": (1.0, 0.1),
    "pose_code": (1.0, 100.0),
    "rest_pose_code": (1.0, 100.0),
    "env_code": (1.0, 0.1),
    "appearance_code": (1.0, 0.1),
    "vid_code": (1.0, 0.1),
    "bones": (1.0, 1.0),
    "skin_aux": (10.0, 0.1),
    "ks_param": (10.0, 0.1),
    "nerf_dp": (1.0, 0.1),
    "csenet": (1.0, 0.1),
}

ROOT_BASIS_LR = {"exp": 10.0, "cnn": 0.2, "mlp": 1.0, "expmlp": 1.0}


def group_of(name: str) -> str:
    return name.split(".", 1)[0]


def lr_mult_for(group: str, root_basis: str) -> float:
    mult = GROUP_TABLE.get(group, (1.0, 1.0))[0]
    if group in ("nerf_root_rts", "root_code"):
        mult *= ROOT_BASIS_LR[root_basis]
    return mult


def onecycle_lr(base_lr: float, total_steps: int, num_epochs: int):
    """Warmup max/25 -> max over 2/num_epochs of the steps, then linear
    anneal max -> max/5."""
    pct_start = 2.0 / max(num_epochs, 1)
    warmup = max(int(total_steps * pct_start), 1)

    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = base_lr / 25.0 + (base_lr - base_lr / 25.0) * (step / warmup)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        down = base_lr + (base_lr / 5.0 - base_lr) * frac
        return torch.where(step < warmup, up, down)

    return sched


@dataclass
class OptState:
    count: torch.Tensor  # int32 scalar on the params' device
    mu: Tensors
    nu: Tensors


class MoDAOptimizer:
    """Adam(0.9, 0.999, eps 1e-8) + weight decay 1e-4 + one-cycle LR +
    group LR multipliers."""

    def __init__(self, cfg, total_steps: int):
        self.cfg = cfg
        self.total_steps = int(total_steps)
        self.sched = onecycle_lr(cfg.learning_rate, self.total_steps, cfg.num_epochs)
        self.b1, self.b2, self.eps, self.wd = 0.9, 0.999, 1e-8, 1e-4

    def init(self, params: Tensors) -> OptState:
        dev = next(iter(params.values())).device
        return OptState(count=torch.zeros((), dtype=torch.int32, device=dev),
                        mu={k: torch.zeros_like(v) for k, v in params.items()},
                        nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors,
               finite: torch.Tensor) -> Tuple[Tensors, OptState]:
        """One step. Where ``finite`` is false the old parameters AND the old
        moments and count are kept (the whole step is rejected)."""
        lr = self.sched(state.count.float()).to(state.count.device)
        count_inc = state.count + 1
        bc1 = 1.0 - self.b1 ** count_inc.float()
        bc2 = 1.0 - self.b2 ** count_inc.float()
        new_p, new_mu, new_nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu = (1.0 - self.b2) * g * g + self.b2 * state.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            mult = lr_mult_for(group_of(k), self.cfg.root_basis)
            upd = p + (-(lr * mult)) * (u + self.wd * p)
            new_p[k] = torch.where(finite, upd, p)
            new_mu[k] = torch.where(finite, mu, state.mu[k])
            new_nu[k] = torch.where(finite, nu, state.nu[k])
        count = torch.where(finite, count_inc, state.count)
        return new_p, OptState(count=count, mu=new_mu, nu=new_nu)


def group_norms(grads: Tensors) -> Dict[str, torch.Tensor]:
    sq: Dict[str, torch.Tensor] = {}
    for k, g in grads.items():
        grp = group_of(k)
        s = (g * g).sum()
        sq[grp] = s if grp not in sq else sq[grp] + s
    return {grp: torch.sqrt(v) for grp, v in sq.items()}


def clip_by_group(grads: Tensors, clip_scale: float) -> Tuple[Tensors, Dict[str, torch.Tensor]]:
    """Per-group clip_grad_norm_. Returns clipped grads and the per-group
    pre-clip norms (logged as <group>_g)."""
    norms = group_norms(grads)
    factors = {grp: torch.clamp(GROUP_TABLE.get(grp, (1.0, 0.1))[1] * clip_scale /
                                torch.clamp(n, min=1e-12), max=1.0)
               for grp, n in norms.items()}
    out = {k: g * factors[group_of(k)] for k, g in grads.items()}
    return out, {grp + "_g": n for grp, n in norms.items()}


INPUT_LAYERS = ("xyz_1", "xyz_5")  # trunk input + skip re-injection layers
POS_DIM = 63


def apply_freeze_masks(grads: Tensors, indicators: Dict[str, torch.Tensor], cfg) -> Tensors:
    """Zero the gradients of frozen groups (root/body: 1=update;
    shape/cvf: 1=freeze)."""
    on = {}
    for grp in ("root_code", "nerf_root_rts"):
        on[grp] = indicators["root_update"]
    for grp in ("pose_code", "rest_pose_code", "nerf_body_rts"):
        on[grp] = indicators["body_update"]
    shape_on = 1.0 - torch.as_tensor(indicators["shape_update"])
    for grp in ("nerf_coarse", "nerf_beta", "nerf_vis", "bones", "nerf_skin", "nerf_dis",
                "skin_aux"):
        on[grp] = shape_on
    cvf_on = 1.0 - torch.as_tensor(indicators["cvf_update"])
    for grp in ("nerf_feat", "nerf_beta_feat", "csenet"):
        on[grp] = cvf_on
    out = {}
    for k, g in grads.items():
        grp = group_of(k)
        if grp in on:
            g = g * torch.as_tensor(on[grp], dtype=g.dtype, device=g.device)
        if cfg.freeze_body_mlp and grp == "nerf_body_rts":
            g = g * 0.0
        if cfg.freeze_coarse:
            # only the positional input rows of coarse/skin/feat trunks train
            parts = k.split(".")
            if grp in ("nerf_coarse", "nerf_skin", "nerf_feat"):
                if parts[-2] in INPUT_LAYERS and parts[-1] == "kernel":
                    mask = (torch.arange(g.shape[0], device=g.device) < POS_DIM)[:, None]
                    g = g * mask
                else:
                    g = g * 0.0
            elif grp in ("bones", "skin_aux", "nerf_vis"):
                g = g * 0.0
        out[k] = g
    return out


def reject_nonfinite(grads: Tensors) -> Tuple[Tensors, torch.Tensor]:
    """Zero the whole step if any gradient is non-finite."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    return {k: torch.where(finite, g, torch.zeros_like(g)) for k, g in grads.items()}, finite
