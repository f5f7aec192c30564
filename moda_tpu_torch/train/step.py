"""The training step: forward render -> losses -> grads -> update.

Counterpart of moda_tpu/train/step.py for the init, ft1 and ft2 stages
(fine pass, delta-skin MLP, uncertainty-guided active sampling). The step
updates the model's parameters and the optimizer state in place and
returns (aux, host_out). Random draws come from a ``torch.Generator`` or,
for tests, from an explicit ``draws`` dict (see render/rays.py,
render/pipeline.py and "eik_idx" [1000]).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from moda_tpu_torch.render import losses as L
from moda_tpu_torch.render.pipeline import render_rays
from moda_tpu_torch.render.rays import build_rays
from moda_tpu_torch.runtime import Device, resolve_device
from moda_tpu_torch.train.optim import (MoDAOptimizer, OptState, apply_freeze_masks,
                                        clip_by_group, reject_nonfinite)


def batch_rtk(model, rtk_all3: torch.Tensor, batch) -> torch.Tensor:
    """Per-batch rtk [2B,4,4]: root poses (rows 0-2) + intrinsics (row 3)."""
    rt = rtk_all3[batch["frameid"]]
    ks = model.ks_param[batch["dataid"]]
    return torch.cat([rt, ks[:, None, :]], 1)


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_sum: ids outside [0, n) are dropped, not raised on."""
    ok = (ids >= 0) & (ids < n)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, torch.where(ok, ids, torch.zeros_like(ids)),
                          torch.where(ok, vals, torch.zeros_like(vals)))


def sil_loss_filter(sil_loss_samp, frameid, num_fr, sil_err_median, progress, warmup_steps,
                    scale_factor=10.0):
    """Frame-level outlier rejection against a host-provided running median.
    Returns (keep [R,1], frame_err [num_fr], frame_cnt [num_fr])."""
    err = sil_loss_samp[..., 0]
    sums = _segment_sum(err, frameid, num_fr)
    cnts = _segment_sum((err > 0).to(err.dtype), frameid, num_fr)
    frame_err = sums / torch.clamp(cnts, min=1e-9)
    bad_frame = frame_err > sil_err_median * scale_factor
    active = torch.as_tensor(progress, device=err.device) > warmup_steps
    keep = torch.where(active & bad_frame[frameid], 0.0, 1.0)[..., None]
    return keep, frame_err, cnts


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """np.median over the masked subset; +inf when the subset is empty."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    lo = s[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)]
    hi = s[torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, float("inf")))


def sil_loss_filter_line(sil_loss_samp, errid, frameid, num_fr, img_size, progress,
                         warmup_steps, scale_factor=10.0):
    """Line-level outlier rejection for lineload training: per-line mean
    sil error, per-frame mean over nonzero lines, frames above 10x the
    masked median of this step are rejected."""
    err = sil_loss_samp[..., 0]
    nlines = num_fr * img_size
    line_sum = _segment_sum(err, errid, nlines)
    line_cnt = _segment_sum((err > 0).to(err.dtype), errid, nlines)
    line_err = (line_sum / torch.clamp(line_cnt, min=1e-9)).reshape(num_fr, img_size)
    fr_cnt = (line_err > 0).sum(-1).to(err.dtype)
    frame_err = line_err.sum(-1) / (1e-9 + fr_cnt)
    med = masked_median(frame_err, frame_err > 0)
    bad_frame = frame_err > med * scale_factor
    active = torch.as_tensor(progress, device=err.device) > warmup_steps
    keep = torch.where(active & bad_frame[frameid], 0.0, 1.0)[..., None]
    return keep, frame_err, fr_cnt


class StepExtras(NamedTuple):
    """Per-step scalars/arrays prepared by the trainer."""

    progress: torch.Tensor
    loss_select: torch.Tensor
    root_update: torch.Tensor
    body_update: torch.Tensor
    shape_update: torch.Tensor
    cvf_update: torch.Tensor
    sil_err_median: torch.Tensor
    shape_samp: torch.Tensor
    shape_samp_valid: torch.Tensor
    embed_alpha: torch.Tensor
    base_rt: Optional[torch.Tensor] = None


def make_train_step(model, optimizer: MoDAOptimizer, *, nsample: int, ndepth: int,
                    use_fine: bool, use_dskin: bool, use_bones: bool,
                    nsample_active: int = 0, accu_steps: int = 1, chunk_steps: int = 1,
                    device: Device = None):
    """Returns ``step(batch, extras, generator=None, draws=None) -> (aux,
    host_out)``, which updates ``model``'s parameters and
    ``optimizer.state`` in place. The step runs on the card unless
    device="cpu" is passed (the model must already live there)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    for flag, what in ((not use_bones, "use_bones=False"), (accu_steps > 1, "accu_steps > 1"),
                       (chunk_steps > 1, "chunk_steps > 1")):
        if flag:
            raise NotImplementedError(f"{what} is ported in a later slice of moda_tpu_torch")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    if getattr(optimizer, "state", None) is None:
        optimizer.state = optimizer.init({k: v.detach() for k, v in params.items()})

    def loss_fn(batch, extras: StepExtras, draws, generator):
        draws = draws or {}
        base_rt = extras.base_rt if cfg.use_cam else None
        rtk_all3 = model.compute_rts(base_rt=base_rt)
        rtk = batch_rtk(model, rtk_all3, batch)
        rays = build_rays(model, batch, rtk, nsample, nsample_active=nsample_active,
                          embed_alpha=extras.embed_alpha, generator=generator, draws=draws)
        rendered = render_rays(model, rays, ndepth, use_fine=use_fine, use_dskin=use_dskin,
                               draws=draws, generator=generator)
        keep = torch.ones_like(rendered["sil_loss_samp"])
        frame_err = torch.zeros(model.num_fr, device=dev)
        frame_cnt = torch.zeros(model.num_fr, device=dev)
        if cfg.loss_flt:
            if cfg.lineload and "errid" in rays:
                keep, frame_err, frame_cnt = sil_loss_filter_line(
                    rendered["sil_loss_samp"] * cfg.sil_wt, rays["errid"], rays["frameid"],
                    model.num_fr, cfg.img_size, extras.progress, cfg.warmup_steps)
            else:
                keep, frame_err, frame_cnt = sil_loss_filter(
                    rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"], model.num_fr,
                    extras.sil_err_median, extras.progress, cfg.warmup_steps)
        loss_extras = {
            "loss_select": extras.loss_select, "invalid_mask": keep,
            "shape_samp": extras.shape_samp, "shape_samp_valid": extras.shape_samp_valid,
            "progress": extras.progress,
        }
        rtk_all = torch.cat([rtk_all3, torch.zeros(model.num_fr, 1, 4, device=dev)], 1)
        total, aux = L.total_loss(model, rendered, rays, rtk_all, loss_extras, draws=draws,
                                  generator=generator)
        return total, aux, {"rtk": rtk.detach(), "frame_err": frame_err.detach(),
                            "frame_cnt": frame_cnt.detach()}

    def step(batch: Dict[str, torch.Tensor], extras: StepExtras,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        total, aux, host_out = loss_fn(batch, extras, draws, generator)
        plist = [params[n] for n in names]
        gl = torch.autograd.grad(total, plist, allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, plist, gl)}
        grads, finite = reject_nonfinite(grads)
        grads = apply_freeze_masks(grads, {
            "root_update": extras.root_update, "body_update": extras.body_update,
            "shape_update": extras.shape_update, "cvf_update": extras.cvf_update}, cfg)
        grads, norms = clip_by_group(grads, cfg.clip_scale)
        state: OptState = optimizer.state
        root_rejected = torch.zeros((), device=dev)
        if cfg.root_stab_reject and "nerf_root_rts_g" in norms:
            # drop this step's root update when the root gradient norm exceeds
            # clip_scale after the 200-step grace period
            root_hot = (norms["nerf_root_rts_g"] > cfg.clip_scale) & (state.count >= 200)
            keep_root = 1.0 - root_hot.float()
            grads = {k: (g * keep_root if k.split(".", 1)[0] in ("nerf_root_rts", "root_code")
                         else g) for k, g in grads.items()}
            root_rejected = root_hot.float()
        old = {n: params[n].detach() for n in names}
        new_params, optimizer.state = optimizer.update(grads, state, old, finite)
        with torch.no_grad():
            for n in names:
                params[n].copy_(new_params[n])
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(norms)
        aux["grad_finite"] = finite.float()
        aux["root_step_rejected"] = root_rejected
        aux["lr"] = optimizer.sched(state.count.float())
        aux["shape_frozen"] = torch.as_tensor(extras.shape_update, dtype=torch.float32)
        return aux, host_out

    return step
