"""Loss assembly: counterpart of moda_tpu/render/losses.py (the terms of the
init, ft1 and ft2 stages).

  extras = {
    "loss_select":  scalar (0: flow-only warmup, 1: all losses),
    "invalid_mask": [R, 1] multiplier (1 keep, 0 reject) from loss_flt,
    "shape_samp":   [S, 3] canonical surface samples (or zeros),
    "shape_samp_valid": scalar {0,1},
    "progress":     scalar in [0,1],
  }
The eikonal term's point indices come from draws["eik_idx"] [n_sample]
when given, else from the generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.ops.sinkhorn import sinkhorn_divergence


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def eikonal_loss(model, pts, bound, ppr: bool, n_sample: int = 1000, embed_alpha=None,
                 idx: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """|grad sdf| == 1 on canonical points. Stays on the plain sigma-only
    path: the analytic form differentiates the gradient itself."""
    pts = pts.detach().reshape(-1, 3)
    if idx is None:
        gdev = generator.device if generator is not None else pts.device
        idx = torch.randint(0, pts.shape[0], (n_sample,), generator=generator, device=gdev)
    idx = idx.to(pts.device)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= pts.shape[0]):
        raise IndexError("eikonal point index out of range")
    pts = pts[idx]
    inb = ((bound[None, :] - torch.abs(pts)) > 0).all(-1).to(pts.dtype)

    def sdf_fn(p):
        return model.apply_coarse(model.embed_xyz(p, embed_alpha), sigma_only=True)[..., 0]

    if ppr:
        eps = 1e-3
        ks = [pts.new_tensor(k) for k in ([1.0, -1.0, -1.0], [-1.0, -1.0, 1.0],
                                          [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0])]
        g = sum(k[None] * sdf_fn(pts + k * eps)[:, None] for k in ks) / (4.0 * eps)
    else:
        pts = pts.requires_grad_(True)
        g, = torch.autograd.grad(sdf_fn(pts).sum(), pts, create_graph=True)
    return masked_mean((Q.safe_norm(g) - 1.0) ** 2, inb)


def compute_root_sm_2nd_loss(rtk_all: torch.Tensor, data_offset) -> torch.Tensor:
    """2nd-order camera smoothness per video."""
    rot_terms, trn_terms = [], []
    for i in range(len(data_offset) - 1):
        s, e = int(data_offset[i]), int(data_offset[i + 1])
        if e - s < 3:
            continue
        stt, mid, end = rtk_all[s:e - 2], rtk_all[s + 1:e - 1], rtk_all[s + 2:e]
        rot1 = stt[:, :3, :3] @ mid[:, :3, :3].transpose(-1, -2)
        rot2 = mid[:, :3, :3] @ end[:, :3, :3].transpose(-1, -2)
        rot_sm = rot1 @ rot2.transpose(-1, -2)
        trn_sm = (stt[:, :3, 3] - mid[:, :3, 3]) - (mid[:, :3, 3] - end[:, :3, 3])
        rot_terms.append(Q.rot_angle(rot_sm))
        trn_terms.append(Q.safe_norm(trn_sm))
    if not rot_terms:
        return torch.zeros((), device=rtk_all.device)
    return (torch.cat(rot_terms).mean() * 1e-1 + torch.cat(trn_terms).mean()) * 0.1


def total_loss(model, rendered: Dict[str, torch.Tensor], rays: Dict[str, torch.Tensor],
               rtk_all: torch.Tensor, extras: Dict[str, torch.Tensor],
               draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    cfg = model.cfg
    if cfg.freeze_coarse or cfg.s3im_loss:
        raise NotImplementedError("freeze_coarse / s3im loss terms are ported in a "
                                  "later slice of moda_tpu_torch")
    aux: Dict[str, torch.Tensor] = {}
    sil_at_samp = rays["sil_at_samp"]
    vis_at_samp = rays["vis_at_samp"]
    sil_at_samp_flo = rendered["sil_at_samp_flo"]
    invalid_mask = extras.get("invalid_mask")
    keep = 1.0 if invalid_mask is None else invalid_mask
    sil_coarse = rendered["sil_coarse"].detach()

    img_loss_samp = cfg.img_wt * rendered["img_loss_samp"] * keep
    img_loss = img_loss_samp
    if cfg.rm_novp:
        img_loss = img_loss * sil_coarse
    img_loss = masked_mean(img_loss, sil_at_samp > 0)
    sil_loss = masked_mean(cfg.sil_wt * rendered["sil_loss_samp"] * keep, vis_at_samp > 0)
    aux["sil_loss"] = sil_loss
    aux["img_loss"] = img_loss
    total = img_loss + sil_loss

    if cfg.use_embed:
        frnd = cfg.frnd_wt * rendered["frnd_loss_samp"] * keep
        if cfg.rm_novp:
            frnd = frnd * sil_coarse
        feat_rnd_loss = masked_mean(frnd, sil_at_samp > 0)
        aux["feat_rnd_loss"] = feat_rnd_loss
        total = total + feat_rnd_loss

    if cfg.use_corresp:
        flo = rendered["flo_loss_samp"] * keep
        if cfg.rm_novp:
            flo = flo * sil_coarse
        flo_loss = masked_mean(flo, sil_at_samp_flo > 0) * 2.0 * cfg.flow_wt
        total = torch.where(torch.as_tensor(extras["loss_select"]) == 0, flo_loss,
                            total + flo_loss)
        aux["flo_loss"] = flo_loss

    if cfg.use_embed:
        feat_loss = cfg.feat_wt * rendered["feat_err"] * keep
        if cfg.rm_novp:
            feat_loss = feat_loss * sil_coarse
        feat_loss = masked_mean(feat_loss, sil_at_samp > 0)
        total = total + feat_loss
        aux["feat_loss"] = feat_loss
        aux["beta_feat"] = model.nerf_beta_feat[0].detach()
        if cfg.use_corr:
            corr = cfg.corr_wt * rendered["corr_err"] * keep
            if cfg.rm_novp:
                corr = corr * sil_coarse
            corr_loss = masked_mean(corr, sil_at_samp > 0)
            total = total + corr_loss
            aux["corr_loss"] = corr_loss
    if cfg.use_proj and "proj_err" in rendered:
        proj_loss = masked_mean(cfg.proj_wt * rendered["proj_err"] * keep, sil_at_samp > 0)
        aux["proj_loss"] = proj_loss
        total = total + proj_loss
        if cfg.freeze_proj:
            # pose-correction stage: ramp from 10x proj-only to the full loss
            progress = torch.as_tensor(extras["progress"], device=total.device)
            ww = (progress - cfg.proj_start) / max(cfg.proj_end - cfg.proj_start, 1e-9)
            ww = torch.clamp((ww - 0.8) * 5.0, 0.0, 1.0)
            in_window = (progress > cfg.proj_start) & (progress < cfg.proj_end)
            total = torch.where(in_window, total * ww + 10.0 * proj_loss * (1.0 - ww), total)

    if "frame_cyc_dis" in rendered:
        cyc_loss = rendered["frame_cyc_dis"].mean()
        total = total + cyc_loss * cfg.cyc_wt
        aux["cyc_loss"] = cyc_loss

    if cfg.root_sm:
        root_sm_loss = compute_root_sm_2nd_loss(rtk_all, model.offset)
        aux["root_sm_loss"] = root_sm_loss
        total = total + root_sm_loss

    if cfg.eikonal_wt > 0 and "xyz_canonical_vis" in rendered:
        idx = None if draws is None else draws.get("eik_idx")
        ekl = cfg.eikonal_wt * eikonal_loss(
            model, rendered["xyz_canonical_vis"], model.mvars.obj_bound, cfg.ppr_eikonal,
            embed_alpha=rays.get("embed_alpha"), idx=idx, generator=generator)
        aux["ekl_loss"] = ekl
        total = total + ekl

    if cfg.bone_loc_reg > 0 and "shape_samp" in extras and "bones_rst" in rays:
        bone_loc_loss = sinkhorn_divergence(rays["bones_rst"][:, :3] * 10.0,
                                            extras["shape_samp"] * 10.0)
        bone_loc_loss = cfg.bone_loc_reg * bone_loc_loss * extras["shape_samp_valid"]
        total = total + bone_loc_loss
        aux["bone_loc_loss"] = bone_loc_loss

    if "vis_loss" in rendered:
        vis_loss = 0.01 * rendered["vis_loss"].mean()
        total = total + vis_loss
        aux["visibility_loss"] = vis_loss

    if cfg.use_unc and "unc_pred" in rendered:
        # the uncertainty head regresses this step's masked photometric error
        unc_rgb = (sil_at_samp[..., 0] * img_loss_samp.mean(-1)).detach()
        unc_loss = ((unc_rgb - rendered["unc_pred"][..., 0]) ** 2).mean()
        aux["unc_loss"] = unc_loss
        total = total + unc_loss

    aux["skin_scale"] = model.skin_aux[0].detach()
    aux["skin_const"] = model.skin_aux[1].detach()
    total = total * cfg.total_wt
    aux["total_loss"] = total
    aux["beta"] = model.nerf_beta[0].detach()
    return total, aux
