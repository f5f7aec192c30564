"""Loss assembly: counterpart of moda_tpu/render/losses.py (the terms of the
init, ft1 and ft2 stages, and the shape warmup's ``shape_init_loss``).

  extras = {
    "loss_select":  scalar (0: flow-only warmup, 1: all losses),
    "invalid_mask": [R, 1] multiplier (1 keep, 0 reject) from loss_flt,
    "shape_samp":   [S, 3] canonical surface samples (or zeros),
    "shape_samp_valid": scalar {0,1},
    "progress":     scalar in [0,1],
    "xyz_wt_snapshot": {component: {layer: kernel}} (freeze_coarse; optional),
  }
The eikonal term's point indices come from draws["eik_idx"] [n_sample]
when given, else from the generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

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


def elastic_loss(model, xyz: torch.Tensor, time_embedded: torch.Tensor,
                 embed_alpha=None) -> torch.Tensor:
    """Log-determinant penalty on the Jacobian of the flowbw field (plus the
    identity) at detached points xyz [N, 3] with codes [N, C]; a point whose
    determinant's sign is <= 0 adds 0. Not wired into total_loss, as in the
    JAX package."""
    xyz = xyz.detach().reshape(-1, 3)
    code = time_embedded.detach().reshape(-1, time_embedded.shape[-1])

    def flow_fn(p, c):
        x = torch.cat([model.embed_xyz(p[None], embed_alpha), c[None]], -1)
        return model.nerf_flowbw(x)[0]

    jac = vmap(jacfwd(flow_fn))(xyz, code) + torch.eye(3, device=xyz.device)[None]
    sign, logdet = torch.linalg.slogdet(jac)
    logdet = torch.where(sign <= 0, torch.zeros_like(logdet), logdet)
    return (logdet ** 2).mean()


def shape_init_loss(model, pts_samp: torch.Tensor, obj_bound: torch.Tensor, use_ellips: bool,
                    embed_alpha=None) -> torch.Tensor:
    """Fit the SDF to an ellipsoid/sphere prior (loss_utils.py:540-572), on
    the plain sigma-only path. pts_samp: [N,3] query points in the loose
    bound; obj_bound [3]: the tight prior-mesh bound."""
    if use_ellips:
        dis = torch.sqrt(((pts_samp / obj_bound[None]) ** 2).sum(-1)) - 1.0
        dis = dis * obj_bound.mean()
    else:
        dis = torch.sqrt((pts_samp ** 2).sum(-1)) - obj_bound.min()
    y = model.apply_coarse(model.embed_xyz(pts_samp, embed_alpha), sigma_only=True)
    sdf = -y[..., 0]
    return ((sdf - dis) ** 2).mean()


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

    if cfg.s3im_loss and "s3im_loss" in rendered:
        s3im = cfg.s3im_wt * rendered["s3im_loss"].mean()
        total = total + s3im
        aux["s3im_loss"] = s3im

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
        aux["beta_feat"] = model.nerf_beta_feat[0].detach().clone()
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

    # the displacement field's regularizers, backward and forward
    for k in ("dis_reg", "dis_reg_forward"):
        if k in rendered:
            total = total + rendered[k].mean()

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

    if cfg.freeze_coarse and "xyz_wt_snapshot" in extras:
        # pin the trunks' input-layer kernels to their values at stage start
        snap = extras["xyz_wt_snapshot"]
        for comp, label in (("nerf_coarse", "shape"), ("nerf_skin", "skin"),
                            ("nerf_feat", "feat")):
            if comp not in snap or not hasattr(model, comp):
                continue
            terms = [((k0.detach() - getattr(model, comp).get_submodule(layer).kernel) ** 2)
                     .mean() for layer, k0 in snap[comp].items()]
            wt_loss = 100.0 * torch.stack(terms).mean()
            aux[f"{label}_xyz_wt_loss"] = wt_loss
            total = total + wt_loss

    # parameter values are cloned: the step updates the parameters in place
    # after the loss, and aux must keep the values this loss saw
    if model.has_bones:
        aux["skin_scale"] = model.skin_aux[0].detach().clone()
        aux["skin_const"] = model.skin_aux[1].detach().clone()
    total = total * cfg.total_wt
    aux["total_loss"] = total
    aux["beta"] = model.nerf_beta[0].detach().clone()
    return total, aux
