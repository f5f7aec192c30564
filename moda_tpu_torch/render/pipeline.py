"""The ray-rendering pipeline: counterpart of moda_tpu/render/pipeline.py.

Ray bundles are dicts of tensors leading with [R]. Random draws: where the
JAX code splits a PRNG key, these functions take a ``draws`` dict holding
the draw itself (so a test can pass the numbers the JAX path made) and
otherwise draw from a ``torch.Generator``:
  "z_u"        [R, S0] uniform [0, 1)   stratified depth jitter (S0 = S, or
               S / 2 with the fine pass)
  "pdf_u"      [R, S / 2] uniform [0, 1)   fine-pass importance samples
  "symm_u"     [R, S, 1] uniform [0, 1)   symm_shape mirror mask (< 0.5)
  "grid_noise" [G^3, 3] standard normal feat-match grid jitter
  "vis_neg"    [R, S, 3] uniform [-1, 1) visibility negatives (x bound)
  "sigma_noise" [R, S] standard normal (used only when cfg.noise_std > 0)
The fine pass's no-grad coarse pass reads its own "symm_u" and
"sigma_noise" ([R, S / 2, ...]) under the names "coarse_symm_u" and
"coarse_sigma_noise".
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as Fn

from moda_tpu_torch.core import camera as cam
from moda_tpu_torch.core import density as DN
from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.core import sampling as SP
from moda_tpu_torch.core import skinning as SK

RayDict = Dict[str, torch.Tensor]
Draws = Dict[str, torch.Tensor]


def draw(draws: Optional[Draws], name: str, shape, generator: Optional[torch.Generator],
         device) -> torch.Tensor:
    """The named draw from ``draws``, else a fresh one from ``generator``."""
    if draws is not None and name in draws:
        return draws[name].to(device)
    gdev = generator.device if generator is not None else device
    if name.endswith("_u"):
        t = torch.rand(shape, generator=generator, device=gdev)
    elif name == "vis_neg":
        t = torch.rand(shape, generator=generator, device=gdev) * 2.0 - 1.0
    else:
        t = torch.randn(shape, generator=generator, device=gdev)
    return t.to(device)


def compute_pts_exp(pts_prob: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    p = pts_prob / (1e-9 + pts_prob.sum(-1, keepdim=True))
    return (pts * p[..., None]).sum(-2)


def vrender_flo(weights, xyz_target, xys, img_size: int):
    """Render 2D flow from per-sample target projections -> (flo, valid)."""
    xy_target = xyz_target[..., :2]
    invalid = (xyz_target[..., 2] < 1e-5) | (torch.linalg.norm(xy_target, dim=-1) > 2.0 * img_size)
    w = torch.where(invalid, torch.zeros_like(weights), weights)
    xy_t = torch.where(invalid[..., None], torch.zeros_like(xy_target), xy_target)
    w = w / (1e-9 + w.sum(-1, keepdim=True))
    flo = ((xy_t - xys[:, None, :]) * w[..., None]).sum(-2)
    flo = flo / img_size * 2.0
    valid = (invalid.sum(-1) == 0).to(flo.dtype)[..., None]
    return flo, valid


def _backward_warp(model, rays, xyz, alpha, use_dskin=False, site=None):
    """Frame -> canonical via NeuDBS (or LBS) backward skinning; with
    use_dskin the delta-skin MLP (the frame's pose code as per-ray trunk
    code) adds to the skinning logits."""
    cfg = model.cfg
    bones_rst, bone_rts_fw = rays["bones_rst"], rays["bone_rts"]
    if cfg.neudbs:
        bones_dfm = SK.bone_transform_dq(bones_rst, bone_rts_fw)
    else:
        bones_dfm = SK.bone_transform_rts(bones_rst, bone_rts_fw)
    dskin = None
    if cfg.nerf_skin and use_dskin:
        dskin = model.apply_skin(xyz, code_trunk=rays["time_embedded"], embed_raw=True,
                                 embed_alpha=alpha, site=site)
    skin_bw = SK.skinning_weights(bones_dfm, xyz, dskin, model.skin_aux[0])
    if cfg.neudbs:
        xyz_c, _ = SK.neu_dbs(bones_rst, bone_rts_fw, skin_bw, xyz, backward=True)
    else:
        xyz_c, _ = SK.lbs(bones_rst, bone_rts_fw, skin_bw, xyz, backward=True)
    return xyz_c, skin_bw


def _forward_warp(model, rays, xyz_c, bone_rts, alpha, use_dskin=False, site=None):
    """Canonical -> frame with forward skinning (skin at rest pose; the
    delta-skin MLP reads the rest-pose code)."""
    cfg = model.cfg
    bones_rst = rays["bones_rst"]
    dskin = None
    if cfg.nerf_skin and use_dskin:
        rest = rays["rest_pose_code"]
        dskin = model.apply_skin(xyz_c, code_trunk=rest.expand(xyz_c.shape[0], rest.shape[-1]),
                                 embed_raw=True, embed_alpha=alpha, site=site)
    skin_fw = SK.skinning_weights(bones_rst, xyz_c, dskin, model.skin_aux[0])
    if cfg.neudbs:
        xyz_f, _ = SK.neu_dbs(bones_rst, bone_rts, skin_fw, xyz_c, backward=False)
    else:
        xyz_f, _ = SK.lbs(bones_rst, bone_rts, skin_fw, xyz_c, backward=False)
    return xyz_f, skin_fw


def _project_with_rtk_vec(xyz, rtk_vec):
    R = xyz.shape[0]
    Rmat = rtk_vec[:, 0:9].reshape(R, 3, 3)
    Tmat = rtk_vec[:, 9:12]
    Kinv = rtk_vec[:, 12:21].reshape(R, 3, 3)
    K = cam.mat2K(cam.Kmatinv(Kinv))
    return cam.pinhole_cam(cam.obj_to_cam(xyz, Rmat, Tmat), K)


def _inference(model, rays, xyz, dir_, dir_embedded, z_vals, cfg, draws=None,
               generator=None, site=None):
    """Coarse and feature MLPs at the samples, then VolSDF compositing."""
    S = xyz.shape[1]
    alpha = rays.get("embed_alpha", None)
    parts = [dir_embedded] + [rays[k] for k in ("env_code", "appearance_code") if k in rays]
    code_dir = torch.cat(parts, -1)
    if cfg.use_embed:
        out, feat = model.apply_coarse_feat(xyz, code_dir=code_dir, embed_raw=True,
                                            embed_alpha=alpha, site=site)
    else:
        out = model.apply_coarse(xyz, code_dir=code_dir, embed_raw=True, embed_alpha=alpha,
                                 site=site)
        feat = torch.zeros_like(out[..., :3])
    rgbs = out[..., :3]
    sigmas_raw = out[..., 3]
    deltas = DN.ray_deltas(z_vals, dir_)
    if cfg.noise_std > 0:
        sigmas_raw = sigmas_raw + draw(draws, "sigma_noise", sigmas_raw.shape, generator,
                                       sigmas_raw.device) * cfg.noise_std
    semantic = cfg.scale_rgb * torch.sigmoid(-10.0 * sigmas_raw)
    beta_min = 2.0 * torch.mean(rays["far"] - rays["near"]) / S
    sigmas = DN.sdf_to_sigma(sigmas_raw, model.nerf_beta[0], beta_min=beta_min)
    _, weights, alpha_prod = DN.compositing_weights(sigmas, deltas)
    visibility = alpha_prod.detach()
    if cfg.rgb_filter:
        rgb_final = ((weights[:, :-1] * semantic[:, :-1])[..., None] * rgbs[:, :-1, :]).sum(-2)
    else:
        rgb_final = (weights[..., None] * rgbs).sum(-2)
    feat_final = (weights[..., None] * feat).sum(-2)
    depth_final = (weights * z_vals).sum(-1)
    return rgb_final, feat_final, depth_final, weights, visibility


def feat_match(model, feats, bound, grid_size, use_ot, is_training, embed_alpha=None,
               draws=None, generator=None):
    """Soft-argmax 3D location of 2D features in the canonical feature
    volume. feats [R,16] unit. Returns (pts_pred [R,3], prob_vol [R,G^3])."""
    g = grid_size
    lin = [torch.linspace(-1.0, 1.0, g, device=feats.device) * bound[i] for i in range(3)]
    grid = torch.stack(torch.meshgrid(lin[0], lin[1], lin[2], indexing="ij"), -1).reshape(-1, 3)
    if is_training:
        grid = grid + draw(draws, "grid_noise", grid.shape, generator, grid.device) * \
            bound[None, :] * 0.05
    # the grid carries no gradient: need_dx=False skips the input gradient
    vol_feat = model.apply_feat(grid, need_dx=False, embed_raw=True, embed_alpha=embed_alpha,
                                site="feat_grid")
    vol_feat = vol_feat / torch.clamp(torch.linalg.norm(vol_feat, dim=-1, keepdim=True), min=1e-9)
    cost = feats @ vol_feat.T
    if use_ot:
        # 20-iteration entropic OT with uniform marginals. With the kernels
        # on (cfg.use_pallas, any device) the matvecs read K rounded to bf16
        # and accumulate in fp32, as the JAX training path does
        K = torch.exp(-(1.0 - cost) / 0.03)
        n, m = K.shape
        prob1, prob2 = 1.0 / n, 1.0 / m
        a = torch.full((n, 1), 1.0 / n, device=K.device)
        if model.cfg.use_pallas:
            # K stays bf16 between uses; each product upcasts it on its own,
            # so, as in JAX, every use's cotangent is rounded to bf16 and the
            # uses' cotangents add up in bf16
            Km = K.to(torch.bfloat16)

            def mv(M, v):
                return M.float() @ v.to(torch.bfloat16).float()
        else:
            Km = K

            def mv(M, v):
                return M @ v
        KmT = Km.T
        for _ in range(20):
            b = prob2 / (mv(KmT, a) + 1e-8)
            a = prob1 / (mv(Km, b) + 1e-8)
        b = prob2 / (mv(KmT, a) + 1e-8)
        T_m = a * K * b.T
        prob_vol = T_m / T_m.sum(1, keepdim=True)
    else:
        beta = torch.abs(model.nerf_beta_feat[0]) + 1e-9
        prob_vol = torch.softmax(cost * beta, -1)
    return prob_vol @ grid, prob_vol


def kp_reproj(model, rays, pts_pred, to_target: bool, embed_alpha=None, use_dskin=False):
    """Forward-warp canonical points into the (target) frame and project."""
    xyz = pts_pred[:, None, :]
    bone_rts = rays["bone_rts_target"] if to_target else rays["bone_rts"]
    xyz, _ = _forward_warp(model, rays, xyz, bone_rts, embed_alpha, use_dskin=use_dskin,
                           site="skin_reproj")
    rtk_vec = rays["rtk_vec_target"] if to_target else rays["rtk_vec"]
    return _project_with_rtk_vec(xyz, rtk_vec)


def visibility_loss(model, xyz_pos, w_pos, bound, alpha=None, draws=None, generator=None):
    """Positive/negative visibility supervision, per ray [R] (normalized by
    S only: the caller means over rays)."""
    xyz_pos = xyz_pos.detach()
    w_pos = w_pos.detach()
    R, S = w_pos.shape
    xyz_neg = draw(draws, "vis_neg", (R, S, 3), generator, xyz_pos.device) * bound[None, None, :]
    # inputs carry no gradient: need_dx=False; negatives and positives in
    # one launch
    vis_both = model.apply_vis(torch.cat([xyz_neg, xyz_pos], 0), need_dx=False,
                               embed_raw=True, embed_alpha=alpha, site="vis")[..., 0]
    vis_neg, vis_pos = vis_both[:R], vis_both[R:]
    loss_neg = -Fn.logsigmoid(-vis_neg).sum(-1) * 0.1 / S
    loss_pos = -(Fn.logsigmoid(vis_pos) * w_pos).sum(-1) / S
    return loss_pos + loss_neg


def inference_deform(model, rays, xyz_sampled, z_vals, cfg, fine_iter=True,
                     use_dskin=False, draws=None, generator=None):
    """Deform + render + per-sample losses. fine_iter=False (the fine
    pass's coarse pass) returns after compositing."""
    if cfg.s3im_loss:
        raise NotImplementedError("s3im_loss is ported in a later slice of moda_tpu_torch")
    result: Dict[str, torch.Tensor] = {}
    alpha = rays.get("embed_alpha", None)
    tag = "" if fine_iter else "_coarse"
    xyz_canonical, _ = _backward_warp(model, rays, xyz_sampled, alpha, use_dskin=use_dskin,
                                      site="skin_bw" + tag)
    if fine_iter:
        xyz_cyc, skin_fw = _forward_warp(model, rays, xyz_canonical, rays["bone_rts"], alpha,
                                         use_dskin=use_dskin, site="skin_fw")
        frame_cyc_dis = Q.safe_norm(xyz_sampled - xyz_cyc)
        xyz_coarse_target = xyz_sampled
        if cfg.dist_corresp:
            if cfg.neudbs:
                xyz_coarse_target, _ = SK.neu_dbs(rays["bones_rst"], rays["bone_rts_target"],
                                                  skin_fw, xyz_canonical, backward=False)
            else:
                xyz_coarse_target, _ = SK.lbs(rays["bones_rst"], rays["bone_rts_target"],
                                              skin_fw, xyz_canonical, backward=False)

    xyz_input = xyz_canonical
    if cfg.symm_shape:
        # rigid-shape symmetrization: mirror x at a random half of the samples
        x = xyz_canonical[..., :1]
        u = draw(draws, "symm_u", x.shape, generator, x.device)
        xyz_input = torch.cat([torch.where(u < 0.5, -x, x), xyz_canonical[..., 1:3]], -1)

    rgb, feat_rnd, depth_rnd, weights, vis_coarse = _inference(
        model, rays, xyz_input, rays["rays_d"], rays["dir_embedded"], z_vals, cfg,
        draws=draws, generator=generator, site="trunk_feat" + tag)
    sil = weights[:, :-1].sum(-1)
    result["img_coarse"] = rgb
    result["depth_rnd"] = depth_rnd[..., None]
    result["sil_coarse"] = sil[..., None]
    if cfg.use_embed:
        result["feat_rnd"] = feat_rnd / torch.clamp(Q.safe_norm(feat_rnd, keepdims=True), min=1e-9)
    if not fine_iter:
        return result, weights
    result["xyz_canonical_vis"] = xyz_canonical
    if cfg.use_corresp and not cfg.dist_corresp:
        pts_target = kp_reproj(model, rays, compute_pts_exp(weights, xyz_canonical),
                               to_target=True, embed_alpha=alpha, use_dskin=use_dskin)
    if cfg.use_embed and "feats_at_samp" in rays:
        pts_exp = compute_pts_exp(weights, xyz_canonical)
        pts_pred, prob_vol = feat_match(model, rays["feats_at_samp"], model.mvars.obj_bound,
                                        cfg.feat_ndepth_grid, cfg.use_ot, is_training=True,
                                        embed_alpha=alpha, draws=draws, generator=generator)
        result["pts_pred"] = pts_pred
        result["pts_exp"] = pts_exp
        result["feat_err"] = Q.safe_norm(pts_pred - pts_exp)[..., None]
        if cfg.use_corr:
            TT = prob_vol @ prob_vol.T
            I = torch.eye(prob_vol.shape[0], dtype=TT.dtype, device=TT.device)
            result["corr_err"] = torch.linalg.norm(TT - I, dim=-1)[..., None]
        if cfg.use_proj:
            xy_reproj = kp_reproj(model, rays, pts_pred, to_target=False, embed_alpha=alpha,
                                  use_dskin=use_dskin)
            proj_err = Q.safe_norm(rays["xys"][:, None, :] - xy_reproj[..., :2])
            result["proj_err"] = proj_err / cfg.img_size * 2.0
    if cfg.dist_corresp and "rtk_vec_target" in rays:
        xyz_coarse_target = _project_with_rtk_vec(xyz_coarse_target, rays["rtk_vec_target"])
    result["frame_cyc_dis"] = (frame_cyc_dis * weights.detach()).sum(-1)[..., None]
    if cfg.nerf_vis:
        result["vis_loss"] = visibility_loss(model, xyz_canonical, vis_coarse,
                                             model.mvars.obj_bound, alpha, draws=draws,
                                             generator=generator)[..., None]
    if "rtk_vec_target" in rays:
        if cfg.dist_corresp:
            flo, flo_valid = vrender_flo(weights, xyz_coarse_target, rays["xys"], cfg.img_size)
        else:
            flo = (pts_target[..., 0, :2] - rays["xys"]) / cfg.img_size * 2.0
            flo_valid = torch.ones_like(flo[..., :1])
        result["flo_coarse"] = flo
        result["flo_valid"] = flo_valid
    if cfg.use_unc and "xysn" in rays:
        xyt = torch.cat([rays["xysn"], rays["ts"]], -1)
        result["unc_pred"] = model.apply_unc(xyt, code_dir=rays["vid_code"], embed_raw=True,
                                             embed_alpha=alpha, site="unc_pred")
    if "img_at_samp" in rays:
        img_at_samp = rays["img_at_samp"]
        sil_at_samp = rays["sil_at_samp"]
        vis_at_samp = rays["vis_at_samp"]
        flo_at_samp = rays["flo_at_samp"]
        cfd_at_samp = rays["cfd_at_samp"]
        img_loss_samp = torch.mean((rgb - img_at_samp) ** 2, -1, keepdim=True)
        pos_count = (sil_at_samp * vis_at_samp).sum()
        neg_count = ((1 - sil_at_samp) * vis_at_samp).sum()
        vis_count = vis_at_samp.sum()
        balanced = (pos_count > 0) & (neg_count > 0)
        one = torch.ones((), device=rgb.device)
        pos_wt = torch.where(balanced, vis_count / torch.clamp(pos_count, min=1.0), one)
        neg_wt = torch.where(balanced, vis_count / torch.clamp(neg_count, min=1.0), one)
        sil_balance_wt = 0.5 * pos_wt * sil_at_samp + 0.5 * neg_wt * (1 - sil_at_samp)
        sil_loss_samp = (sil[..., None] - sil_at_samp) ** 2 * sil_balance_wt * vis_at_samp
        flo_loss_samp = ((flo - flo_at_samp) ** 2).sum(-1, keepdim=True)
        sil_at_samp_flo = (sil_at_samp > 0) & (flo_valid == 1) & (cfd_at_samp != 0)
        cfd_norm = cfd_at_samp / torch.clamp(
            (cfd_at_samp * sil_at_samp_flo).sum() / torch.clamp(sil_at_samp_flo.sum(), min=1.0),
            min=1e-9)
        flo_loss_samp = flo_loss_samp * cfd_norm
        result["img_loss_samp"] = img_loss_samp * sil_at_samp
        result["sil_loss_samp"] = sil_loss_samp
        result["flo_loss_samp"] = flo_loss_samp * sil_at_samp
        result["sil_at_samp_flo"] = sil_at_samp_flo.to(rgb.dtype)
        if cfg.use_embed and "feats_at_samp" in rays:
            f = feat_rnd / torch.clamp(Q.safe_norm(feat_rnd, keepdims=True), min=1e-9)
            frnd = torch.mean((f - rays["feats_at_samp"]) ** 2, -1)
            result["frnd_loss_samp"] = (frnd * sil_at_samp[..., 0])[..., None]
    return result, weights


def render_rays(model, rays: RayDict, n_samples: int, use_fine: bool = False,
                fine_iter: bool = True, perturb: Optional[float] = None,
                use_dskin: bool = False, draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Sample depths, with use_fine resample half of them by importance from
    a no-grad coarse pass, and render."""
    cfg = model.cfg
    perturb = cfg.perturb if perturb is None else perturb
    rays = dict(rays)
    d = rays["rays_d"]
    d_norm = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    rays["dir_embedded"] = model.embed_dir(d_norm, rays.get("embed_alpha"))
    R = d.shape[0]
    n_coarse = n_samples // 2 if use_fine else n_samples
    u = draw(draws, "z_u", (R, n_coarse), generator, d.device) if perturb > 0 else None
    z_vals = SP.stratified_zvals(rays["near"], rays["far"], n_coarse, u=u, perturb=perturb)
    xyz = rays["rays_o"][:, None, :] + rays["rays_d"][:, None, :] * z_vals[..., None]
    if use_fine:
        coarse_draws = {k[len("coarse_"):]: v for k, v in (draws or {}).items()
                        if k.startswith("coarse_")}
        with torch.no_grad():
            _, w_coarse = inference_deform(model, rays, xyz, z_vals, cfg, fine_iter=False,
                                           use_dskin=use_dskin, draws=coarse_draws,
                                           generator=generator)
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        det = perturb == 0
        u_pdf = None if det else draw(draws, "pdf_u", (R, n_coarse), generator, d.device)
        z_fine = SP.sample_pdf(z_mid, w_coarse[:, 1:-1], n_coarse, u=u_pdf, det=det)
        z_vals = torch.sort(torch.cat([z_vals, z_fine], -1), -1).values
        xyz = rays["rays_o"][:, None, :] + rays["rays_d"][:, None, :] * z_vals[..., None]
    result, _ = inference_deform(model, rays, xyz, z_vals, cfg, fine_iter=fine_iter,
                                 use_dskin=use_dskin, draws=draws, generator=generator)
    return result
