"""Ray-bundle construction: counterpart of moda_tpu/render/rays.py.

Batch layout ("frame-pair batch"): arrays lead with [2B] where entry b
pairs with b+B. Rays are flat [R] with ray i of the first half paired
with ray i + R/2. With active sampling, R = 2B * (nsample + nsample_active):
the uniform rays first, then the uncertainty top-k.

Random draws (the ``draws`` idiom of render/pipeline.py; each is drawn from
the generator when absent):
  "pix_ids"    [2B, nsample] uniform pixel ids
  "cand_ids"   [2B, 4 * (nsample + nsample_active)] active-sampling pool
  "active_idx" [B * nsample_active] the top-k selection itself, indices into
               the reference half's flattened pool (the uncertainty MLP is
               then not run)

Data parallelism (parallel/dist.py): with ``pairs``, a Shard of the [2B]
batch rows, the batch is this rank's share of a global batch. Pixel draws
have the global shape and the rank takes its pairs' rows; the top-k ranks
the global pool (the scores are gathered) and the rank keeps the
selections that fall on its pairs. The rays are then the rank's rows of
the one-process bundle, whose global row ids build_rays returns in
``rays["ray_index"]`` (``ray_count`` gives the global count).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from moda_tpu_torch.core import camera as cam
from moda_tpu_torch.core import skinning as SK

RayDict = Dict[str, torch.Tensor]


def sample_pixel_ids(generator: Optional[torch.Generator], bs: int, nsample: int,
                     img_size: int, lineid: Optional[torch.Tensor], device=None) -> torch.Tensor:
    """Uniform pixel indices [bs, nsample]: over img_size^2 (batch mode)
    or along the line (lineload)."""
    high = img_size * img_size if lineid is None else img_size
    return torch.randint(0, high, (bs, nsample), generator=generator,
                         device=device if generator is None else generator.device).to(device)


def ids_to_xys(rand_inds: torch.Tensor, img_size: int,
               lineid: Optional[torch.Tensor]) -> torch.Tensor:
    if lineid is None:
        x = (rand_inds % img_size).float()
        y = torch.div(rand_inds, img_size, rounding_mode="floor").float()
    else:
        x = rand_inds.float()
        y = lineid.float().reshape(lineid.shape + (1,) * (rand_inds.dim() - lineid.dim()))
        y = y.expand(rand_inds.shape)
    return torch.stack([x, y], -1)


def flip_pair(x: torch.Tensor) -> torch.Tensor:
    B = x.shape[0] // 2
    return torch.cat([x[B:], x[:B]], 0)


def compute_bone_rts(model, frameid: torch.Tensor):
    """(bones_rst [B,10], bone_rts [N, B, 8|12]) for frames ``frameid``."""
    rts_fw = model.body_rts(frameid)
    rts_rst = model.body_rts_rest()
    if model.cfg.neudbs:
        return (SK.correct_bones_dq(model.bones, rts_rst),
                SK.correct_rest_pose_dq(rts_fw, rts_rst[0]))
    return (SK.correct_bones_rts(model.bones, rts_rst[0]),
            SK.correct_rest_pose_rts(rts_fw, rts_rst[0]))


def _check_index(idx: torch.Tensor, size: int, what: str):
    # JAX gathers clamp out-of-range indices; torch raises on the CPU and
    # faults on the card, so indices from outside are checked here
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= size):
        raise IndexError(f"{what} out of range [0, {size})")


def ray_count(n_pairs: int, nsample: int, nsample_active: int = 0) -> int:
    """Rays of a bundle of ``n_pairs`` pairs."""
    return 2 * n_pairs * (nsample + nsample_active)


def _unc_scores(model, xys, ts, vid_code, Kinv, embed_alpha):
    """No-grad uncertainty at candidate pixels. xys [..., 2]; Kinv
    [..., 3, 3]. The MLP reads the embedded xyt and the video code per
    point (the legacy layout, no in-kernel embed)."""
    with torch.no_grad():
        xy1 = torch.cat([xys, torch.ones_like(xys[..., :1])], -1)
        xysn = (xy1[..., None, :] @ Kinv.transpose(-1, -2))[..., 0, :2]
        xyt_e = model.embed_xyz(torch.cat([xysn, ts], -1), embed_alpha)
        return model.apply_unc(torch.cat([xyt_e, vid_code], -1), site="unc_scores")[..., 0]


def active_sample_ids(model, batch: Dict[str, torch.Tensor], Kinv: torch.Tensor,
                      cand_ids: torch.Tensor, nsample_active: int,
                      embed_alpha=None, pairs=None) -> torch.Tensor:
    """Uncertainty-guided selection: the global top B * nsample_active
    candidates of the reference half (the paired half takes the same slots),
    as indices into its flattened [B, pool] candidates, highest first. With
    ``pairs`` the scores of every rank's pool are ranked together, and the
    indices are into the global pool."""
    B, pool = cand_ids.shape[0] // 2, cand_ids.shape[1]
    cand_xys = ids_to_xys(cand_ids, model.cfg.img_size, batch.get("lineid"))
    ts = batch["frameid_sub"].float() / model.max_ts * 2.0 - 1.0
    vid = model.apply_vid_code(batch["dataid"][:B])
    scores = _unc_scores(model, cand_xys[:B], ts[:B, None, None].expand(B, pool, 1),
                         vid[:, None, :].expand(B, pool, vid.shape[-1]),
                         Kinv[:B, None].expand(B, pool, 3, 3), embed_alpha)
    scores = scores.reshape(-1)
    n_sel = B * nsample_active
    if pairs is not None:
        gp = pairs.index[:B]
        scores = pairs.sub((gp[:, None] * pool + torch.arange(pool, device=gp.device))
                           .reshape(-1), pairs.n // 2 * pool).gather(scores)
        n_sel = pairs.n // 2 * nsample_active
    # a pool may hold one pixel twice: ties go to the lower index, as in
    # jax.lax.top_k (a stable descending sort; torch.topk leaves ties unordered)
    order = torch.sort(scores, descending=True, stable=True).indices
    return order[:n_sel]


def _own_selection(pairs, top: torch.Tensor, pool: int):
    """This rank's part of a global top-k ``top`` (indices into the global
    [B, pool] pool): (their positions in ``top``, their indices into the
    rank's [b, pool] pool)."""
    B = pairs.n // 2
    gp = pairs.index[:pairs.index.shape[0] // 2]
    local = torch.full((B,), -1, dtype=torch.long, device=top.device)
    local[gp] = torch.arange(gp.shape[0], device=top.device)
    ent = local[torch.div(top, pool, rounding_mode="floor")]
    pos = torch.nonzero(ent >= 0)[:, 0]
    return pos, ent[pos] * pool + top[pos] % pool


def build_rays(model, batch: Dict[str, torch.Tensor], rtk: torch.Tensor, nsample: int,
               nsample_active: int = 0, embed_alpha=None,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None, pairs=None) -> RayDict:
    """Flat per-ray bundle [R = 2B * (nsample + nsample_active)].

    The pixel ids come from batch["pix_ids"] (host-sampled sparse batches:
    the uniform slots first, the candidate pool in the last columns), else
    from ``draws`` (module docstring), else from ``generator``. ``pairs``:
    data parallelism (module docstring)."""
    draws = draws or {}
    cfg = model.cfg
    dev = rtk.device
    kaug, frameid, dataid = batch["kaug"], batch["frameid"], batch["dataid"]
    lineid = batch.get("lineid", None)
    packed = batch.get("pix_ids", None)
    bs2 = rtk.shape[0]
    B = bs2 // 2
    Rmat, Tmat, Kinv = cam.prepare_ray_cams(rtk, kaug)
    _check_index(frameid, model.num_fr, "frameid")
    # the pixel draws of the global batch (rows: pairs)
    n_rows = bs2 if pairs is None else pairs.n

    def own(t):
        return t if pairs is None else pairs.rows(t)

    if packed is not None:
        rand_inds = packed[:, :nsample]
    elif "pix_ids" in draws:
        rand_inds = own(draws["pix_ids"].to(dev))
    else:
        rand_inds = own(sample_pixel_ids(generator, n_rows, nsample, cfg.img_size, lineid,
                                         device=dev))
    ent_first = torch.arange(B, device=dev).repeat_interleave(nsample)
    loc_first = torch.arange(nsample, device=dev).repeat(B)
    pix_first = rand_inds[:B].reshape(-1)
    pix_second = rand_inds[B:].reshape(-1)
    if pairs is not None:  # global ids of the rank's rays in the first half
        gp = pairs.index[:B]
        gid_first = (gp[:, None] * nsample + torch.arange(nsample, device=dev)).reshape(-1)

    if nsample_active > 0:
        pool = 4 * (nsample + nsample_active)
        if packed is not None:
            cand_loc0 = packed.shape[1] - pool  # the pool takes the last columns
            cand_ids = packed[:, cand_loc0:]
        else:
            cand_loc0 = 0
            cand_ids = own(draws["cand_ids"].to(dev) if "cand_ids" in draws else
                           sample_pixel_ids(generator, n_rows, pool, cfg.img_size, lineid,
                                            device=dev))
        if "active_idx" in draws:
            top = draws["active_idx"].to(dev)
            _check_index(top, n_rows // 2 * pool, "active_idx")
        else:
            top = active_sample_ids(model, batch, Kinv, cand_ids, nsample_active, embed_alpha,
                                    pairs=pairs)
        if pairs is not None:  # the global selections on this rank's pairs
            pos, top = _own_selection(pairs, top, pool)
            gid_first = torch.cat([gid_first, pairs.n // 2 * nsample + pos])
        ent_first = torch.cat([ent_first, torch.div(top, pool, rounding_mode="floor")])
        loc_first = torch.cat([loc_first, cand_loc0 + top % pool])
        pix_first = torch.cat([pix_first, cand_ids[:B].reshape(-1)[top]])
        pix_second = torch.cat([pix_second, cand_ids[B:].reshape(-1)[top]])

    ray_entry = torch.cat([ent_first, ent_first + B])
    ray_pix = torch.cat([pix_first, pix_second])
    if pairs is not None:
        half = ray_count(pairs.n // 2, nsample, nsample_active) // 2
        ray_index = torch.cat([gid_first, gid_first + half])
    ray_loc = torch.cat([loc_first, loc_first]) if packed is not None else ray_pix
    n_cols = batch["imgs"].shape[-1]
    _check_index(ray_loc, n_cols, "pixel id")

    ray_lineid = None if lineid is None else lineid[ray_entry]
    xys = ids_to_xys(ray_pix, cfg.img_size, ray_lineid)

    near_far = model.mvars.near_far[frameid][ray_entry]
    rays_nt = cam.raycast(xys[:, None, :], Rmat[ray_entry], Tmat[ray_entry],
                          Kinv[ray_entry], near_far)
    rays: RayDict = {
        "rays_o": rays_nt.rays_o[:, 0], "rays_d": rays_nt.rays_d[:, 0],
        "near": rays_nt.near[:, 0], "far": rays_nt.far[:, 0],
        "rtk_vec": rays_nt.rtk_vec[:, 0], "xys": xys,
    }
    if embed_alpha is not None:
        rays["embed_alpha"] = embed_alpha
    rays["rtk_vec_target"] = flip_pair(rays["rtk_vec"])

    rf = frameid[ray_entry]
    if hasattr(model, "pose_code"):
        rays["time_embedded"] = model.apply_pose_code(frameid)[ray_entry]
    if cfg.env_code:
        rays["env_code"] = model.apply_env_code(frameid)[ray_entry]
    if cfg.appearance_code:
        rays["appearance_code"] = model.apply_appearance_code(frameid)[ray_entry]
    if model.has_bones:
        bones_rst, bone_rts = compute_bone_rts(model, frameid)
        rays["bones_rst"] = bones_rst
        rays["bone_rts"] = bone_rts[ray_entry]
        rays["bone_rts_target"] = flip_pair(rays["bone_rts"])
        rays["rest_pose_code"] = model.apply_rest_pose_code(
            torch.zeros(1, dtype=torch.long, device=dev))
    if cfg.flowbw:
        rays["time_embedded_target"] = flip_pair(rays["time_embedded"])
    if cfg.use_unc:
        _check_index(dataid, model.num_vid, "dataid")
        ts = batch["frameid_sub"].float() / model.max_ts * 2.0 - 1.0
        rays["ts"] = ts[ray_entry][:, None]
        rays["vid_code"] = model.apply_vid_code(dataid)[ray_entry]
        xy1 = torch.cat([xys, torch.ones_like(xys[..., :1])], -1)
        rays["xysn"] = (xy1[:, None, :] @ Kinv[ray_entry].transpose(-1, -2))[:, 0, :2]

    def gather(img):  # [2B, C, P|npix] -> [R, C]
        return img[ray_entry, :, ray_loc]

    rays["img_at_samp"] = gather(batch["imgs"])
    rays["sil_at_samp"] = gather(batch["masks"])
    rays["vis_at_samp"] = gather(batch["vis2d"])
    rays["flo_at_samp"] = gather(batch["flow"])
    rays["cfd_at_samp"] = gather(batch["occ"])
    if cfg.use_embed:
        feats = gather(batch["dp_feats"])
        feats = feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-9)
        rays["feats_at_samp"] = feats
    rays["frameid"] = rf
    if pairs is not None:
        rays["ray_index"] = ray_index
    if ray_lineid is not None:
        rays["errid"] = rf * cfg.img_size + ray_lineid.to(rf.dtype)
    elif "errid" in batch:
        rays["errid"] = batch["errid"][ray_entry]
    return rays


def build_rays_image(model, rtk: torch.Tensor, kaug: torch.Tensor, frameid: torch.Tensor,
                     dataid: torch.Tensor, render_size: int, embed_alpha=None,
                     rtk_target: Optional[torch.Tensor] = None,
                     frameid_target: Optional[torch.Tensor] = None) -> RayDict:
    """Full-image ray bundle for eval rendering, every pixel of each frame:
    rtk [B,4,4], kaug [B,4], frameid/dataid [B] -> rays leading with
    [B * render_size^2]. rtk_target/frameid_target (optional): the paired
    frame's camera and codes, so the render includes flow (flo_coarse), as
    the reference's eval grid does (train_utils.py:500-505)."""
    cfg = model.cfg
    dev = rtk.device
    B = rtk.shape[0]
    P = render_size * render_size
    _check_index(frameid, model.num_fr, "frameid")
    ii = torch.arange(P, device=dev)
    xys = torch.stack([(ii % render_size).float(),
                       torch.div(ii, render_size, rounding_mode="floor").float()], -1)
    xys = xys[None].expand(B, P, 2)
    Rmat, Tmat, Kinv = cam.prepare_ray_cams(rtk, kaug)
    rays_nt = cam.raycast(xys, Rmat, Tmat, Kinv, model.mvars.near_far[frameid])
    R = B * P

    def flat(x):
        return x.reshape((R,) + x.shape[2:])

    def per_ray(codes):  # [B, C] -> [R, C]
        return flat(codes[:, None, :].expand(B, P, codes.shape[-1]))

    rays: RayDict = {"rays_o": flat(rays_nt.rays_o), "rays_d": flat(rays_nt.rays_d),
                     "near": flat(rays_nt.near), "far": flat(rays_nt.far),
                     "rtk_vec": flat(rays_nt.rtk_vec), "xys": flat(rays_nt.xys)}
    if embed_alpha is not None:
        rays["embed_alpha"] = embed_alpha
    if hasattr(model, "pose_code"):
        rays["time_embedded"] = per_ray(model.apply_pose_code(frameid))
    if cfg.env_code:
        rays["env_code"] = per_ray(model.apply_env_code(frameid))
    if cfg.appearance_code:
        rays["appearance_code"] = per_ray(model.apply_appearance_code(frameid))
    if model.has_bones:
        bones_rst, bone_rts = compute_bone_rts(model, frameid)
        rays["bones_rst"] = bones_rst
        rays["bone_rts"] = flat(bone_rts[:, None].expand((B, P) + bone_rts.shape[1:]))
        rays["rest_pose_code"] = model.apply_rest_pose_code(
            torch.zeros(1, dtype=torch.long, device=dev))
    if cfg.use_unc:
        # the unc MLP's inputs for the eval grid's uncertainty channel
        # (rendering.py:501-516): normalized pixel coords and frame time
        _check_index(dataid, model.num_vid, "dataid")
        off = torch.as_tensor(model.offset, dtype=torch.float32, device=dev)[dataid]
        ts = (frameid.float() - off) / model.max_ts * 2.0 - 1.0
        rays["ts"] = flat(ts[:, None, None].expand(B, P, 1))
        rays["vid_code"] = per_ray(model.apply_vid_code(dataid))
        xy1 = torch.cat([xys, torch.ones_like(xys[..., :1])], -1)
        rays["xysn"] = flat((xy1[..., None, :] @ Kinv.transpose(-1, -2)[:, None])[..., 0, :2])
    if rtk_target is not None and frameid_target is not None:
        _check_index(frameid_target, model.num_fr, "frameid_target")
        Rt, Tt, Kit = cam.prepare_ray_cams(rtk_target, kaug)
        rtk_vec_t = torch.cat([Rt.reshape(B, 1, 9), Tt.reshape(B, 1, 3), Kit.reshape(B, 1, 9)],
                              -1)
        rays["rtk_vec_target"] = flat(rtk_vec_t.expand(B, P, 21))
        if model.has_bones:
            _, bone_rts_t = compute_bone_rts(model, frameid_target)
            rays["bone_rts_target"] = flat(
                bone_rts_t[:, None].expand((B, P) + bone_rts_t.shape[1:]))
        if cfg.flowbw:
            rays["time_embedded_target"] = per_ray(model.apply_pose_code(frameid_target))
    return rays
