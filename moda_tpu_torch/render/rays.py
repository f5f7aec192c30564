"""Ray-bundle construction: counterpart of moda_tpu/render/rays.py.

Batch layout ("frame-pair batch"): arrays lead with [2B] where entry b
pairs with b+B. Rays are flat [R] with ray i of the first half paired
with ray i + R/2. Uniform pixel sampling only; uncertainty-guided active
sampling belongs to a later slice.
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


def build_rays(model, batch: Dict[str, torch.Tensor], rtk: torch.Tensor, nsample: int,
               nsample_active: int = 0, embed_alpha=None,
               generator: Optional[torch.Generator] = None,
               pix_ids: Optional[torch.Tensor] = None) -> RayDict:
    """Flat per-ray bundle [R = 2B*nsample].

    The uniform pixel ids come from batch["pix_ids"] (host-sampled sparse
    batches), else from ``pix_ids`` [2B, nsample] when the caller passes
    the draw, else from ``generator``."""
    if nsample_active > 0:
        raise NotImplementedError("uncertainty-guided active sampling is ported in a later "
                                  "slice of moda_tpu_torch")
    cfg = model.cfg
    dev = rtk.device
    kaug, frameid, dataid = batch["kaug"], batch["frameid"], batch["dataid"]
    lineid = batch.get("lineid", None)
    packed = batch.get("pix_ids", None)
    bs2 = rtk.shape[0]
    B = bs2 // 2
    Rmat, Tmat, Kinv = cam.prepare_ray_cams(rtk, kaug)
    _check_index(frameid, model.num_fr, "frameid")

    if packed is not None:
        rand_inds = packed[:, :nsample]
    elif pix_ids is not None:
        rand_inds = pix_ids
    else:
        rand_inds = sample_pixel_ids(generator, bs2, nsample, cfg.img_size, lineid, device=dev)
    ent_first = torch.arange(B, device=dev).repeat_interleave(nsample)
    loc_first = torch.arange(nsample, device=dev).repeat(B)
    pix_first = rand_inds[:B].reshape(-1)
    pix_second = rand_inds[B:].reshape(-1)

    ray_entry = torch.cat([ent_first, ent_first + B])
    ray_pix = torch.cat([pix_first, pix_second])
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
    rays["time_embedded"] = model.apply_pose_code(frameid)[ray_entry]
    if cfg.env_code:
        rays["env_code"] = model.apply_env_code(frameid)[ray_entry]
    if cfg.appearance_code:
        rays["appearance_code"] = model.apply_appearance_code(frameid)[ray_entry]
    bones_rst, bone_rts = compute_bone_rts(model, frameid)
    rays["bones_rst"] = bones_rst
    rays["bone_rts"] = bone_rts[ray_entry]
    rays["bone_rts_target"] = flip_pair(rays["bone_rts"])
    rays["rest_pose_code"] = model.apply_rest_pose_code(
        torch.zeros(1, dtype=torch.long, device=dev))

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
    if ray_lineid is not None:
        rays["errid"] = rf * cfg.img_size + ray_lineid.to(rf.dtype)
    elif "errid" in batch:
        rays["errid"] = batch["errid"][ray_entry]
    return rays
