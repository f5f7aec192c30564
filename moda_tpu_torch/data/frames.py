"""Per-frame raw reading, mask-centred cropping and flow processing: the
port's copy of moda_tpu/data/frames.py (vidbase.py:41-246's read_raw,
compute_crop_params and flow_process). Images, masks, optical flow (PFM),
DensePose vertex maps and 16-d CSE features are cropped around the object
mask into a square img_size canvas; the crop is recorded as a ``kaug``
intrinsics correction; flow is re-expressed in crop coordinates and
forward/backward-checked into a confidence map.

Decoding and resampling go through ``data/imageio.py`` (the port's own
JPEG/PNG decoders and cv2-semantic resize/remap in host C++), so the port
needs no image library; images come back in RGB order. A frame image that
is missing or not an image raises FileNotFoundError; the other files keep
the JAX package's fallbacks (zero flow, zero CSE features, a default
camera).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.pfm import read_pfm

CROP_FACTOR = 1.2


@dataclass
class FramePaths:
    """Path table for one video (derived from the DAVIS layout,
    utils/io.py:456-488)."""

    imglist: List[str]
    masklist: List[str]
    flowfw: List[str]  # template containing 'FlowFW' to be suffixed _%d
    flowbw: List[str]
    dplist: List[str]
    featlist: List[str]
    bboxlist: List[str]
    rtklist: List[str]

    @staticmethod
    def from_imglist(imglist: List[str], rtk_path: Optional[str] = None) -> "FramePaths":
        seqdir = os.path.dirname(imglist[0])
        seqname = os.path.basename(seqdir)

        def swap(p, kind, ext):
            return p.replace("JPEGImages", kind).rsplit(".", 1)[0] + ext

        masks = [swap(i, "Annotations", ".png") for i in imglist]
        flowfw = [swap(i, "FlowFW", ".pfm").replace(f"{seqname}/", f"{seqname}/flo-")
                  for i in imglist]
        flowbw = [f.replace("FlowFW", "FlowBW") for f in flowfw]
        dps = [swap(i, "Densepose", ".pfm") for i in imglist]
        feats = [os.path.join(os.path.dirname(d), "feat-%05d.pfm" % k) for k, d in enumerate(dps)]
        bboxes = [os.path.join(os.path.dirname(d), "bbox-%05d.txt" % k)
                  for k, d in enumerate(dps)]
        if rtk_path:
            rtks = ["%s-%05d.txt" % (rtk_path, k) for k in range(len(imglist))]
        else:
            rtks = [swap(i, "Cameras", ".txt") for i in imglist]
        return FramePaths(imglist, masks, flowfw, flowbw, dps, feats, bboxes, rtks)


def compute_crop_params(mask: np.ndarray, img_size: int, flip: int = 0):
    """Mask bbox -> crop warp + kaug intrinsics correction
    (vidbase.py:176-201). Returns (kaug[4], sample grid hp0 [H,W,3], AB [3,3])."""
    ys, xs = np.where(mask > 0)
    if len(xs) == 0:
        xs = np.asarray([0, mask.shape[1] - 1])
        ys = np.asarray([0, mask.shape[0] - 1])
    cx, cy = (xs.max() + xs.min()) // 2, (ys.max() + ys.min()) // 2
    lx, ly = (xs.max() - xs.min()) // 2, (ys.max() - ys.min()) // 2
    lx, ly = int(CROP_FACTOR * lx), int(CROP_FACTOR * ly)
    lx, ly = max(lx, 1), max(ly, 1)

    alp = [2 * lx / img_size, 2 * ly / img_size]
    sign = -1.0 if flip else 1.0
    kaug = np.asarray([alp[0], alp[1], sign * float(cx - lx), float(cy - ly)], np.float32)

    x0, y0 = np.meshgrid(range(img_size), range(img_size))
    AB = np.asarray([[alp[0], 0, cx - lx], [0, alp[1], cy - ly], [0, 0, 1]], np.float64).T
    hp0 = np.stack([x0, y0, np.ones_like(x0)], -1).astype(np.float64)
    hp0 = hp0 @ AB
    return kaug, hp0, AB


def warp_flow(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp img by flow (ext_utils/flowlib.warp_flow semantics)."""
    h, w = flow.shape[:2]
    coords = flow.copy().astype(np.float32)
    coords[:, :, 0] += np.arange(w, dtype=np.float32)
    coords[:, :, 1] += np.arange(h, dtype=np.float32)[:, None]
    return IO.remap(img.astype(np.float32), coords[..., 0], coords[..., 1], IO.INTER_LINEAR)


def _default_rtk() -> np.ndarray:
    rtk = np.zeros((4, 4))
    rtk[:3, :3] = np.eye(3)
    rtk[:3, 3] = [0, 0, 10]
    rtk[3, :] = [512, 512, 256, 256]
    return rtk


class FrameReader:
    """Reads and crops one frame's full observation set."""

    def __init__(self, paths: FramePaths, img_size: int, flip: int = 0):
        self.paths = paths
        self.img_size = img_size
        self.flip = flip

    def read_raw(self, idx: int, flowfw: bool, dframe: int) -> Dict[str, np.ndarray]:
        p = self.paths
        img = IO.imread(p.imglist[idx])
        if img is None:
            raise FileNotFoundError(f"{p.imglist[idx]}: missing or not an image")
        img = img / 255.0
        mask = IO.imread(p.masklist[idx], gray=True)
        if mask is None:
            mask = np.ones(img.shape[:2], np.uint8)
        # the reference's order: levels[1] scaling first, then the 255
        # occluder test on the scaled mask
        levels = np.sort(np.unique(mask))
        if len(levels) > 1:
            mask = mask / levels[1]
        occluder = mask == 255
        mask = mask.astype(np.float32)
        mask[occluder] = 0
        if mask.shape[:2] != img.shape[:2]:
            mask = IO.resize(mask, img.shape[:2][::-1], IO.INTER_NEAREST)

        flow_path = (p.flowfw if flowfw else p.flowbw)[idx]
        flow_path = flow_path.replace("FlowFW", "FlowFW_%d" % dframe).replace(
            "FlowBW", "FlowBW_%d" % dframe)
        h, w = mask.shape
        try:
            flow = read_pfm(flow_path)[0][..., :2]
            occ = read_pfm(flow_path.replace("flo-", "occ-"))[0]
            oh, ow = flow.shape[:2]
            flow = IO.resize(flow, (w, h))
            occ = IO.resize(occ, (w, h))
            flow[..., 0] *= w / ow
            flow[..., 1] *= h / oh
        except (FileNotFoundError, ValueError):
            flow = np.zeros((h, w, 2), np.float32)
            occ = np.zeros((h, w), np.float32)
        occ = np.where(occluder, np.float32(0.0), occ)

        try:
            dp = read_pfm(p.dplist[idx])[0]
            dp = (dp * 50).astype(np.int32)  # /50 storage trick (compute_dp.py:97)
        except (FileNotFoundError, ValueError):
            dp = np.zeros((h, w), np.int32)
        try:
            dp_feat = read_pfm(p.featlist[idx])[0].reshape(16, 112, 112)
            dp_bbox = np.loadtxt(p.bboxlist[idx])
        except (FileNotFoundError, ValueError, OSError):
            dp_feat = np.zeros((16, 112, 112), np.float32)
            dp_bbox = np.zeros(4, np.float32)

        try:
            rtk = np.loadtxt(p.rtklist[idx])
        except OSError:
            rtk = None
        if rtk is None or rtk.shape != (4, 4):
            rtk = _default_rtk()

        vis2d = np.ones_like(mask)

        kaug, hp0, AB = compute_crop_params(mask, self.img_size, self.flip)
        x0 = hp0[:, :, 0].astype(np.float32)
        y0 = hp0[:, :, 1].astype(np.float32)

        def crop(x, interp):
            return IO.remap(x, x0, y0, interp)

        img = crop(img.astype(np.float32), IO.INTER_LINEAR)
        mask = crop(mask, IO.INTER_NEAREST)
        flow = crop(flow, IO.INTER_LINEAR)
        occ = crop(occ, IO.INTER_LINEAR)
        dp = crop(dp.astype(np.float32), IO.INTER_NEAREST)
        vis2d = crop(vis2d, IO.INTER_NEAREST)
        mask = (mask > 0).astype(np.float32)

        dp_feat_rsmp = resample_dp_np(dp_feat, dp_bbox, kaug, self.img_size)
        return {
            "img": img, "mask": mask, "flow": flow, "occ": occ, "dp": dp,
            "vis2d": vis2d, "dp_feat": dp_feat, "dp_feat_rsmp": dp_feat_rsmp,
            "dp_bbox": dp_bbox, "rtk": rtk, "kaug": kaug, "hp0": hp0, "AB": AB,
        }

    def flow_process(self, d0: Dict, d1: Dict):
        """Re-express the pair's flows in crop coords + fb confidence
        (vidbase.py:203-246). Returns (flow, flown, occ, occn) with flow in
        NDC units [-2,2] and occ the confidence."""
        S = self.img_size
        flow, flown = d0["flow"], d1["flow"]
        hp0, hp1 = d0["hp0"], d1["hp0"]
        AB, ABp = d0["AB"], d1["AB"]
        grid = np.stack(np.meshgrid(range(S), range(S)), -1)

        hp1c = np.concatenate([flow + hp0[:, :, :2], np.ones_like(hp0[:, :, :1])], -1)
        hp1c = hp1c @ np.linalg.inv(ABp)
        flow = hp1c[:, :, :2] - grid

        hp0c = np.concatenate([flown + hp1[:, :, :2], np.ones_like(hp0[:, :, :1])], -1)
        hp0c = hp0c @ np.linalg.inv(AB)
        flown = hp0c[:, :, :2] - grid

        xy = grid.astype(np.float32)

        def confidence(fwd, bwd):
            dis = warp_flow(xy + bwd, fwd) - xy
            c = np.exp(-25 * (np.linalg.norm(dis, axis=-1) / S * 2))
            c[c < 0.25] = 0.0
            return c

        occ = confidence(flow, flown)
        occn = confidence(flown, flow)
        flow = flow * 2.0 / S
        flown = flown * 2.0 / S
        return (flow.astype(np.float32), flown.astype(np.float32),
                occ.astype(np.float32), occn.astype(np.float32))


def resample_dp_np(dp_feat: np.ndarray, dp_bbox: np.ndarray, kaug: np.ndarray,
                   target_size: int) -> np.ndarray:
    """Resample the 112x112 CSE feature crop onto the training crop
    (geom_utils.py:1665-1701); each channel as the JAX package's cv2 call
    on that channel alone. dp_feat [16,112,112]."""
    dp_feat = dp_feat / np.maximum(np.linalg.norm(dp_feat, axis=0, keepdims=True), 1e-9)
    if np.abs(dp_bbox).sum() == 0:
        out = np.stack([IO.resize(dp_feat[c], (target_size, target_size), IO.INTER_LINEAR)
                        for c in range(dp_feat.shape[0])])
        return out.astype(np.float32)
    # dp-crop -> image -> training-crop transform (bbox_dp2rnd)
    cropa2im = np.asarray([
        [(dp_bbox[2] - dp_bbox[0]) / 112.0, 0, dp_bbox[0]],
        [0, (dp_bbox[3] - dp_bbox[1]) / 112.0, dp_bbox[1]],
        [0, 0, 1],
    ])
    im2cropb = np.asarray([
        [1.0 / kaug[0], 0, -kaug[2] / kaug[0]],
        [0, 1.0 / kaug[1], -kaug[3] / kaug[1]],
        [0, 0, 1],
    ])
    rnd2dp = np.linalg.inv(im2cropb @ cropa2im)
    x0, y0 = np.meshgrid(range(target_size), range(target_size))
    g = np.stack([x0, y0, np.ones_like(x0)], -1).astype(np.float64) @ rnd2dp.T
    gx = g[..., 0].astype(np.float32)
    gy = g[..., 1].astype(np.float32)
    return IO.remap_planes(dp_feat, gx, gy, IO.INTER_LINEAR)
