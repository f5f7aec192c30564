"""Novel-view synthesis: counterpart of moda_tpu/viz/nvs.py (the reference's
scripts/visualize/nvs.py:41-199). Cameras are decoupled from frame codes,
so any trajectory (turntable, input-view replay, bullet time over one
frame) renders with any frame's pose and environment codes, through the
eval renderer (``render/evalrender.make_frame_renderer``) with the
visibility culling on. The renders run on the model's plain fp32 view
under no_grad: no kernel launch.
"""
from __future__ import annotations

import copy
import dataclasses
import glob
from typing import Iterable, List

import numpy as np
import torch

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.render.evalrender import make_frame_renderer
from moda_tpu_torch.train.trainer import get_near_far


def turntable_cams(base_rtk: np.ndarray, num_views: int, axis: str = "y") -> np.ndarray:
    """Orbit around the object keeping the base camera distance: the base
    rotation composed with ``num_views`` rotations about ``axis``."""
    out = []
    for i in range(num_views):
        ang = 2 * np.pi * i / num_views
        c, s = np.cos(ang), np.sin(ang)
        if axis == "y":
            R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:
            R = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])
        rtk = base_rtk.copy()
        rtk[:3, :3] = base_rtk[:3, :3] @ R
        out.append(rtk)
    return np.stack(out).astype(np.float32)


def _render(renderer, device, rtk, kaug, eid) -> dict:
    # one fixed stream a frame, as the JAX renderer's fixed key
    gen = torch.Generator(device=device).manual_seed(0)
    return renderer(np.asarray(rtk, np.float32)[None], np.asarray(kaug, np.float32),
                    [int(eid)], [0], generator=gen)


def render_nvs(model, cam_rtks: np.ndarray, embedids: Iterable[int], render_size: int,
               ndepth: int, chunk: int = 32768) -> List[dict]:
    """Render each (camera, frame code) pair: bullet time is one embedid
    with varying cameras, the input-view replay matching pairs. Each frame
    is a dict of numpy images [render_size, render_size, C]."""
    renderer = make_frame_renderer(model, render_size, ndepth, chunk=chunk, render_vis=True)
    frames = []
    for rtk, eid in zip(cam_rtks, embedids):
        px, py = float(rtk[3, 2]), float(rtk[3, 3])
        kaug = [[max(2 * px / render_size, 1e-6), max(2 * py / render_size, 1e-6), 0.0, 0.0]]
        frames.append(_render(renderer, model.device, rtk, kaug, eid))
    return frames


# --------------------------------------------------- ctraj-file-driven NVS
def load_root(prefix: str, cap_frame: int = 0) -> np.ndarray:
    """Saved root trajectories ``<prefix>*.txt`` -> [N, 4, 4]
    (utils/io.py:173-188)."""
    paths = sorted(glob.glob(f"{prefix}*.txt"))
    if cap_frame > 0:
        paths = paths[:cap_frame]
    return np.stack([np.loadtxt(p) for p in paths]).astype(np.float32)


def load_sils(prefix: str, cap_frame: int = 0) -> List[np.ndarray]:
    """Reference silhouettes ``<prefix>*.png`` as uint8 grey images
    (utils/io.py:155-170)."""
    paths = sorted(glob.glob(f"{prefix}*.png"))
    if cap_frame > 0:
        paths = paths[:cap_frame]
    return [IO.imread(p, gray=True) for p in paths]


def render_nvs_ctraj(model, rtks: np.ndarray, rndsils: List[np.ndarray],
                     embedids: Iterable[int], ndepth: int, scale: float = 0.1,
                     chunk: int = 32768, mesh_rest_verts: np.ndarray = None) -> List[dict]:
    """NVS along saved camera trajectories composited with reference
    silhouettes (scripts/visualize/nvs.py:41-199):

    - intrinsics scaled by ``scale``; the square render canvas is
      max(sil shape) * scale, the sil resized into it keeping its aspect;
    - near/far per camera from the rest-mesh vertices;
    - the rendered rgb is masked to the silhouette (white background), then
      cropped back to the silhouette's aspect.

    Returns per-frame dicts {rgb, sil, vis} of float images in [0, 1]."""
    rtks = np.asarray(rtks, np.float32).copy()
    rtks[:, 3] = rtks[:, 3] * scale
    sil_shape = rndsils[0].shape
    vert = sil_shape[0] > sil_shape[1]
    img_size = int(max(sil_shape) * scale)

    # per-camera near-far from the canonical shape (nvs.py:93-99)
    pts = (mesh_rest_verts if mesh_rest_verts is not None and len(mesh_rest_verts)
           else np.zeros((1, 3), np.float32))
    nf = get_near_far(np.zeros((len(rtks), 2), np.float32), rtks, np.ones(len(rtks)), pts)
    near_far_base = model.mvars.near_far.cpu().numpy()
    kaug = [[1.0, 1.0, 0.0, 0.0]]

    out_frames = []
    for i, (rtk, eid) in enumerate(zip(rtks, embedids)):
        # the resized sil placed in the square canvas (nvs.py:110-119)
        rndsil = rndsils[i].astype(np.float32)
        rndmask = np.zeros((img_size, img_size), np.float32)
        if vert:
            short = int(rndsil.shape[1] * img_size / rndsil.shape[0])
            rndmask[:, :short] = IO.resize(rndsil, (short, img_size))
        else:
            short = int(rndsil.shape[0] * img_size / rndsil.shape[1])
            rndmask[:short] = IO.resize(rndsil, (img_size, short))

        # this camera's near-far in place of the frame's, on a view of the
        # model that shares its parameters
        nf_i = near_far_base.copy()
        nf_i[int(eid)] = nf[i]
        view = copy.copy(model)
        view.mvars = dataclasses.replace(
            model.mvars, near_far=torch.as_tensor(nf_i, device=model.device))
        renderer = make_frame_renderer(view, img_size, ndepth, chunk=chunk, render_vis=True)
        out = _render(renderer, model.device, rtk, kaug, eid)
        rgb = np.clip(out["img_coarse"], 0, 1)
        sil = np.clip(out["sil_coarse"][..., 0], 0, 1)
        vis = np.clip(out["vis_pred"][..., 0], 0, 1)
        # composite: low-sil and out-of-mask pixels -> white (nvs.py:163-183)
        sil = np.where(sil < 0.5, 0.0, sil)
        rgb = np.where(((sil > 0) & (rndmask > 0))[..., None], rgb, 1.0)
        sil = np.where(rndmask > 0, sil, 1.0)
        vis = np.where(rndmask > 0, vis, 1.0)
        if vert:
            rgb, sil, vis = rgb[:, :short], sil[:, :short], vis[:, :short]
        else:
            rgb, sil, vis = rgb[:short], sil[:short], vis[:short]
        out_frames.append({"rgb": rgb, "sil": sil, "vis": vis})
    return out_frames
