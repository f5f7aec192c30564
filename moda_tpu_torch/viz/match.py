"""Two-frame correspondence visualization via canonical feature matching:
counterpart of moda_tpu/viz/match.py (the reference's
scripts/visualize/match.py:64-166). Pixels of a reference frame are
soft-matched into the canonical feature volume (render/pipeline.feat_match),
forward-warped into the target frame's pose, projected, and drawn as
motion lines.

``match_frames`` runs on the model as the trainer holds it, not its plain
view: on the card under ``cfg.use_pallas`` the feature grid's MLP is one K1
launch at the ``feat_grid`` call site. ``draw_line`` is the port's own
8-connected, 1-pixel line drawer with cv2.line's clipping and stepping, so
the canvas needs no cv2.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from moda_tpu_torch.core import camera as cam
from moda_tpu_torch.render import rays as RB
from moda_tpu_torch.render.pipeline import feat_match, kp_reproj


@torch.no_grad()
def match_frames(model, feats0: np.ndarray, xys0: np.ndarray, rtk0: np.ndarray,
                 rtk1: np.ndarray, kaug: np.ndarray, frameid0: int, frameid1: int,
                 grid_size: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """feats0 [N, 16]: frame 0's pixel features at pixels xys0 [N, 2];
    returns (canonical points [N, 3], their pixels in frame 1 [N, 2]).
    With bones, the points are warped by frame 1's bone transforms (the
    rest-pose code of video 0, no delta skin and no displacement, as
    kp_reproj does)."""
    dev = model.device
    feats = torch.as_tensor(np.asarray(feats0, np.float32), device=dev)
    feats = feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-9)
    pts_pred, _ = feat_match(model, feats, model.mvars.obj_bound, grid_size,
                             use_ot=model.cfg.use_ot, is_training=False)

    # forward-warp into frame 1 and project with its camera
    Rmat, Tmat, Kinv = cam.prepare_ray_cams(
        torch.as_tensor(np.asarray(rtk1, np.float32), device=dev)[None],
        torch.as_tensor(np.asarray(kaug, np.float32), device=dev)[None])
    N = feats.shape[0]
    rtk_vec = torch.cat([Rmat.reshape(1, 9), Tmat.reshape(1, 3), Kinv.reshape(1, 9)], -1)
    rays = {"rtk_vec": rtk_vec.expand(N, 21), "rtk_vec_target": rtk_vec.expand(N, 21)}
    if model.has_bones:
        bones_rst, bone_rts = RB.compute_bone_rts(
            model, torch.tensor([frameid1], dtype=torch.long, device=dev))
        rays["bones_rst"] = bones_rst
        rays["bone_rts"] = bone_rts[0][None].expand((N,) + bone_rts.shape[1:])
        rays["rest_pose_code"] = model.apply_rest_pose_code(
            torch.zeros(1, dtype=torch.long, device=dev))
    proj = kp_reproj(model, rays, pts_pred, to_target=False)
    return pts_pred.cpu().numpy(), proj[:, 0, :2].cpu().numpy()


def _clip_line(w: int, h: int, p1, p2) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """cv2.clipLine on a w x h image: the segment's ends moved onto the
    border where it leaves the image (integer steps truncated toward zero,
    as cv2's int64 casts), or None where it misses the image."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Draw an 8-connected 1-pixel segment from p0 to p1 (integer (x, y))
    into img [H, W, C] in place: cv2.line(img, p0, p1, color, 1), with its
    clipping to the image and its left-to-right Bresenham stepping."""
    h, w = img.shape[:2]
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
        clipped = _clip_line(w, h, p0, p1)
        if clipped is None:
            return
        p0, p1 = clipped
    (x, y), (x2, y2) = p0, p1
    dx, dy = x2 - x, y2 - y
    if dx < 0:  # always left to right
        dx, dy = -dx, -dy
        x, y = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    for _ in range(major + 1):
        img[y, x] = color
        step = err < 0  # minor step with the major one
        err += -2 * minor + (2 * major if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


def draw_matches(img0: np.ndarray, img1: np.ndarray, xys0: np.ndarray,
                 xys1: np.ndarray, stride: int = 1) -> np.ndarray:
    """The two float images side by side on a uint8 canvas [H, W0 + W1, 3]
    with a line of colour ``default_rng(i).integers(64, 255, 3)`` from each
    pixel i of frame 0 to its match in frame 1 (the reference's match.py
    vis)."""
    h = max(img0.shape[0], img1.shape[0])
    w0 = img0.shape[1]
    canvas = np.zeros((h, w0 + img1.shape[1], 3), np.float32)
    canvas[: img0.shape[0], :w0] = img0
    canvas[: img1.shape[0], w0:] = img1
    canvas = (canvas * 255).astype(np.uint8)
    for i in range(0, len(xys0), stride):
        p0 = np.round(xys0[i]).astype(int)
        p1 = np.round(xys1[i]).astype(int) + np.asarray([w0, 0])
        color = np.random.default_rng(i).integers(64, 255, 3).astype(np.uint8)
        draw_line(canvas, p0, p1, color)
    return canvas
