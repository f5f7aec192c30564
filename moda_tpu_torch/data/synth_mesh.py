"""Mesh-based articulated synthetic fixture ("a-flap": an eagle-like
creature with flapping wings and a wagging tail). The port's copy of
moda_tpu/data/synth_mesh.py (numpy and the port's native rasterizer).

Role of the reference's scripts/synthetic/render_synthetic.py:46-173,
which rasterizes the eagle/hands OBJ sequences with SoftRas to produce the
self-contained quantitative fixture (GT cameras in Cameras/, GT camera-
space meshes in Meshes/, GT flow PFMs) consumed by scripts/eval/run_eval.sh
with gt_pmat=canonical. The reference's OBJ assets are not redistributable,
so the creature here is procedural: a multi-part triangle mesh (body, head,
two wings, tail) deformed by a 4-bone LBS rig with smooth skinning
weights — articulated GT with realistic topology, unlike the analytic
ellipsoid in data/synthetic.py.

Rendering uses the native hard z-buffer rasterizer (native/raster.cpp),
matching the reference's exercised SoftRas configuration (sigma 1e-12,
aggr 'hard', vertex textures). GT flow is rendered exactly the way the
reference does (render_flow, geom_utils.py:1704-1757): rasterize frame i
with per-pixel interpolated rest coordinates + skin weights, re-pose those
surface points at frame j, project with camera j, subtract pixel grids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from moda_tpu_torch.data.synthetic import SynthScene


def uv_sphere(n_lat: int = 16, n_lon: int = 24) -> Tuple[np.ndarray, np.ndarray]:
    """Unit UV sphere -> (verts [V,3], faces [F,3])."""
    lat = np.linspace(0.0, np.pi, n_lat)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1).reshape(-1, 3)
    idx = np.arange(n_lat * n_lon).reshape(n_lat, n_lon)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = idx[i, j], idx[i, (j + 1) % n_lon]
            c, d = idx[i + 1, j], idx[i + 1, (j + 1) % n_lon]
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _part(scale, center) -> Tuple[np.ndarray, np.ndarray]:
    v, f = uv_sphere()
    return (v * np.asarray(scale, np.float32) + np.asarray(center, np.float32), f)


def _rot(axis: str, ang: float) -> np.ndarray:
    c, s = np.cos(ang), np.sin(ang)
    if axis == "x":
        return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == "y":
        return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@dataclass
class MeshScene(SynthScene):
    """Articulated mesh fixture with the SynthScene camera/scale protocol:
    object radius ~1 at camera distance 3 (the reference normalization
    regime), orbiting camera (render_synthetic.py:100-116 with rot_axis=y,
    init_a=0.25), focal 2 in half-image units."""

    flap_cycles: float = 2.0    # wing beats over the sequence
    flap_amp: float = 0.9       # radians
    tail_amp: float = 0.5
    orbit_frac: float = 1.0     # fraction of a full camera orbit (alpha)
    init_a: float = 0.25

    def __post_init__(self):
        parts = [
            _part((0.42, 0.30, 0.85), (0, 0, 0)),          # body (long in z)
            _part((0.22, 0.20, 0.24), (0, -0.12, 0.95)),   # head
            _part((0.55, 0.05, 0.30), (0.80, 0, 0.10)),    # wing L
            _part((0.55, 0.05, 0.30), (-0.80, 0, 0.10)),   # wing R
            _part((0.16, 0.05, 0.42), (0, 0.05, -1.05)),   # tail
        ]
        verts, faces = [], []
        off = 0
        for v, f in parts:
            verts.append(v)
            faces.append(f + off)
            off += len(v)
        v = np.concatenate(verts)
        self.faces = np.concatenate(faces)
        # normalize to radius ~= self.radius (render_synthetic.py:64-67)
        v = v - v.mean(0)
        v = v / np.abs(v).max() * self.radius
        self.rest_verts = v.astype(np.float32)

        # --- 4-bone rig: body(root) / wingL / wingR / tail ---------------
        x, z = v[:, 0], v[:, 2]
        smooth = lambda a: np.clip(a, 0.0, 1.0)
        wL = smooth((x - 0.22) / 0.22) * (x > 0)
        wR = smooth((-x - 0.22) / 0.22) * (x < 0)
        wT = smooth((-z - 0.55) / 0.18) * (np.abs(x) < 0.25)
        body = np.clip(1.0 - wL - wR - wT, 0.0, 1.0)
        w = np.stack([body, wL, wR, wT], -1)
        self.weights = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        self.hinges = np.asarray([[0, 0, 0], [0.22, 0, 0.10], [-0.22, 0, 0.10],
                                  [0, 0.03, -0.55]], np.float32)

        # per-vertex texture: canonical direction color + stripes
        n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        stripes = 0.25 * np.sin(7.0 * v[:, 2] + 3.0 * v[:, 0])[:, None]
        self.colors = np.clip(0.55 + 0.40 * n + stripes, 0.0, 1.0).astype(np.float32)
        # CSE stand-in: canonical (rest) surface embedding, pose-invariant
        self.vert_feats = self.surface_feat(v).astype(np.float32)

    # ----------------------------------------------------------- kinematics
    def bone_rots(self, t: float) -> np.ndarray:
        th = self.flap_amp * np.sin(2 * np.pi * self.flap_cycles * t)
        ph = self.tail_amp * np.sin(2 * np.pi * self.flap_cycles * t + 1.3)
        return np.stack([np.eye(3, dtype=np.float32),
                         _rot("z", +th), _rot("z", -th), _rot("x", ph)])

    def pose_points(self, pts: np.ndarray, weights: np.ndarray, t: float
                    ) -> np.ndarray:
        """LBS of rest-space points with given per-point weights [N,B]."""
        R = self.bone_rots(t)                                   # [B,3,3]
        rel = pts[:, None, :] - self.hinges[None]               # [N,B,3]
        posed_b = np.einsum("bij,nbj->nbi", R, rel) + self.hinges[None]
        return np.einsum("nb,nbi->ni", weights, posed_b).astype(np.float32)

    def posed_verts(self, t: float) -> np.ndarray:
        return self.pose_points(self.rest_verts, self.weights, t)

    def camera(self, i: int):
        t = i / max(self.num_frames - 1, 1)
        ang = 2 * np.pi * (self.init_a + self.orbit_frac * t)
        R = _rot("y", ang)
        T = np.asarray([0.0, 0.0, self.cam_dist])
        f = self.focal * self.img_size / 2.0
        K = np.asarray([f, f, self.img_size / 2.0, self.img_size / 2.0])
        return R, T, K

    # ------------------------------------------------------------ rendering
    def _project(self, pts_obj: np.ndarray, rtk: np.ndarray) -> np.ndarray:
        """Object points -> screen-space [x_px, y_px, depth]."""
        R, T, K = rtk[:3, :3], rtk[:3, 3], rtk[3]
        cam = pts_obj @ R.T + T
        z = np.maximum(cam[:, 2], 1e-6)
        return np.stack([cam[:, 0] / z * K[0] + K[2],
                         cam[:, 1] / z * K[1] + K[3], cam[:, 2]], -1)

    def render_frame(self, i: int) -> Dict[str, np.ndarray]:
        from moda_tpu_torch.native import rasterize

        S = self.img_size
        t = i / max(self.num_frames - 1, 1)
        R, T, K = self.camera(i)
        rtk = np.concatenate([np.concatenate([R, T[:, None]], 1), K[None]], 0
                             ).astype(np.float32)
        posed = self.posed_verts(t)
        screen = self._project(posed, rtk)
        attrs = np.concatenate(
            [self.colors, self.vert_feats, self.rest_verts, self.weights], -1)
        out, depth, mask = rasterize(screen, self.faces, attrs.astype(np.float32), S, S)
        img = np.where(mask[..., None] > 0, out[..., :3], 1.0)
        feat = out[..., 3:19]
        nrm = np.linalg.norm(feat, axis=-1, keepdims=True)
        feat = np.where(mask[..., None] > 0, feat / np.maximum(nrm, 1e-9), 0.0)
        return {
            "img": img.astype(np.float32),
            "mask": (mask > 0).astype(np.float32),
            "feat": feat.astype(np.float32),
            "rest_pts": out[..., 19:22].astype(np.float32),
            "skin_w": out[..., 22:26].astype(np.float32),
            "rtk": rtk,
            "time": t,
        }

    def vertex_ids(self, frame: Dict[str, np.ndarray]) -> np.ndarray:
        """The frame's DensePose vertex map: per pixel on the mask, the id of
        the rest vertex nearest its interpolated rest point (an index into
        ``vert_feats``, as CSE ids index the template prior); 0 off it."""
        m = frame["mask"] > 0
        pts = frame["rest_pts"][m]
        v = self.rest_verts
        vv = (v ** 2).sum(-1)
        ids = np.zeros(m.shape, np.int32)
        # 8192 pixels at a time bounds the distance matrix at 512 px
        near = [(vv - 2 * pts[i:i + 8192] @ v.T).argmin(-1) for i in range(0, len(pts), 8192)]
        ids[m] = np.concatenate(near) if near else 0
        return ids

    def flow_between(self, f0: Dict, f1: Dict, i1: int) -> np.ndarray:
        """GT flow frame0 -> frame1 in NDC units, via the interpolated
        rest-surface correspondence (exact for the LBS rig)."""
        S = self.img_size
        rest = f0["rest_pts"].reshape(-1, 3)
        w = f0["skin_w"].reshape(-1, 4)
        wsum = np.maximum(w.sum(-1, keepdims=True), 1e-9)
        posed1 = self.pose_points(rest, w / wsum, f1["time"])
        scr = self._project(posed1, f1["rtk"]).reshape(S, S, 3)
        xs, ys = np.meshgrid(np.arange(S) + 0.5, np.arange(S) + 0.5)
        flow = np.stack([scr[..., 0] - xs, scr[..., 1] - ys], -1)
        flow = np.where(f0["mask"][..., None] > 0, flow, 0.0)
        return (flow * 2.0 / S).astype(np.float32)

    # ------------------------------------------------------------ GT meshes
    def gt_mesh_cam(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Posed GT mesh in CAMERA space (the reference convention:
        render_synthetic.py:127-129 exports obj_to_cam verts)."""
        t = i / max(self.num_frames - 1, 1)
        R, T, _ = self.camera(i)
        return (self.posed_verts(t) @ R.T + T).astype(np.float32), self.faces

    def gt_mesh_rest(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.rest_verts, self.faces
