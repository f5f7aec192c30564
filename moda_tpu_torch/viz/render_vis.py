"""Host-side mesh helpers of the viz tools that the trainer needs: the
icosphere of the default shape prior and the camera-trajectory mesh of
its ``mesh_cam`` export. Counterpart of part of moda_tpu/viz/render_vis.py;
plain numpy. The rest of the viz tools waits for the viz slice.
"""
from __future__ import annotations

import numpy as np

from moda_tpu_torch.extract.mesh import Mesh


def unit_sphere(subdiv: int = 1):
    """Icosphere with ``subdiv`` midpoint subdivisions: (verts, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    for _ in range(subdiv):
        mid = {}
        nv = list(v)
        nf = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (v[a] + v[b]) / 2
                m = m / np.linalg.norm(m)
                mid[key] = len(nv)
                nv.append(m)
            return mid[key]

        for (a, b, c) in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(nv, np.float32)
        f = np.asarray(nf, np.int32)
    return v, f


def draw_cams(rtks: np.ndarray, axis_len: float = 0.05) -> Mesh:
    """Camera-trajectory visualization mesh (utils/io.py:190-240 role):
    one small pyramid per camera at its center, colored by time."""
    verts, faces, colors = [], [], []
    n = len(rtks)
    for i, rtk in enumerate(rtks):
        R_ = rtk[:3, :3]
        T = rtk[:3, 3]
        center = -R_.T @ T
        # frustum: apex at center, base towards viewing dir (-z row of R)
        fwd = R_[2]
        up = R_[1]
        right = R_[0]
        base = center + fwd * axis_len * 2
        s = axis_len
        quad = [base + s * (up + right), base + s * (up - right),
                base + s * (-up - right), base + s * (-up + right)]
        vs = [center] + quad
        off = sum(len(v) for v in verts)
        verts.append(np.stack(vs))
        f = np.asarray([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]])
        faces.append(f + off)
        t = i / max(n - 1, 1)
        col = np.asarray([t, 0.2, 1.0 - t])
        colors.append(np.tile(col, (5, 1)))
    return Mesh(np.concatenate(verts).astype(np.float32),
                np.concatenate(faces).astype(np.int32),
                np.concatenate(colors).astype(np.float32))
