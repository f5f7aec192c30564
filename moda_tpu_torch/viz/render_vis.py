"""Host-side helpers of the viz tools that training and extraction need:
the icosphere of the default shape prior, the camera-trajectory mesh of
the trainer's ``mesh_cam`` export, the mesh silhouette of the extraction's
``refsil`` export, and image output. Counterpart of part of
moda_tpu/viz/render_vis.py; plain numpy and the native rasterizer. The rest
of the viz tools waits for the viz slice.

Image output needs no image library (the card's machine is not promised
one): ``save_png`` encodes 8-bit RGB or grey PNGs with zlib and struct,
and ``save_frames`` stores an animation as a uint8 ``.npy`` frame stack
[N, H, W, 3], where the JAX package's ``save_gif`` writes a gif through
imageio. No module of either package reads the gifs back.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from moda_tpu_torch.extract.mesh import Mesh
from moda_tpu_torch.native import rasterize

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


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


def project_verts(mesh: Mesh, rtk: np.ndarray) -> np.ndarray:
    """Vertices in pixels and depth [V, 3] under rtk ([R|T] in rows 0-2,
    intrinsics (fx, fy, px, py) in row 3)."""
    R_ = rtk[:3, :3]
    T = rtk[:3, 3]
    K = rtk[3]
    cam = mesh.vertices @ R_.T + T
    x = cam[:, 0] / np.maximum(cam[:, 2], 1e-6) * K[0] + K[2]
    y = cam[:, 1] / np.maximum(cam[:, 2], 1e-6) * K[1] + K[3]
    return np.stack([x, y, cam[:, 2]], -1)


def mesh_silhouette(mesh: Mesh, rtk: np.ndarray, height: int, width: int) -> np.ndarray:
    """Binary mesh silhouette [height, width] (float32 0/1) under camera rtk:
    the native z-buffer's coverage mask (the reference's refsil export,
    render_vis.py:490,531-535, uses pyrender's depth mask)."""
    if len(mesh.vertices) == 0:
        return np.zeros((height, width), np.float32)
    _, _, mask = rasterize(project_verts(mesh, rtk), mesh.faces,
                           np.ones((len(mesh.vertices), 1), np.float32), height, width)
    return (mask > 0).astype(np.float32)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray):
    """Write uint8 [H, W] (grey) or [H, W, 3] (RGB) as a lossless 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"save_png takes uint8 [H, W] or [H, W, 3], not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    # filter type 0 (none) before every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def save_frames(path: str, frames: List[np.ndarray]):
    """Store float frames in [0, 1] as a uint8 ``.npy`` stack [N, H, W, C]
    (the JAX package's save_gif quantizes the same way)."""
    np.save(path, np.stack([(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]))
