"""Offline mesh rendering and image output: counterpart of
moda_tpu/viz/render_vis.py (the reference's scripts/visualize/render_vis.py
roles). Meshes are projected with rtk cameras and drawn by the port's native
z-buffer rasterizer with lambertian toning; bones draw as icosphere meshes.
Everything runs on the host in numpy.

Image output needs no image library (the card's machine is not promised
one): ``save_png`` encodes 8-bit RGB or grey PNGs with zlib and struct, and
``save_gif`` writes a GIF89a animation of its own. The GIF has one
256-colour palette per file: the file's colours where there are at most 256,
otherwise a median cut over its colours (``quantize``), so the palette is
not imageio/Pillow's; each frame waits 1/fps seconds.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

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


def bones_to_mesh(bones: np.ndarray, radius: float = 0.025) -> Mesh:
    """Bone 10-vectors (center, wxyz quaternion, log scales) -> one coloured
    icosphere of fixed radius a bone (utils/io.py:51-78)."""
    from scipy.spatial.transform import Rotation as R

    sv, sf = unit_sphere(1)
    verts, faces, colors = [], [], []
    rng = np.random.default_rng(0)
    for i, b in enumerate(bones):
        center, q = b[:3], b[3:7]
        q = q / max(np.linalg.norm(q), 1e-9)
        rot = R.from_quat(q[[1, 2, 3, 0]]).as_matrix()
        verts.append((sv * radius) @ rot.T + center)
        faces.append(sf + i * len(sv))
        colors.append(np.tile(rng.uniform(0.2, 1.0, 3), (len(sv), 1)))
    return Mesh(np.concatenate(verts).astype(np.float32),
                np.concatenate(faces).astype(np.int32),
                np.concatenate(colors).astype(np.float32))


def vertex_normals(mesh: Mesh) -> np.ndarray:
    """Unit area-weighted vertex normals [V, 3]."""
    v, f = mesh.vertices, mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for i in range(3):
        np.add.at(n, f[:, i], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)


def render_mesh_view(mesh: Mesh, rtk: np.ndarray, size: int = 256,
                     shade: bool = True) -> np.ndarray:
    """The mesh drawn under camera rtk into a [size, size, 3] float32 image
    on white; with ``shade`` the vertex colours are toned by the normals'
    facing (0.4 + 0.6 x max(0, -n_z) in the camera frame)."""
    if len(mesh.vertices) == 0:
        return np.ones((size, size, 3), np.float32)
    colors = mesh.colors if mesh.colors is not None else np.full_like(mesh.vertices, 0.7)
    if shade:
        n_cam = vertex_normals(mesh) @ rtk[:3, :3].T
        light = np.clip(-n_cam[:, 2], 0.0, 1.0)[:, None]
        colors = colors * (0.4 + 0.6 * light)
    img, _, mask = rasterize(project_verts(mesh, rtk), mesh.faces, colors, size, size)
    return np.where(mask[..., None] > 0, img, 1.0).astype(np.float32)


def render_turntable(mesh: Mesh, num_views: int = 36, size: int = 256,
                     cam_dist: Optional[float] = None) -> List[np.ndarray]:
    """``num_views`` views on a circle about the y axis through the mesh's
    centroid, at ``cam_dist`` (3x the mesh's radius by default), focal
    length ``size`` pixels."""
    if len(mesh.vertices) == 0:
        return [np.ones((size, size, 3), np.float32)] * num_views
    center = mesh.vertices.mean(0)
    radius = np.linalg.norm(mesh.vertices - center, axis=-1).max()
    d = cam_dist or 3.0 * radius
    frames = []
    for i in range(num_views):
        ang = 2 * np.pi * i / num_views
        c, s = np.cos(ang), np.sin(ang)
        R_ = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        rtk = np.zeros((4, 4), np.float32)
        rtk[:3, :3] = R_
        rtk[:3, 3] = -R_ @ center + np.asarray([0, 0, d], np.float32)
        rtk[3] = [size, size, size / 2, size / 2]
        frames.append(render_mesh_view(mesh, rtk, size))
    return frames


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


def to_uint8(frame: np.ndarray) -> np.ndarray:
    """Float image in [0, 1] -> uint8, truncating (as the JAX package's
    writers quantize)."""
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def quantize(frames: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """One palette for a whole animation: float RGB frames [H, W, 3] in
    [0, 1] -> (palette [256, 3] uint8, indices [N, H, W] uint8). The frames
    are quantized to uint8 first; where they hold at most 256 colours the
    palette is exactly those, otherwise a median cut: the box with the
    widest channel range (the first such) is split at the pixel-weighted
    median of that channel until there are 256 boxes, and each box's colour
    is its pixels' mean, rounded. Deterministic: the same frames give the
    same bytes."""
    px = np.stack([to_uint8(f) for f in frames]).astype(np.int32)
    keys = (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2]
    uniq, inv, counts = np.unique(keys.ravel(), return_inverse=True, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
    palette = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        palette[:len(uniq)] = cols
        return palette, inv.reshape(keys.shape).astype(np.uint8)

    def widest(box):  # (channel range, channel) of a box
        span = cols[box].max(0) - cols[box].min(0)
        return int(span.max()), int(span.argmax())

    boxes = [np.arange(len(uniq))]
    spans = [widest(boxes[0])]
    while len(boxes) < 256:
        bi = max(range(len(boxes)), key=lambda j: (spans[j][0], -j))
        if spans[bi][0] == 0:
            break  # every box is one colour
        ch = spans[bi][1]
        box = boxes[bi]
        box = box[np.argsort(cols[box, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)) + 1, 1), len(box) - 1)
        boxes[bi], spans[bi] = box[:cut], widest(box[:cut])
        boxes.append(box[cut:])
        spans.append(widest(box[cut:]))
    lut = np.zeros(len(uniq), np.uint8)
    for j, box in enumerate(boxes):
        w = counts[box].astype(np.float64)
        palette[j] = np.round((cols[box] * w[:, None]).sum(0) / w.sum())
        lut[box] = j
    return palette, lut[inv].reshape(keys.shape)


def _lzw(indices: bytes) -> bytes:
    """GIF LZW code stream of 8-bit indices (minimum code size 8): a clear
    code first, variable-width codes of 9 to 12 bits packed LSB first, a
    clear code whenever the 4096-entry table is full, the end code last."""
    clear, end = 256, 257
    out = bytearray()
    acc, nbits, width = clear, 9, 9
    table: dict = {}
    next_code = end + 1
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        acc |= prefix << nbits
        nbits += width
        if next_code < 4096:
            table[key] = next_code
            if next_code == 1 << width:
                width += 1
            next_code += 1
        else:
            acc |= clear << nbits
            nbits += width
            table.clear()
            next_code, width = end + 1, 9
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        prefix = k
    for code in (prefix, end):
        acc |= code << nbits
        nbits += width
    while nbits > 0:
        out.append(acc & 255)
        acc >>= 8
        nbits -= 8
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks (a length byte, at most 255 bytes) and the
    terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def save_gif(path: str, frames: List[np.ndarray], fps: int = 10):
    """Write float RGB frames [H, W, 3] in [0, 1] as a looping GIF89a with
    one global palette (``quantize``) and a delay of 1/fps seconds a frame
    (in the format's hundredths)."""
    palette, idx = quantize(frames)
    h, w = idx.shape[1:]
    delay = int(round(100.0 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in idx:
        parts += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08",
                  _sub_blocks(_lzw(frame.tobytes()))]
    with open(path, "wb") as f:
        f.write(b"".join(parts) + b"\x3b")


def gif_info(path: str) -> dict:
    """Walk a GIF's block structure: {"height", "width", "frames", "delays"
    (hundredths of a second, one a frame)}; raises ValueError where the
    file is not a well-formed GIF89a/87a."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF89a", b"GIF87a") or len(data) < 13:
        raise ValueError(f"{path} is not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    frames, delays, delay = 0, [], 0
    try:
        while data[pos] != 0x3B:
            if data[pos] == 0x21:
                if data[pos + 1] == 0xF9:
                    delay = struct.unpack("<H", data[pos + 4:pos + 6])[0]
                pos = skip_sub_blocks(pos + 2)
            elif data[pos] == 0x2C:
                iflags = data[pos + 9]
                pos += 10 + (3 << ((iflags & 7) + 1) if iflags & 0x80 else 0)
                pos = skip_sub_blocks(pos + 1)
                frames += 1
                delays.append(delay)
            else:
                raise ValueError(f"{path}: unknown block 0x{data[pos]:02x} at {pos}")
    except IndexError:
        raise ValueError(f"{path}: truncated GIF") from None
    return {"height": h, "width": w, "frames": frames, "delays": delays}
