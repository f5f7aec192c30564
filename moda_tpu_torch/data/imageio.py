"""Image reading and resampling for the frame reader, without an image
library: ``imread``, ``resize`` and ``remap`` stand in for the cv2 calls of
moda_tpu/data/frames.py, train/warmup_pose.py and train/trainer.py, with
the semantics of the cv2 build the JAX package runs against. The pixel work
is host C++ (``native/imgcodec.cpp``, built with g++ at first use); PNG
inflate is Python's zlib.

- ``imread(path, gray=False)`` tells JPEG, PNG and PBM apart by the file's
  first bytes, as cv2.imread does, and returns uint8 [H, W, 3] in RGB order (cv2
  gives BGR) or [H, W] with ``gray=True``; None for a missing, empty or
  non-image file. JPEG: baseline and extended sequential Huffman with
  libjpeg-turbo's arithmetic (grey = the Y plane); progressive, lossless
  and arithmetic-coded files raise ValueError naming their SOF marker.
  PNG: 8-bit grey, grey+alpha, RGB, RGBA and palette colour (1-8 bits),
  not interlaced; colour read as grey goes through libpng's rgb_to_gray
  with the coefficients OpenCV sets (0.299, 0.587: (9797 R + 19234 G +
  3737 B) >> 15); alpha is dropped. PBM (netpbm P1 text and P4 binary, the
  AMA silhouettes): a set bit is black (0), a clear one white (255), as
  cv2 reads them. Anything else raises ValueError.
- ``resize(img, (width, height), interpolation)`` and ``remap(img, map_x,
  map_y, interpolation)`` take float32 images [H, W] or [H, W, C] with any
  channel count and return float32 of the same layout: cv2.resize and
  cv2.remap (float maps, BORDER_CONSTANT 0) with INTER_NEAREST or
  INTER_LINEAR (see imgcodec.cpp for the exact rules); ``remap_planes``
  remaps [C, H, W] planes as cv2.remap does each plane alone. A uint8
  image through ``resize`` with INTER_LINEAR takes cv2's 8-bit fixed-point
  path and stays uint8, bit-equal to cv2.resize of that image (VCN's
  inputs are resized so, before they become floats).
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from moda_tpu_torch.native import _load

INTER_NEAREST, INTER_LINEAR = 0, 1  # cv2's values

_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PBM_MAGICS = (b"P1", b"P4")
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def imread(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """Decode the image at ``path``: uint8 [H, W, 3] RGB, or [H, W] with
    ``gray``; None where the file is missing, empty or not an image."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data, gray)
    if data.startswith(_PNG_MAGIC):
        return decode_png(data, gray)
    if data[:2] in _PBM_MAGICS and data[2:3].isspace():
        return decode_pbm(data, gray)
    return None


def _pbm_header(data: bytes):
    """(width, height, offset of the raster) of a PBM: the magic, then two
    decimal fields separated by whitespace and '#' comments, then one
    whitespace byte."""
    pos, fields = 2, []
    while len(fields) < 2:
        while pos < len(data) and (data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                end = data.find(b"\n", pos)
                pos = len(data) if end < 0 else end
            pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError("PBM header without its width and height")
        fields.append(int(data[start:pos]))
    return fields[0], fields[1], pos + 1


def decode_pbm(data: bytes, gray: bool = False) -> np.ndarray:
    w, h, pos = _pbm_header(data)
    if w <= 0 or h <= 0:
        raise ValueError(f"PBM of size {w} x {h}")
    if data[:2] == b"P4":
        rowbytes = (w + 7) // 8
        raw = np.frombuffer(data, np.uint8, count=h * rowbytes, offset=pos) \
            if len(data) - pos >= h * rowbytes else None
        if raw is None:
            raise ValueError("truncated PBM image data")
        bits = np.unpackbits(raw.reshape(h, rowbytes), axis=1)[:, :w]
    else:
        digits = np.frombuffer(data[pos:], np.uint8)
        digits = digits[(digits == ord("0")) | (digits == ord("1"))]
        if digits.size < w * h:
            raise ValueError("truncated PBM image data")
        bits = (digits[:w * h] - ord("0")).reshape(h, w)
    img = np.where(bits > 0, 0, 255).astype(np.uint8)
    return img if gray else np.repeat(img[..., None], 3, axis=-1)


def jpeg_size(data: bytes) -> Tuple[int, int, int]:
    """(height, width, components) from a JPEG's headers, up to its frame
    header; ValueError where the file is not one the decoder reads."""
    lib = _load("imgcodec")
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_size(buf.ctypes.data_as(_U8P), len(buf), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(nc), err, len(err)) != 0:
        raise ValueError(err.value.decode())
    return h.value, w.value, nc.value


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    h, w, _ = jpeg_size(data)
    lib = _load("imgcodec")
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    ch = 1 if gray else 3
    out = np.empty((h, w, ch), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data_as(_U8P), len(buf), ch, out.ctypes.data_as(_U8P),
                       h, w, err, len(err)) != 0:
        raise ValueError(err.value.decode())
    return out[..., 0] if gray else out


def _png_chunks(data: bytes):
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    hdr, idat, palette = None, [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if w * h > 1 << 30:  # OpenCV's default limit on decoded pixels
        raise ValueError(f"PNG image too large: {w} x {h}")
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if chans is None or interlace or (depth != 8 and not (ctype == 3 and depth in (1, 2, 4))):
        raise ValueError(f"unsupported PNG: colour type {ctype}, {depth}-bit, "
                         f"{'interlaced' if interlace else 'not interlaced'}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    rowbytes = (w * chans * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (rowbytes + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((h, rowbytes), np.uint8)
    if _load("imgcodec").png_unfilter(raw.ctypes.data_as(_U8P), h, rowbytes,
                                       max(1, chans * depth // 8),
                                       out.ctypes.data_as(_U8P)) != 0:
        raise ValueError("PNG with an unknown filter type")
    if ctype == 3:
        idx = np.unpackbits(out, axis=1)[:, :w * depth] if depth < 8 else out
        if depth < 8:
            idx = idx.reshape(h, w, depth) @ (1 << np.arange(depth - 1, -1, -1))
        img = palette[np.minimum(idx, len(palette) - 1)]
    else:
        img = out.reshape(h, w, chans)[..., :3 if chans >= 3 else 1]
    if img.shape[-1] == 1:
        return img[..., 0] if gray else np.repeat(img, 3, axis=-1)
    if not gray:
        return np.ascontiguousarray(img)
    r, g, b = (img[..., k].astype(np.int32) for k in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _as_f32(img: np.ndarray) -> Tuple[np.ndarray, int]:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim not in (2, 3):
        raise ValueError(f"image of shape {img.shape}: expected [H, W] or [H, W, C]")
    return img, (img.shape[2] if img.ndim == 3 else 1)


def _interp(interpolation: int) -> int:
    if interpolation not in (INTER_NEAREST, INTER_LINEAR):
        raise ValueError(f"interpolation {interpolation}: INTER_NEAREST or INTER_LINEAR")
    return interpolation


def resize(img: np.ndarray, dsize: Tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.resize(img, dsize=(width, height), interpolation) on float32, or
    on uint8 with INTER_LINEAR (uint8 out, cv2's fixed-point arithmetic)."""
    if isinstance(img, np.ndarray) and img.dtype == np.uint8 \
            and _interp(interpolation) == INTER_LINEAR:
        return _resize_u8(img, dsize)
    src, cn = _as_f32(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or src.shape[0] == 0 or src.shape[1] == 0:
        raise ValueError(f"resize of {src.shape[:2]} to {(dh, dw)}")
    out = np.empty((dh, dw) + src.shape[2:], np.float32)
    _load("imgcodec").resize_f32(src.ctypes.data_as(_F32P), src.shape[0], src.shape[1], cn,
                                 out.ctypes.data_as(_F32P), dh, dw, _interp(interpolation))
    return out


def _resize_u8(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    src = np.ascontiguousarray(img)
    if src.ndim not in (2, 3):
        raise ValueError(f"image of shape {src.shape}: expected [H, W] or [H, W, C]")
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or src.shape[0] == 0 or src.shape[1] == 0:
        raise ValueError(f"resize of {src.shape[:2]} to {(dh, dw)}")
    out = np.empty((dh, dw) + src.shape[2:], np.uint8)
    _load("imgcodec").resize_u8(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1],
                                src.shape[2] if src.ndim == 3 else 1,
                                out.ctypes.data_as(_U8P), dh, dw)
    return out


def _maps(map_x: np.ndarray, map_y: np.ndarray):
    mx = np.ascontiguousarray(map_x, np.float32)
    my = np.ascontiguousarray(map_y, np.float32)
    if mx.shape != my.shape or mx.ndim != 2:
        raise ValueError(f"maps of shapes {mx.shape} and {my.shape}")
    return mx, my


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, interpolation) on float32 with float
    maps and BORDER_CONSTANT 0; the output has the maps' [H, W]. As in
    OpenCV 5, INTER_LINEAR weighs with the exact fraction for 1, 3 and 4
    channels and with the fraction rounded to 1/32 pixel for the others."""
    src, cn = _as_f32(img)
    mx, my = _maps(map_x, map_y)
    out = np.empty(mx.shape + src.shape[2:], np.float32)
    _load("imgcodec").remap_f32(src.ctypes.data_as(_F32P), src.shape[0], src.shape[1], cn, 0,
                                mx.ctypes.data_as(_F32P), my.ctypes.data_as(_F32P), mx.size,
                                out.ctypes.data_as(_F32P), _interp(interpolation),
                                int(cn not in (1, 3, 4)))
    return out


def remap_planes(planes: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                 interpolation: int = INTER_LINEAR) -> np.ndarray:
    """[C, H, W] float32 planes through one pair of maps -> [C, h, w]: what
    cv2.remap gives on each [H, W] plane alone, in one pass over the maps."""
    src = np.ascontiguousarray(planes, np.float32)
    if src.ndim != 3:
        raise ValueError(f"planes of shape {src.shape}: expected [C, H, W]")
    mx, my = _maps(map_x, map_y)
    out = np.empty((src.shape[0],) + mx.shape, np.float32)
    _load("imgcodec").remap_f32(src.ctypes.data_as(_F32P), src.shape[1], src.shape[2],
                                src.shape[0], 1, mx.ctypes.data_as(_F32P),
                                my.ctypes.data_as(_F32P), mx.size, out.ctypes.data_as(_F32P),
                                _interp(interpolation), 0)
    return out
