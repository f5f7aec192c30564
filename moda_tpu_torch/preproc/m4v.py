"""MPEG-4 Part 2 (ISO/IEC 14496-2) video on the card: what FFmpeg's mpeg4
decoder and swscale give cv2.VideoCapture for the streams FFmpeg's mpeg4
encoder writes at its defaults (OpenCV's VideoWriter for 'mp4v' in MP4 and
'XVID', 'DIVX', 'FMP4', 'DX50' in AVI), bit for bit.

A sample goes through three steps:
- the host parse (``native/m4v.cpp``, through ctypes): headers, the
  macroblock layer, the motion vectors, the DC and AC predictions and the
  coefficient VLCs, into one record a macroblock (``mbs``: type, QP,
  vector, the row of each coded block in ``levels``) and the quantised
  levels of each coded block in raster order;
- one copy of those arrays to the device;
- two kernels of ``csrc/m4v.cu``: ``m4v_reconstruct`` (every macroblock of
  the VOP at once: H.263 dequantisation, FFmpeg's simple integer IDCT, the
  half-pel prediction from the previous VOP with its rounding control, the
  clip) and ``yuv420_to_bgr`` (swscale's conversion of the cropped yuv420p
  frame, as cv2 gets it).

``reconstruct_plain`` and ``yuv420_to_bgr_plain`` are the kernels' plain
versions in PyTorch integer arithmetic: the CPU runs them (the tests), the
card never does. A frame is the macroblock-padded yuv420p planes in one
uint8 tensor (Y, then U, then V); each VOP is written into a new one, so
the reference it reads is never the frame being written.

FFmpeg's 8-bit simple IDCT keeps a row shortcut the standard leaves open:
a row whose AC levels are all zero becomes its DC times 8 (the full row
formula differs by one once |DC| passes 1024). The tests hold it, and the
half-pel averages' rounding control, against cv2.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# macroblock types and the fields of a macroblock record (native/m4v.cpp)
MB_INTRA, MB_INTER, MB_SKIP = 0, 1, 2
F_TYPE, F_QP, F_MVX, F_MVY, F_BLK = 0, 1, 2, 3, 4
MB_FIELDS = F_BLK + 6
# VOP coding types as the parser reports them
VOP_I, VOP_P, VOP_NOT_CODED, VOP_NONE = 0, 1, -1, -2
# FFmpeg's 8-bit simple IDCT (simple_idct_template.c): cos(k pi / 16) sqrt(2) 2^14
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20
# swscale's yuv420p -> BGR24 (its x86 SIMD yuv2rgb: BT.601, limited range,
# ff_yuv2rgb_coeffs scaled by ff_yuv2rgb_c_init_tables; products >> 16)
Y_MUL, UB_MUL, UG_MUL, VG_MUL, VR_MUL = 9539, 16525, -3209, -6660, 13075
BT601 = (UB_MUL, UG_MUL, VG_MUL, VR_MUL)

# launches of each kernel through its wrapper since the last reset
launches = {"m4v_reconstruct": 0, "yuv420_to_bgr": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclass
class Geometry:
    """A VOL's sizes: the picture (width x height) and its macroblocks."""
    width: int
    height: int
    mb_w: int
    mb_h: int

    @property
    def luma(self) -> int:
        return 256 * self.mb_w * self.mb_h

    @property
    def frame_bytes(self) -> int:
        return self.luma * 3 // 2


@dataclass
class Vop:
    """One sample's VOP as the host parse gives it."""
    coding: int          # VOP_I, VOP_P or VOP_NOT_CODED
    rounding: int        # vop_rounding_type (0 in an I-VOP)
    qp: int              # vop_quant
    fcode: int
    mbs: Optional[np.ndarray] = None     # int32 [mb_w * mb_h, MB_FIELDS]
    levels: Optional[np.ndarray] = None  # int16 [blocks, 64]


class Parser:
    """The host half: ``native/m4v.cpp`` for one track."""

    def __init__(self, fourcc: str, config: bytes = b""):
        from moda_tpu_torch import native

        self._lib = native._load("m4v")
        self._h = self._lib.m4v_open(fourcc.encode("latin-1")[:4].ljust(4))
        self.geometry: Optional[Geometry] = None
        if config:
            err = ctypes.create_string_buffer(512)
            if self._lib.m4v_config(self._h, config, len(config), err, len(err)):
                raise ValueError(f"the track's decoder configuration (esds): "
                                 f"{err.value.decode()}")
            self._update_geometry()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.m4v_close(self._h)
            self._h = None

    def _update_geometry(self):
        # the parser refuses a VOL whose size differs from an earlier one's
        info = np.zeros(4, np.int32)
        if not self._lib.m4v_info(self._h, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))):
            self.geometry = Geometry(*map(int, info))

    def parse(self, data: bytes) -> Vop:
        """The sample's VOP, with its arrays unless it has vop_coded 0;
        ValueError naming what is refused."""
        vop = np.zeros(4, np.int32)
        if self.geometry is None:  # a VOL in the sample sets the sizes
            self._run(data, vop)
            if vop[0] < 0:
                return self._vop(vop)
        nmb = self.geometry.mb_w * self.geometry.mb_h
        mbs = np.empty((nmb, MB_FIELDS), np.int32)
        levels = np.empty((6 * nmb, 64), np.int16)
        n = self._run(data, vop, mbs, levels)
        return self._vop(vop) if vop[0] < 0 else self._vop(vop, mbs, levels[:n])

    def _run(self, data: bytes, vop: np.ndarray, mbs=None, levels=None) -> int:
        """m4v_parse: the headers alone without ``mbs``, else the VOP's
        records into ``mbs`` and its levels into ``levels``, each at most its
        length."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        err = ctypes.create_string_buffer(512)
        n = self._lib.m4v_parse(
            self._h, data, len(data), vop.ctypes.data_as(i32p),
            None if mbs is None else mbs.ctypes.data_as(i32p), 0 if mbs is None else len(mbs),
            None if levels is None else levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            0 if levels is None else len(levels), err, len(err))
        if n < 0:
            raise ValueError(err.value.decode())
        self._update_geometry()
        return n

    @staticmethod
    def _vop(vop, mbs=None, levels=None) -> Vop:
        if vop[0] == VOP_NONE:
            raise ValueError("no VOP in the sample")
        return Vop(int(vop[0]), int(vop[1]), int(vop[2]), int(vop[3]), mbs, levels)


# ---------------------------------------------------------- plain versions
def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 values stored to int16 (two's complement wrap), as int32."""
    return ((x + 32768) & 0xFFFF) - 32768


def dc_scale(qp: torch.Tensor, luma: bool) -> torch.Tensor:
    """ff_mpeg4_{y,c}_dc_scale_table."""
    if luma:
        s = torch.where(qp < 9, 2 * qp, torch.where(qp < 25, qp + 8, 2 * qp - 16))
    else:
        s = torch.where(qp < 25, (qp + 13) // 2, qp - 6)
    return torch.where(qp < 5, torch.full_like(qp, 8), s)


def dequantize(coef: torch.Tensor, typ: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """H.263 dequantisation of [nmb, 6, 64] int32 levels: intra AC and inter
    levels as level 2QP +- ((QP - 1) | 1), the intra DC times dc_scaler,
    intra blocks stored as int16, inter ones saturated to [-2048, 2047]."""
    q = qp.view(-1, 1, 1)
    ac = torch.where(coef > 0, coef * (2 * q) + ((q - 1) | 1),
                     torch.where(coef < 0, coef * (2 * q) - ((q - 1) | 1), 0))
    scale = torch.cat([dc_scale(qp, True).view(-1, 1).expand(-1, 4),
                       dc_scale(qp, False).view(-1, 1).expand(-1, 2)], 1)
    intra = torch.cat([(coef[..., :1] * scale[..., None]), ac[..., 1:]], -1)
    return torch.where(typ.view(-1, 1, 1) == MB_INTRA, _wrap16(intra), ac.clamp(-2048, 2047))


def idct_plain(blocks: torch.Tensor) -> torch.Tensor:
    """FFmpeg's ff_simple_idct_int16_8bit of [N, 8, 8] int32 coefficients
    (int16 values): rows (a row with only a DC becomes DC x 8, stored as
    int16), then columns; int32 [N, 8, 8], not clipped."""
    r = [blocks[..., k] for k in range(8)]
    dc_only = (blocks[..., 1:] == 0).all(-1)
    a0 = W4 * r[0] + (1 << (ROW_SHIFT - 1))
    a1, a2, a3 = a0 + W6 * r[2], a0 - W6 * r[2], a0 - W2 * r[2]
    a0 = a0 + W2 * r[2]
    b0 = W1 * r[1] + W3 * r[3]
    b1 = W3 * r[1] - W7 * r[3]
    b2 = W5 * r[1] - W1 * r[3]
    b3 = W7 * r[1] - W5 * r[3]
    a0 = a0 + W4 * r[4] + W6 * r[6]
    a1 = a1 - W4 * r[4] - W2 * r[6]
    a2 = a2 - W4 * r[4] + W2 * r[6]
    a3 = a3 + W4 * r[4] - W6 * r[6]
    b0 = b0 + W5 * r[5] + W7 * r[7]
    b1 = b1 - W1 * r[5] - W5 * r[7]
    b2 = b2 + W7 * r[5] + W3 * r[7]
    b3 = b3 + W3 * r[5] - W1 * r[7]
    rows = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1,
                        a0 - b0], -1) >> ROW_SHIFT
    rows = torch.where(dc_only[..., None], _wrap16(r[0] * 8)[..., None], _wrap16(rows))
    c = [rows[..., k, :] for k in range(8)]
    a0 = W4 * (c[0] + ((1 << (COL_SHIFT - 1)) // W4))
    a1, a2, a3 = a0 + W6 * c[2], a0 - W6 * c[2], a0 - W2 * c[2]
    a0 = a0 + W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3]
    b1 = W3 * c[1] - W7 * c[3]
    b2 = W5 * c[1] - W1 * c[3]
    b3 = W7 * c[1] - W5 * c[3]
    a0 = a0 + W4 * c[4] + W6 * c[6]
    a1 = a1 - W4 * c[4] - W2 * c[6]
    a2 = a2 - W4 * c[4] + W2 * c[6]
    a3 = a3 + W4 * c[4] - W6 * c[6]
    b0 = b0 + W5 * c[5] + W7 * c[7]
    b1 = b1 - W1 * c[5] - W5 * c[7]
    b2 = b2 + W7 * c[5] + W3 * c[7]
    b3 = b3 + W3 * c[5] - W1 * c[7]
    return torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1,
                        a0 - b0], -2) >> COL_SHIFT


def _half_pel(plane: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, dx: torch.Tensor,
              dy: torch.Tensor, size: int, rounding: int) -> torch.Tensor:
    """[nmb, size, size] predictions from ``plane`` at integer origins (x0,
    y0) [nmb] plus half-pel flags (dx, dy), coordinates clamped to the
    plane (unrestricted vectors: edge extension), averaged with the rounding
    control: (a + b + 1 - r) >> 1, (a + b + c + d + 2 - r) >> 2."""
    h, w = plane.shape
    k = torch.arange(size + 1, device=plane.device)
    xs = (x0[:, None] + k).clamp(0, w - 1)
    ys = (y0[:, None] + k).clamp(0, h - 1)
    p = plane.long()[ys[:, :, None], xs[:, None, :]]  # [nmb, size + 1, size + 1]
    a, b = p[:, :-1, :-1], p[:, :-1, 1:]
    c, d = p[:, 1:, :-1], p[:, 1:, 1:]
    hx = (a + b + 1 - rounding) >> 1
    hy = (a + c + 1 - rounding) >> 1
    hxy = (a + b + c + d + 2 - rounding) >> 2
    fx, fy = dx.view(-1, 1, 1).bool(), dy.view(-1, 1, 1).bool()
    return torch.where(fx & fy, hxy, torch.where(fx, hx, torch.where(fy, hy, a)))


def planes(frame: torch.Tensor, g: Geometry):
    """The (Y, U, V) views of a padded frame."""
    n = g.luma
    return (frame[:n].view(16 * g.mb_h, 16 * g.mb_w),
            frame[n:n + n // 4].view(8 * g.mb_h, 8 * g.mb_w),
            frame[n + n // 4:].view(8 * g.mb_h, 8 * g.mb_w))


def reconstruct_plain(ref: Optional[torch.Tensor], mbs: torch.Tensor, levels: torch.Tensor,
                      rounding: int, g: Geometry) -> torch.Tensor:
    """What ``m4v_reconstruct`` computes, in PyTorch: the VOP of ``mbs``
    (int32 [nmb, MB_FIELDS]) and ``levels`` (int16 [blocks, 64]) predicted
    from the padded frame ``ref`` (uint8; None in an I-VOP, which predicts
    every macroblock from zero), as a new padded frame (uint8
    [frame_bytes])."""
    dev = mbs.device
    nmb = g.mb_w * g.mb_h
    typ, qp = mbs[:, F_TYPE], mbs[:, F_QP]
    idx = mbs[:, F_BLK:].long()
    coef = torch.zeros((nmb, 6, 64), dtype=torch.int32, device=dev)
    has = idx >= 0
    if has.any():
        coef[has] = levels[idx[has]].int()
    res = idct_plain(dequantize(coef, typ, qp).view(nmb * 6, 8, 8)).view(nmb, 6, 8, 8)
    intra = (typ == MB_INTRA).view(-1, 1, 1, 1)
    if ref is None:
        pred = torch.zeros_like(res)
    else:
        mx, my = mbs[:, F_MVX].long(), mbs[:, F_MVY].long()
        k = torch.arange(nmb, device=dev)
        bx, by = k % g.mb_w, k // g.mb_w
        Y, U, V = planes(ref, g)
        luma = _half_pel(Y, 16 * bx + (mx >> 1), 16 * by + (my >> 1), mx & 1, my & 1, 16,
                         rounding)
        cx, cy = (mx >> 1) | (mx & 1), (my >> 1) | (my & 1)
        chroma = [_half_pel(P, 8 * bx + (cx >> 1), 8 * by + (cy >> 1), cx & 1, cy & 1, 8,
                            rounding) for P in (U, V)]
        pred = torch.cat([luma.view(nmb, 2, 8, 2, 8).permute(0, 1, 3, 2, 4).reshape(nmb, 4, 8, 8),
                          torch.stack(chroma, 1)], 1).int()
        pred = torch.where(intra, 0, pred)
    out = (pred + res).clamp(0, 255).to(torch.uint8)
    y = out[:, :4].reshape(g.mb_h, g.mb_w, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
    u = out[:, 4].reshape(g.mb_h, g.mb_w, 8, 8).permute(0, 2, 1, 3)
    v = out[:, 5].reshape(g.mb_h, g.mb_w, 8, 8).permute(0, 2, 1, 3)
    return torch.cat([y.reshape(-1), u.reshape(-1), v.reshape(-1)])


def yuv420_to_bgr_plain(frame: torch.Tensor, g: Geometry, left: int = 0, top: int = 0,
                        coeffs=BT601) -> torch.Tensor:
    """What ``yuv420_to_bgr`` computes, in PyTorch: the width x height
    picture at (``left``, ``top``; even) of a padded frame as uint8
    [height, width, 3] BGR, by swscale's integer yuv2rgb (chroma nearest,
    each 2 x 2 pixels one U and one V) with the matrix's ``coeffs``
    (u -> B, u -> G, v -> G, v -> R)."""
    Y, U, V = planes(frame, g)
    h, w = g.height, g.width
    ub, ug, vg, vr = coeffs
    y = Y[top:top + h, left:left + w].int()
    cy, cx = top // 2, left // 2
    u = U[cy:cy + (h + 1) // 2, cx:cx + (w + 1) // 2].int().repeat_interleave(2, 0) \
        .repeat_interleave(2, 1)
    v = V[cy:cy + (h + 1) // 2, cx:cx + (w + 1) // 2].int().repeat_interleave(2, 0) \
        .repeat_interleave(2, 1)
    u, v = 8 * u[:h, :w] - 1024, 8 * v[:h, :w] - 1024
    luma = ((8 * y - 128) * Y_MUL) >> 16
    b = luma + ((u * ub) >> 16)
    gr = luma + ((u * ug) >> 16) + ((v * vg) >> 16)
    r = luma + ((v * vr) >> 16)
    return torch.stack([b, gr, r], -1).clamp(0, 255).to(torch.uint8)


# ------------------------------------------------------------ the kernels
_lib = None
_lib_lock = threading.Lock()
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "m4v.cu"
_BUILD = Path(__file__).resolve().parent.parent / "_build"


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libmoda_m4v_{tag}.so"


def build_library() -> ctypes.CDLL:
    """Compile csrc/m4v.cu for sm_90a into a shared library (once per source
    content) and load it. A failed build raises."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from moda_tpu_torch.ops.fused_mlp import _nvcc

        _BUILD.mkdir(parents=True, exist_ok=True)
        so = _lib_path()
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SRC)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
            so.with_suffix(".log").write_text(res.stderr)
        lib = ctypes.CDLL(str(so))
        lib.moda_m4v_reconstruct.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        lib.moda_m4v_reconstruct.restype = ctypes.c_int
        lib.moda_yuv420_to_bgr.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        lib.moda_yuv420_to_bgr.restype = ctypes.c_int
        lib.moda_m4v_error_string.argtypes = [ctypes.c_int]
        lib.moda_m4v_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_report() -> str:
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: {build_library().moda_m4v_error_string(rc).decode()}")


def reconstruct(ref: Optional[torch.Tensor], mbs: torch.Tensor, levels: torch.Tensor,
                rounding: int, g: Geometry) -> torch.Tensor:
    """The VOP as a new padded frame (``ref`` None: predicted from zero):
    the kernel m4v_reconstruct on CUDA tensors, ``reconstruct_plain`` on CPU
    ones."""
    if mbs.device.type == "cpu":
        return reconstruct_plain(ref, mbs, levels, rounding, g)
    nmb = g.mb_w * g.mb_h
    if mbs.dtype != torch.int32 or tuple(mbs.shape) != (nmb, MB_FIELDS) or \
            levels.dtype != torch.int16 or levels.dim() != 2 or levels.shape[1] != 64 or \
            not (mbs.is_contiguous() and levels.is_contiguous()) or levels.device != mbs.device:
        raise ValueError(f"m4v_reconstruct: mbs must be int32 [{nmb}, {MB_FIELDS}] and levels "
                         f"int16 [n, 64], contiguous on one device, got {mbs.dtype} "
                         f"{tuple(mbs.shape)} on {mbs.device}, {levels.dtype} "
                         f"{tuple(levels.shape)} on {levels.device}")
    if ref is not None and (ref.device != mbs.device or ref.dtype != torch.uint8 or
                            ref.numel() != g.frame_bytes or not ref.is_contiguous()):
        raise ValueError(f"m4v_reconstruct: the reference must be a contiguous uint8 "
                         f"[{g.frame_bytes}] on {mbs.device}")
    lib = build_library()
    out = torch.empty(g.frame_bytes, dtype=torch.uint8, device=mbs.device)
    stream = torch.cuda.current_stream(mbs.device).cuda_stream
    _check(lib.moda_m4v_reconstruct(ref.data_ptr() if ref is not None else None, mbs.data_ptr(),
                                    levels.data_ptr(), out.data_ptr(), g.mb_w, g.mb_h, rounding,
                                    stream), "m4v_reconstruct")
    launches["m4v_reconstruct"] += 1
    return out


def yuv420_to_bgr(frame: torch.Tensor, g: Geometry, left: int = 0, top: int = 0,
                  coeffs=BT601) -> torch.Tensor:
    """The picture of a padded frame (at ``left``, ``top``) as uint8
    [height, width, 3] BGR: the kernel yuv420_to_bgr on a CUDA tensor,
    ``yuv420_to_bgr_plain`` on a CPU one."""
    if frame.device.type == "cpu":
        return yuv420_to_bgr_plain(frame, g, left, top, coeffs)
    if frame.dtype != torch.uint8 or frame.numel() != g.frame_bytes or \
            not frame.is_contiguous():
        raise ValueError(f"yuv420_to_bgr: the frame must be contiguous uint8 [{g.frame_bytes}]")
    lib = build_library()
    out = torch.empty((g.height, g.width, 3), dtype=torch.uint8, device=frame.device)
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    _check(lib.moda_yuv420_to_bgr(frame.data_ptr(), out.data_ptr(), g.mb_w, g.mb_h, g.width,
                                  g.height, left, top, *coeffs, stream), "yuv420_to_bgr")
    launches["yuv420_to_bgr"] += 1
    return out


# ----------------------------------------------------------- the decoder
class Mpeg4Decoder:
    """Decodes a track's samples in decode order on ``device`` (the card
    unless the caller asks for the CPU), holding the reference frame there.

    ``video`` is a preproc/video.py ``Video`` (its fourcc names the stream
    kind FFmpeg assumes, its ``config`` holds an MP4's esds
    DecoderSpecificInfo). ``decode(sample)`` returns the picture as uint8
    [height, width, 3] BGR on the device, what cv2.VideoCapture reads, or
    None for a VOP with vop_coded 0 (cv2 reads no frame for it; the
    reference stays). ``advance`` and ``picture`` are its two halves, for a
    caller that keeps only some pictures."""

    def __init__(self, video, device=None):
        from moda_tpu_torch.runtime import resolve_device

        self.device = resolve_device(device)
        try:
            self.parser = Parser(video.fourcc, video.config)
        except ValueError as e:
            raise ValueError(f"{video.path}: {e}") from None
        self.ref: Optional[torch.Tensor] = None  # the last padded frame

    def upload(self, vop: Vop):
        """(mbs, levels) on the device, from one host-to-device copy."""
        g = self.parser.geometry
        mb_bytes = vop.mbs.nbytes
        host = np.empty(mb_bytes + vop.levels.nbytes, np.uint8)
        host[:mb_bytes] = vop.mbs.reshape(-1).view(np.uint8)
        host[mb_bytes:] = vop.levels.reshape(-1).view(np.uint8)
        buf = torch.from_numpy(host)
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        mbs = buf[:mb_bytes].view(torch.int32).view(g.mb_w * g.mb_h, MB_FIELDS)
        levels = buf[mb_bytes:].view(torch.int16).view(-1, 64)
        return mbs, levels

    def advance(self, vop: Vop) -> bool:
        """Reconstructs a parsed VOP into the reference frame; False (and
        the reference kept) for one with vop_coded 0."""
        if vop.coding == VOP_NOT_CODED:
            return False
        if vop.coding == VOP_P and self.ref is None:
            raise ValueError("a P-VOP without a preceding I-VOP")
        mbs, levels = self.upload(vop)
        # the new frame is another buffer: no block reads a plane being written
        self.ref = reconstruct(self.ref if vop.coding == VOP_P else None, mbs, levels,
                               vop.rounding, self.parser.geometry)
        return True

    def picture(self) -> torch.Tensor:
        """The reference frame's picture, uint8 [height, width, 3] BGR on
        the device."""
        return yuv420_to_bgr(self.ref, self.parser.geometry)

    def decode(self, sample: bytes) -> Optional[torch.Tensor]:
        return self.picture() if self.advance(self.parser.parse(sample)) else None
