"""H.264 (ISO/IEC 14496-10) video on the card: what FFmpeg's h264 decoder
and swscale give cv2.VideoCapture for progressive 8-bit 4:2:0 streams with
CAVLC or CABAC and I, P and B slices (the tool set of the Baseline, Main and
High profiles in frame coding: B slices with spatial and temporal direct
prediction, weighted prediction explicit and implicit, High profile's 8x8
transform, Intra 8x8 prediction and scaling matrices), bit for bit, in
FFmpeg's output order. The other tools native/h264.cpp names are refused.

A sample (an access unit) goes through three steps:
- the host parse (``native/h264.cpp``, through ctypes): parameter sets,
  slice headers, order counts, the decoded picture buffer's marking and
  lists, the macroblock layer (CAVLC or CABAC, as the PPS says), motion
  vector prediction (direct prediction included), intra mode prediction
  and the loop filter's boundary strengths, into one record a macroblock
  (``mbs``, fields ``F_*``), the levels of each macroblock with a residual
  (``levels``, layout ``L_*``), the picture's LevelScale tables
  (``scales``, layout at ``SCALES``: its scaling matrices times
  normAdjust) and one weighted prediction table a slice (``weights``,
  layout ``W_*``); and FFmpeg's output order: which picture leaves the
  reorder buffer after this one;
- one copy of those arrays, with the picture's launch lists, to the device;
- three kernels of ``csrc/h264.cu``, in this order, since intra prediction
  reads unfiltered neighbours: ``h264_inter`` (every P, B and skipped
  macroblock at once: the 6-tap luma and bilinear chroma prediction from
  the reference slots of one or both lists, combined as the slice's weight
  table says, the residual), ``h264_intra`` (the intra
  macroblocks, one launch a wavefront x + 2y of macroblocks) and
  ``h264_deblock`` (the loop filter, one launch a wavefront); then
  preproc/m4v.py's ``yuv420_to_bgr`` for a picture that is kept.

``inter_plain``, ``intra_plain`` and ``deblock_plain`` are the kernels' plain
versions in PyTorch integer arithmetic, vectorised over the macroblocks one
kernel step handles (every inter macroblock; one wavefront): the CPU runs
them (the tests), the card never does. The decoded picture buffer is one
uint8 tensor [slots, frame bytes], each frame the macroblock-padded planes
Y, then U, then V, as preproc/m4v.py lays them out.
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

from moda_tpu_torch.preproc import m4v as M

# macroblock kinds (intra ones first; K_P a coded inter macroblock of a P or
# B slice, K_SKIP P_Skip or B_Skip) and the fields of a record
# (native/h264.cpp): F_MODES a 4x4 block's intra mode a nibble (an Intra 8x8
# block's over its four 4x4 blocks), F_T8 transform_size_8x8_flag; per 4x4
# block F_MV/F_MV1 the list 0/1 vector (x low 16 bits, y high), F_REF/F_REF1
# the slot it predicts from (a byte a block, 0xFF: the list is not used),
# F_RIDX/F_RIDX1 its ref_idx (a byte a block), F_SLICE the slice whose
# weight table they index
K_I4, K_I8, K_I16, K_PCM, K_P, K_SKIP = range(6)
F_KIND, F_QP, F_CQP0, F_CQP1, F_M16, F_MC, F_AVAIL, F_ROW = range(8)
F_MODES, F_BS, F_ALPHA, F_BETA, F_MV, F_REF, F_T8 = 8, 10, 18, 19, 20, 36, 40
F_MV1, F_REF1, F_RIDX, F_RIDX1, F_SLICE, FIELDS = 41, 57, 61, 65, 69, 70
# a slice's weighted prediction table (8.4.2.3): W_MODE 0 the default
# average, 1 explicit, 2 implicit; logWD of luma, then chroma; the explicit
# weight and offset [list][ref_idx][Y, Cb, Cr][w, o]; the implicit w0
# [refIdxL0][refIdxL1] (w1 = 64 - w0, logWD 5, no offsets)
W_MODE, W_LOGWD, W_EXPLICIT = 0, 1, 3
W_IMPLICIT = W_EXPLICIT + 2 * 32 * 3 * 2
WT = W_IMPLICIT + 32 * 32
UNUSED = 0xFF  # a list's slot byte where the block does not use it
# a macroblock's row of levels: 16 luma blocks (raster in each; with the
# 8x8 transform four 8x8 blocks of 64, raster in each), the Intra16x16 DC
# (raster over the blocks), chroma DC (Cb, Cr), chroma AC (Cb, Cr; 4 blocks
# each); an I_PCM macroblock's samples in the same row
L_DC, L_CDC, L_CAC, LEVELS = 256, 272, 280, 408
# a picture's LevelScale tables: LevelScale4x4 [6 lists: Intra Y, Cb, Cr,
# Inter Y, Cb, Cr][qP % 6][16 raster], then LevelScale8x8 [2: Intra Y,
# Inter Y][qP % 6][64 raster]
S_8X8 = 6 * 6 * 16
SCALES = S_8X8 + 2 * 6 * 64
BLK_X = [0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3]
BLK_Y = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]
CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38,
                               38, 38, 39, 39, 39, 39]
# the loop filter's tables (8.7.2.2), by indexA / indexB, and tC0 by bS 1-3
ALPHA = [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50,
                    56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255]
BETA = [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12,
                   13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18]
TC0 = [[0, 0, 0]] * 17 + [
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1], [1, 1, 1], [1, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3],
    [2, 2, 3], [2, 2, 4], [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
    [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14], [8, 11, 16],
    [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25]]
# swscale's yuv2rgb coefficients (ff_yuv2rgb_coeffs / 8: u -> B, u -> G,
# v -> G, v -> R) of the colour matrices the parser passes: BT.601, BT.709
COEFFS = ((M.UB_MUL, M.UG_MUL, M.VG_MUL, M.VR_MUL), (17305, -1747, -4366, 14686))

# macroblocks a step of inter_plain (its windows take ~10 kB a macroblock a
# list)
INTER_CHUNK = 2048
MAX_SLOTS = 33  # native/h264.cpp's decoded picture buffer at its largest
# launches of each kernel through its wrapper since the last reset
launches = {"h264_inter": 0, "h264_intra": 0, "h264_deblock": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclass
class Geometry:
    """The active SPS's sizes: macroblocks, the cropped picture and its
    offsets, the decoded picture buffer's slots, the colour matrix."""
    mb_w: int
    mb_h: int
    width: int
    height: int
    left: int
    top: int
    slots: int           # references, the current picture, pictures waiting for output
    matrix: int

    @property
    def luma(self) -> int:
        return 256 * self.mb_w * self.mb_h

    @property
    def frame_bytes(self) -> int:
        return self.luma * 3 // 2

    @property
    def m4v(self) -> M.Geometry:
        """The padded frame's geometry as preproc/m4v.py's conversion takes
        it (the picture's size; the crop's offsets go beside it)."""
        return M.Geometry(self.width, self.height, self.mb_w, self.mb_h)

    @property
    def waves(self) -> int:
        return self.mb_w + 2 * (self.mb_h - 1)


@dataclass
class Picture:
    """One sample's picture as the host parse gives it."""
    slot: int            # the decoded picture buffer slot it is decoded into
    idr: bool
    poc: int
    frame_num: int
    ref: bool
    slices: int
    types: int           # 1: an I slice, 2: a P slice, 4: a B slice
    out: int = -1        # the slot of the picture output after this one (-1: none)
    mbs: Optional[np.ndarray] = None     # int32 [nmb, FIELDS]
    levels: Optional[np.ndarray] = None  # int16 [rows, LEVELS]
    scales: Optional[np.ndarray] = None  # int32 [SCALES]
    weights: Optional[np.ndarray] = None  # int32 [slices, WT]


class Parser:
    """The host half: ``native/h264.cpp`` for one track, configured by its
    avcC (``config``; parameter sets may also come in the samples)."""

    def __init__(self, config: bytes = b""):
        from moda_tpu_torch import native

        self._lib = native._load("h264")
        self._h = self._lib.h264_open()
        self.geometry: Optional[Geometry] = None
        if config:
            err = ctypes.create_string_buffer(512)
            if self._lib.h264_config(self._h, config, len(config), err, len(err)):
                raise ValueError(f"the track's decoder configuration (avcC): "
                                 f"{err.value.decode()}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.h264_close(self._h)
            self._h = None

    def parse(self, data: bytes, headers_only: bool = False) -> Optional[Picture]:
        """The sample's picture (None if it holds none), with its arrays
        unless ``headers_only``; ValueError naming what is refused."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        pic = np.zeros(8, np.int32)
        mbs = levels = None
        g = self.geometry
        if not headers_only and g is None:
            g = self._peek_geometry(data)
            if g is None:  # no slice in the sample
                return self.parse(data, headers_only=True)
        if not headers_only:
            nmb = g.mb_w * g.mb_h
            mbs = np.empty((nmb, FIELDS), np.int32)
            levels = np.empty((nmb, LEVELS), np.int16)
        err = ctypes.create_string_buffer(512)
        rows = self._lib.h264_parse(
            self._h, data, len(data), int(headers_only), pic.ctypes.data_as(i32p),
            None if mbs is None else mbs.ctypes.data_as(i32p), 0 if mbs is None else len(mbs),
            None if levels is None else levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            0 if levels is None else len(levels), err, len(err))
        if rows < 0:
            raise ValueError(err.value.decode())
        self._update_geometry()
        if pic[0] < 0:
            return None
        scales = weights = None
        if mbs is not None:
            scales = np.empty(SCALES, np.int32)
            self._lib.h264_scales(self._h, scales.ctypes.data_as(i32p))
            weights = np.empty((int(pic[5]), WT), np.int32)
            self._lib.h264_weights(self._h, weights.ctypes.data_as(i32p))
        return Picture(int(pic[0]), bool(pic[1]), int(pic[2]), int(pic[3]), bool(pic[4]),
                       int(pic[5]), int(pic[6]), int(pic[7]), mbs,
                       None if levels is None else levels[:rows], scales, weights)

    def set_delay(self, delay: int) -> None:
        """The reorder delay to start from (before the first picture)."""
        self._lib.h264_set_delay(self._h, int(delay))

    def flush(self) -> list:
        """The end of the stream: the slots of the pictures still waiting
        for output, in output order."""
        out = np.zeros(MAX_SLOTS, np.int32)
        n = self._lib.h264_flush(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 len(out))
        return out[:n].tolist()

    def _peek_geometry(self, data: bytes) -> Optional[Geometry]:
        """The geometry before the first picture, from the SPS its first
        slice names (in the avcC or in this sample); None without a slice."""
        info = np.zeros(8, np.int32)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.h264_peek(self._h, data, len(data),
                                 info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, len(err))
        if rc < 0:
            raise ValueError(err.value.decode())
        return None if rc > 0 else Geometry(*map(int, info))

    def _update_geometry(self):
        info = np.zeros(8, np.int32)
        if not self._lib.h264_info(self._h, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))):
            self.geometry = Geometry(*map(int, info))


def cabac_tables() -> dict:
    """CABAC's tables as native/h264.cpp decodes with them: "init" int8
    [4, 460, 2] (m, n of context indices 0-459 under the I table, then the P
    tables of cabac_init_idc 0-2), "range_lps" uint8 [64, 4] (rangeTabLPS by
    pStateIdx and qCodIRangeIdx), "trans_lps" and "trans_mps" uint8 [64]."""
    from moda_tpu_torch import native

    init = np.zeros((4, 460, 2), np.int8)
    lps = np.zeros((64, 4), np.uint8)
    trans = np.zeros((2, 64), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    native._load("h264").h264_cabac_tables(init.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                                           lps.ctypes.data_as(u8p), trans.ctypes.data_as(u8p))
    return {"init": init, "range_lps": lps, "trans_lps": trans[0], "trans_mps": trans[1]}


def high_tables() -> dict:
    """High profile's tables as native/h264.cpp decodes with them: "zigzag8"
    [64] (8x8 scan index -> raster position), "sig8" and "last8" [63]
    (CABAC's 8x8 ctxIdxInc of significant_coeff_flag, frame coded, and of
    last_significant_coeff_flag, by scan position), "default4" [2, 16] and
    "default8" [2, 64] (Default_4x4/8x8_Intra, _Inter, raster), "norm4" [6,
    3] and "norm8" [6, 6] (normAdjust's v by qP % 6), all uint8."""
    from moda_tpu_torch import native

    t = {"zigzag8": np.zeros(64, np.uint8), "ctx8": np.zeros(126, np.uint8),
         "default4": np.zeros((2, 16), np.uint8), "default8": np.zeros((2, 64), np.uint8),
         "norm4": np.zeros((6, 3), np.uint8), "norm8": np.zeros((6, 6), np.uint8)}
    native._load("h264").h264_high_tables(
        *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for a in t.values()))
    ctx8 = t.pop("ctx8")
    return {**t, "sig8": ctx8[:63], "last8": ctx8[63:]}


# ---------------------------------------------------------- plain versions
# They index only through index_select, gather and scatter_: on the CPU,
# PyTorch's general advanced indexing costs milliseconds a call.
# luma4x4BlkIdx of each 4x4 block (x, y), raster over the macroblock
BLK_AT = [[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13], [10, 11, 14, 15]]
# the 4x4 block of each luma sample (raster) and of each chroma sample
LUMA_BLK = [BLK_AT[p // 64][(p % 16) // 4] for p in range(256)]
CHROMA_BLK = [BLK_AT[q // 16][(q % 8) // 2] for q in range(64)]


_TABLES = {}


def _tab(values, dev) -> torch.Tensor:
    """``values`` as an int32 tensor on ``dev``, made once."""
    key = (id(values), str(dev))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(values, dtype=torch.int32, device=dev)
    return _TABLES[key]


def _lut(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D table and any index shape."""
    return table.index_select(0, idx.reshape(-1).long()).view(idx.shape)


def _cols(t: torch.Tensor, idx) -> torch.Tensor:
    """t[:, idx] for a 1-D tensor of columns or a module-level list."""
    if not torch.is_tensor(idx):
        idx = _tab(idx, t.device)
    return t.index_select(1, idx.reshape(-1).long()).view(len(t), *idx.shape)


def _get(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[idx] as int32 for a 1-D uint8 tensor."""
    return flat.gather(0, idx.reshape(-1)).view(idx.shape).int()


def _put(flat: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    flat.scatter_(0, idx.reshape(-1), val.reshape(-1).to(flat.dtype))


def _idct4(d: torch.Tensor) -> torch.Tensor:
    """8.5.12.2 on [..., 16] raster coefficients: rows, then columns, then
    (x + 32) >> 6."""
    d = d.view(*d.shape[:-1], 4, 4)
    e0, e1 = d[..., 0] + d[..., 2], d[..., 0] - d[..., 2]
    e2, e3 = (d[..., 1] >> 1) - d[..., 3], d[..., 1] + (d[..., 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    g0, g1 = f[..., 0, :] + f[..., 2, :], f[..., 0, :] - f[..., 2, :]
    g2, g3 = (f[..., 1, :] >> 1) - f[..., 3, :], f[..., 1, :] + (f[..., 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], -2)
    return ((h + 32) >> 6).reshape(*h.shape[:-2], 16)


def _idct8_pass(x: torch.Tensor, dim: int) -> torch.Tensor:
    """8.5.13.2's one-dimensional 8-point transform along ``dim``."""
    d = x.unbind(dim)
    a0, a4 = d[0] + d[4], d[0] - d[4]
    a2, a6 = (d[2] >> 1) - d[6], d[2] + (d[6] >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    a3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    a5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    a7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7],
                       dim)


def _idct8(d: torch.Tensor) -> torch.Tensor:
    """8.5.13.2 on [..., 64] raster coefficients: rows, then columns, then
    (x + 32) >> 6."""
    h = _idct8_pass(_idct8_pass(d.view(*d.shape[:-1], 8, 8), -1), -2)
    return ((h + 32) >> 6).reshape(*d.shape)


def _hadamard4(x: torch.Tensor, dim: int) -> torch.Tensor:
    a, b, c, d = x.unbind(dim)
    return torch.stack([a + b + c + d, a + b - c - d, a - b - c + d, a - b + c - d], dim)


def _pixel_gather() -> list:
    """For each of a macroblock's 384 samples (16x16 luma, 8x8 Cb, 8x8 Cr in
    raster order) its index in the [24 blocks x 16] residual."""
    idx = [16 * LUMA_BLK[p] + 4 * ((p // 16) & 3) + (p & 3) for p in range(256)]
    for c in range(2):
        for y in range(8):
            for x in range(8):
                idx.append(16 * (16 + 4 * c + 2 * (y >> 2) + (x >> 2)) + 4 * (y & 3) + (x & 3))
    return idx


PIXEL_GATHER = _pixel_gather()
# each luma sample's index in the [4 blocks x 64] residual of the 8x8 transform
PIXEL8_GATHER = [64 * (2 * (p // 128) + (p % 16) // 8) + 8 * ((p // 16) & 7) + (p & 7)
                 for p in range(256)]
DC_ORDER = [4 * y + x for x, y in zip(BLK_X, BLK_Y)]  # each block's Intra16x16 DC


def qp_chroma(qp: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return _lut(_tab(CHROMA_QP, qp.device), (qp + offset).clamp(0, 51))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx.long())


def _dequant(c: torch.Tensor, ls: torch.Tensor, q6: torch.Tensor, bits: int) -> torch.Tensor:
    """8.5.12.1 (``bits`` 4) and 8.5.13.1 (``bits`` 6): levels ``c`` times
    their LevelScale ``ls``, scaled by 2^(qP / 6 - bits) with rounding below
    it; ``q6`` broadcast against them."""
    x = c * ls
    up = (q6 - bits).clamp(min=0)
    down = (bits - q6).clamp(min=0)
    return torch.where(q6 >= bits, x << up, (x + ((1 << down) >> 1)) >> down)


def luma_dc_scale(f: torch.Tensor, ls: torch.Tensor, q6: torch.Tensor) -> torch.Tensor:
    """The Intra16x16 DC ``f`` (after the Hadamard) scaled by LevelScale4x4
    ``ls`` of the Intra Y list at (0, 0), as cv2's libavcodec computes it:
    its x86 h264_luma_dc_dequant_idct multiplies by qmul = ls << (qP / 6 +
    2) in 16 bits, (f qmul + 128) >> 8, and a qmul above 32767 by qmul >> 7,
    (f (qmul >> 7) + 1) >> 1. That is 8.5.10 exactly but where a scaling
    list makes qmul exceed 32767 with low bits set (qP below 30)."""
    qmul = ls << (q6 + 2)
    return torch.where(qmul <= 32767, (f * qmul + 128) >> 8, (f * (qmul >> 7) + 1) >> 1)


def residual_plain(rec: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The residual of macroblocks ``rec`` (int32 [n, FIELDS]): int32 [n,
    384] (16x16 luma, 8x8 Cb, 8x8 Cr, raster): dequantisation by the
    picture's LevelScale tables ``scales`` (int32 [SCALES]; intra lists for
    intra macroblocks, inter ones for P macroblocks), the Intra16x16 DC
    Hadamard (``luma_dc_scale``) and the chroma DC 2x2 transform, the 4x4
    inverse transform, or for luma with F_T8 the 8x8 one. An I_PCM
    macroblock's is meaningless."""
    dev, n = rec.device, len(rec)
    row = rec[:, F_ROW]
    if len(levels):
        L = _rows(levels, row.clamp(min=0)).int() * (row >= 0).int()[:, None]
    else:
        L = torch.zeros((n, LEVELS), dtype=torch.int32, device=dev)
    qp = rec[:, F_QP]
    inter = (rec[:, F_KIND] >= K_P).long()
    ls4 = scales[:S_8X8].view(36, 16)        # [6 list + qP % 6, raster]
    at4 = lambda lst, q: _rows(ls4, 6 * lst + q % 6)
    q6 = (qp // 6)[:, None]
    d = _dequant(L[:, :256].reshape(n, 16, 16), at4(3 * inter, qp)[:, None], q6[:, :, None], 4)
    # Intra16x16: the DC of each block from the Hadamard of its levels
    # (8.5.10), scaled as FFmpeg's x86 luma_dc_dequant_idct scales it
    f = _hadamard4(_hadamard4(L[:, L_DC:L_DC + 16].reshape(n, 4, 4), 1), 2).reshape(n, 16)
    dc = _cols(luma_dc_scale(f, at4(0, qp)[:, :1], q6), DC_ORDER)
    d[:, :, 0] = torch.where((rec[:, F_KIND] == K_I16)[:, None], dc, d[:, :, 0])
    # chroma: the 2x2 DC transform (8.5.11), then each plane's AC
    blocks = [d]
    for c in range(2):
        qc = qp_chroma(qp, rec[:, F_CQP0 + c])
        lsc = at4(3 * inter + 1 + c, qc)
        a, b, cc, dd = L[:, L_CDC + 4 * c:L_CDC + 4 * c + 4].unbind(1)
        fc = torch.stack([a + b + cc + dd, a - b + cc - dd, a + b - cc - dd, a - b - cc + dd], 1)
        dcc = ((fc * lsc[:, :1]) << (qc // 6)[:, None]) >> 5
        ac = L[:, L_CAC + 64 * c:L_CAC + 64 * c + 64].reshape(n, 4, 16)
        dac = _dequant(ac, lsc[:, None], (qc // 6)[:, None, None], 4)
        dac[:, :, 0] = dcc
        blocks.append(dac)
    r = _idct4(torch.cat(blocks, 1))  # [n, 24, 16]
    out = _cols(r.reshape(n, 384), PIXEL_GATHER)
    t8 = torch.nonzero(rec[:, F_T8])[:, 0]
    if len(t8):  # luma of the 8x8 transform (8.5.13)
        ls8 = scales[S_8X8:].view(12, 64)
        q = _rows(qp, t8)
        c8 = _rows(L, t8)[:, :256].reshape(-1, 4, 64)
        d8 = _dequant(c8, _rows(ls8, 6 * _rows(inter, t8) + q % 6)[:, None],
                      (q // 6)[:, None, None], 6)
        luma = _cols(_idct8(d8).reshape(-1, 256), PIXEL8_GATHER)
        out[:, :256] = out[:, :256].index_copy(0, t8, luma)
    return out


def _clip(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255)


def _bytes16(rec: torch.Tensor, f: int) -> torch.Tensor:
    """The 16 bytes (one a 4x4 block) of fields f..f + 3, [n, 16]."""
    r = rec[:, f:f + 4]
    return torch.stack([(r >> (8 * k)) & 0xFF for k in range(4)], -1).reshape(len(rec), 16)


def _unpack_mv(rec: torch.Tensor, lst: int = 0):
    """(mvx, mvy, slot, ref_idx) [n, 16] of each 4x4 block in list ``lst``
    (slot UNUSED where the block does not use the list)."""
    f = F_MV1 if lst else F_MV
    v = rec[:, f:f + 16]
    mx = ((v & 0xFFFF) ^ 0x8000) - 0x8000
    my = v >> 16
    return (mx, my, _bytes16(rec, F_REF1 if lst else F_REF),
            _bytes16(rec, F_RIDX1 if lst else F_RIDX))


TAPS = (1, -5, 20, 20, -5, 1)


def _tap6(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The 6-tap filter along ``dim``: out[i] = sum_k TAPS[k] x[i + k], for
    i < n."""
    return sum(t * x.narrow(dim, k, n) for k, t in enumerate(TAPS))


def _half_planes(Y: torch.Tensor):
    """The luma reference's intermediates for every position a vector can
    name, as 8.4.2.2.1 forms them from samples clamped to the picture:
    b1 [H, W + 5] (the horizontal 6-tap between x and x + 1 of row y, x in
    -3..W + 1), h1 [H + 5, W] (the vertical one, y in -3..H + 1) and j1
    [H + 5, W + 5] (the vertical 6-tap of b1). Any position past those
    ranges reads only edge samples, so its value is the range's end's."""
    H, W = Y.shape
    y = Y.int()
    gx = torch.cat([y[:, :1].expand(H, 5), y, y[:, -1:].expand(H, 5)], 1)   # x -5..W+4
    gy = torch.cat([y[:1].expand(5, W), y, y[-1:].expand(5, W)], 0)         # y -5..H+4
    b1 = _tap6(gx, 1, W + 5)                                               # x -3..W+1
    h1 = _tap6(gy, 0, H + 5)                                               # y -3..H+1
    b1y = torch.cat([b1[:1].expand(5, W + 5), b1, b1[-1:].expand(5, W + 5)], 0)
    j1 = _tap6(b1y, 0, H + 5)
    return b1, h1, j1


def _inter_pred(dpb: torch.Tensor, mx: torch.Tensor, my: torch.Tensor, slot: torch.Tensor,
                mbi: torch.Tensor, g: Geometry):
    """The prediction of macroblocks ``mbi`` [n] from one list: each 4x4
    block's vector (``mx``, ``my``) and slot [n, 16]: int32 [n, 384]."""
    dev = mx.device
    W, H = 16 * g.mb_w, 16 * g.mb_h
    frames = dpb.view(-1)
    fb = g.frame_bytes
    mbx, mby = (mbi % g.mb_w)[:, None], (mbi // g.mb_w)[:, None]
    # luma: integer samples and the half-sample intermediates of each slot
    p = torch.arange(256, device=dev)
    vx, vy, s = _cols(mx, LUMA_BLK), _cols(my, LUMA_BLK), _cols(slot, LUMA_BLK).long()
    xi = 16 * mbx + p % 16 + (vx >> 2)
    yi = 16 * mby + p // 16 + (vy >> 2)
    used = torch.unique(s)
    planes = [_half_planes(dpb[k, :g.luma].view(H, W)) for k in used.tolist()]
    flat = [torch.stack([pl[i].reshape(-1) for pl in planes]).view(-1) for i in range(3)]
    u = torch.searchsorted(used, s)  # each sample's slot among the used ones
    xc, yc = xi.clamp(0, W - 1), yi.clamp(0, H - 1)
    xc1, yc1 = (xi + 1).clamp(0, W - 1), (yi + 1).clamp(0, H - 1)
    xh, yh = xi.clamp(-3, W + 1) + 3, yi.clamp(-3, H + 1) + 3
    at = lambda yy, xx: _get(frames, s * fb + yy * W + xx)
    G, Hh, Mm = at(yc, xc), at(yc, xc1), at(yc1, xc)
    bsize, hsize, jsize = H * (W + 5), (H + 5) * W, (H + 5) * (W + 5)
    half = lambda i, off: flat[i].gather(0, off.reshape(-1)).view(off.shape)
    b = _clip((half(0, u * bsize + yc * (W + 5) + xh) + 16) >> 5)
    s_ = _clip((half(0, u * bsize + yc1 * (W + 5) + xh) + 16) >> 5)
    h = _clip((half(1, u * hsize + yh * W + xc) + 16) >> 5)
    m = _clip((half(1, u * hsize + yh * W + xc1) + 16) >> 5)
    j = _clip((half(2, u * jsize + yh * (W + 5) + xh) + 512) >> 10)
    cand = torch.stack([
        G, (G + b + 1) >> 1, b, (b + Hh + 1) >> 1,
        (G + h + 1) >> 1, (b + h + 1) >> 1, (b + j + 1) >> 1, (b + m + 1) >> 1,
        h, (h + j + 1) >> 1, j, (j + m + 1) >> 1,
        (h + Mm + 1) >> 1, (h + s_ + 1) >> 1, (j + s_ + 1) >> 1, (m + s_ + 1) >> 1], -1)
    frac = (4 * (vy & 3) + (vx & 3)).long()
    luma = cand.gather(-1, frac[..., None])[..., 0]
    # chroma: the 1/8-sample bilinear of each plane
    q = torch.arange(64, device=dev)
    qx, qy = q % 8, q // 8
    cx, cy, cs = _cols(mx, CHROMA_BLK), _cols(my, CHROMA_BLK), _cols(slot, CHROMA_BLK).long()
    CW, CH = W // 2, H // 2
    x0 = 8 * mbx + qx + (cx >> 3)
    y0 = 8 * mby + qy + (cy >> 3)
    fx, fy = cx & 7, cy & 7
    xa, xb = x0.clamp(0, CW - 1), (x0 + 1).clamp(0, CW - 1)
    ya, yb = y0.clamp(0, CH - 1), (y0 + 1).clamp(0, CH - 1)
    chroma = []
    for c in range(2):
        base = cs * fb + g.luma + c * (g.luma // 4)
        atc = lambda yy, xx: _get(frames, base + yy * CW + xx)
        chroma.append(((8 - fx) * (8 - fy) * atc(ya, xa) + fx * (8 - fy) * atc(ya, xb) +
                       (8 - fx) * fy * atc(yb, xa) + fx * fy * atc(yb, xb) + 32) >> 6)
    return torch.cat([luma] + chroma, 1)


def _mb_offsets(mbi: torch.Tensor, g: Geometry) -> torch.Tensor:
    """Each sample's offset in a frame, [n, 384], for macroblocks ``mbi``."""
    dev = mbi.device
    W = 16 * g.mb_w
    mbx, mby = (mbi % g.mb_w)[:, None], (mbi // g.mb_w)[:, None]
    p = torch.arange(256, device=dev)
    luma = (16 * mby + p // 16) * W + 16 * mbx + p % 16
    q = torch.arange(64, device=dev)
    ch = (8 * mby + q // 8) * (W // 2) + 8 * mbx + q % 8
    return torch.cat([luma, g.luma + ch, g.luma + g.luma // 4 + ch], 1)


# each sample's 4x4 block (luma, Cb, Cr) and plane (0 Y, 1 Cb, 2 Cr)
SAMPLE_BLK = LUMA_BLK + CHROMA_BLK * 2
SAMPLE_COMP = [0] * 256 + [1] * 64 + [2] * 64


def weighted(p0: torch.Tensor, p1: torch.Tensor, use0: torch.Tensor, use1: torch.Tensor,
             r0: torch.Tensor, r1: torch.Tensor, comp: torch.Tensor,
             wt: torch.Tensor) -> torch.Tensor:
    """8.4.2.3's weighted sample prediction of samples [n, m] from their
    list 0 and list 1 predictions ``p0``, ``p1`` (where ``use0``/``use1``),
    ref_idx ``r0``, ``r1``, plane ``comp`` (0 Y, 1 Cb, 2 Cr) and their
    slice's weight table ``wt`` [n, WT] (W_*), in integers: the default
    (a + b + 1) >> 1; explicit and implicit bi-prediction ((a w0 + b w1 +
    2^logWD) >> (logWD + 1)) + ((o0 + o1 + 1) >> 1); explicit one-list
    ((a w + 2^(logWD - 1)) >> logWD) + o (a w + o at logWD 0); each
    clipped. A one-list block is not weighted in the default and implicit
    modes."""
    r0, r1 = r0 & 31, r1 & 31
    at = lambda idx: wt.gather(1, idx.long())
    mode = wt[:, W_MODE:W_MODE + 1]
    lw = at(W_LOGWD + (comp > 0).int().expand_as(r0))
    ex = lambda lst, r, k: at(W_EXPLICIT + ((32 * lst + r) * 3 + comp) * 2 + k)
    w0, o0, w1, o1 = ex(0, r0, 0), ex(0, r0, 1), ex(1, r1, 0), ex(1, r1, 1)
    one = torch.ones_like(lw)
    ebi = ((p0 * w0 + p1 * w1 + (one << lw)) >> (lw + 1)) + ((o0 + o1 + 1) >> 1)
    iw0 = at(W_IMPLICIT + 32 * r0 + r1)
    ibi = (p0 * iw0 + p1 * (64 - iw0) + 32) >> 6
    bi = torch.where(mode == 0, (p0 + p1 + 1) >> 1, torch.where(mode == 1, ebi, ibi))
    pu = torch.where(use0, p0, p1)
    wu, ou = torch.where(use0, w0, w1), torch.where(use0, o0, o1)
    eu = torch.where(lw > 0, ((pu * wu + (one << (lw - 1).clamp(min=0))) >> lw) + ou,
                     pu * wu + ou)
    uni = torch.where(mode == 1, eu, pu)
    return _clip(torch.where(use0 & use1, bi, uni))


def inter_plain(dpb: torch.Tensor, slot: int, mbs: torch.Tensor, levels: torch.Tensor,
                scales: torch.Tensor, weights: torch.Tensor, inter: torch.Tensor,
                g: Geometry) -> None:
    """What ``h264_inter`` computes, in PyTorch: the P, B and skipped
    macroblocks ``inter`` (int64 indices) of the picture in ``dpb[slot]``,
    each 4x4 block predicted from the slots its record names in one or both
    lists, combined by ``weighted`` under its slice's table of ``weights``
    [slices, WT], plus the residual, clipped."""
    for k in range(0, len(inter), INTER_CHUNK):  # the 6x6 windows of a chunk at a time
        mbi = inter[k:k + INTER_CHUNK].long()
        rec = _rows(mbs, mbi)
        mx0, my0, s0, r0 = _unpack_mv(rec, 0)
        mx1, my1, s1, r1 = _unpack_mv(rec, 1)
        u0, u1 = s0 != UNUSED, s1 != UNUSED
        wt = _rows(weights, rec[:, F_SLICE])
        if bool(u1.any()):
            # both lists in one call (the half-sample planes once a slot); a
            # list's unused blocks read the other list's slot (masked below)
            both = _inter_pred(dpb, torch.cat([mx0, mx1]), torch.cat([my0, my1]),
                               torch.cat([torch.where(u0, s0, s1), torch.where(u1, s1, s0)]),
                               torch.cat([mbi, mbi]), g)
            p0, p1 = both[:len(mbi)], both[len(mbi):]
        else:  # list 0 alone (P macroblocks)
            p0 = p1 = _inter_pred(dpb, mx0, my0, s0, mbi, g)
        pred = p0
        if bool(u1.any()) or bool((wt[:, W_MODE] == 1).any()):
            pick = lambda t: _cols(t, SAMPLE_BLK)
            pred = weighted(p0, p1, pick(u0), pick(u1), pick(r0), pick(r1),
                            _tab(SAMPLE_COMP, rec.device)[None], wt)
        out = _clip(pred + residual_plain(rec, levels, scales))
        _put(dpb[slot], _mb_offsets(mbi, g), out)


def _intra_avail(rec: torch.Tensor):
    """Whether the left, top, top-right and top-left macroblocks are
    available to intra prediction (Intra4x4's use of the corner is checked
    by the parse; Intra8x8's filter reads it where it is available)."""
    a = rec[:, F_AVAIL]
    return (a & 1) > 0, (a & 2) > 0, (a & 4) > 0, (a & 8) > 0


def _dc(top, left, ta, la, n4: int):
    """DC of ``n4`` samples on each side: both, one, or 128."""
    sh = n4.bit_length()  # log2(2 n4) for both sides
    both = (top.sum(-1) + left.sum(-1) + n4) >> sh
    lo = (left.sum(-1) + n4 // 2) >> (sh - 1)
    to = (top.sum(-1) + n4 // 2) >> (sh - 1)
    return torch.where(ta & la, both, torch.where(la, lo, torch.where(ta, to, 128)))


def _intra_terms(mode: int, x: int, y: int, n: int):
    """Intra4x4 (``n`` 4, 8.3.1.2.1-9) or Intra8x8 (``n`` 8, 8.3.2.2.2-10)
    mode ``mode``'s sample (x, y) as ({sample: weight}, rounding, shift)
    over the 3n + 1 neighbours: 0 the corner p[-1, -1], 1 + i the row above
    p[i, -1] (i < 2n), 1 + 2n + i the left column p[-1, i]. DC (mode 2)
    depends on availability and is formed apart."""
    P = lambda i: 0 if i < 0 else 1 + i
    Q = lambda i: 0 if i < 0 else 1 + 2 * n + i

    def f(*terms, add=0, sh=0):
        out = {}
        for w, k in terms:
            out[k] = out.get(k, 0) + w
        return out, add, sh

    three = lambda a, b_, c: f((1, a), (2, b_), (1, c), add=2, sh=2)
    two = lambda a, b_: f((1, a), (1, b_), add=1, sh=1)
    if mode == 0:
        return f((1, P(x)))
    if mode == 1:
        return f((1, Q(y)))
    if mode == 2:
        return f()
    if mode == 3:
        if x == n - 1 and y == n - 1:
            return f((1, P(2 * n - 2)), (3, P(2 * n - 1)), add=2, sh=2)
        return three(P(x + y), P(x + y + 1), P(x + y + 2))
    if mode == 4:
        if x > y:
            return three(P(x - y - 2), P(x - y - 1), P(x - y))
        if x < y:
            return three(Q(y - x - 2), Q(y - x - 1), Q(y - x))
        return three(P(0), 0, Q(0))
    if mode == 5:
        z, hy = 2 * x - y, y >> 1
        if z >= 0 and z % 2 == 0:
            return two(P(x - hy - 1), P(x - hy))
        if z > 0:
            return three(P(x - hy - 2), P(x - hy - 1), P(x - hy))
        if z == -1:
            return three(Q(0), 0, P(0))
        return three(Q(y - 2 * x - 1), Q(y - 2 * x - 2), Q(y - 2 * x - 3))
    if mode == 6:
        z, hx = 2 * y - x, x >> 1
        if z >= 0 and z % 2 == 0:
            return two(Q(y - hx - 1), Q(y - hx))
        if z > 0:
            return three(Q(y - hx - 2), Q(y - hx - 1), Q(y - hx))
        if z == -1:
            return three(Q(0), 0, P(0))
        return three(P(x - 2 * y - 1), P(x - 2 * y - 2), P(x - 2 * y - 3))
    if mode == 7:
        hy = y >> 1
        if y % 2 == 0:
            return two(P(x + hy), P(x + hy + 1))
        return three(P(x + hy), P(x + hy + 1), P(x + hy + 2))
    z, hx = x + 2 * y, x >> 1
    if z < 2 * n - 3 and z % 2 == 0:
        return two(Q(y + hx), Q(y + hx + 1))
    if z < 2 * n - 3:
        return three(Q(y + hx), Q(y + hx + 1), Q(y + hx + 2))
    if z == 2 * n - 3:
        return f((1, Q(n - 2)), (3, Q(n - 1)), add=2, sh=2)
    return f((1, Q(n - 1)))


def _mode_tables(n: int):
    """[9, n * n, 3n + 1] weights, [9, n * n] roundings and shifts."""
    w = [[[0] * (3 * n + 1) for _ in range(n * n)] for _ in range(9)]
    add = [[0] * (n * n) for _ in range(9)]
    sh = [[0] * (n * n) for _ in range(9)]
    for m in range(9):
        for k in range(n * n):
            terms, add[m][k], sh[m][k] = _intra_terms(m, k % n, k // n, n)
            for i, v in terms.items():
                w[m][k][i] = v
    return w, add, sh


MODE4_W, MODE4_ADD, MODE4_SHIFT = _mode_tables(4)  # [9, 16, 13], [9, 16], [9, 16]
MODE8_W, MODE8_ADD, MODE8_SHIFT = _mode_tables(8)  # [9, 64, 25], [9, 64], [9, 64]


def _pred_nxn(t: torch.Tensor, l: torch.Tensor, tl: torch.Tensor, ta, la, mode: torch.Tensor):
    """Intra4x4 (8.3.1.2) or Intra8x8 (8.3.2.2, from filtered samples)
    prediction of [m] n x n blocks: ``t`` [m, 2n] the row above (the
    top-right already substituted), ``l`` [m, n] the column on the left,
    ``tl`` [m] the corner; [m, n * n] raster."""
    dev, m, n = t.device, len(mode), l.shape[1]
    tabs = (MODE4_W, MODE4_ADD, MODE4_SHIFT) if n == 4 else (MODE8_W, MODE8_ADD, MODE8_SHIFT)
    nbr = torch.cat([tl[:, None], t, l], 1)  # [m, 3n + 1]
    md = mode.long()
    w, add, sh = (_tab(v, dev).index_select(0, md) for v in tabs)
    pred = ((w * nbr[:, None, :]).sum(-1) + add) >> sh
    dc = _dc(t[:, :n], l, ta, la, n)[:, None].expand(m, n * n)
    return torch.where((mode == 2)[:, None], dc, pred)


def _filter8(t, l, tl, ta, la, tla):
    """8.3.2.2.1: Intra8x8's reference samples filtered: ``t`` [m, 16] (the
    top-right substituted), ``l`` [m, 8], ``tl`` [m], each read only where
    available (``ta``, ``la``, ``tla``)."""
    smooth = lambda v: (v[:, :-2] + 2 * v[:, 1:-1] + v[:, 2:] + 2) >> 2
    t0 = torch.where(tla, (tl + 2 * t[:, 0] + t[:, 1] + 2) >> 2, (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    tf = torch.cat([t0[:, None], smooth(t), ((t[:, 14] + 3 * t[:, 15] + 2) >> 2)[:, None]], 1)
    l0 = torch.where(tla, (tl + 2 * l[:, 0] + l[:, 1] + 2) >> 2, (3 * l[:, 0] + l[:, 1] + 2) >> 2)
    lf = torch.cat([l0[:, None], smooth(l), ((l[:, 6] + 3 * l[:, 7] + 2) >> 2)[:, None]], 1)
    cf = torch.where(ta & la, (t[:, 0] + 2 * tl + l[:, 0] + 2) >> 2,
                     torch.where(ta, (3 * tl + t[:, 0] + 2) >> 2,
                                 torch.where(la, (3 * tl + l[:, 0] + 2) >> 2, tl)))
    return tf, lf, cf


def _plane(t, l, tl, n: int, k: int):
    """Plane prediction of an n x n block (16: luma, k 5; 8: chroma, k 34)."""
    half = n // 2
    dev = t.device
    i = torch.arange(half, device=dev)
    T = torch.cat([tl[:, None], t], 1)   # p[x, -1] at x + 1
    Lf = torch.cat([tl[:, None], l], 1)
    hi, lo = half + 1 + i, half - 1 - i
    Hs = ((i + 1) * (_cols(T, hi) - _cols(T, lo))).sum(-1)
    Vs = ((i + 1) * (_cols(Lf, hi) - _cols(Lf, lo))).sum(-1)
    a = 16 * (l[:, n - 1] + t[:, n - 1])
    b = (k * Hs + 32) >> 6
    c = (k * Vs + 32) >> 6
    x = torch.arange(n, device=dev)
    p = (a[:, None, None] + b[:, None, None] * (x[None, None, :] - (half - 1)) +
         c[:, None, None] * (x[None, :, None] - (half - 1)) + 16) >> 5
    return _clip(p).reshape(len(t), n * n)


def _pred16(t, l, tl, ta, la, mode):
    n = len(mode)
    v = t[:, None, :].expand(n, 16, 16).reshape(n, 256)
    h = l[:, :, None].expand(n, 16, 16).reshape(n, 256)
    dc = _dc(t, l, ta, la, 16)[:, None].expand(n, 256)
    cand = torch.stack([v, h, dc, _plane(t, l, tl, 16, 5)], -1)
    return cand.gather(-1, mode.long()[:, None, None].expand(n, 256, 1))[..., 0]


def _pred_chroma(t, l, tl, ta, la, mode):
    n = len(mode)
    v = t[:, None, :].expand(n, 8, 8).reshape(n, 64)
    h = l[:, :, None].expand(n, 8, 8).reshape(n, 64)
    quads = []
    for by in range(2):
        for bx in range(2):
            tt, ll = t[:, 4 * bx:4 * bx + 4], l[:, 4 * by:4 * by + 4]
            both = (tt.sum(-1) + ll.sum(-1) + 4) >> 3
            to, lo = (tt.sum(-1) + 2) >> 2, (ll.sum(-1) + 2) >> 2
            if bx == by:
                val = torch.where(ta & la, both, torch.where(la, lo, torch.where(ta, to, 128)))
            elif bx:
                val = torch.where(ta, to, torch.where(la, lo, 128))
            else:
                val = torch.where(la, lo, torch.where(ta, to, 128))
            quads.append(val)
    dc = torch.stack(quads, 1).view(n, 2, 1, 2, 1).expand(n, 2, 4, 2, 4).reshape(n, 64)
    cand = torch.stack([dc, h, v, _plane(t, l, tl, 8, 34)], -1)
    return cand.gather(-1, mode.long()[:, None, None].expand(n, 64, 1))[..., 0]


# Intra4x4's top-right 4x4 block inside the macroblock: decoded (1), not (0),
# or the macroblock above (2) / above-right (3); Intra8x8's of each 8x8 block
TOP_RIGHT = [2, 2, 1, 0, 2, 3, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0]
TOP_RIGHT8 = [2, 3, 1, 0]
# Intra8x8's corner p[-1, -1]: in macroblock D (4), B (2), A (5), or decoded (1)
CORNER8 = [4, 2, 5, 1]


def _wavefronts(select: np.ndarray, mb_w: int):
    """(order, offsets): the selected macroblocks grouped by wavefront x + 2y,
    for the kernels' launches (one a non-empty wavefront)."""
    idx = np.nonzero(select)[0].astype(np.int32)
    wave = idx % mb_w + 2 * (idx // mb_w)
    order = idx[np.argsort(wave, kind="stable")]
    nwaves = mb_w + 2 * (len(select) // mb_w - 1)
    counts = np.bincount(wave, minlength=nwaves)
    return order, np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _edges(g: Geometry, mx: torch.Tensor, my: torch.Tensor, c: int, n: int):
    """Offsets in a frame of the n x n block of plane c (0 Y, 1 U, 2 V) at
    block (mx, my): the row above [m, n], the column on the left [m, n], the
    corner [m] (clamped into the plane) and the block [m, n * n]."""
    w = 16 * g.mb_w if c == 0 else 8 * g.mb_w
    base = 0 if c == 0 else g.luma + (c - 1) * (g.luma // 4)
    x0, y0 = n * mx, n * my
    k = torch.arange(n, device=mx.device)
    yt, xl = (y0 - 1).clamp(min=0), (x0 - 1).clamp(min=0)
    top = base + yt[:, None] * w + (x0[:, None] + k)
    left = base + (y0[:, None] + k) * w + xl[:, None]
    q = torch.arange(n * n, device=mx.device)
    block = base + (y0[:, None] + q // n) * w + x0[:, None] + q % n
    return top, left, base + yt * w + xl, block


def intra_plain(frame: torch.Tensor, mbs: torch.Tensor, levels: torch.Tensor,
                scales: torch.Tensor, order: torch.Tensor, offsets: np.ndarray,
                g: Geometry) -> None:
    """What ``h264_intra`` computes, in PyTorch: the intra macroblocks of the
    padded ``frame``, wavefront by wavefront (``order``/``offsets`` from
    ``plan``): I_PCM samples, Intra16x16 and chroma prediction, and Intra4x4
    and Intra8x8 block by block, each plus its residual, clipped."""
    W = 16 * g.mb_w
    for w in range(len(offsets) - 1):
        if offsets[w + 1] == offsets[w]:
            continue
        mbi_all = order[offsets[w]:offsets[w + 1]].long()
        kind_all = _rows(mbs, mbi_all)[:, F_KIND]
        pcm = torch.nonzero(kind_all == K_PCM)[:, 0]
        if len(pcm):
            rows = _rows(mbs, mbi_all.index_select(0, pcm))[:, F_ROW]
            _put(frame, _mb_offsets(mbi_all.index_select(0, pcm), g),
                 _rows(levels, rows)[:, :384].int())
        keep = torch.nonzero(kind_all != K_PCM)[:, 0]
        if not len(keep):
            continue
        mbi = mbi_all.index_select(0, keep)
        rec = _rows(mbs, mbi)
        kind = rec[:, F_KIND]
        res = residual_plain(rec, levels, scales)
        mx, my = mbi % g.mb_w, mbi // g.mb_w
        A, B, C, D = _intra_avail(rec)
        for c in (1, 2):  # chroma
            top, left, corner, block = _edges(g, mx, my, c, 8)
            pred = _pred_chroma(_get(frame, top), _get(frame, left), _get(frame, corner), B, A,
                                rec[:, F_MC])
            _put(frame, block, _clip(pred + res[:, 256 + 64 * (c - 1):320 + 64 * (c - 1)]))
        i16 = torch.nonzero(kind == K_I16)[:, 0]
        if len(i16):
            top, left, corner, block = _edges(g, mx.index_select(0, i16),
                                              my.index_select(0, i16), 0, 16)
            pred = _pred16(_get(frame, top), _get(frame, left), _get(frame, corner),
                           B.index_select(0, i16), A.index_select(0, i16),
                           rec[:, F_M16].index_select(0, i16))
            _put(frame, block, _clip(pred + _rows(res, i16)[:, :256]))
        for kk, n in ((K_I4, 4), (K_I8, 8)):
            sel = torch.nonzero(kind == kk)[:, 0]
            if len(sel):
                _intra_nxn(frame, _rows(rec, sel), _rows(res, sel)[:, :256],
                           *(v.index_select(0, sel) for v in (mx, my, A, B, C, D)), n, W)


def _intra_nxn(frame, rec, res, mx, my, A, B, C, D, n: int, W: int) -> None:
    """Intra4x4 (``n`` 4) or Intra8x8 (``n`` 8) macroblocks of a wavefront,
    block by block in decoding order, each block predicted from the samples
    the earlier ones wrote and its residual added: ``res`` their luma
    residual [m, 256] (raster), ``A``-``D`` the neighbours' availability."""
    dev = frame.device
    modes = torch.stack([(rec[:, F_MODES + (b >> 3)] >> (4 * (b & 7))) & 15
                         for b in range(16)], 1)
    k1, k2, q = (torch.arange(v, device=dev) for v in (n, 2 * n, n * n))
    res = res.reshape(-1, 16, 16)
    true = torch.ones_like(A)
    for blk in range(16 // (n * n // 16)):  # block by block in decoding order
        if n == 4:
            bx, by, tr = BLK_X[blk], BLK_Y[blk], TOP_RIGHT[blk]
        else:
            bx, by, tr = 2 * (blk & 1), 2 * (blk >> 1), TOP_RIGHT8[blk]
        x0, y0 = 16 * mx + 4 * bx, 16 * my + 4 * by
        la = A if bx == 0 else true
        ta = B if by == 0 else true
        tra = B if tr == 2 else C if tr == 3 else torch.full_like(A, bool(tr))
        yt, xl = (y0 - 1).clamp(min=0), (x0 - 1).clamp(min=0)
        t = _get(frame, yt[:, None] * W + (x0[:, None] + k2).clamp(max=W - 1))
        t = torch.where(tra[:, None] | (k2 < n), t, t[:, n - 1:n])
        lft = _get(frame, (y0[:, None] + k1) * W + xl[:, None])
        tl = _get(frame, yt * W + xl)
        mode = modes[:, blk * (n * n // 16)]
        if n == 8:
            # the corner's availability is needed by the filter alone
            c8 = CORNER8[blk]
            tla = D if c8 == 4 else B if c8 == 2 else A if c8 == 5 else true
            t, lft, tl = _filter8(t, lft, tl, ta, la, tla)
        # an Intra4x4 mode that reads the corner where it is not available
        # was refused by the parse
        pred = _pred_nxn(t, lft, tl, ta, la, mode)
        out = _clip(pred + res[:, 4 * by:4 * by + n, 4 * bx:4 * bx + n].reshape(-1, n * n))
        _put(frame, (y0[:, None] + q // n) * W + x0[:, None] + q % n, out)


def _filter(p: torch.Tensor, q: torch.Tensor, bs: torch.Tensor, qpav: torch.Tensor,
            off_a: torch.Tensor, off_b: torch.Tensor, luma: torch.Tensor):
    """8.7.2.3/8.7.2.4 on [..., 4] sample lines p (p0, p1, p2, p3 outwards)
    and q (q0..q3), each a luma line where ``luma`` is set, else a chroma
    one: the filtered (p, q)."""
    dev = p.device
    ia = (qpav + off_a).clamp(0, 51)
    ib = (qpav + off_b).clamp(0, 51)
    alpha, beta = _lut(_tab(ALPHA, dev), ia), _lut(_tab(BETA, dev), ib)
    tc0 = _lut(_tab(TC0, dev).view(-1), 3 * ia + (bs - 1).clamp(0, 2))
    p0, p1, p2, p3 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    on = (bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta) & \
        ((q1 - q0).abs() < beta)
    ap, aq = (p2 - p0).abs() < beta, (q2 - q0).abs() < beta
    apl, aql = ap & luma, aq & luma
    # bS < 4
    tc = tc0 + torch.where(luma, apl.int() + aql.int(), 1)
    delta = torch.maximum(torch.minimum((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc), -tc)
    np0, nq0 = _clip(p0 + delta), _clip(q0 - delta)
    avg = (p0 + q0 + 1) >> 1
    np1 = torch.where(apl, p1 + torch.maximum(torch.minimum(
        (p2 + avg - (p1 << 1)) >> 1, tc0), -tc0), p1)
    nq1 = torch.where(aql, q1 + torch.maximum(torch.minimum(
        (q2 + avg - (q1 << 1)) >> 1, tc0), -tc0), q1)
    # bS 4 (chroma: the weak form alone)
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp, sq = apl & strong, aql & strong
    s_p0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s_p1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s_p2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    s_q0 = torch.where(sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s_q1 = torch.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, q1)
    s_q2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    four = bs == 4
    newp = torch.stack([torch.where(four, s_p0, np0), torch.where(four, s_p1, np1),
                        torch.where(four, s_p2, p2), p3], -1)
    newq = torch.stack([torch.where(four, s_q0, nq0), torch.where(four, s_q1, nq1),
                        torch.where(four, s_q2, q2), q3], -1)
    return torch.where(on[..., None], newp, p), torch.where(on[..., None], newq, q)


def _edge_lines(g: Geometry, dev):
    """The sample lines of one macroblock edge, luma then Cb then Cr: for
    each of the 32 lines its plane's offset, row stride and line size, its
    index along the edge, and whether it is luma."""
    base = [0] * 16 + [g.luma] * 8 + [g.luma + g.luma // 4] * 8
    stride = [16 * g.mb_w] * 16 + [8 * g.mb_w] * 16
    size = [16] * 16 + [8] * 16
    line = list(range(16)) + list(range(8)) * 2
    t = lambda v: torch.tensor(v, device=dev)
    return t(base), t(stride), t(size), t(line), t([True] * 16 + [False] * 16)


def deblock_plain(frame: torch.Tensor, mbs: torch.Tensor, order: torch.Tensor,
                  offsets: np.ndarray, g: Geometry) -> None:
    """What ``h264_deblock`` computes, in PyTorch: the loop filter of the
    padded ``frame`` over the macroblocks ``order`` (those with an edge to
    filter) wavefront by wavefront, each macroblock's vertical edges left to
    right and then its horizontal edges top to bottom, luma and chroma
    lines of an edge in one step (chroma on edges 0 and 2). The lines of a
    step never share a sample, so each step writes its lines back whole."""
    dev = frame.device
    qp_all = mbs[:, F_QP]
    base, stride, size, line, is_luma = _edge_lines(g, dev)
    seg = torch.where(is_luma, line >> 2, line >> 1)
    k = torch.arange(8, device=dev) - 4  # p3..p0 q0..q3 at -4..3
    for w in range(len(offsets) - 1):
        if offsets[w + 1] == offsets[w]:
            continue
        mbi = order[offsets[w]:offsets[w + 1]].long()
        rec = _rows(mbs, mbi)
        n = len(mbi)
        mx, my = (mbi % g.mb_w)[:, None], (mbi // g.mb_w)[:, None]
        bs_all = torch.stack([(rec[:, F_BS:F_BS + 8] >> (8 * j)) & 0xFF for j in range(4)],
                             -1).view(-1, 2, 4, 4)  # [n, dir, edge, segment]
        qq = rec[:, F_QP, None]
        cqp = torch.cat([torch.zeros_like(rec[:, :1]).expand(n, 16),
                         rec[:, F_CQP0, None].expand(n, 8), rec[:, F_CQP1, None].expand(n, 8)], 1)
        for d in range(2):
            nb = torch.where(mx > 0, mbi[:, None] - 1, mbi[:, None]) if d == 0 else \
                torch.where(my > 0, mbi[:, None] - g.mb_w, mbi[:, None])
            qpn = _lut(qp_all, nb)
            for e in range(4):
                nl = 16 if e % 2 else 32  # chroma edges at luma edges 0 and 2 alone
                qp_p = qpn if e == 0 else qq
                qpa = torch.where(is_luma[:nl], (qp_p + qq + 1) >> 1,
                                  (qp_chroma(qp_p.expand(n, nl), cqp[:, :nl]) +
                                   qp_chroma(qq.expand(n, nl), cqp[:, :nl]) + 1) >> 1)
                bs = _cols(bs_all[:, d, e, :], seg[:nl])
                sz, ln = size[:nl], line[:nl]
                along = sz * (mx if d == 0 else my) + torch.where(is_luma[:nl], 4 * e, 2 * e)
                across = sz * (my if d == 0 else mx) + ln
                a_ = along[..., None] + k                     # [n, nl, 8]
                extent = (sz * (g.mb_w if d == 0 else g.mb_h))[:, None]
                a_ = torch.minimum(a_.clamp(min=0), extent - 1)
                c_ = across[..., None].expand_as(a_)
                st = stride[:nl, None]
                idx = base[:nl, None] + (c_ * st + a_ if d == 0 else a_ * st + c_)
                smp = _get(frame, idx)
                np_, nq_ = _filter(smp[..., :4].flip(-1), smp[..., 4:], bs, qpa,
                                   rec[:, F_ALPHA, None], rec[:, F_BETA, None], is_luma[:nl])
                _put(frame, idx, torch.cat([np_.flip(-1), nq_], -1))


# ------------------------------------------------------------ the kernels
_lib = None
_lib_lock = threading.Lock()
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "h264.cu"
_BUILD = Path(__file__).resolve().parent.parent / "_build"


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libmoda_h264_{tag}.so"


def build_library() -> ctypes.CDLL:
    """Compile csrc/h264.cu for sm_90a into a shared library (once per
    source content) and load it. A failed build raises."""
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
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.moda_h264_inter.argtypes = [vp, ctypes.c_int64, i, vp, vp, vp, vp, i, vp, i, i, i,
                                        vp]
        lib.moda_h264_inter.restype = i
        lib.moda_h264_intra.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, vp,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.moda_h264_intra.restype = i
        lib.moda_h264_deblock.argtypes = [vp, vp, vp, vp, i, i, i, vp,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.moda_h264_deblock.restype = i
        lib.moda_h264_error_string.argtypes = [i]
        lib.moda_h264_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_report() -> str:
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: {build_library().moda_h264_error_string(rc).decode()}")


def _need(t: torch.Tensor, dtype, what: str):
    if t.dtype != dtype or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"{what}: a contiguous {dtype} CUDA tensor, got {t.dtype} on {t.device}")


def _need_scales(scales: torch.Tensor, what: str):
    _need(scales, torch.int32, f"{what}: the LevelScale tables")
    if scales.numel() != SCALES:
        raise ValueError(f"{what}: {scales.numel()} LevelScale entries, not {SCALES}")


def inter(dpb: torch.Tensor, slot: int, mbs: torch.Tensor, levels: torch.Tensor,
          scales: torch.Tensor, weights: torch.Tensor, inter_mbs: torch.Tensor,
          g: Geometry) -> None:
    """The P, B and skipped macroblocks into ``dpb[slot]``: the kernel
    h264_inter on CUDA tensors, ``inter_plain`` on CPU ones."""
    if dpb.device.type == "cpu":
        return inter_plain(dpb, slot, mbs, levels, scales, weights, inter_mbs.long(), g)
    if not len(inter_mbs):
        return
    for t, dt, w in ((dpb, torch.uint8, "the picture buffer"), (mbs, torch.int32, "mbs"),
                     (levels, torch.int16, "levels"), (inter_mbs, torch.int32, "the list"),
                     (weights, torch.int32, "the weight tables")):
        _need(t, dt, f"h264_inter: {w}")
    _need_scales(scales, "h264_inter")
    if weights.dim() != 2 or weights.shape[1] != WT:
        raise ValueError(f"h264_inter: weight tables {tuple(weights.shape)}, not [slices, {WT}]")
    if dpb.shape != (g.slots, g.frame_bytes) or mbs.shape != (g.mb_w * g.mb_h, FIELDS) or \
            not 0 <= slot < g.slots:
        raise ValueError(f"h264_inter: buffer {tuple(dpb.shape)}, records {tuple(mbs.shape)}, "
                         f"slot {slot} for {g}")
    lib = build_library()
    stream = torch.cuda.current_stream(dpb.device).cuda_stream
    _check(lib.moda_h264_inter(dpb.data_ptr(), g.frame_bytes, slot, mbs.data_ptr(),
                               levels.data_ptr(), scales.data_ptr(), weights.data_ptr(),
                               len(weights), inter_mbs.data_ptr(), len(inter_mbs), g.mb_w,
                               g.mb_h, stream), "h264_inter")
    launches["h264_inter"] += 1


def intra(frame: torch.Tensor, mbs: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor,
          order: torch.Tensor, offsets: np.ndarray, g: Geometry) -> None:
    """The intra macroblocks of ``frame``, wavefront by wavefront: the
    kernel h264_intra (one launch a non-empty wavefront) on CUDA tensors,
    ``intra_plain`` on CPU ones."""
    if frame.device.type == "cpu":
        return intra_plain(frame, mbs, levels, scales, order, offsets, g)
    if not len(order):
        return
    for t, dt, w in ((frame, torch.uint8, "the frame"), (mbs, torch.int32, "mbs"),
                     (levels, torch.int16, "levels"), (order, torch.int32, "the order")):
        _need(t, dt, f"h264_intra: {w}")
    _need_scales(scales, "h264_intra")
    if frame.numel() != g.frame_bytes or len(offsets) != g.waves + 1:
        raise ValueError(f"h264_intra: frame of {frame.numel()} bytes, {len(offsets)} offsets "
                         f"for {g}")
    lib = build_library()
    off = np.ascontiguousarray(offsets, np.int32)
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    _check(lib.moda_h264_intra(frame.data_ptr(), mbs.data_ptr(), levels.data_ptr(),
                               scales.data_ptr(), order.data_ptr(), off.ctypes.data, g.waves,
                               g.mb_w, g.mb_h, stream, ctypes.byref(n)), "h264_intra")
    launches["h264_intra"] += n.value


def deblock(frame: torch.Tensor, mbs: torch.Tensor, order: torch.Tensor, offsets: np.ndarray,
            g: Geometry) -> None:
    """The loop filter of ``frame`` over the macroblocks with an edge to
    filter, wavefront by wavefront: the kernel h264_deblock (one launch a
    non-empty wavefront) on CUDA tensors, ``deblock_plain`` on CPU ones."""
    if frame.device.type == "cpu":
        return deblock_plain(frame, mbs, order, offsets, g)
    if not len(order):
        return
    for t, dt, w in ((frame, torch.uint8, "the frame"), (mbs, torch.int32, "mbs"),
                     (order, torch.int32, "the order")):
        _need(t, dt, f"h264_deblock: {w}")
    if frame.numel() != g.frame_bytes or len(offsets) != g.waves + 1:
        raise ValueError(f"h264_deblock: frame of {frame.numel()} bytes, {len(offsets)} "
                         f"offsets for {g}")
    lib = build_library()
    off = np.ascontiguousarray(offsets, np.int32)
    n = ctypes.c_int(0)
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    _check(lib.moda_h264_deblock(frame.data_ptr(), mbs.data_ptr(), order.data_ptr(),
                                 off.ctypes.data, g.waves, g.mb_w, g.mb_h, stream,
                                 ctypes.byref(n)), "h264_deblock")
    launches["h264_deblock"] += n.value


# ----------------------------------------------------------- the decoder
@dataclass
class Work:
    """One picture on the device: its records, levels, LevelScale and weight
    tables, and the kernels' launch lists (the inter macroblocks; the intra
    and filtered ones by wavefront)."""
    mbs: torch.Tensor
    levels: torch.Tensor
    scales: torch.Tensor
    weights: torch.Tensor
    inter: torch.Tensor
    intra: torch.Tensor
    intra_offsets: np.ndarray
    deblock: torch.Tensor
    deblock_offsets: np.ndarray


def plan(pic: Picture, g: Geometry):
    """The launch lists of a parsed picture, on the host: (inter,
    (intra order, offsets), (deblock order, offsets))."""
    kind = pic.mbs[:, F_KIND]
    inter_mbs = np.nonzero(kind >= K_P)[0].astype(np.int32)
    intra_w = _wavefronts(kind <= K_PCM, g.mb_w)
    deblock_w = _wavefronts((pic.mbs[:, F_BS:F_BS + 8] != 0).any(1), g.mb_w)
    return inter_mbs, intra_w, deblock_w


def picture_steps(work: Work, slot: int, g: Geometry):
    """The kernel steps of one picture in decoding order, each a (kernel
    name, macroblocks, step) where ``step(dpb, plain=False)`` reconstructs
    into the picture buffer ``dpb`` [slots, frame_bytes] by the kernel (its
    wrapper) or, with ``plain``, by its plain version: inter prediction
    first, then intra prediction, which reads unfiltered neighbours, then
    the loop filter."""
    def inter_step(dpb, plain=False):
        if plain:
            return inter_plain(dpb, slot, work.mbs, work.levels, work.scales, work.weights,
                               work.inter.long(), g)
        inter(dpb, slot, work.mbs, work.levels, work.scales, work.weights, work.inter, g)

    def intra_step(dpb, plain=False):
        (intra_plain if plain else intra)(dpb[slot], work.mbs, work.levels, work.scales,
                                          work.intra, work.intra_offsets, g)

    def deblock_step(dpb, plain=False):
        (deblock_plain if plain else deblock)(dpb[slot], work.mbs, work.deblock,
                                              work.deblock_offsets, g)
    return (("h264_inter", len(work.inter), inter_step),
            ("h264_intra", len(work.intra), intra_step),
            ("h264_deblock", len(work.deblock), deblock_step))


def to_device(pic: Picture, g: Geometry, device) -> Work:
    """The picture's arrays and launch lists on ``device``, from one
    host-to-device copy."""
    inter_mbs, (iorder, ioff), (dorder, doff) = plan(pic, g)
    parts = [pic.mbs.reshape(-1).view(np.uint8), pic.levels.reshape(-1).view(np.uint8),
             pic.scales.view(np.uint8), pic.weights.reshape(-1).view(np.uint8),
             inter_mbs.view(np.uint8), iorder.view(np.uint8), dorder.view(np.uint8)]
    host = np.empty(sum(p.nbytes for p in parts) + 4 * len(parts), np.uint8)
    pos, spans = 0, []
    for p in parts:
        host[pos:pos + p.nbytes] = p
        spans.append((pos, pos + p.nbytes))
        pos += p.nbytes + (-p.nbytes) % 4
    buf = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    v = [buf[a:b] for a, b in spans]
    return Work(v[0].view(torch.int32).view(-1, FIELDS), v[1].view(torch.int16).view(-1, LEVELS),
                v[2].view(torch.int32), v[3].view(torch.int32).view(-1, WT),
                v[4].view(torch.int32), v[5].view(torch.int32), ioff, v[6].view(torch.int32), doff)


class H264Decoder:
    """Decodes a track's samples in decode order on ``device`` (the card
    unless the caller asks for the CPU), holding the decoded picture buffer
    there, and gives the pictures in FFmpeg's output order, from the
    reorder delay the container gives its decoder (``Video.reorder_delay``).

    ``video`` is a preproc/video.py ``Video`` (its ``config`` holds the
    avcC). ``decode(sample)`` returns the next picture in output order as
    uint8 [height, width, 3] BGR on the device, what cv2.VideoCapture's next
    read gives, or None where none leaves the reorder buffer; ``flush()``
    returns the rest at the end of the stream. ``advance`` and ``picture``
    are the decoding-order halves, for a caller that keeps only some
    pictures: ``advance`` reconstructs a parsed picture, ``picture(slot)``
    converts the one in a slot (the last decoded one by default)."""

    def __init__(self, video, device=None):
        from moda_tpu_torch.runtime import resolve_device

        self.device = resolve_device(device)
        try:
            self.parser = Parser(video.config)
        except ValueError as e:
            raise ValueError(f"{video.path}: {e}") from None
        self.parser.set_delay(video.reorder_delay)
        self.dpb: Optional[torch.Tensor] = None
        self.cur: Optional[int] = None

    @property
    def geometry(self) -> Geometry:
        return self.parser.geometry

    def advance(self, pic: Optional[Picture]) -> bool:
        """Reconstructs a parsed picture into its slot; False for a sample
        without one."""
        if pic is None:
            return False
        g = self.geometry
        if self.dpb is None:
            self.dpb = torch.zeros((g.slots, g.frame_bytes), dtype=torch.uint8,
                                   device=self.device)
        for _, _, step in picture_steps(to_device(pic, g, self.device), pic.slot, g):
            step(self.dpb)
        self.cur = pic.slot
        return True

    def picture(self, slot: Optional[int] = None) -> torch.Tensor:
        """The picture in ``slot`` (the last decoded one if None), uint8
        [height, width, 3] BGR on the device."""
        g = self.geometry
        s = self.cur if slot is None else slot
        return M.yuv420_to_bgr(self.dpb[s], g.m4v, g.left, g.top, COEFFS[g.matrix])

    def decode(self, sample: bytes) -> Optional[torch.Tensor]:
        pic = self.parser.parse(sample)
        self.advance(pic)
        return None if pic is None or pic.out < 0 else self.picture(pic.out)

    def flush(self) -> list:
        """The pictures still waiting at the end of the stream, in output
        order (a list of uint8 [height, width, 3] BGR)."""
        return [self.picture(s) for s in self.parser.flush()]
