"""Test helpers for the port's H.264 decoder (moda_tpu_torch/preproc/h264.py):
a writer of H.264 (ISO/IEC 14496-10) streams in the syntax the port decodes
(progressive 8-bit 4:2:0, CAVLC or CABAC, I, P and B slices with weighted
prediction, at High profile the 8x8 transform, Intra 8x8 and scaling
lists), their MP4 muxing (with the ctts and edit list FFmpeg's mov muxer
writes for reordered pictures), and cv2's reading of them with avcodec's
log.

The writer has two modes, each of which writes either entropy coder
(``Sequence(..., entropy="cabac")``) from the same macroblock decisions:

- ``random_stream``: random valid syntax from a seed. It draws macroblock
  types, sub-macroblock types, intra modes (only those whose neighbours are
  available under the slice and constrained_intra_pred_flag rules), coded
  block patterns, the transform size, levels (escapes included; every level
  kept inside the 16-bit range a conforming stream keeps its transform in,
  under the stream's scaling lists), QP deltas, mvds, reference indices,
  skip runs, slices, deblocking settings, memory management operations and
  reference list modifications; the SPS's and PPS's scaling lists come from
  ``scaling_specs``; with ``bframes``, B pictures between P anchors (every
  B macroblock and sub-macroblock type, B-refs, both direct modes, both
  lists' sizes and modifications, pred_weight_table), the syntax alone:
  the writer never derives a B block's motion.
- ``natural_stream``: a small real encoder for ``tests/torch_video.py::
  scene`` frames: I_16x16 (DC, V, H) pictures (at High profile Intra 4x4,
  8x8 or 16x16 by cost) and P_L0_16x16 pictures with one global vector a
  reference plus the quantised residual (at High profile by the 4x4 or 8x8
  transform), reconstructed as it goes, with the loop filter off; with
  ``bframes``, x264's default structure (B pictures of B_L0/L1/Bi_16x16
  under implicit weights or B_Skip by spatial direct, a B-ref, weighted
  P).

A stream counts as valid only if cv2 decodes it with no error line from
avcodec (``cv2_read``: OPENCV_FFMPEG_DEBUG in a subprocess): FFmpeg would
otherwise conceal an error silently and corrupt the oracle. ``COVERAGE``
counts every CAVLC table entry, macroblock type and sub-macroblock type the
writer emits, and under CABAC every (table, context index, bin value) and
every leaf of every binarisation, so that a table entry that the writer and
the reader got wrong alike cannot hide behind cv2. CABAC's tables are the
port's (``preproc/h264.py::cabac_tables``), which
tests/test_torch_h264_cabac.py finds byte for byte in cv2's libavcodec.

cv2 is the oracle here and only here: the port reads no clip through it.
"""
from __future__ import annotations

import collections
import functools
import os
import re
import subprocess
import sys

import numpy as np

# ----------------------------------------------------------------- tables
# CAVLC's code tables, indexed as FFmpeg's h264_cavlc.c indexes them:
# coeff_token by nC class (0-1, 2-3, 4-7, 8+) at 4 * TotalCoeff +
# TrailingOnes, chroma DC's coeff_token the same way, total_zeros by
# TotalCoeff - 1, run_before by min(zerosLeft, 7) - 1
CT_LEN = [[1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16], [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14], [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10], [6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6]]
CT_BITS = [[1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8], [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4], [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2], [3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63]]
CDC_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
CDC_BITS = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]
TZ_LEN = [[1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9], [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0], [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0], [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0], [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0], [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0], [6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0], [6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0], [6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0], [5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0], [4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]]
TZ_BITS = [[1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1], [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0], [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0], [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0], [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0], [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0], [1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0], [1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0], [1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0], [1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]]
CTZ_LEN = [[1, 2, 3, 3], [1, 2, 2, 0], [1, 1, 0, 0]]
CTZ_BITS = [[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]]
RUN_LEN = [[1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0]]
RUN_BITS = [[1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0], [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0]]
# coded_block_pattern's me(v) mapping (Table 9-4): codeNum -> pattern
INTRA_CBP = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12,
             19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33,
             34, 36, 40, 38, 41]
INTER_CBP = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42,
             44, 33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30,
             22, 25, 38, 41]
INTRA_CBP_CODE = {c: k for k, c in enumerate(INTRA_CBP)}
INTER_CBP_CODE = {c: k for k, c in enumerate(INTER_CBP)}
# zig-zag scan index -> raster position (4 * row + column) in a 4x4 block
ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
# luma4x4BlkIdx -> (x, y) in 4x4 units inside the macroblock
BLK_X = [0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3]
BLK_Y = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]
BLK_AT = {(x, y): i for i, (x, y) in enumerate(zip(BLK_X, BLK_Y))}
# normAdjust4x4 (8.5.9): v[qP % 6] for positions (even, even), (odd, odd), other
NORM = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
# the forward quantiser's multipliers of the same positions
MF = [[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554], [9362, 3647, 5825],
      [8192, 3355, 5243], [7282, 2893, 4559]]
CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38,
                               38, 38, 39, 39, 39, 39]
P_TYPES = {"P16x16": 0, "P16x8": 1, "P8x16": 2, "P8x8": 3, "P8x8ref0": 4}
# "I8" is I_NxN with transform_size_8x8_flag (Intra 8x8)
INTRA = ("I4", "I8", "I16", "PCM")
NXN = ("I4", "I8")
# sub-macroblock types: (partitions, width, height) in 4x4 units
SUB_PARTS = [(1, 2, 2), (2, 2, 1), (2, 1, 2), (4, 1, 1)]
MB_PARTS = {"P16x16": (1, 4, 4), "P16x8": (2, 4, 2), "P8x16": (2, 2, 4)}
# B slices' inter types ("BDIRECT" B_Direct_16x16; "SKIP" in a B slice is
# B_Skip): a partition's lists 1 L0, 2 L1, 3 both; mb_type 4-21's list
# pairs (Table 7-14, a pair for the 16x8 and the 8x16 type); each
# sub_mb_type's lists (0: B_Direct_8x8) and SUB_PARTS shape (Table 7-18)
B_TYPES = ("BDIRECT", "B16x16", "B16x8", "B8x16", "B8x8")
B_PARTS = {"B16x16": (1, 4, 4), "B16x8": (2, 4, 2), "B8x16": (2, 2, 4)}
B_PAIRS = [(1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2), (3, 3)]
B_SUB = [(0, 0), (1, 0), (2, 0), (3, 0), (1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2),
         (1, 3), (2, 3), (3, 3)]
INTER = tuple(P_TYPES) + B_TYPES  # coded inter macroblocks


def b_mb_type(kind: str, preds) -> int:
    """A B macroblock's mb_type (Table 7-14)."""
    if kind == "BDIRECT":
        return 0
    if kind == "B8x8":
        return 22
    if kind == "B16x16":
        return preds[0]
    return 4 + 2 * B_PAIRS.index(tuple(preds)) + (kind == "B8x16")
# the most a conforming stream lets the transform's values reach (8-bit: 2^15)
RANGE = 32767

COVERAGE: collections.Counter = collections.Counter()


def _pos_class(r: int) -> int:
    i, j = r >> 2, r & 3
    return 0 if (i & 1) == 0 and (j & 1) == 0 else 1 if (i & 1) and (j & 1) else 2


POS_CLASS = np.array([_pos_class(r) for r in range(16)])
# zig-zag scan index -> raster position (8 * row + column) in an 8x8 block
ZIGZAG8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
           37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# normAdjust8x8 (8.5.13.1): v[qP % 6] for the six position classes
NORM8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26], [26, 23, 42, 24, 33, 31],
         [28, 25, 45, 26, 35, 33], [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]


def _pos_class8(r: int) -> int:
    i, j = r >> 3, r & 7
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 and j % 2:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2) or (i % 2 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


POS_CLASS8 = np.array([_pos_class8(r) for r in range(64)])
FLAT4, FLAT8 = np.full(16, 16), np.full(64, 16)


def level_scale(qp: int, w=None) -> np.ndarray:
    """[16] LevelScale4x4 of qP % 6 by raster position: the weights ``w``
    (raster; Flat_16 if None) times normAdjust4x4."""
    return (FLAT4 if w is None else np.asarray(w)) * np.array(NORM[qp % 6])[POS_CLASS]


def level_scale8(qp: int, w=None) -> np.ndarray:
    """[64] LevelScale8x8 of qP % 6 by raster position."""
    return (FLAT8 if w is None else np.asarray(w)) * np.array(NORM8[qp % 6])[POS_CLASS8]


def dequant(levels: np.ndarray, ls: np.ndarray, qp: int, bits: int) -> np.ndarray:
    """8.5.12.1 (``bits`` 4) and 8.5.13.1 (``bits`` 6): levels times their
    LevelScale, scaled by 2^(qP / 6 - bits), rounded below 1."""
    x = levels.astype(np.int64) * ls
    q6 = qp // 6
    return x << (q6 - bits) if q6 >= bits else (x + (1 << (bits - q6 - 1))) >> (bits - q6)


# ------------------------------------------------------------- bit writer
class BitWriter:
    def __init__(self):
        self.parts = []
        self.n = 0

    def u(self, n: int, v: int):
        if n:
            assert 0 <= v < (1 << n), (n, v)
            self.parts.append(format(v, f"0{n}b"))
            self.n += n

    def ue(self, v: int):
        assert v >= 0
        x = int(v) + 1
        self.u(2 * x.bit_length() - 1, x)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, rng: int, v: int):
        if rng > 1:
            self.ue(v)
        else:
            self.u(1, 1 - v)

    def align_zero(self):
        self.u((-self.n) % 8, 0)

    def trailing(self) -> bytes:
        self.u(1, 1)
        return self.aligned()

    def aligned(self) -> bytes:
        """The bits so far, zero bits to the byte boundary, as bytes (a CABAC
        slice's flush writes its rbsp_stop_one_bit itself)."""
        self.align_zero()
        s = "".join(self.parts)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def nal(ref_idc: int, typ: int, rbsp: bytes) -> bytes:
    """A NAL unit (header byte + the RBSP with emulation prevention)."""
    return bytes([ref_idc << 5 | typ]) + re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp)


# --------------------------------------------------------------- numerics
def idct_checked(d: np.ndarray) -> np.ndarray:
    """The 4x4 inverse transform (8.5.12.2: rows, then columns) of [..., 16]
    scaled coefficients in raster order, as int64 [..., 16] residuals; also
    whether every intermediate stays in the 16-bit range."""
    d = d.reshape(*d.shape[:-1], 4, 4).astype(np.int64)
    e0, e1 = d[..., 0] + d[..., 2], d[..., 0] - d[..., 2]
    e2, e3 = (d[..., 1] >> 1) - d[..., 3], d[..., 1] + (d[..., 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    g0, g1 = f[..., 0, :] + f[..., 2, :], f[..., 0, :] - f[..., 2, :]
    g2, g3 = (f[..., 1, :] >> 1) - f[..., 3, :], f[..., 1, :] + (f[..., 3, :] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], -2)
    ok = all(np.abs(a).max(initial=0) <= RANGE - 32 for a in (d, f, h))
    return ((h + 32) >> 6).reshape(*h.shape[:-2], 16), ok


def idct8_checked(d: np.ndarray):
    """The 8x8 inverse transform (8.5.13.2: rows, then columns) of [..., 64]
    scaled coefficients in raster order, as int64 [..., 64] residuals; also
    whether every intermediate of both passes stays in the 16-bit range."""
    d = d.reshape(*d.shape[:-1], 8, 8).astype(np.int64)
    stages = [d]

    def one(x, axis):
        v = np.moveaxis(x, axis, -1)
        v = [v[..., k] for k in range(8)]
        a0, a4 = v[0] + v[4], v[0] - v[4]
        a2, a6 = (v[2] >> 1) - v[6], v[2] + (v[6] >> 1)
        b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
        a1 = -v[3] + v[5] - v[7] - (v[7] >> 1)
        a3 = v[1] + v[7] - v[3] - (v[3] >> 1)
        a5 = -v[1] + v[7] + v[5] + (v[5] >> 1)
        a7 = v[3] + v[5] + v[1] + (v[1] >> 1)
        b1, b7, b3, b5 = a1 + (a7 >> 2), a7 - (a1 >> 2), a3 + (a5 >> 2), (a3 >> 2) - a5
        stages.extend([a0, a4, a2, a6, b0, b2, b4, b6, a1, a3, a5, a7, b1, b3, b5, b7])
        out = np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7], -1)
        stages.append(out)
        return np.moveaxis(out, -1, axis)

    h = one(one(d, -1), -2)
    ok = all(np.abs(a).max(initial=0) <= RANGE - 32 for a in stages)
    return ((h + 32) >> 6).reshape(*h.shape[:-2], 64), ok


def luma_dc(levels: np.ndarray, qp: int, w0: int = 16) -> np.ndarray:
    """Intra16x16 DC: [16] levels (raster over the 4x4 blocks) -> the [16]
    dcY values (8.5.10); ``w0`` the Intra Y list's weight at (0, 0)."""
    c = levels.reshape(4, 4).astype(np.int64)
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
    f = H @ c @ H
    ls = w0 * NORM[qp % 6][0]
    if qp >= 36:
        return ((f * ls) << (qp // 6 - 6)).reshape(16)
    return ((f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)).reshape(16)


def chroma_dc(levels: np.ndarray, qp: int, w0: int = 16) -> np.ndarray:
    """4:2:0 chroma DC: [4] levels -> the [4] dcC values (8.5.11); ``w0``
    the plane's list's weight at (0, 0)."""
    c = np.asarray(levels, np.int64).reshape(2, 2)
    H = np.array([[1, 1], [1, -1]])
    f = H @ c @ H
    return (((f * w0 * NORM[qp % 6][0]) << (qp // 6)) >> 5).reshape(4)


def residual_blocks(levels: np.ndarray, qp: int, dc=None, w=None):
    """[n, 16] raster levels of 4x4 blocks at ``qp`` -> ([n, 16] residuals,
    in range); ``dc`` [n]: their DC values already scaled (Intra16x16,
    chroma); ``w`` the list's weights (raster; flat if None)."""
    d = dequant(levels, level_scale(qp, w), qp, 4)
    if dc is not None:
        d[:, 0] = dc
    return idct_checked(d)


def residual_blocks8(levels: np.ndarray, qp: int, w=None):
    """[n, 64] raster levels of 8x8 blocks -> ([n, 64] residuals, in range)."""
    return idct8_checked(dequant(levels, level_scale8(qp, w), qp, 6))


# ------------------------------------------------------------------ CAVLC
def write_block(w: BitWriter, nc: int, coeffs, maxn: int) -> int:
    """residual_block_cavlc of ``coeffs`` (scan order, ``maxn`` of them) at
    nC ``nc`` (-1: chroma DC); returns TotalCoeff."""
    nz = [i for i, c in enumerate(coeffs) if c]
    tc = len(nz)
    t1 = 0
    for i in reversed(nz):
        if abs(coeffs[i]) != 1 or t1 == 3:
            break
        t1 += 1
    if nc == -1:
        cls = "dc"
        w.u(CDC_LEN[4 * tc + t1], CDC_BITS[4 * tc + t1])
    else:
        cls = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        w.u(CT_LEN[cls][4 * tc + t1], CT_BITS[cls][4 * tc + t1])
    COVERAGE[("coeff_token", cls, tc, t1)] += 1
    if tc == 0:
        return 0
    levels = [coeffs[i] for i in reversed(nz)]
    for i in range(t1):
        w.u(1, int(levels[i] < 0))
    sl = 1 if tc > 10 and t1 < 3 else 0
    for i in range(t1, tc):
        lv = levels[i]
        code = 2 * lv - 2 if lv > 0 else -2 * lv - 1
        if i == t1 and t1 < 3:
            code -= 2
        if sl == 0:
            if code < 14:
                prefix, suf, ns = code, 0, 0
            elif code < 30:
                prefix, suf, ns = 14, code - 14, 4
            else:
                prefix, suf, ns = 15, code - 30, 12
        elif code < (15 << sl):
            prefix, suf, ns = code >> sl, code & ((1 << sl) - 1), sl
        else:
            prefix, suf, ns = 15, code - (15 << sl), 12
        assert suf < (1 << ns) or ns == 0, (lv, sl)
        if prefix >= 14 and (prefix == 15 or sl == 0):
            COVERAGE[("level_escape", prefix, min(sl, 1))] += 1
        w.u(prefix + 1, 1)
        w.u(ns, suf)
        if sl == 0:
            sl = 1
        if abs(lv) > (3 << (sl - 1)) and sl < 6:
            sl += 1
    if tc < maxn:
        tz = nz[-1] + 1 - tc
        if maxn == 4:
            w.u(CTZ_LEN[tc - 1][tz], CTZ_BITS[tc - 1][tz])
            COVERAGE[("total_zeros", "dc", tc, tz)] += 1
        else:
            w.u(TZ_LEN[tc - 1][tz], TZ_BITS[tc - 1][tz])
            COVERAGE[("total_zeros", "luma", tc, tz)] += 1
        zl = tz
        for k in range(tc - 1):
            if zl == 0:
                break
            run = nz[-1 - k] - nz[-2 - k] - 1
            t = min(zl, 7) - 1
            w.u(RUN_LEN[t][run], RUN_BITS[t][run])
            COVERAGE[("run_before", t + 1, run)] += 1
            zl -= run
    return tc


def coverage_expected() -> set:
    """Every entry of the CAVLC tables, and every macroblock and
    sub-macroblock type of I and P slices."""
    out = set()
    for cls in (0, 1, 2, 3):
        for tc in range(17):
            for t1 in range(min(tc, 3) + 1):
                out.add(("coeff_token", cls, tc, t1))
    for tc in range(5):
        for t1 in range(min(tc, 3) + 1):
            out.add(("coeff_token", "dc", tc, t1))
    for tc in range(1, 16):
        for tz in range(17 - tc):
            out.add(("total_zeros", "luma", tc, tz))
    for tc in range(1, 4):
        for tz in range(5 - tc):
            out.add(("total_zeros", "dc", tc, tz))
    for zl in range(1, 7):
        for run in range(zl + 1):
            out.add(("run_before", zl, run))
    for run in range(15):
        out.add(("run_before", 7, run))
    for p in range(15):
        for sl in (0, 1):
            if p >= 14 and (p == 15 or sl == 0):
                out.add(("level_escape", p, sl))
    for t in ("I4", "PCM") + tuple(P_TYPES) + ("SKIP",):
        out.add(("mb_type", t))
    for mode in range(4):
        for cc in range(3):
            for cl in (0, 15):
                out.add(("mb_type", "I16", mode, cc, cl))
    for s in range(4):
        out.add(("sub_mb_type", s))
    for m in range(9):
        out.add(("intra4x4", m))
    for m in range(4):
        out.add(("intra_chroma", m))
    return out


# ------------------------------------------------------------------ CABAC
# ctxBlockCat 0-4 (Intra16x16 DC, Intra16x16 AC, luma 4x4, chroma DC,
# chroma AC): offsets of coded_block_flag's, significant_coeff_flag's (and
# last_significant_coeff_flag's) and coeff_abs_level_minus1's contexts
# from their first (85, 105, 166, 227; Table 9-40, frame macroblocks)
CBF_OFF = [0, 4, 8, 12, 16]
SIG_OFF = [0, 15, 29, 44, 47]
ABS_OFF = [0, 10, 20, 30, 39]
# the tables (9.3.1.1: "I", "P0"-"P2" by cabac_init_idc) whose contexts
# I and P slices use without the 8x8 transform, and the terminate bin 276
CABAC_TAGS = ("I", "P0", "P1", "P2")
CABAC_CONTEXTS = {"I": list(range(3, 11)) + list(range(60, 70)) + list(range(73, 277))}
CABAC_CONTEXTS.update({t: list(range(11, 24)) + list(range(40, 70)) + list(range(73, 277))
                       for t in CABAC_TAGS[1:]})


@functools.cache
def _cabac_tables() -> dict:
    from moda_tpu_torch.preproc import h264 as D

    t = D.cabac_tables()
    return dict(init=t["init"].astype(np.int64), lps=t["range_lps"].tolist(),
                tl=t["trans_lps"].tolist(), tm=t["trans_mps"].tolist())


class CabacEncoder:
    """The arithmetic encoder of 9.3.4 (InitEncoder, EncodeDecision,
    EncodeBypass, EncodeTerminate with EncodeFlush, PutBit with the
    outstanding bits) writing into a BitWriter, its contexts initialised
    from the slice QP under table ``tag`` (CABAC_TAGS). Every decision is
    counted in COVERAGE as ("cabac", tag, ctxIdx, bin), the terminate bin as
    context 276."""

    def __init__(self, w: BitWriter, qp: int, tag: str):
        T = _cabac_tables()
        m, n = T["init"][CABAC_TAGS.index(tag), :, 0], T["init"][CABAC_TAGS.index(tag), :, 1]
        pre = np.clip(((m * qp) >> 4) + n, 1, 126)
        self.state = np.where(pre <= 63, 63 - pre, pre - 64).tolist()
        self.mps = (pre > 63).astype(int).tolist()
        self.lps, self.tl, self.tm = T["lps"], T["tl"], T["tm"]
        self.w, self.tag = w, tag
        self.start()

    def start(self):
        """InitEncoder: at the slice data's first byte, and after I_PCM."""
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0
        self.out = []

    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.out.append(b)
        if self.outstanding:
            self.out.extend([1 - b] * self.outstanding)
            self.outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int):
        COVERAGE[("cabac", self.tag, ctx, b)] += 1
        s, m = self.state[ctx], self.mps[ctx]
        lps = self.lps[s][(self.range >> 6) & 3]
        self.range -= lps
        if b != m:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - m
            self.state[ctx] = self.tl[s]
        else:
            self.state[ctx] = self.tm[s]
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def exp_golomb(self, v: int, k: int):
        """The k-th order Exp-Golomb suffix (9.3.2.3) in bypass bins."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)

    def terminate(self, b: int):
        """end_of_slice_flag or mb_type's I_PCM bin; 1 flushes (its last bit
        is the slice's rbsp_stop_one_bit) into the BitWriter."""
        COVERAGE[("cabac", self.tag, 276, b)] += 1
        self.range -= 2
        if not b:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        v = ((self.low >> 7) & 3) | 1
        self.out += [v >> 1, v & 1]
        self.w.parts.append("".join(map(str, self.out)))
        self.w.n += len(self.out)
        self.out = []


def cabac_coverage_expected() -> set:
    """Every context index of I/P frame coding without the 8x8 transform
    under each table it has, with both bin values; every I mb_type in I
    slices and as a P slice's suffix, the four P mb_types and sub_mb_types,
    the escapes of mvd and of every block category's levels, mb_qp_delta's
    ends, a ref_idx of 2 or more, and I_PCM first in a slice, mid-row and
    last in a slice."""
    out = {("cabac", t, c, b) for t in CABAC_TAGS for c in CABAC_CONTEXTS[t] for b in (0, 1)}
    out |= {("cabac_mb_type", sl, t) for sl in ("I", "P") for t in range(26)}
    out |= {("cabac_mb_type", "P", k) for k in ("P16x16", "P16x8", "P8x16", "P8x8")}
    out |= {("cabac_sub_mb_type", t) for t in range(4)}
    out |= {("cabac_mvd_escape", c) for c in (0, 1)}
    out |= {("cabac_level_escape", cat) for cat in range(5)}
    out |= {("cabac_qp_delta", -26), ("cabac_qp_delta", 25), ("cabac_ref_idx", 2)}
    out |= {("cabac_pcm", w) for w in ("first", "mid_row", "last")}
    return out


# --------------------------------------------------------- scaling lists
@functools.cache
def _high_tables() -> dict:
    from moda_tpu_torch.preproc import h264 as D

    return {k: v.astype(np.int64) for k, v in D.high_tables().items()}


def _list_raster(spec, size: int, dflt, fallback) -> np.ndarray:
    """The weightScale (raster) a scaling list ``spec`` gives: None (absent)
    the fall-back list, "default" (useDefaultScalingMatrixFlag) the default
    one, else its values in scan order."""
    if spec is None:
        return np.array(fallback)
    if isinstance(spec, str):
        return np.array(dflt)
    out = np.zeros(size, np.int64)
    out[np.array(ZIGZAG if size == 16 else ZIGZAG8)] = spec
    return out


def resolve_lists(specs, n8: int, fb4, fb8):
    """([6, 16], [n8, 64]) weightScale of 6 + n8 list specs, an absent list
    falling back (Table 7-2) to the previous one of its kind or to ``fb4``
    (Intra Y, Inter Y) / ``fb8``."""
    T = _high_tables()
    w4 = []
    for i in range(6):
        w4.append(_list_raster(specs[i], 16, T["default4"][i // 3],
                               fb4[i // 3] if i % 3 == 0 else w4[i - 1]))
    w8 = [_list_raster(specs[6 + i], 64, T["default8"][i], fb8[i]) for i in range(n8)]
    return np.array(w4), np.array(w8).reshape(n8, 64)


def write_scaling_list(w: BitWriter, spec) -> None:
    """The present flag and scaling_list() (7.3.2.1.1.1) of ``spec``: a
    repeated tail of values is left to nextScale 0."""
    w.u(1, int(spec is not None))
    if spec is None:
        return
    if isinstance(spec, str):
        w.se(-8)  # nextScale 0 at j 0: useDefaultScalingMatrixFlag
        return
    vals = [int(v) for v in spec]
    k = len(vals)
    while k > 1 and vals[k - 1] == vals[k - 2]:
        k -= 1
    last = 8
    for j, v in enumerate(vals):
        target = 0 if j == k else v
        w.se((target - last + 128) % 256 - 128)
        if j == k:
            COVERAGE[("scaling_list_tail",)] += 1
            return
        last = v


SCALING_CASES = ("values", "default", "absent")


def scaling_specs(rng, pattern: str) -> list:
    """The list specs of ``pattern``, a letter a list: "v" values drawn
    from 1-255 (half of them with a repeated tail), "d" the default flag,
    "a" absent."""
    out = []
    for i, case in enumerate(pattern):
        if case == "v":
            size = 16 if i < 6 else 64
            v = rng.integers(1, 256, size)
            if rng.random() < 0.5:
                k = int(rng.integers(1, size))
                v[k:] = v[k - 1]
            out.append([int(a) for a in v])
        else:
            out.append("default" if case == "d" else None)
    return out


def _case(spec, absent: str) -> str:
    return absent if spec is None else "default" if isinstance(spec, str) else "values"


# ---------------------------------------------------------------- streams
class Sequence:
    """One coded video sequence: its SPS and PPS (``entropy`` "cavlc" or
    "cabac"), frame_num and POC state, and the writer's model of the decoded
    picture buffer's reference marking (to draw valid memory management
    operations and reference list modifications). CABAC's cabac_init_idc
    draws come from a generator of their own, so that the other draws, and
    so the pictures, do not depend on the coder."""

    def __init__(self, width: int, height: int, seed: int = 0, poc_type: int = 0,
                 max_refs: int = 1, log2_max_frame_num: int = 4, log2_max_poc_lsb: int = 5,
                 chroma_qp_offset: int = 0, constrained_intra: bool = False, qp: int = 26,
                 full_range=None, matrix=None, poc1_always_zero: bool = False,
                 num_ref_default: int = 1, sps_extra=None, pps_extra=None,
                 entropy: str = "cavlc"):
        assert width % 2 == 0 and height % 2 == 0 and entropy in ("cavlc", "cabac")
        self.entropy = entropy
        self.cabac_rng = np.random.default_rng([seed, 264])
        self.width, self.height = width, height
        self.sps_extra, self.pps_extra = sps_extra or {}, pps_extra or {}
        self._high_fields(chroma_qp_offset)
        # the coded picture: the cropped one plus its left and top crop
        self.mb_w = (width + self.sps_extra.get("crop_left", 0) + 15) // 16
        self.mb_h = (height + self.sps_extra.get("crop_top", 0) + 15) // 16
        self.nmb = self.mb_w * self.mb_h
        self.rng = np.random.default_rng(seed)
        self.poc_type = poc_type
        self.max_refs = max_refs
        self.log2_fn, self.log2_poc = log2_max_frame_num, log2_max_poc_lsb
        self.max_fn = 1 << log2_max_frame_num
        self.cqp_offset = chroma_qp_offset
        self.constrained = constrained_intra
        self.qp = qp
        self.full_range, self.matrix = full_range, matrix
        self.poc1_zero = poc1_always_zero
        self.poc1_cycle = [2]
        self.poc1_nonref = 0
        self.num_ref_default = num_ref_default
        # B slices: list 1's default size, weighted_pred_flag,
        # weighted_bipred_idc, direct_8x8_inference_flag, the VUI's
        # max_num_reorder_frames (None: no bitstream_restriction)
        self.num_ref_default1 = self.pps_extra.get("num_ref_idx_l1_default", 1)
        self.weighted = int(self.pps_extra.get("weighted_pred", 0))
        self.bipred = int(self.pps_extra.get("weighted_bipred_idc", 0))
        self.direct8x8 = int(self.sps_extra.get("direct_8x8_inference", 1))
        self.reorder = self.sps_extra.get("reorder")
        # reference marking: {"fn", "lt" (LongTermFrameIdx or None), "poc"}
        self.refs = []
        self.max_lt = -1  # MaxLongTermFrameIdx; -1: "no long-term frame indices"
        self.prev_ref_fn = 0
        self.frame_num = 0
        self.n_since_idr = 0
        self.poc1_offset = 0  # FrameNumOffset of POC type 1 and 2
        self.prev_fn = 0

    def _high_fields(self, cqp: int):
        """High profile's fields as the decoder reads them: the SPS's lists
        (sps_extra "scaling_lists": 8 specs, or "seq_scaling_matrix_present"
        with none present), the PPS's extension (pps_extra
        "transform_8x8_mode", "scaling_lists" or "pic_scaling_matrix_present",
        "second_chroma_qp_offset"), which FFmpeg skips for a constrained
        Baseline, Main or Extended SPS; so ``t8`` (transform_8x8_mode_flag),
        ``cqp`` (the Cb and Cr offsets), ``w4`` [6, 16] and ``w8`` [2, 64]
        (the picture-level weightScale, raster)."""
        x, y = self.sps_extra, self.pps_extra
        prof = x.get("profile", 66)
        self.sps_specs = x.get("scaling_lists",
                               [None] * 8 if x.get("seq_scaling_matrix_present") else None)
        T = _high_tables()
        flat4, flat8 = np.full((6, 16), 16), np.full((2, 64), 16)
        sw4, sw8 = (resolve_lists(self.sps_specs, 2, T["default4"], T["default8"])
                    if self.sps_specs is not None else (flat4, flat8))
        self.pps_ext = any(k in y for k in ("transform_8x8_mode", "pic_scaling_matrix_present",
                                            "scaling_lists", "second_chroma_qp_offset"))
        t8 = int(y.get("transform_8x8_mode", 0))
        self.pps_specs = y.get("scaling_lists", [None] * (6 + 2 * t8)
                               if y.get("pic_scaling_matrix_present") else None)
        cons = x.get("constraints", 0xC0 if prof == 66 else 0)
        self.pps_read = read = self.pps_ext and not (prof in (66, 77, 88) and cons & 0xE0)
        self.cqp_offset = cqp
        self.cqp = (cqp, y.get("second_chroma_qp_offset", cqp) if read else cqp)
        self.t8 = bool(t8) and read
        self.w4, self.w8 = sw4, sw8
        if read and self.pps_specs is not None:
            scaled = self.sps_specs is not None
            fb4 = [sw4[0], sw4[3]] if scaled else T["default4"]
            fb8 = sw8 if scaled else T["default8"]
            self.w4, w8 = resolve_lists(self.pps_specs, 2 * t8, fb4, fb8)
            if t8:
                self.w8 = w8

    # parameter sets
    def sps(self) -> bytes:
        x = self.sps_extra
        w = BitWriter()
        prof = x.get("profile", 66)
        w.u(8, prof)
        w.u(8, x.get("constraints", 0xC0 if prof == 66 else 0))
        w.u(8, x.get("level", 40))
        w.ue(0)
        if prof in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            cf = x.get("chroma_format_idc", 1)
            w.ue(cf)
            if cf == 3:
                w.u(1, x.get("separate_colour_plane", 0))
            w.ue(x.get("bit_depth_luma_minus8", 0))
            w.ue(x.get("bit_depth_chroma_minus8", 0))
            w.u(1, 0)  # qpprime_y_zero_transform_bypass_flag
            w.u(1, int(self.sps_specs is not None))
            for i, spec in enumerate(self.sps_specs or ()):
                write_scaling_list(w, spec)
                COVERAGE[("scaling_list", self.entropy, "sps", i, _case(spec, "absent"))] += 1
        w.ue(self.log2_fn - 4)
        w.ue(self.poc_type)
        if self.poc_type == 0:
            w.ue(self.log2_poc - 4)
        elif self.poc_type == 1:
            w.u(1, int(self.poc1_zero))
            w.se(self.poc1_nonref)
            w.se(0)
            w.ue(len(self.poc1_cycle))
            for o in self.poc1_cycle:
                w.se(o)
        w.ue(self.max_refs)
        w.u(1, x.get("gaps_in_frame_num_allowed", 0))
        w.ue(self.mb_w - 1)
        w.ue(self.mb_h - 1)
        w.u(1, x.get("frame_mbs_only", 1))
        if not x.get("frame_mbs_only", 1):
            w.u(1, 0)  # mb_adaptive_frame_field_flag
        w.u(1, int(self.direct8x8))
        left, top = x.get("crop_left", 0), x.get("crop_top", 0)
        crop = (16 * self.mb_w - self.width - left, 16 * self.mb_h - self.height - top)
        if crop != (0, 0) or left or top:
            w.u(1, 1)
            w.ue(left // 2)
            w.ue(crop[0] // 2)
            w.ue(top // 2)
            w.ue(crop[1] // 2)
        else:
            w.u(1, 0)
        colour = self.full_range is not None or self.matrix is not None
        vui = colour or self.reorder is not None
        w.u(1, int(vui))
        if vui:
            w.u(1, 0)  # aspect_ratio_info_present_flag
            w.u(1, 0)  # overscan_info_present_flag
            w.u(1, int(colour))  # video_signal_type_present_flag
            if colour:
                w.u(3, 5)
                w.u(1, int(bool(self.full_range)))
                w.u(1, int(self.matrix is not None))
                if self.matrix is not None:
                    w.u(8, self.matrix)
                    w.u(8, self.matrix)
                    w.u(8, self.matrix)
            w.u(1, 0)  # chroma_loc_info_present_flag
            timing = self.reorder is not None
            w.u(1, int(timing))  # timing_info_present_flag, as x264 writes it
            if timing:
                w.u(32, 1)
                w.u(32, 60)
                w.u(1, 1)
            for _ in range(3):  # nal/vcl hrd, pic_struct
                w.u(1, 0)
            w.u(1, int(self.reorder is not None))  # bitstream_restriction_flag
            if self.reorder is not None:
                COVERAGE[("vui_reorder", self.entropy, self.reorder)] += 1
                w.u(1, 1)  # motion_vectors_over_pic_boundaries_flag
                w.ue(0)
                w.ue(0)
                w.ue(16)
                w.ue(16)
                w.ue(self.reorder)  # max_num_reorder_frames
                w.ue(max(self.max_refs, 1) + self.reorder)  # max_dec_frame_buffering
        return nal(3, 7, w.trailing())

    def pps(self) -> bytes:
        x = self.pps_extra
        w = BitWriter()
        w.ue(0)
        w.ue(0)
        w.u(1, x.get("entropy_coding_mode", int(self.entropy == "cabac")))
        w.u(1, 0)  # bottom_field_pic_order_in_frame_present_flag
        ngroups = x.get("num_slice_groups", 1)
        w.ue(ngroups - 1)
        if ngroups > 1:
            w.ue(6)
            w.ue(self.nmb - 1)
            for _ in range(self.nmb):
                w.u(1, 0)
        w.ue(self.num_ref_default - 1)
        w.ue(self.num_ref_default1 - 1)
        w.u(1, self.weighted)
        w.u(2, self.bipred)
        w.se(self.qp - 26)
        w.se(0)
        w.se(self.cqp_offset)
        w.u(1, 1)  # deblocking_filter_control_present_flag
        w.u(1, int(self.constrained))
        w.u(1, x.get("redundant_pic_cnt_present", 0))
        if self.pps_ext:
            w.u(1, x.get("transform_8x8_mode", 0))
            w.u(1, int(self.pps_specs is not None))
            absent = "absent_B" if self.sps_specs is not None else "absent_A"
            for i, spec in enumerate(self.pps_specs or ()):
                write_scaling_list(w, spec)
                if self.pps_read:
                    COVERAGE[("scaling_list", self.entropy, "pps", i, _case(spec, absent))] += 1
            if self.pps_read and self.pps_specs is None and self.sps_specs is not None:
                COVERAGE[("scaling_matrix", self.entropy, "pps_takes_sps")] += 1
            w.se(x.get("second_chroma_qp_offset", self.cqp_offset))
        return nal(3, 8, w.trailing())

    # reference marking
    def pic_num(self, r) -> int:
        return r["fn"] - self.max_fn if r["fn"] > self.frame_num else r["fn"]

    def ref_list(self):
        shorts = sorted((r for r in self.refs if r["lt"] is None), key=self.pic_num, reverse=True)
        longs = sorted((r for r in self.refs if r["lt"] is not None), key=lambda r: r["lt"])
        return shorts + longs

    def b_lists(self):
        """A B slice's initial lists (8.2.4.2.3): short-term references by
        POC before the current picture (descending), then after it
        (ascending), list 1 the other way round, long-term ones after; list
        1's first two swapped where it equals list 0."""
        shorts = [r for r in self.refs if r["lt"] is None]
        before = sorted((r for r in shorts if r["poc"] <= self.poc), key=lambda r: -r["poc"])
        after = sorted((r for r in shorts if r["poc"] > self.poc), key=lambda r: r["poc"])
        longs = sorted((r for r in self.refs if r["lt"] is not None), key=lambda r: r["lt"])
        l0, l1 = before + after + longs, after + before + longs
        if len(l1) > 1 and l0 == l1:
            l1[0], l1[1] = l1[1], l1[0]
        return l0, l1

    def begin(self, idr: bool, ref: bool, display: int = None):
        """Sets frame_num and POC for the next picture (POC type 0: twice
        ``display``, its place in output order since the IDR, where given;
        else in decoding order); returns its header fields."""
        if idr:
            self.refs, self.max_lt = [], -1
            self.frame_num, self.n_since_idr, self.poc1_offset = 0, 0, 0
            self.prev_fn = 0
        else:
            self.frame_num = (self.prev_ref_fn + 1) % self.max_fn
            if self.frame_num < self.prev_fn:
                self.poc1_offset += self.max_fn
            self.n_since_idr += 1
        self.prev_fn = self.frame_num
        hdr = {"idr": idr, "ref": ref, "frame_num": self.frame_num}
        self.poc = 2 * (self.n_since_idr if display is None else display)
        if self.poc_type == 0:
            hdr["poc_lsb"] = self.poc % (1 << self.log2_poc)
        elif self.poc_type == 1 and not self.poc1_zero:
            # a non-reference picture shares its expected count with the
            # reference before it: one more keeps the output order
            hdr["delta_poc0"] = 0 if ref else 1
        return hdr

    def mark(self, hdr, mmco=None, long_term_idr=False):
        """Reference marking after the picture (8.2.5): the IDR's, the
        sliding window, or the operations ``mmco`` [(op, *args)]."""
        if not hdr["ref"]:
            return
        self.prev_ref_fn = self.frame_num
        cur = {"fn": self.frame_num, "lt": None, "poc": self.poc}
        if hdr["idr"]:
            if long_term_idr:
                cur["lt"], self.max_lt = 0, 0
            self.refs = [cur]
            return
        if mmco is None:
            shorts = [r for r in self.refs if r["lt"] is None]
            if len(self.refs) >= max(self.max_refs, 1) and shorts:
                self.refs.remove(min(shorts, key=self.pic_num))
        else:
            for op in mmco:
                self.apply_mmco(op, cur)
        if cur["lt"] is None or cur not in self.refs:
            if cur["lt"] is not None:
                self.refs = [r for r in self.refs if r["lt"] != cur["lt"]]
            self.refs.append(cur)
        assert len(self.refs) <= self.max_refs, self.refs

    def apply_mmco(self, op, cur):
        k = op[0]
        if k == 1:
            pn = self.frame_num - (op[1] + 1)
            self.refs = [r for r in self.refs if r["lt"] is not None or self.pic_num(r) != pn]
        elif k == 2:
            self.refs = [r for r in self.refs if r["lt"] != op[1]]
        elif k == 3:
            pn = self.frame_num - (op[1] + 1)
            self.refs = [r for r in self.refs if r["lt"] != op[2]]
            for r in self.refs:
                if r["lt"] is None and self.pic_num(r) == pn:
                    r["lt"] = op[2]
        elif k == 4:
            self.max_lt = op[1] - 1
            self.refs = [r for r in self.refs if r["lt"] is None or r["lt"] <= self.max_lt]
        elif k == 6:
            self.refs = [r for r in self.refs if r["lt"] != op[1]]
            cur["lt"] = op[1]

    def random_mmco(self):
        """A valid list of operations for the next reference picture, or
        None (the sliding window); the buffer stays within max_refs."""
        rng = self.rng
        stale = any(r["lt"] is None and self.frame_num - self.pic_num(r) >= self.max_fn // 2
                    for r in self.refs)
        if (rng.random() < 0.5 or self.max_refs < 2) and not stale:
            return None
        shorts = [r for r in self.refs if r["lt"] is None]
        # short-term references half a frame_num cycle old go first: their
        # frame_num must not come round again while they are held
        ops = [(1, self.frame_num - self.pic_num(r) - 1) for r in shorts
               if self.frame_num - self.pic_num(r) >= self.max_fn // 2]
        shorts = [r for r in shorts if self.frame_num - self.pic_num(r) < self.max_fn // 2]
        nlong = sum(r["lt"] is not None for r in self.refs)
        if self.max_lt < 1 and rng.random() < 0.7:
            ops.append((4, 2))  # long-term indices 0 and 1
        max_lt = ops[-1][1] - 1 if ops else self.max_lt
        choice = rng.integers(0, 4)
        if choice == 0 and shorts and max_lt >= 0:
            r = shorts[rng.integers(len(shorts))]
            ops.append((3, self.frame_num - self.pic_num(r) - 1, int(rng.integers(max_lt + 1))))
        elif choice == 1 and nlong:
            r = [r for r in self.refs if r["lt"] is not None][0]
            ops.append((2, r["lt"]))
        elif choice == 2 and max_lt >= 0:
            ops.append((6, int(rng.integers(max_lt + 1))))
        elif shorts:
            r = shorts[rng.integers(len(shorts))]
            ops.append((1, self.frame_num - self.pic_num(r) - 1))
        # replay to keep the buffer within max_refs
        saved = ([dict(r) for r in self.refs], self.max_lt)
        cur = {"fn": self.frame_num, "lt": None, "poc": self.poc}
        for op in ops:
            self.apply_mmco(op, cur)
        n = len(self.refs) + (1 if cur["lt"] is None or
                              not any(r["lt"] == cur["lt"] for r in self.refs) else 0)
        while n > self.max_refs:
            shorts = [r for r in self.refs if r["lt"] is None]
            if shorts:
                r = min(shorts, key=self.pic_num)
                op = (1, self.frame_num - self.pic_num(r) - 1)
            else:
                r = [r for r in self.refs if r["lt"] != cur["lt"]][0]
                op = (2, r["lt"])
            self.apply_mmco(op, cur)
            ops.append(op)
            n -= 1
        self.refs, self.max_lt = saved
        return ops


def _avail(ctx, mb, dx, dy, intra_rule):
    """The neighbour macroblock (dx, dy) of ``mb`` if available (same slice;
    with ``intra_rule`` and constrained_intra_pred_flag, intra only)."""
    x, y = mb % ctx.mb_w + dx, mb // ctx.mb_w + dy
    if not (0 <= x < ctx.mb_w and 0 <= y < ctx.mb_h):
        return None
    n = y * ctx.mb_w + x
    if ctx.slice_of[n] != ctx.slice_id or n >= mb:
        return None
    if intra_rule and ctx.seq.constrained and ctx.kind[n] not in INTRA:
        return None
    return n


class Picture:
    """The macroblock state of the picture being written: what the next
    macroblock's syntax depends on (slices, types, coefficient counts,
    intra modes, motion)."""

    def __init__(self, seq: Sequence, hdr: dict):
        self.seq, self.hdr = seq, hdr
        self.mb_w, self.mb_h, n = seq.mb_w, seq.mb_h, seq.nmb
        self.slice_of = np.full(n, -1)
        self.slice_id = -1
        self.kind = [None] * n
        self.tc = np.zeros((n, 16), int)        # luma 4x4 blocks' TotalCoeff
        self.tcc = np.zeros((n, 2, 4), int)     # chroma AC blocks'
        self.modes = np.full((n, 16), 2)        # Intra4x4PredMode (Intra 8x8: over its 4x4s)
        self.t8 = np.zeros(n, bool)             # transform_size_8x8_flag
        self.mv = np.zeros((n, 2, 2), int)      # natural mode: a vector a list a macroblock
        self.refidx = np.full((n, 2), -1)       # ... and its ref_idx (-1: list not used)
        # what CABAC's context index increments read of a macroblock
        self.cbp = np.zeros(n, int)             # luma bits | chroma << 4
        self.cmode = np.zeros(n, int)           # intra_chroma_pred_mode
        self.cbf_dc = np.zeros((n, 3), int)     # coded_block_flag: Intra16x16 DC, Cb DC, Cr DC
        self.ref4 = np.full((n, 2, 16), -1)     # ref_idx of each 4x4 block, per list
        self.amvd = np.zeros((n, 2, 16, 2), int)  # absMvdComp of each 4x4 block, per list
        self.direct = np.zeros((n, 16), bool)   # a direct-predicted 4x4 block
        self.direct16 = np.zeros(n, bool)       # B_Skip or B_Direct_16x16
        self.dq = np.zeros(n, int)              # mb_qp_delta
        self.nals = []

    # neighbours
    def avail(self, mb, dx, dy, intra_rule=False):
        return _avail(self, mb, dx, dy, intra_rule)

    def intra_avail(self, mb):
        """(A, B, C, D) availability for intra prediction."""
        return tuple(self.avail(mb, dx, dy, True) is not None
                     for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, -1)))

    def _block_nb(self, mb, blk, dx, dy):
        x, y = BLK_X[blk] + dx, BLK_Y[blk] + dy
        if 0 <= x < 4 and 0 <= y < 4:
            return mb, BLK_AT[(x, y)]
        n = self.avail(mb, -1 if x < 0 else 0, -1 if y < 0 else 0)
        return None if n is None else (n, BLK_AT[(x % 4, y % 4)])

    def _count(self, n, blk, chroma=None):
        if self.kind[n] == "PCM":
            return 16
        return self.tcc[n, chroma, blk] if chroma is not None else self.tc[n, blk]

    def nc_luma(self, mb, blk):
        a, b = self._block_nb(mb, blk, -1, 0), self._block_nb(mb, blk, 0, -1)
        for nb, side in ((a, "A"), (b, "B")):
            if nb is not None and nb[0] != mb and self.t8[nb[0]] != self.t8[mb]:
                COVERAGE[("nc_mixed", side, int(self.t8[mb]), int(self.t8[nb[0]]))] += 1
        na = None if a is None else self._count(*a)
        nb = None if b is None else self._count(*b)
        return _nc(na, nb)

    def nc_chroma(self, mb, c, blk):
        bx, by = blk & 1, blk >> 1
        if bx:
            na = self._count(mb, blk - 1, c)
        else:
            n = self.avail(mb, -1, 0)
            na = None if n is None else self._count(n, by * 2 + 1, c)
        if by:
            nb = self._count(mb, blk - 2, c)
        else:
            n = self.avail(mb, 0, -1)
            nb = None if n is None else self._count(n, 2 + bx, c)
        return _nc(na, nb)

    def pred_mode4(self, mb, blk, size: int = 4, count: bool = True):
        """Intra4x4PredMode's prediction of block ``blk``, or (``size`` 8)
        Intra8x8PredMode's of the 8x8 block whose first 4x4 block it is: the
        4x4 blocks left of and above it (an Intra 8x8 macroblock holds its
        modes over its 4x4 blocks). ``count``: a written block (COVERAGE)."""
        out = []
        for dx, dy in ((-1, 0), (0, -1)):
            x, y = BLK_X[blk] + dx, BLK_Y[blk] + dy
            if 0 <= x < 4 and 0 <= y < 4:
                out.append(self.modes[mb, BLK_AT[(x, y)]])
                continue
            n = self.avail(mb, -1 if x < 0 else 0, -1 if y < 0 else 0, True)
            if n is None:
                return 2
            if count and self.kind[n] in NXN and self.kind[n] != ("I4" if size == 4 else "I8"):
                COVERAGE[("mode_pred_mixed", size, self.kind[n], "A" if dx else "B")] += 1
            out.append(self.modes[n, BLK_AT[(x % 4, y % 4)]] if self.kind[n] in NXN else 2)
        return min(out)

    # slices
    def slice(self, first: int, count: int, typ: str, choose, qp=None, deblock=(0, 0, 0),
              num_ref=None, modifications=(), mmco=None, long_term_idr=False,
              slice_type_code=None, cabac_init_idc=None, num_ref1=None, modifications1=(),
              direct_spatial=True, weights=None):
        """Writes one slice of ``count`` macroblocks from ``first``;
        ``choose(pic, mb, qp)`` gives each macroblock's syntax (a dict).
        A CABAC P or B slice draws its cabac_init_idc unless given one. A B
        slice has list 1's size and modifications besides list 0's, and
        direct_spatial_mv_pred_flag; ``weights`` is the pred_weight_table
        of a P slice under weighted_pred_flag or a B slice under
        weighted_bipred_idc 1: (luma logWD, chroma logWD, [list][ref_idx]
        (luma (w, o) or None, chroma ((w, o), (w, o)) or None))."""
        seq, hdr = self.seq, self.hdr
        self.slice_id += 1
        w = BitWriter()
        w.ue(first)
        w.ue(slice_type_code if slice_type_code is not None else {"P": 0, "B": 1, "I": 2}[typ])
        w.ue(0)
        w.u(seq.log2_fn, hdr["frame_num"])
        if hdr["idr"]:
            w.ue(hdr.get("idr_pic_id", 0))
        if seq.poc_type == 0:
            w.u(seq.log2_poc, hdr["poc_lsb"])
        elif seq.poc_type == 1 and not seq.poc1_zero:
            w.se(hdr["delta_poc0"])
        self.num_ref = self.num_ref1 = 0
        if typ == "B":
            w.u(1, int(direct_spatial))
            COVERAGE[("b_direct", seq.entropy, "spatial" if direct_spatial else "temporal")] += 1
        if typ in ("P", "B"):
            nref = num_ref or seq.num_ref_default
            nref1 = (num_ref1 or seq.num_ref_default1) if typ == "B" else 0
            self.num_ref, self.num_ref1 = nref, nref1
            override = nref != seq.num_ref_default or (typ == "B" and nref1 != seq.num_ref_default1)
            w.u(1, int(override))
            if override:
                w.ue(nref - 1)
                if typ == "B":
                    w.ue(nref1 - 1)
            for lst, mods in enumerate((modifications, modifications1)[:1 + (typ == "B")]):
                w.u(1, int(bool(mods)))
                if mods:
                    COVERAGE[("list_modification", typ, lst)] += 1
                    for idc, v in mods:
                        w.ue(idc)
                        w.ue(v)
                    w.ue(3)
        if (typ == "P" and seq.weighted) or (typ == "B" and seq.bipred == 1):
            self._write_weights(w, weights, typ)
        if hdr["ref"]:
            if hdr["idr"]:
                w.u(1, 0)
                w.u(1, int(long_term_idr))
            else:
                w.u(1, int(mmco is not None))
                if mmco is not None:
                    for op in mmco:
                        w.ue(op[0])
                        for a in op[1:]:
                            w.ue(a)
                    w.ue(0)
        cabac = seq.entropy == "cabac"
        if cabac and typ != "I":
            if cabac_init_idc is None:
                cabac_init_idc = int(seq.cabac_rng.integers(0, 3))
            w.ue(cabac_init_idc)
        qp = seq.qp if qp is None else qp
        w.se(qp - seq.qp)
        w.ue(deblock[0])
        if deblock[0] != 1:
            w.se(deblock[1])
            w.se(deblock[2])
        nal_type = 5 if hdr["idr"] else 1
        if cabac:
            while w.n % 8:
                w.u(1, 1)  # cabac_alignment_one_bit
            tag = "I" if typ == "I" else CABAC_TAGS[1 + min(cabac_init_idc, 2)]
            e = CabacEncoder(w, qp, tag)
            self.span = (first, first + count - 1)
            for mb in range(first, first + count):
                self.slice_of[mb] = self.slice_id
                spec = choose(self, mb, qp)
                skip = False
                if typ != "I":
                    skip = spec["kind"] == "SKIP"
                    a, b = self.avail(mb, -1, 0), self.avail(mb, 0, -1)
                    inc = sum(n is not None and self.kind[n] != "SKIP" for n in (a, b))
                    e.decision((24 if typ == "B" else 11) + inc, int(skip))
                    if skip:
                        self._skipped(mb, typ)
                if not skip:
                    qp = self.write_mb_cabac(e, mb, spec, qp, typ)
                e.terminate(int(mb == first + count - 1))  # end_of_slice_flag
            self.nals.append(nal(2 if hdr["ref"] else 0, nal_type, w.aligned()))
            return
        skip = 0
        for mb in range(first, first + count):
            self.slice_of[mb] = self.slice_id
            spec = choose(self, mb, qp)
            if typ != "I" and spec["kind"] == "SKIP":
                self._skipped(mb, typ)
                skip += 1
                continue
            if typ != "I":
                w.ue(skip)
                skip = 0
            qp = self.write_mb(w, mb, spec, qp, typ)
        if skip:
            w.ue(skip)
        self.nals.append(nal(2 if hdr["ref"] else 0, nal_type, w.trailing()))

    def _skipped(self, mb: int, typ: str):
        """P_Skip (list 0's ref_idx 0) or B_Skip (direct)."""
        self.kind[mb] = "SKIP"
        if typ == "B":
            self.direct[mb] = self.direct16[mb] = True
            COVERAGE[("b_mb_type", "SKIP")] += 1
        else:
            self.ref4[mb, 0] = 0
            COVERAGE[("mb_type", "SKIP")] += 1

    def _write_weights(self, w: BitWriter, weights, typ: str):
        """pred_weight_table (7.3.3.2): ``weights`` as ``slice`` takes it
        (None: the logWDs 0 and no flag set)."""
        lw, cw, tabs = weights if weights is not None else (0, 0, [[], []])
        w.ue(lw)
        w.ue(cw)
        for lst in range(2 if typ == "B" else 1):
            for i in range(self.num_ref1 if lst else self.num_ref):
                luma, chroma = tabs[lst][i] if i < len(tabs[lst]) else (None, None)
                w.u(1, int(luma is not None))
                if luma is not None:
                    w.se(luma[0])
                    w.se(luma[1])
                w.u(1, int(chroma is not None))
                if chroma is not None:
                    for wo in chroma:
                        w.se(wo[0])
                        w.se(wo[1])
                COVERAGE[("pred_weight", typ, lst, luma is not None, chroma is not None)] += 1

    def _b_parts(self, s: dict):
        """A B macroblock's partitions in decoding order: (x, y, w, h, lists,
        sub-macroblock or -1); a direct sub-macroblock as one entry with
        lists 0."""
        kind = s["kind"]
        if kind in B_PARTS:
            n, pw, ph = B_PARTS[kind]
            return [(2 * p if kind == "B8x16" else 0, 2 * p if kind == "B16x8" else 0, pw, ph,
                     s["preds"][p], -1) for p in range(n)]
        out = []
        for i, t in enumerate(s["subs"]):
            lists, shape = B_SUB[t]
            np_, sw, sh = SUB_PARTS[shape]
            for k in range(np_ if lists else 1):
                dx = (k & 1) if shape in (2, 3) else 0
                dy = k if shape == 1 else (k >> 1) if shape == 3 else 0
                out.append((2 * (i % 2) + dx, 2 * (i // 2) + dy, sw, sh, lists, i))
        return out

    def _b_syntax(self, mb: int, s: dict):
        """The ref_idx (per list: (x, y, blocks, value)) and mvds (per list:
        (x, y, blocks, (mx, my))) of a B macroblock in syntax order, the
        direct blocks marked."""
        parts = self._b_parts(s) if s["kind"] != "BDIRECT" else []
        if s["kind"] == "BDIRECT":
            self.direct[mb] = self.direct16[mb] = True
        refs, mvds = [[], []], [[], []]
        k_mvd = [0, 0]
        seen = [set(), set()]
        for (x, y, pw, ph, lists, sub) in parts:
            if not lists:
                for j in range(2):
                    for i in range(2):
                        self.direct[mb, BLK_AT[(x + i, y + j)]] = True
                continue
            blocks = [BLK_AT[(i, j)] for j in range(y, y + ph) for i in range(x, x + pw)]
            for lst in range(2):
                if not lists >> lst & 1:
                    continue
                unit = sub if sub >= 0 else (x, y)
                if unit not in seen[lst]:
                    seen[lst].add(unit)
                    rb = blocks if sub < 0 else [BLK_AT[(2 * (sub % 2) + i, 2 * (sub // 2) + j)]
                                                 for j in range(2) for i in range(2)]
                    ref = s["refs"][lst][len(refs[lst])]
                    refs[lst].append((x, y, rb, ref))
                mvds[lst].append((x, y, blocks, s["mvds"][lst][k_mvd[lst]]))
                k_mvd[lst] += 1
        return refs, mvds

    def write_mb(self, w: BitWriter, mb: int, s: dict, qp: int, typ: str) -> int:
        kind = s["kind"]
        self.kind[mb] = kind
        off = {"P": 5, "B": 23, "I": 0}[typ]
        if kind == "PCM":
            w.ue(off + 25)
            COVERAGE[("mb_type", "PCM")] += 1
            self.w_pcm(w, s["pcm"])
            self.tc[mb] = 16
            self.tcc[mb] = 16
            return qp
        cbp_l, cbp_c = s.get("cbp_l", 0), s.get("cbp_c", 0)
        t8 = bool(s.get("t8", False))
        if kind in NXN:
            w.ue(off)
            COVERAGE[("mb_type", kind)] += 1
            if self.seq.t8:
                w.u(1, int(kind == "I8"))
            self.t8[mb] = kind == "I8"
            for blk, m, pm in self._nxn_modes(mb, s):
                if m == pm:
                    w.u(1, 1)
                else:
                    w.u(1, 0)
                    w.u(3, m if m < pm else m - 1)
            w.ue(s["chroma_mode"])
            COVERAGE[("intra_chroma", s["chroma_mode"])] += 1
        elif kind == "I16":
            assert cbp_l in (0, 15)
            w.ue(off + 1 + s["mode16"] + 4 * cbp_c + (12 if cbp_l else 0))
            COVERAGE[("mb_type", "I16", s["mode16"], cbp_c, cbp_l)] += 1
            w.ue(s["chroma_mode"])
            COVERAGE[("intra_chroma", s["chroma_mode"])] += 1
        elif kind in B_TYPES:
            t = b_mb_type(kind, s.get("preds"))
            w.ue(t)
            COVERAGE[("b_mb_type", t)] += 1
            for st in s.get("subs", ()) if kind == "B8x8" else ():
                w.ue(st)
                COVERAGE[("b_sub_mb_type", st)] += 1
            refs, mvds = self._b_syntax(mb, s)
            for lst in range(2):
                nref = self.num_ref1 if lst else self.num_ref
                for x, y, blocks, r in refs[lst]:
                    if nref > 1:
                        w.te(nref - 1, r)
                    self.ref4[mb, lst, blocks] = r
            for lst in range(2):
                for x, y, blocks, (mx, my) in mvds[lst]:
                    w.se(mx)
                    w.se(my)
        else:
            w.ue(P_TYPES[kind])
            COVERAGE[("mb_type", kind)] += 1
            nref = self.num_ref
            if kind in MB_PARTS:
                nparts = MB_PARTS[kind][0]
                if nref > 1:
                    for r in s["refs"][:nparts]:
                        w.te(nref - 1, r)
                for mx, my in s["mvds"]:
                    w.se(mx)
                    w.se(my)
            else:
                for t in s["subs"]:
                    w.ue(t)
                    COVERAGE[("sub_mb_type", t)] += 1
                if nref > 1 and kind == "P8x8":
                    for r in s["refs"]:
                        w.te(nref - 1, r)
                for mx, my in s["mvds"]:
                    w.se(mx)
                    w.se(my)
        if kind != "I16":
            cbp = cbp_l | cbp_c << 4
            w.ue(INTRA_CBP_CODE[cbp] if kind in NXN else INTER_CBP_CODE[cbp])
            if self._t8_flag(mb, s):
                w.u(1, int(t8))
        self.tc[mb] = 0
        self.tcc[mb] = 0
        if cbp_l or cbp_c or kind == "I16":
            dq = s.get("qp_delta", 0)
            w.se(dq)
            qp = (qp + dq + 52) % 52
            L = s["levels"]
            if kind == "I16":
                write_block(w, self.nc_luma(mb, 0), L["dc"], 16)
            for blk in range(16):
                if not cbp_l >> (blk // 4) & 1:
                    continue
                if self.t8[mb]:  # coefficient 4 i + k of an 8x8 block: the k-th block's i-th
                    co = L["luma8"][blk // 4][blk % 4::4]
                else:
                    co = L["luma"][blk]
                self.tc[mb, blk] = write_block(w, self.nc_luma(mb, blk), co, len(co))
            if cbp_c:
                for c in range(2):
                    write_block(w, -1, L["cdc"][c], 4)
            if cbp_c == 2:
                for c in range(2):
                    for b in range(4):
                        self.tcc[mb, c, b] = write_block(w, self.nc_chroma(mb, c, b),
                                                         L["cac"][c][b], 15)
        return qp

    def _nxn_modes(self, mb, s):
        """(block, mode, predicted mode) of an I_NxN macroblock's 16 4x4 or
        4 8x8 blocks in decoding order, its modes recorded as it goes."""
        size = 8 if s["kind"] == "I8" else 4
        for k, m in enumerate(s["modes"]):
            blk = 4 * k if size == 8 else k
            pm = self.pred_mode4(mb, blk, size)
            COVERAGE[("intra4x4" if size == 4 else "intra8x8", m)] += 1
            if size == 8:
                a, b, c, d = self.intra_avail(mb)
                tr = (b, c, True, False)[k]
                COVERAGE[("intra8x8_at", m, k, int(tr))] += 1
                # the reference filter's cases (8.3.2.2.1): the corner's
                # rule by the top and left samples' availability
                ta, la, tla = k >= 2 or b, k & 1 or a, (d, b, a, True)[k]
                COVERAGE[("intra8x8_refs", int(bool(ta)), int(bool(la)), int(bool(tla)))] += 1
            self.modes[mb, blk:blk + (4 if size == 8 else 1)] = m
            yield blk, m, pm

    def _t8_flag(self, mb, s) -> bool:
        """Whether an inter macroblock carries transform_size_8x8_flag (7.3.5):
        luma coefficients and no partition below 8x8 (a direct one counting
        as 8x8 under direct_8x8_inference_flag, B_Direct_16x16 only under
        it); records the flag."""
        kind = s["kind"]
        if kind not in INTER:
            return False
        d8 = self.seq.direct8x8
        if kind in P_TYPES:
            small = kind not in MB_PARTS and any(s["subs"])
        elif kind == "B8x8":
            small = any(B_SUB[t][1] or (not B_SUB[t][0] and not d8) for t in s["subs"])
        else:
            small = kind == "BDIRECT" and not d8
        has = self.seq.t8 and s.get("cbp_l", 0) > 0 and not small
        assert has or not s.get("t8"), s
        self.t8[mb] = bool(s.get("t8")) and has
        if self.t8[mb]:
            COVERAGE[("transform_8x8", "P", kind)] += 1
        return has

    # CABAC (9.3.2, 9.3.3.1): each syntax element's binarisation, with the
    # context index increments the decoder derives from the same neighbours
    def _nb4(self, mb, x, y):
        """The macroblock (None if not available; ``mb`` itself inside it)
        and the block index of the 4x4 block (x, y), x or y -1 reaching into
        macroblock A or B."""
        if x < 0:
            n = self.avail(mb, -1, 0)
        elif y < 0:
            n = self.avail(mb, 0, -1)
        else:
            n = mb
        return n, BLK_AT[(x % 4, y % 4)]

    def _intra_type_cabac(self, e, mb, t: int, typ: str):
        """An I mb_type (0 I_NxN, 1-24 I_16x16, 25 I_PCM): contexts 3-10 in
        an I slice (bin 0 by whether A and B are coded other than I_NxN),
        17-20 as a P slice's suffix, 32-35 as a B slice's; bin 1 the
        terminate bin."""
        COVERAGE[("cabac_mb_type", typ, t)] += 1
        islice, base = typ == "I", 17 if typ == "P" else 32
        if islice:
            inc = sum(n is not None and self.kind[n] not in NXN
                      for n in (self.avail(mb, -1, 0), self.avail(mb, 0, -1)))
            e.decision(3 + inc, int(t != 0))
        else:
            e.decision(base, int(t != 0))
        if t == 0:
            return
        e.terminate(int(t == 25))
        if t == 25:
            return
        mode, cc, cl = (t - 1) % 4, (t - 1) // 4 % 3, int(t >= 13)
        e.decision(6 if islice else base + 1, cl)
        e.decision(7 if islice else base + 2, int(cc > 0))
        if cc:
            e.decision(8 if islice else base + 2, int(cc == 2))
        e.decision(9 if islice else base + 3, mode >> 1)
        e.decision(10 if islice else base + 3, mode & 1)

    def _b_type_cabac(self, e, mb, t: int):
        """A B mb_type (Table 9-37): bin 0 by whether A and B are coded
        other than B_Skip and B_Direct_16x16 (27-29), then contexts 30-32 as
        FFmpeg's decode_cabac_mb_type_b reads them; t 23 + an I type."""
        inc = sum(n is not None and not self.direct16[n]
                  for n in (self.avail(mb, -1, 0), self.avail(mb, 0, -1)))
        COVERAGE[("cabac_b_mb_type", min(t, 23))] += 1
        e.decision(27 + inc, int(t != 0))
        if t == 0:
            return
        e.decision(30, int(t > 2))
        if t <= 2:
            e.decision(32, t - 1)
            return
        if t >= 23:
            bits, extra = 13, None
        elif t <= 10:
            bits, extra = t - 3, None
        elif t == 11:
            bits, extra = 14, None
        elif t == 22:
            bits, extra = 15, None
        else:
            bits, extra = (t + 4) >> 1, (t + 4) & 1
        for k, ctx in zip((3, 2, 1, 0), (31, 32, 32, 32)):
            e.decision(ctx, bits >> k & 1)
        if extra is not None:
            e.decision(32, extra)
        if t >= 23:
            self._intra_type_cabac(e, mb, t - 23, "B")

    def _b_sub_cabac(self, e, t: int):
        """A B sub_mb_type (Table 9-38), contexts 36-39."""
        COVERAGE[("cabac_b_sub_mb_type", t)] += 1
        e.decision(36, int(t != 0))
        if t == 0:
            return
        e.decision(37, int(t >= 3))
        if t < 3:
            e.decision(39, t - 1)
            return
        big = t >= 7
        e.decision(38, int(big))
        if t >= 11:
            e.decision(39, 1)
            e.decision(39, t - 11)
            return
        if big:
            e.decision(39, 0)
        v = t - (7 if big else 3)
        e.decision(39, v >> 1)
        e.decision(39, v & 1)

    def _ref_cabac(self, e, mb, x, y, r: int, lst: int = 0):
        """ref_idx (U) in list ``lst`` of the partition at (x, y): bin 0 by
        whether A's and B's refIdx exceed 0 (a coded inter macroblock's
        block that is not direct-predicted)."""
        def term(dx, dy):
            n, b = self._nb4(mb, x + dx, y + dy)
            return int(n is not None and self.kind[n] in INTER and not self.direct[n, b]
                       and self.ref4[n, lst, b] > 0)
        e.decision(54 + term(-1, 0) + 2 * term(0, -1), int(r > 0))
        for k in range(1, r + 1):
            e.decision(58 if k == 1 else 59, int(k < r))
        COVERAGE[("cabac_ref_idx", min(r, 2))] += 1

    def _mvd_cabac(self, e, mb, x, y, comp: int, v: int, lst: int = 0):
        """mvd (UEG3, signed, prefix of 9) in list ``lst`` of the partition
        at (x, y): bin 0 by absMvdComp of A plus B against 3 and 32."""
        (na, ba), (nb, bb) = self._nb4(mb, x - 1, y), self._nb4(mb, x, y - 1)
        s = sum(0 if n is None else int(self.amvd[n, lst, b, comp])
                for n, b in ((na, ba), (nb, bb)))
        base, a = 47 if comp else 40, abs(v)
        e.decision(base + (0 if s < 3 else 2 if s > 32 else 1), int(a > 0))
        if not a:
            return
        for k in range(1, min(a, 9)):
            e.decision(base + min(k + 2, 6), 1)
        if a < 9:
            e.decision(base + min(a + 2, 6), 0)
        else:
            e.exp_golomb(a - 9, 3)
            COVERAGE[("cabac_mvd_escape", comp)] += 1
        e.bypass(int(v < 0))

    def _cbf_term(self, mb, cat, idx, dx, dy) -> int:
        """coded_block_flag's condTermFlagN (9.3.3.1.1.9) of the block left
        (dx -1) or above (dy -1) of block ``idx`` of category ``cat``."""
        intra = self.kind[mb] in INTRA
        if cat in (0, 3):
            n = self.avail(mb, dx, dy)
        elif cat == 4:
            c, b = idx >> 2, idx & 3
            x, y = (b & 1) + dx, (b >> 1) + dy
            if x >= 0 and y >= 0:
                return int(self.tcc[mb, c, 2 * y + x] != 0)
            n = self.avail(mb, dx, dy)
            if n is not None and self.kind[n] != "PCM":
                return int(self.tcc[n, c, 2 * (y % 2) + x % 2] != 0)
        else:
            n, b = self._nb4(mb, BLK_X[idx] + dx, BLK_Y[idx] + dy)
            if n is not None and self.kind[n] != "PCM" and n != mb and self.t8[n]:
                # a neighbour 8x8 block: its flag is inferred 1 where coded
                bit = int(self.cbp[n] >> (b // 4) & 1)
                COVERAGE[("cbf_from_8x8", "A" if dx else "B", bit)] += 1
                return bit
            if n is not None and self.kind[n] != "PCM":
                return int(self.tc[n, b] != 0)
        if n is None:
            return int(intra)
        if self.kind[n] == "PCM":
            return 1
        if cat == 0:
            return int(self.kind[n] == "I16" and self.cbf_dc[n, 0] != 0)
        return int(self.cbf_dc[n, 1 + idx] != 0)

    def _block_cabac(self, e, mb, cat: int, idx: int, coeffs) -> int:
        """residual_block_cabac of ``coeffs`` (scan order): coded_block_flag,
        the significance map, then the levels in reverse (coeff_abs_level
        _minus1: TU prefix of 14 and EG0, the sign in bypass); returns the
        nonzero coefficients."""
        maxn = len(coeffs)
        nz = [i for i, c in enumerate(coeffs) if c]
        if cat == 5:  # no coded_block_flag: a coded 8x8 block has a coefficient
            assert nz
            T = _high_tables()
            sig = [402 + int(v) for v in T["sig8"]]
            lst = [417 + int(v) for v in T["last8"]]
            base = 426
        else:
            inc = self._cbf_term(mb, cat, idx, -1, 0) + 2 * self._cbf_term(mb, cat, idx, 0, -1)
            e.decision(85 + CBF_OFF[cat] + inc, int(bool(nz)))
            if not nz:
                return 0
            k = [min(i, 2) if cat == 3 else i for i in range(maxn - 1)]
            sig = [105 + SIG_OFF[cat] + v for v in k]
            lst = [166 + SIG_OFF[cat] + v for v in k]
            base = 227 + ABS_OFF[cat]
        last = nz[-1]
        for i in range(min(last + 1, maxn - 1)):
            e.decision(sig[i], int(coeffs[i] != 0))
            if coeffs[i]:
                e.decision(lst[i], int(i == last))
        eq1, gt1 = 0, 0
        for i in reversed(nz):
            v = abs(coeffs[i]) - 1
            e.decision(base + (0 if gt1 else min(4, 1 + eq1)), int(v > 0))
            if v:
                ctx = base + 5 + min(4 - (cat == 3), gt1)
                for _ in range(1, min(v, 14)):
                    e.decision(ctx, 1)
                if v < 14:
                    e.decision(ctx, 0)
                else:
                    e.exp_golomb(v - 14, 0)
                    COVERAGE[("cabac_level_escape", cat)] += 1
                gt1 += 1
            else:
                eq1 += 1
            e.bypass(int(coeffs[i] < 0))
        return len(nz)

    def write_mb_cabac(self, e: CabacEncoder, mb: int, s: dict, qp: int, typ: str) -> int:
        """macroblock_layer under CABAC: the syntax of ``write_mb``."""
        kind = s["kind"]
        self.kind[mb] = kind
        a, b = self.avail(mb, -1, 0), self.avail(mb, 0, -1)
        cbp_l, cbp_c = s.get("cbp_l", 0), s.get("cbp_c", 0)
        t8_inc = sum(n is not None and bool(self.t8[n]) for n in (a, b))
        if kind in INTRA:
            t = 0 if kind in NXN else 25 if kind == "PCM" else \
                1 + s["mode16"] + 4 * cbp_c + (12 if cbp_l else 0)
            if typ == "P":
                e.decision(14, 1)
            if typ == "B":
                self._b_type_cabac(e, mb, 23 + t)
            else:
                self._intra_type_cabac(e, mb, t, typ)
            if kind in NXN and self.seq.t8:
                e.decision(399 + t8_inc, int(kind == "I8"))
            self.t8[mb] = kind == "I8"
        elif kind in B_TYPES:
            self._b_type_cabac(e, mb, b_mb_type(kind, s.get("preds")))
        else:
            assert kind in P_TYPES and kind != "P8x8ref0", kind
            COVERAGE[("cabac_mb_type", "P", kind)] += 1
            e.decision(14, 0)
            e.decision(15, int(kind in ("P16x8", "P8x16")))
            if kind in ("P16x8", "P8x16"):
                e.decision(17, int(kind == "P16x8"))
            else:
                e.decision(16, int(kind == "P8x8"))
        if kind == "PCM":
            first, last = self.span
            for where, hit in (("first", mb == first), ("last", mb == last),
                               ("mid_row", 0 < mb % self.mb_w < self.mb_w - 1)):
                if hit:
                    COVERAGE[("cabac_pcm", where)] += 1
            self.w_pcm(e.w, s["pcm"])
            e.start()
            self.tc[mb] = 16
            self.tcc[mb] = 16
            return qp
        if kind in NXN:
            for blk, m, pm in self._nxn_modes(mb, s):
                e.decision(68, int(m == pm))
                if m != pm:
                    rem = m if m < pm else m - 1
                    for k in range(3):
                        e.decision(69, (rem >> k) & 1)
        if kind in INTRA:
            mc = s["chroma_mode"]
            COVERAGE[("intra_chroma", mc)] += 1
            inc = sum(n is not None and self.kind[n] in ("I4", "I8", "I16") and self.cmode[n] != 0
                      for n in (a, b))
            e.decision(64 + inc, int(mc > 0))
            if mc:
                e.decision(67, int(mc > 1))
                if mc > 1:
                    e.decision(67, int(mc > 2))
            self.cmode[mb] = mc
        elif kind in B_TYPES:
            for st in s.get("subs", ()) if kind == "B8x8" else ():
                self._b_sub_cabac(e, st)
            refs, mvds = self._b_syntax(mb, s)
            for lst in range(2):
                nref = self.num_ref1 if lst else self.num_ref
                for x, y, blocks, r in refs[lst]:
                    if nref > 1:
                        self._ref_cabac(e, mb, x, y, r, lst)
                    self.ref4[mb, lst, blocks] = r
            for lst in range(2):
                for x, y, blocks, mvd in mvds[lst]:
                    for comp in range(2):
                        self._mvd_cabac(e, mb, x, y, comp, mvd[comp], lst)
                        self.amvd[mb, lst, blocks, comp] = min(abs(mvd[comp]), 64)
        else:
            nref = self.num_ref
            if kind in MB_PARTS:
                n, pw, ph = MB_PARTS[kind]
                parts = [(2 * p if kind == "P8x16" else 0, 2 * p if kind == "P16x8" else 0, pw, ph)
                         for p in range(n)]
                refs = s["refs"][:n]
                mvd_parts = parts
            else:
                for t in s["subs"]:
                    COVERAGE[("cabac_sub_mb_type", t)] += 1
                    e.decision(21, int(t == 0))
                    if t:
                        e.decision(22, int(t > 1))
                        if t > 1:
                            e.decision(23, int(t == 2))
                parts = [(2 * (i % 2), 2 * (i // 2), 2, 2) for i in range(4)]
                refs = s["refs"]
                mvd_parts = []
                for i, t in enumerate(s["subs"]):
                    np_, sw, sh = SUB_PARTS[t]
                    for k in range(np_):
                        dx = (k & 1) if t in (2, 3) else 0
                        dy = k if t == 1 else (k >> 1) if t == 3 else 0
                        mvd_parts.append((2 * (i % 2) + dx, 2 * (i // 2) + dy, sw, sh))
            for (x, y, pw, ph), r in zip(parts, refs):
                if nref > 1:
                    self._ref_cabac(e, mb, x, y, r)
                for j in range(y, y + ph):
                    for i in range(x, x + pw):
                        self.ref4[mb, 0, BLK_AT[(i, j)]] = r
            for (x, y, pw, ph), mvd in zip(mvd_parts, s["mvds"]):
                for comp in range(2):
                    self._mvd_cabac(e, mb, x, y, comp, mvd[comp])
                    for j in range(y, y + ph):
                        for i in range(x, x + pw):
                            self.amvd[mb, 0, BLK_AT[(i, j)], comp] = min(abs(mvd[comp]), 64)
        if kind != "I16":
            # coded_block_pattern: a neighbour's luma 8x8 counts as coded when
            # not available or I_PCM; its chroma as coded only when I_PCM
            def luma(n, b8):
                return int(n is not None and self.kind[n] != "PCM" and not self.cbp[n] >> b8 & 1)

            def chroma(n, bin_):
                return int(n is not None and (self.kind[n] == "PCM" or self.cbp[n] >> 4 > bin_))
            for b8 in range(4):
                ta = (1 - (cbp_l >> (b8 - 1) & 1)) if b8 & 1 else luma(a, b8 + 1)
                tb = (1 - (cbp_l >> (b8 - 2) & 1)) if b8 & 2 else luma(b, b8 + 2)
                e.decision(73 + ta + 2 * tb, cbp_l >> b8 & 1)
            e.decision(77 + chroma(a, 0) + 2 * chroma(b, 0), int(cbp_c > 0))
            if cbp_c:
                e.decision(81 + chroma(a, 1) + 2 * chroma(b, 1), int(cbp_c == 2))
            if self._t8_flag(mb, s):
                e.decision(399 + t8_inc, int(self.t8[mb]))
        self.cbp[mb] = cbp_l | cbp_c << 4
        if cbp_l or cbp_c or kind == "I16":
            dq = s.get("qp_delta", 0)
            if dq in (-26, 25):
                COVERAGE[("cabac_qp_delta", dq)] += 1
            prev = mb - 1 >= 0 and self.slice_of[mb - 1] == self.slice_id and self.dq[mb - 1] != 0
            k = 2 * dq - 1 if dq > 0 else -2 * dq
            e.decision(60 + int(prev), int(k > 0))
            for j in range(1, k + 1):
                e.decision(62 if j == 1 else 63, int(j < k))
            self.dq[mb] = dq
            qp = (qp + dq + 52) % 52
            L = s["levels"]
            if kind == "I16":
                self.cbf_dc[mb, 0] = int(self._block_cabac(e, mb, 0, 0, L["dc"]) > 0)
            for blk in range(16):
                if not cbp_l >> (blk // 4) & 1:
                    continue
                if self.t8[mb]:
                    if blk % 4 == 0:
                        self.tc[mb, blk:blk + 4] = self._block_cabac(e, mb, 5, blk // 4,
                                                                     L["luma8"][blk // 4])
                else:
                    self.tc[mb, blk] = self._block_cabac(e, mb, 1 if kind == "I16" else 2, blk,
                                                         L["luma"][blk])
            if cbp_c:
                for c in range(2):
                    self.cbf_dc[mb, 1 + c] = int(self._block_cabac(e, mb, 3, c, L["cdc"][c]) > 0)
            if cbp_c == 2:
                for c in range(2):
                    for bk in range(4):
                        self.tcc[mb, c, bk] = self._block_cabac(e, mb, 4, 4 * c + bk,
                                                                L["cac"][c][bk])
        return qp

    @staticmethod
    def w_pcm(w: BitWriter, samples):
        """pcm_alignment_zero_bits and the 384 samples."""
        w.align_zero()
        for v in samples:
            w.u(8, int(v))


def _nc(na, nb) -> int:
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    return na if na is not None else nb if nb is not None else 0


# ------------------------------------------------------------ random mode
def _rand_coeffs(rng, maxn: int, big: float) -> list:
    """Scan-ordered coefficients of one block, drawn by their CAVLC
    structure: TotalCoeff, trailing ones, total_zeros, the runs (often all
    or none of the zeros left, so that every run_before entry shows), the
    levels (now and then large: the level escapes)."""
    tc = int(rng.integers(0, maxn + 1)) if rng.random() < 0.7 else int(rng.integers(0, 4))
    if tc == 0:
        return [0] * maxn
    t1 = int(rng.integers(0, min(tc, 3) + 1))
    tz = int(rng.integers(0, maxn - tc + 1))
    runs, zl = [], tz
    for _ in range(tc - 1):
        u = rng.random()
        r = zl if u < 0.25 else 0 if u < 0.5 else int(rng.integers(0, zl + 1))
        runs.append(r)
        zl -= r
    levels = []
    for i in range(tc):
        if i < t1:
            lv = 1
        elif rng.random() < big:
            lv = int(rng.integers(8, 600))
        else:
            lv = int(rng.geometric(0.35)) + (1 if i == t1 and t1 < 3 else 0)
        levels.append(lv if rng.random() < 0.5 else -lv)
    if t1 < 3 and tc > t1 and abs(levels[t1]) == 1:
        levels[t1] *= 2
    out = [0] * maxn
    p = tc + tz - 1
    for i in range(tc):
        out[p] = levels[i]
        p -= 1 + (runs[i] if i < tc - 1 else 0)
    return out


def _fit(coeffs: list, scan_to_raster, qp: int, dc=None, w=None) -> list:
    """The coefficients scaled down (then thinned) until the block's
    transform stays in the 16-bit range (a conforming stream's bound); a
    block of 64 is an 8x8 one. ``w`` the list's weights (flat if None)."""
    co = list(coeffs)
    while True:
        lv = np.zeros(64 if len(co) == 64 else 16, np.int64)
        for k, c in enumerate(co):
            lv[scan_to_raster[k]] = c
        if len(co) == 64:
            _, ok = residual_blocks8(lv[None], qp, w)
        else:
            _, ok = residual_blocks(lv[None], qp, None if dc is None else np.array([dc]), w)
        if ok:
            return co
        nz = [k for k, c in enumerate(co) if c]
        if not nz:
            return co
        if max(abs(c) for c in co) > 1:
            co = [int(c / 2) if abs(c) > 1 else c for c in co]
        else:
            co[nz[-1]] = 0


def random_levels(rng, kind: str, cbp_l: int, cbp_c: int, qp: int, cqp, big: float,
                  t8: bool = False, w4=None, w8=None) -> dict:
    """A macroblock's levels for ``kind``, in range at ``qp``: ``cqp`` the
    chroma QP offset (or the Cb and Cr ones), ``t8`` luma as 8x8 blocks
    ("luma8", scan order: four 4x4 draws interleaved, as CAVLC codes them),
    ``w4`` [6, 16] and ``w8`` [2, 64] the weightScale lists (flat if None)."""
    cqp = (cqp, cqp) if isinstance(cqp, int) else cqp
    inter = int(kind in INTER)
    wl = lambda i: None if w4 is None else w4[3 * inter + i]
    luma_scan = ZIGZAG if kind != "I16" else ZIGZAG[1:]
    out = {"luma": [None] * 16, "luma8": [None] * 4}
    dcv = [None] * 16
    if kind == "I16":
        dc = _rand_coeffs(rng, 16, big)
        while True:
            raster = np.zeros(16, np.int64)
            for k, c in enumerate(dc):
                raster[ZIGZAG[k]] = c
            dcy = luma_dc(raster, qp, 16 if w4 is None else int(w4[0][0]))
            if np.abs(dcy).max() <= RANGE // 4:
                break
            dc = [int(c / 2) for c in dc]  # toward zero: -1 // 2 stays -1
        out["dc"] = dc
        # dcY is in raster order over the blocks (row, column of 4x4 blocks)
        dcv = [int(dcy[4 * BLK_Y[b] + BLK_X[b]]) for b in range(16)]
    for b8 in range(4 if t8 else 0):
        if cbp_l >> b8 & 1:
            co = [0] * 64
            for i4 in range(4):
                co[i4::4] = _rand_coeffs(rng, 16, big)
            if rng.random() < 0.1:  # a DC alone, as smooth content gives
                co = [co[0] or 1] + [0] * 63
            out["luma8"][b8] = _fit(co, ZIGZAG8, qp, None, None if w8 is None else w8[inter])
    for blk in range(0 if t8 else 16):
        if cbp_l >> (blk // 4) & 1:
            co = _rand_coeffs(rng, len(luma_scan), big)
            out["luma"][blk] = _fit(co, luma_scan, qp, dcv[blk], wl(0))
    out["cdc"] = [[0] * 4, [0] * 4]
    out["cac"] = [[[0] * 15 for _ in range(4)] for _ in range(2)]
    if cbp_c:
        for c in range(2):
            qpc = CHROMA_QP[min(max(qp + cqp[c], 0), 51)]
            w0 = 16 if w4 is None else int(wl(1 + c)[0])
            while True:
                d = _rand_coeffs(rng, 4, big)
                if np.abs(chroma_dc(d, qpc, w0)).max() <= RANGE // 4:
                    break
            out["cdc"][c] = d
            dcc = chroma_dc(d, qpc, w0)
            if cbp_c == 2:
                for b in range(4):
                    out["cac"][c][b] = _fit(_rand_coeffs(rng, 15, big), ZIGZAG[1:], qpc,
                                            int(dcc[b]), wl(1 + c))
    return out


def _allowed4(blk, a, b, d):
    x, y = BLK_X[blk], BLK_Y[blk]
    left, top = x > 0 or a, y > 0 or b
    tl = (x > 0 and y > 0) or (x == 0 and y > 0 and a) or (x > 0 and y == 0 and b) or \
        (x == 0 and y == 0 and d)
    return _allowed_modes(top, left, tl)


def _allowed_modes(top, left, tl) -> list:
    modes = [2]
    if top:
        modes += [0, 3, 7]
    if left:
        modes += [1, 8]
    if top and left and tl:
        modes += [4, 5, 6]
    return modes


def _allowed8(b8, a, b, d):
    """Intra8x8 modes of 8x8 block ``b8`` whose samples are available."""
    left, top = (b8 & 1) or a, b8 >= 2 or b
    tl = b8 == 3 or (b8 == 0 and d) or (b8 == 1 and b) or (b8 == 2 and a)
    return _allowed_modes(top, left, tl)


def _allowed16(a, b, d):
    """(Intra16x16 modes, chroma modes) whose samples are available."""
    m16, mc = [2], [0]
    if b:
        m16.append(0)
        mc.append(2)
    if a:
        m16.append(1)
        mc.append(1)
    if a and b and d:
        m16.append(3)
        mc.append(3)
    return m16, mc


class RandomMB:
    """``choose`` of the random mode: draws each macroblock's syntax."""

    def __init__(self, rng, weights: dict, big: float = 0.05, mvd_scale: int = 8,
                 far_mvd: float = 0.05, qp_walk: int = 3, pcm: float = 1.0,
                 qp_ends: float = 0.0, t8_share: float = 0.5):
        self.rng, self.weights, self.big = rng, weights, big
        # with the 8x8 transform: the share of eligible inter macroblocks
        # that use it (and of P_8x8 ones drawn with 8x8 sub-partitions alone)
        self.t8_share = t8_share
        self.mvd_scale, self.far_mvd, self.qp_walk = mvd_scale, far_mvd, qp_walk
        self.qp_ends = qp_ends  # the share of mb_qp_delta drawn as -26 or +25
        self.force_pcm = set()  # macroblocks coded I_PCM whatever is drawn

    def _mvd(self):
        rng = self.rng
        if rng.random() < self.far_mvd:
            return tuple(int(v) for v in rng.integers(-600, 600, 2))
        return tuple(int(v) for v in rng.integers(-self.mvd_scale, self.mvd_scale + 1, 2))

    def __call__(self, pic: Picture, mb: int, qp: int) -> dict:
        rng, typ, seq = self.rng, pic.cur_type, pic.seq
        allowed = {"I": INTRA, "P": INTRA + tuple(P_TYPES) + ("SKIP",),
                   "B": INTRA + B_TYPES + ("SKIP",)}[typ]
        kinds = [k for k in self.weights if k in allowed and (k != "I8" or seq.t8)]
        p = np.array([self.weights[k] for k in kinds], float)
        kind = kinds[rng.choice(len(kinds), p=p / p.sum())]
        # P_8x8ref0 has no CABAC binarisation: P_8x8 with every ref_idx 0
        ref0 = kind == "P8x8ref0"
        if ref0 and (pic.num_ref < 2 or pic.seq.entropy == "cabac"):
            kind = "P8x8"
        if mb in self.force_pcm:
            kind = "PCM"
        s = {"kind": kind}
        a, b, _, d = pic.intra_avail(mb)
        if kind == "PCM":
            s["pcm"] = rng.integers(1, 256, 384)
            return s
        if kind == "SKIP":
            return s
        if kind == "I4":
            s["modes"] = [int(rng.choice(_allowed4(blk, a, b, d))) for blk in range(16)]
        if kind == "I8":
            s["modes"] = [int(rng.choice(_allowed8(b8, a, b, d))) for b8 in range(4)]
        m16, mc = _allowed16(a, b, d)
        if kind in INTRA:
            s["chroma_mode"] = int(rng.choice(mc))
        if kind == "I16":
            s["mode16"] = int(rng.choice(m16))
            s["cbp_l"] = 15 * int(rng.integers(0, 2))
        else:
            s["cbp_l"] = int(rng.integers(0, 16))
        s["cbp_c"] = int(rng.integers(0, 3))
        if kind in MB_PARTS:
            n = MB_PARTS[kind][0]
            s["refs"] = [int(rng.integers(0, max(pic.num_ref, 1))) for _ in range(n)]
            s["mvds"] = [self._mvd() for _ in range(n)]
        elif kind in ("P8x8", "P8x8ref0"):
            s["subs"] = [int(v) for v in rng.integers(0, 4, 4)]
            if seq.t8 and rng.random() < self.t8_share:
                s["subs"] = [0] * 4
            s["refs"] = [int(rng.integers(0, max(pic.num_ref, 1))) for _ in range(4)]
            if ref0:
                s["refs"] = [0] * 4
            s["mvds"] = [self._mvd() for t in s["subs"] for _ in range(SUB_PARTS[t][0])]
        elif kind in B_TYPES:
            self._b_motion(pic, s)
        t8 = kind == "I8"
        if seq.t8 and kind in INTER and s["cbp_l"] and self._t8_ok(s, seq):
            t8 = s["t8"] = bool(rng.random() < self.t8_share)
        if s["cbp_l"] or s["cbp_c"] or kind == "I16":
            dq = int(rng.integers(-self.qp_walk, self.qp_walk + 1))
            if rng.random() < 0.03:
                dq = int(rng.integers(-26, 26))
            if self.qp_ends and rng.random() < self.qp_ends:
                dq = -26 if rng.random() < 0.5 else 25
            s["qp_delta"] = dq
            nqp = (qp + dq + 52) % 52
            s["levels"] = L = random_levels(rng, kind, s["cbp_l"], s["cbp_c"], nqp, seq.cqp,
                                            self.big, t8, seq.w4, seq.w8)
            # an 8x8 block whose levels came out all zero is not coded (CABAC
            # has no syntax for a coded one without a coefficient)
            for b8 in range(4 if t8 else 0):
                if L["luma8"][b8] is not None and not any(L["luma8"][b8]):
                    s["cbp_l"] &= ~(1 << b8)
            if kind in INTER and not s["cbp_l"]:
                s.pop("t8", None)
        return s

    @staticmethod
    def _t8_ok(s: dict, seq) -> bool:
        """No partition below 8x8 (Picture._t8_flag's rule)."""
        kind = s["kind"]
        if kind == "B8x8":
            return all(not B_SUB[t][1] and (B_SUB[t][0] or seq.direct8x8) for t in s["subs"])
        if kind == "BDIRECT":
            return bool(seq.direct8x8)
        return not any(s.get("subs", ()))

    def _b_motion(self, pic, s: dict):
        """A B macroblock's partitions' lists (or sub-types), ref_idx per
        list (one a partition or sub-macroblock using the list) and mvds per
        list (one a partition or sub-partition using it)."""
        rng, kind = self.rng, s["kind"]
        if kind == "BDIRECT":
            return
        if kind == "B16x16":
            s["preds"] = [int(rng.integers(1, 4))]
            units = [(s["preds"][0], 1)]
        elif kind in B_PARTS:
            s["preds"] = list(B_PAIRS[int(rng.integers(0, 9))])
            units = [(p, 1) for p in s["preds"]]
        else:
            s["subs"] = [int(v) for v in rng.integers(0, 13, 4)]
            if pic.seq.t8 and rng.random() < self.t8_share:
                s["subs"] = [int(v) for v in rng.integers(0, 4, 4)]  # 8x8 or direct
            units = [(B_SUB[t][0], SUB_PARTS[B_SUB[t][1]][0]) for t in s["subs"]]
        nref = (pic.num_ref, pic.num_ref1)
        s["refs"] = [[int(rng.integers(0, max(nref[lst], 1))) for p, _ in units if p >> lst & 1]
                     for lst in range(2)]
        s["mvds"] = [[self._mvd() for p, n in units if p >> lst & 1 for _ in range(n)]
                     for lst in range(2)]


def random_stream(width: int, height: int, pictures: int, seed: int = 0, *,
                  weights=None, p_every: int = 1, slices: int = 1, deblock=((0, 0, 0),),
                  max_refs: int = 1, mmco: bool = False, modify: bool = False,
                  long_term_idr: bool = False, nonref: float = 0.0, idr_every: int = 0,
                  big: float = 0.05, mvd_scale: int = 8, far_mvd: float = 0.05,
                  qp_walk: int = 3, seq_args=None, slice_qp=None, edit=None,
                  first_idr: bool = True, reverse_slices: int = -1,
                  partition_nal: int = -1, entropy: str = "cavlc", pcm_places: bool = False,
                  qp_ends: float = 0.0, bframes: int = 0, pyramid: bool = False,
                  direct: str = "spatial") -> tuple:
    """(Sequence, [sample NAL lists]) of a random stream: picture 0 an IDR,
    then P pictures (every ``p_every``-th, the others I), ``slices``
    slices a picture (each drawing its deblocking setting from
    ``deblock``), references up to ``max_refs`` with, on request, memory
    management operations and list modifications; ``nonref`` the share of
    non-reference pictures.

    For streams the decoder must refuse: ``edit(k, header)`` may change
    picture k's header fields and returns options for its slices
    (``slice_type_code``, ``mmco``); ``first_idr`` False codes picture 0 as
    a non-IDR I picture; picture ``reverse_slices`` has its slices in
    reverse order; picture ``partition_nal`` gains a data partition NAL.

    ``entropy`` picks the coder; the draws, and so the pictures, are the
    same for both. ``pcm_places`` codes I_PCM at each slice's first and
    last macroblock and one mid-row; ``qp_ends`` is the share of
    mb_qp_delta drawn at -26 or +25.

    ``bframes`` > 0 codes ``bframes`` B pictures between P anchors (POC
    type 0, in output order; an IDR every ``idr_every`` pictures of output
    order), with ``pyramid`` the middle one of each run a reference, each B
    slice's direct mode "spatial", "temporal" or "mixed" (drawn), its lists'
    sizes drawn and, with ``modify``, both lists modified. Under
    weighted_pred_flag (P) or weighted_bipred_idc 1 (B) every slice draws
    its pred_weight_table."""
    seq = Sequence(width, height, seed=seed, max_refs=max_refs, entropy=entropy,
                   **(seq_args or {}))
    rng = seq.rng
    weights = weights or {"I4": 3, "I16": 3, "PCM": 0.3, "P16x16": 2, "P16x8": 2, "P8x16": 2,
                          "P8x8": 2, "P8x8ref0": 1, "SKIP": 3}
    choose = RandomMB(rng, weights, big, mvd_scale, far_mvd, qp_walk, qp_ends=qp_ends)
    if bframes:
        return seq, _random_b_pictures(seq, choose, pictures, bframes, pyramid, direct,
                                       idr_every, slices, deblock, mmco, modify, slice_qp,
                                       edit)
    samples, prev_ref = [], True
    for k in range(pictures):
        idr = (k == 0 and first_idr) or (idr_every and k % idr_every == 0)
        # no two non-reference pictures in a row (POC types 1 and 2 would
        # give them one order count)
        ref = idr or not prev_ref or rng.random() >= nonref
        prev_ref = ref
        typ = "I" if idr or (k % p_every) else "P"
        if typ == "P" and not seq.refs:
            typ = "I"
        hdr = seq.begin(idr, ref)
        hdr["idr_pic_id"] = k % 3
        extra = edit(k, hdr) if edit else {}
        pic = Picture(seq, hdr)
        pic.cur_type = typ
        ops = seq.random_mmco() if (mmco and ref and not idr) else None
        cuts = sorted(set([0, seq.nmb] + [int(v) for v in
                                          rng.integers(1, seq.nmb, slices - 1)])) \
            if slices > 1 and seq.nmb > slices else [0, seq.nmb]
        nlist = len(seq.refs)
        spans = list(zip(cuts, cuts[1:]))
        for s0, s1 in (reversed(spans) if k == reverse_slices else spans):
            db = deblock[int(rng.integers(len(deblock)))]
            nref, mods = None, ()
            if typ == "P":
                nref = int(rng.integers(1, nlist + 1))
                if modify and rng.random() < 0.7:
                    mods = _random_modifications(seq, rng, nref)
            qp = slice_qp if slice_qp is not None else int(seq.qp + rng.integers(-4, 5))
            if pcm_places:
                mid = [m for m in range(s0, s1) if 0 < m % seq.mb_w < seq.mb_w - 1]
                choose.force_pcm = {s0, s1 - 1} | set(mid[len(mid) // 2:][:1])
            wts = random_weights(rng, "P", (nref, 0)) if typ == "P" and seq.weighted else None
            pic.slice(s0, s1 - s0, typ, choose, qp=qp, deblock=db, num_ref=nref,
                      modifications=mods, **{"mmco": ops, "long_term_idr": long_term_idr,
                                             "weights": wts, **extra})
        seq.mark(hdr, ops, long_term_idr)
        if k == partition_nal:
            pic.nals.append(nal(2, 2, b"\x88\x84\x21\xa0"))
        samples.append(pic.nals)
    return seq, samples


def random_weights(rng, typ: str, nrefs) -> tuple:
    """A pred_weight_table as Picture.slice takes it: logWDs 0-7, each
    reference's luma and chroma weights present or not, near 2^logWD or
    (now and then) anywhere in -128..127, offsets small or large. A B
    slice's keep every pair's sum within 8.4.2.3's bound for explicit
    bi-prediction (-128..128): logWDs 0-6, weights in -64..64."""
    top = 7 if typ == "P" else 6
    lw, cw = int(rng.integers(0, top + 1)), int(rng.integers(0, top + 1))
    lo, hi = (-128, 127) if typ == "P" else (-64, 64)

    def one(denom):
        if rng.random() < 0.15:
            w = int(rng.integers(lo, hi + 1))
        else:
            w = int(np.clip((1 << denom) + rng.integers(-(1 << denom) // 2 - 1,
                                                       (1 << denom) // 2 + 2), lo, hi))
        o = int(rng.integers(-128, 128)) if rng.random() < 0.15 else int(rng.integers(-12, 13))
        return (w, o)
    tabs = []
    for lst in range(2 if typ == "B" else 1):
        tabs.append([(one(lw) if rng.random() < 0.6 else None,
                      (one(cw), one(cw)) if rng.random() < 0.5 else None)
                     for _ in range(nrefs[lst])])
    if typ == "P":
        tabs.append([])
    return lw, cw, tabs


def b_schedule(pictures: int, bframes: int, pyramid: bool, idr_every: int = 0) -> list:
    """Decoding order of ``pictures`` in output order with ``bframes`` B
    pictures between anchors: [(place in output order since the IDR, type
    "I"/"P"/"B", reference, IDR)]. Each IDR period closes with an anchor;
    with ``pyramid`` the middle B picture of each run (of two or more) is a
    reference, decoded before the others."""
    out, start = [], 0
    while start < pictures:
        end = min(start + idr_every, pictures) if idr_every else pictures
        out.append((0, "I", True, True))
        prev = start
        while prev < end - 1:
            a = min(prev + bframes + 1, end - 1)
            out.append((a - start, "P", True, False))
            mids = list(range(prev + 1, a))
            if pyramid and len(mids) >= 2:
                m = mids[len(mids) // 2]
                out.append((m - start, "B", True, False))
                mids.remove(m)
            out += [(d - start, "B", False, False) for d in mids]
            prev = a
        start = end
    return out


def _random_b_pictures(seq: Sequence, choose, pictures: int, bframes: int, pyramid: bool,
                       direct: str, idr_every: int, slices: int, deblock, mmco: bool,
                       modify: bool, slice_qp, edit) -> list:
    """random_stream's pictures with B slices (its arguments)."""
    rng, samples = seq.rng, []
    order = b_schedule(pictures, bframes, pyramid, idr_every)
    # each sample's place in output order over the whole stream
    seq.display, base = [], 0
    for disp, typ, ref, idr in order:
        base = len(seq.display) if idr else base
        seq.display.append(base + disp)
    for k, (disp, typ, ref, idr) in enumerate(order):
        hdr = seq.begin(idr, ref, display=disp)
        hdr["idr_pic_id"] = k % 3
        extra = edit(k, hdr) if edit else {}
        pic = Picture(seq, hdr)
        pic.cur_type = typ
        ops = seq.random_mmco() if (mmco and ref and not idr) else None
        cuts = sorted(set([0, seq.nmb] + [int(v) for v in
                                          rng.integers(1, seq.nmb, slices - 1)])) \
            if slices > 1 and seq.nmb > slices else [0, seq.nmb]
        l0, l1 = seq.b_lists()
        for s0, s1 in zip(cuts, cuts[1:]):
            db = deblock[int(rng.integers(len(deblock)))]
            opts = {}
            # under implicit weights list 0 holds the earlier pictures alone
            # and list 1 the later ones, so that no weight reaches 128 (cv2's
            # libavcodec takes bi-prediction weights as 8-bit)
            implicit = typ == "B" and seq.bipred == 2
            before = sum(r["poc"] < seq.poc for r in l0)
            mod_ok = modify and not implicit
            if typ in ("P", "B"):
                n0 = len(seq.refs) if typ == "P" else before if implicit else len(l0)
                opts["num_ref"] = int(rng.integers(1, n0 + 1))
                if mod_ok and rng.random() < 0.7:
                    opts["modifications"] = _random_modifications(seq, rng, opts["num_ref"])
            if typ == "B":
                n1 = len(l1) - before if implicit else len(l1)
                opts["num_ref1"] = int(rng.integers(1, n1 + 1))
                if mod_ok and rng.random() < 0.7:
                    opts["modifications1"] = _random_modifications(seq, rng, opts["num_ref1"])
                opts["direct_spatial"] = direct == "spatial" or (direct == "mixed" and
                                                                 rng.random() < 0.5)
            if (typ == "P" and seq.weighted) or (typ == "B" and seq.bipred == 1):
                opts["weights"] = random_weights(rng, typ, (opts["num_ref"],
                                                            opts.get("num_ref1", 0)))
            qp = slice_qp if slice_qp is not None else int(seq.qp + rng.integers(-4, 5))
            pic.slice(s0, s1 - s0, typ, choose, qp=qp, deblock=db, mmco=ops,
                      **{**opts, **extra})
        seq.mark(hdr, ops)
        samples.append(pic.nals)
    return samples


def _random_modifications(seq: Sequence, rng, nref: int) -> list:
    """ref_pic_list_modification operations that move random references to
    the front."""
    ops, pred = [], seq.frame_num
    max_pn = seq.max_fn
    last = None
    for _ in range(int(rng.integers(1, nref + 1))):
        r = seq.refs[int(rng.integers(len(seq.refs)))]
        if r is last:
            continue
        last = r
        if r["lt"] is not None:
            ops.append((2, r["lt"]))
            continue
        pn = seq.pic_num(r)
        nowrap = pn + max_pn if pn < 0 else pn
        if nowrap == pred:  # a difference of 0 has no code
            continue
        if rng.random() < 0.5:
            ops.append((0, (pred - nowrap) % max_pn - 1))
        else:
            ops.append((1, (nowrap - pred) % max_pn - 1))
        pred = nowrap
    return ops


# ----------------------------------------------------------- natural mode
def bgr_to_yuv420(bgr: np.ndarray, mb_w: int, mb_h: int):
    """BT.601 limited-range planes of a BGR frame, padded to whole
    macroblocks by edge replication: Y [16 mb_h, 16 mb_w], U, V half."""
    f = bgr.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    H, W = 16 * mb_h, 16 * mb_w
    pad = lambda p: np.pad(p, ((0, H - p.shape[0]), (0, W - p.shape[1])), mode="edge")
    y, u, v = pad(y), pad(u), pad(v)
    sub = lambda p: p.reshape(H // 2, 2, W // 2, 2).mean((1, 3))
    return [np.clip(np.round(p), 0, 255).astype(np.int64) for p in (y, sub(u), sub(v))]


def _fwd(x: np.ndarray) -> np.ndarray:
    """The forward core transform of [..., 4, 4] residuals."""
    C = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]])
    return C @ x @ C.T


def _quant(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """[..., 16] raster coefficients -> levels."""
    qbits = 15 + qp // 6
    mf = np.array(MF[qp % 6])[POS_CLASS]
    f = (1 << qbits) // (3 if intra else 6)
    return np.sign(w) * ((np.abs(w) * mf + f) >> qbits)


def _blocks(plane_part: np.ndarray, n: int) -> np.ndarray:
    """[4n, 4n] -> [n * n, 16] 4x4 blocks in raster order of blocks."""
    return plane_part.reshape(n, 4, n, 4).transpose(0, 2, 1, 3).reshape(n * n, 16)


def _unblocks(b: np.ndarray, n: int) -> np.ndarray:
    return b.reshape(n, n, 4, 4).transpose(0, 2, 1, 3).reshape(4 * n, 4 * n)


def _raster_to_scan(lv: np.ndarray, first: int = 0) -> list:
    return [int(lv[ZIGZAG[k]]) for k in range(first, 16)]


def _idct8_float_pass() -> np.ndarray:
    """[8, 8] the 8-point inverse transform of 8.5.13.2 without its shifts'
    rounding (x >> k read as x / 2^k)."""
    T = np.zeros((8, 8))
    for k in range(8):
        d = np.eye(8)[k]
        a0, a4, a2, a6 = d[0] + d[4], d[0] - d[4], d[2] / 2 - d[6], d[2] + d[6] / 2
        b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
        a1 = -d[3] + d[5] - d[7] - d[7] / 2
        a3 = d[1] + d[7] - d[3] - d[3] / 2
        a5 = -d[1] + d[7] + d[5] + d[5] / 2
        a7 = d[3] + d[5] + d[1] + d[1] / 2
        b1, b7, b3, b5 = a1 + a7 / 4, a7 - a1 / 4, a3 + a5 / 4, a3 / 4 - a5
        T[:, k] = [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7]
    return T


# [64, 64]: the dequantised coefficients (raster) whose 8x8 inverse transform
# (rows, then columns, then / 64) is a residual (raster)
FWD8 = np.linalg.inv(np.kron(_idct8_float_pass(), _idct8_float_pass()) / 64)


def _quant8(x: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """[..., 64] raster residuals -> 8x8 levels (flat lists), rounding with
    the dead zone of 1/3 (intra) or 1/6 (inter)."""
    step = level_scale8(qp) * 2.0 ** (qp // 6) / 64
    c = (x.reshape(*x.shape[:-1], 64) @ FWD8.T) / step
    return (np.sign(c) * np.floor(np.abs(c) + (1 / 3 if intra else 1 / 6))).astype(np.int64)


def _filter8_ref(t, l, c, ta, la, tla):
    """8.3.2.2.1 on numpy rows: (top [16], left [8], corner) filtered."""
    t, l = np.asarray(t, np.int64), np.asarray(l, np.int64)
    mid = lambda v: (v[:-2] + 2 * v[1:-1] + v[2:] + 2) >> 2
    tf = np.concatenate([[(c + 2 * t[0] + t[1] + 2) >> 2 if tla else (3 * t[0] + t[1] + 2) >> 2],
                         mid(t), [(t[14] + 3 * t[15] + 2) >> 2]])
    lf = np.concatenate([[(c + 2 * l[0] + l[1] + 2) >> 2 if tla else (3 * l[0] + l[1] + 2) >> 2],
                         mid(l), [(l[6] + 3 * l[7] + 2) >> 2]])
    cf = (t[0] + 2 * c + l[0] + 2) >> 2 if ta and la else (3 * c + t[0] + 2) >> 2 if ta else \
        (3 * c + l[0] + 2) >> 2 if la else c
    return tf, lf, cf


class NaturalEncoder:
    """``choose`` of the natural mode: codes ``frame`` (YUV planes) at one
    QP, I_16x16 in I pictures and P_L0_16x16 in P pictures, keeping the
    reconstruction (``recon``) as the decoder forms it. With ``high`` (High
    profile, flat lists) an I macroblock is Intra 16x16, 4x4 or 8x8 and a P
    macroblock's residual takes the 4x4 or the 8x8 transform, whichever
    costs less (the sum of absolute differences to the source plus LAMBDA
    per estimated bit)."""

    def __init__(self, qp: int, high: bool = False):
        self.qp = qp
        self.recon = None
        self.high = high
        self.lam = 0.92 * 2 ** ((qp - 12) / 6)

    def start(self, planes, refs, vectors, weights=None, lists=None, col=None, w0=32):
        """The next picture: its source ``planes``, the reference
        reconstructions by ref_idx, and each reference's global vector
        (integer luma pixels, even). A P picture's ``weights``: ref_idx 0's
        explicit luma weight (logWD 6), or None. A B picture's ``lists``:
        (list 0, list 1) of (reconstruction, vector), its colocated
        picture's motion ``col`` (refidx, mv, intra per macroblock) and the
        implicit weight ``w0`` of the two ref_idx 0."""
        self.src = planes
        self.refs, self.vectors = refs, vectors
        self.weight, self.lists, self.col, self.w0 = weights, lists, col, w0
        self.recon = [np.zeros_like(p) for p in planes]

    def __call__(self, pic: Picture, mb: int, qp: int) -> dict:
        x, y = mb % pic.mb_w, mb // pic.mb_w
        qpc = CHROMA_QP[min(max(qp + pic.seq.cqp_offset, 0), 51)]
        if pic.cur_type == "I":
            return self._intra(pic, mb, x, y, qp, qpc)
        if pic.cur_type == "B":
            return self._inter_b(pic, mb, x, y, qp, qpc)
        return self._inter(pic, mb, x, y, qp, qpc)

    def _chroma_levels(self, pred_u, pred_v, x, y, qpc, intra):
        s, out, rec = {"cdc": [], "cac": []}, [], []
        any_ac = any_dc = False
        for c, pred in enumerate((pred_u, pred_v)):
            src = self.src[1 + c][8 * y:8 * y + 8, 8 * x:8 * x + 8]
            w = _fwd(_blocks(src - pred, 2).reshape(4, 4, 4))
            dcw = w[:, 0, 0].reshape(2, 2)
            H = np.array([[1, 1], [1, -1]])
            dcf = (H @ dcw @ H).reshape(4)
            qbits = 15 + qpc // 6
            dcl = np.sign(dcf) * ((np.abs(dcf) * MF[qpc % 6][0] + 2 * ((1 << qbits) //
                                                                        (3 if intra else 6)))
                                  >> (qbits + 1))
            ac = _quant(w.reshape(4, 16), qpc, intra)
            ac[:, 0] = 0
            s["cdc"].append([int(v) for v in dcl])
            s["cac"].append([_raster_to_scan(ac[b], 1) for b in range(4)])
            any_dc |= bool(dcl.any())
            any_ac |= bool(ac.any())
            out.append((dcl, ac))
        cbp_c = 2 if any_ac else 1 if any_dc else 0
        for c, pred in enumerate((pred_u, pred_v)):
            dcl, ac = out[c]
            if cbp_c == 0:
                dcl = dcl * 0
            if cbp_c < 2:
                ac = ac * 0
            res, _ = residual_blocks(ac, qpc, chroma_dc(dcl, qpc))
            rec.append(np.clip(pred + _unblocks(res, 2), 0, 255))
        return s, cbp_c, rec

    def _chroma_dc_pred(self, pic, x, y, a, b):
        out = []
        for c in (1, 2):
            R = self.recon[c]
            top = R[8 * y - 1, 8 * x:8 * x + 8] if b else None
            left = R[8 * y:8 * y + 8, 8 * x - 1] if a else None
            p = np.zeros((8, 8), np.int64)
            for by in range(2):
                for bx in range(2):
                    t = None if top is None else top[4 * bx:4 * bx + 4]
                    lf = None if left is None else left[4 * by:4 * by + 4]
                    if (bx, by) in ((0, 0), (1, 1)) and t is not None and lf is not None:
                        v = (t.sum() + lf.sum() + 4) >> 3
                    elif bx == 1 and by == 0 and t is not None:
                        v = (t.sum() + 2) >> 2
                    elif bx == 0 and by == 1 and lf is not None:
                        v = (lf.sum() + 2) >> 2
                    elif lf is not None:
                        v = (lf.sum() + 2) >> 2
                    elif t is not None:
                        v = (t.sum() + 2) >> 2
                    else:
                        v = 128
                    p[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v
            out.append(p)
        return out

    def _intra(self, pic, mb, x, y, qp, qpc):
        a, b, _, d = pic.intra_avail(mb)
        Y = self.recon[0]
        src = self.src[0][16 * y:16 * y + 16, 16 * x:16 * x + 16]
        preds = {}
        top = Y[16 * y - 1, 16 * x:16 * x + 16] if b else None
        left = Y[16 * y:16 * y + 16, 16 * x - 1] if a else None
        if top is not None:
            preds[0] = np.tile(top, (16, 1))
        if left is not None:
            preds[1] = np.tile(left[:, None], (1, 16))
        if top is not None and left is not None:
            dc = (top.sum() + left.sum() + 16) >> 5
        elif top is not None:
            dc = (top.sum() + 8) >> 4
        elif left is not None:
            dc = (left.sum() + 8) >> 4
        else:
            dc = 128
        preds[2] = np.full((16, 16), dc, np.int64)
        mode = min(preds, key=lambda m: np.abs(src - preds[m]).sum())
        pred = preds[mode]
        luma = self._i16(pred, mode, src, qp)
        if self.high:
            cands = [luma, self._nxn(pic, mb, x, y, qp, 4, src), self._nxn(pic, mb, x, y, qp, 8, src)]
            luma = min(cands, key=lambda c: c["cost"])
            pic.modes[mb] = luma["modes16"]
        self.recon[0][16 * y:16 * y + 16, 16 * x:16 * x + 16] = luma.pop("recon")
        luma.pop("cost")
        luma.pop("modes16")
        pu, pv = self._chroma_dc_pred(pic, x, y, a, b)
        cs, cbp_c, rec = self._chroma_levels(pu, pv, x, y, qpc, True)
        for c in range(2):
            self.recon[1 + c][8 * y:8 * y + 8, 8 * x:8 * x + 8] = rec[c]
        luma["levels"].update(cs)
        return {**luma, "chroma_mode": 0, "cbp_c": cbp_c, "qp_delta": 0}

    def _i16(self, pred, mode, src, qp) -> dict:
        """Intra 16x16 coding of the macroblock from prediction ``pred``."""
        w = _fwd(_blocks(src - pred, 4).reshape(16, 4, 4)).reshape(16, 16)
        # the DC of the 16 blocks (raster order of blocks)
        Hd = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
        dcf = (Hd @ w[:, 0].reshape(4, 4) @ Hd) // 2
        qbits = 15 + qp // 6
        dcl = (np.sign(dcf) * ((np.abs(dcf) * MF[qp % 6][0] + 2 * ((1 << qbits) // 3))
                               >> (qbits + 1))).reshape(16)
        ac = _quant(w, qp, True)
        ac[:, 0] = 0
        cbp_l = 15 if ac.any() else 0
        if not cbp_l:
            ac[:] = 0
        dcy = luma_dc(dcl, qp)  # raster over blocks = our block raster order
        res, _ = residual_blocks(ac, qp, dcy)
        recon = np.clip(pred + _unblocks(res, 4), 0, 255)
        luma = [None] * 16
        for blk in range(16):
            r = 4 * BLK_Y[blk] + BLK_X[blk]  # this block's row in raster order of blocks
            luma[blk] = _raster_to_scan(ac[r], 1)
        dc_scan = [int(dcl[ZIGZAG[k]]) for k in range(16)]
        bits = 5 * (np.count_nonzero(ac) + np.count_nonzero(dcl)) + 2
        return {"kind": "I16", "mode16": int(mode), "cbp_l": cbp_l, "recon": recon,
                "levels": {"luma": luma, "dc": dc_scan}, "modes16": np.full(16, 2),
                "cost": np.abs(src - recon).sum() + self.lam * bits}

    def _nxn(self, pic, mb, x, y, qp, n, src) -> dict:
        """Intra 4x4 (``n`` 4) or 8x8 coding of the macroblock, block by
        block in decoding order, each block's mode the one closest to the
        source (a mode other than the predicted one costing its rest)."""
        from moda_tpu_torch.preproc import h264 as D

        Y = self.recon[0]
        H, W = Y.shape
        a, b, c, d = pic.intra_avail(mb)
        rec = np.zeros((16, 16), np.int64)
        x0, y0 = 16 * x, 16 * y
        tabs = [np.array(t) for t in ((D.MODE4_W, D.MODE4_ADD, D.MODE4_SHIFT) if n == 4 else
                                      (D.MODE8_W, D.MODE8_ADD, D.MODE8_SHIFT))]

        def at(px, py):  # a sample relative to the macroblock: its own reconstruction inside
            if 0 <= px < 16 and 0 <= py < 16:
                return rec[py, px]
            return Y[min(max(y0 + py, 0), H - 1), min(max(x0 + px, 0), W - 1)]
        modes, levels, cost = [], [], 0.0
        saved = pic.modes[mb].copy()
        for k in range(16 if n == 4 else 4):
            if n == 4:
                bx, by, tr = 4 * BLK_X[k], 4 * BLK_Y[k], D.TOP_RIGHT[k]
                tra = b if tr == 2 else c if tr == 3 else bool(tr)
                blk = k
            else:
                bx, by, tra, blk = 8 * (k & 1), 8 * (k >> 1), (b, c, True, False)[k], 4 * k
            la, ta = bx > 0 or a, by > 0 or b
            tla = (bx > 0 and by > 0) or (bx == 0 and by > 0 and a) or \
                (bx > 0 and by == 0 and b) or (bx == 0 and by == 0 and d)
            top = np.array([at(bx + i, by - 1) for i in range(2 * n)])
            if not tra:
                top[n:] = top[n - 1]
            left = np.array([at(bx - 1, by + i) for i in range(n)])
            corner = at(bx - 1, by - 1)
            if n == 8:
                top, left, corner = _filter8_ref(top, left, corner, ta, la, tla)
            nbr = np.concatenate([[corner], top, left])
            allowed = _allowed_modes(ta, la, tla)
            preds = (tabs[0][allowed] @ nbr + tabs[1][allowed]) >> tabs[2][allowed]
            st, sl = top[:n].sum(), left.sum()
            sh = {4: 3, 8: 4}[n]
            dc = ((st + sl + n) >> sh if ta and la else (sl + n // 2) >> (sh - 1) if la else
                  (st + n // 2) >> (sh - 1) if ta else 128)
            preds[allowed.index(2)] = dc
            sb = src[by:by + n, bx:bx + n].reshape(-1)
            pm = pic.pred_mode4(mb, blk, n, count=False)
            costs = np.abs(sb[None] - preds).sum(1) + self.lam * np.where(
                np.array(allowed) == pm, 1, 4)
            j = int(np.argmin(costs))
            m, pred = allowed[j], preds[j]
            if n == 4:
                lv = _quant(_fwd((sb - pred).reshape(4, 4)).reshape(16), qp, True)
                res = residual_blocks(lv[None], qp)[0][0]
            else:
                lv = _quant8(sb - pred, qp, True)
                res = residual_blocks8(lv[None], qp)[0][0]
            r = np.clip(pred + res, 0, 255)
            rec[by:by + n, bx:bx + n] = r.reshape(n, n)
            pic.modes[mb, blk:blk + n * n // 16] = m
            modes.append(m)
            levels.append(lv)
            cost += np.abs(sb - r).sum() + self.lam * (5 * np.count_nonzero(lv) +
                                                       (1 if m == pm else 4))
        out_modes = pic.modes[mb].copy()
        pic.modes[mb] = saved
        group = 4 if n == 4 else 1  # blocks an 8x8 block holds
        cbp_l = sum(1 << g for g in range(4)
                    if any(np.any(levels[i]) for i in range(g * group, (g + 1) * group)))
        if n == 4:
            lv = {"luma": [_raster_to_scan(v) for v in levels]}
        else:
            lv = {"luma8": [[int(v[ZIGZAG8[k]]) for k in range(64)] for v in levels]}
        return {"kind": "I4" if n == 4 else "I8", "modes": modes, "cbp_l": cbp_l, "recon": rec,
                "levels": lv, "modes16": out_modes, "cost": cost}

    def _inter(self, pic, mb, x, y, qp, qpc):
        # the reference whose global vector predicts this macroblock best
        best = None
        for r, (R, (vx, vy)) in enumerate(zip(self.refs, self.vectors)):
            pred = _block_pred(R, x, y, vx, vy)
            if r == 0 and self.weight is not None:  # explicit weighted prediction
                pred = [np.clip(((p * self.weight + 32) >> 6), 0, 255) for p in pred]
            src = self.src[0][16 * y:16 * y + 16, 16 * x:16 * x + 16]
            cost = np.abs(src - pred[0]).sum() + 64 * r
            if best is None or cost < best[0]:
                best = (cost, r, pred, (4 * vx, 4 * vy))
        _, r, pred, mv = best
        spec = self._residual(x, y, qp, qpc, pred)
        mvp = _mvp16(pic, mb, r, 0)
        pic.mv[mb, 0], pic.refidx[mb, 0] = mv, r
        return {"kind": "P16x16", "refs": [r],
                "mvds": [(int(mv[0] - mvp[0]), int(mv[1] - mvp[1]))], **spec}

    def _inter_b(self, pic, mb, x, y, qp, qpc):
        """A B macroblock: list 0's or list 1's ref_idx 0 by its global
        vector, both under the implicit weights, or B_Skip where spatial
        direct prediction (8.4.1.2.2, its colocated block the same
        macroblock of list 1's ref_idx 0) predicts as well."""
        src = self.src[0][16 * y:16 * y + 16, 16 * x:16 * x + 16]
        one = [_block_pred(R, x, y, vx, vy) for R, (vx, vy) in (self.lists[0][0], self.lists[1][0])]
        both = [(a * self.w0 + b * (64 - self.w0) + 32) >> 6 for a, b in zip(*one)]
        mvs = [(4 * v[0], 4 * v[1]) for _, v in (self.lists[0][0], self.lists[1][0])]
        cands = [(np.abs(src - p[0]).sum() + self.lam * bits, preds, p)
                 for preds, p, bits in ((1, one[0], 8), (2, one[1], 8), (3, both, 14))]
        cost, preds, pred = min(cands, key=lambda c: c[0])
        # B_Skip: spatial direct's motion, no residual
        refs, dmv = _spatial_direct16(pic, mb, self.col[0][mb], self.col[1][mb], self.col[2][mb])
        if all(r <= 0 for r in refs):
            planes = [_block_pred(self.lists[k][0][0], x, y, dmv[k][0] // 4, dmv[k][1] // 4)
                      if refs[k] == 0 else None for k in range(2)]
            skip = planes[0] if refs[1] < 0 else planes[1] if refs[0] < 0 else \
                [(a * self.w0 + b * (64 - self.w0) + 32) >> 6 for a, b in zip(*planes)]
            if all(v % 8 == 0 for m in dmv for v in m) and \
                    np.abs(src - skip[0]).sum() <= cost - self.lam * 6:
                self.recon[0][16 * y:16 * y + 16, 16 * x:16 * x + 16] = skip[0]
                for c in range(2):
                    self.recon[1 + c][8 * y:8 * y + 8, 8 * x:8 * x + 8] = skip[1 + c]
                pic.refidx[mb], pic.mv[mb] = refs, dmv
                return {"kind": "SKIP"}
        spec = self._residual(x, y, qp, qpc, pred)
        refs, mvds = [[], []], [[], []]
        for k in range(2):
            pic.refidx[mb, k] = 0 if preds >> k & 1 else -1
            pic.mv[mb, k] = mvs[k] if preds >> k & 1 else (0, 0)
        for k in range(2):
            if preds >> k & 1:
                mvp = _mvp16(pic, mb, 0, k)
                refs[k].append(0)
                mvds[k].append((int(mvs[k][0] - mvp[0]), int(mvs[k][1] - mvp[1])))
        return {"kind": "B16x16", "preds": [preds], "refs": refs, "mvds": mvds, **spec}

    def _residual(self, x, y, qp, qpc, pred) -> dict:
        """An inter macroblock's residual from prediction planes ``pred``
        (Y 16x16, Cb, Cr 8x8), by the 4x4 or (High) the 8x8 transform,
        whichever costs less; its reconstruction kept."""
        src = self.src[0][16 * y:16 * y + 16, 16 * x:16 * x + 16]
        w = _fwd(_blocks(src - pred[0], 4).reshape(16, 4, 4)).reshape(16, 16)
        lv = _quant(w, qp, False)
        cbp_l = 0
        for blk in range(16):
            if lv[4 * BLK_Y[blk] + BLK_X[blk]].any():
                cbp_l |= 1 << (blk // 4)
        for blk in range(16):
            if not cbp_l >> (blk // 4) & 1:
                lv[4 * BLK_Y[blk] + BLK_X[blk]] = 0
        res, _ = residual_blocks(lv, qp)
        recon = np.clip(pred[0] + _unblocks(res, 4), 0, 255)
        luma = {"luma": [_raster_to_scan(lv[4 * BLK_Y[blk] + BLK_X[blk]]) for blk in range(16)]}
        t8 = False
        if self.high:
            # the 8x8 transform of the same residual, where it costs less
            r8 = (src - pred[0]).reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(4, 64)
            lv8 = _quant8(r8, qp, False)
            rec8 = np.clip(pred[0] + residual_blocks8(lv8, qp)[0].reshape(2, 2, 8, 8)
                           .transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
            cost = lambda r, nz: np.abs(src - r).sum() + self.lam * 5 * nz
            if lv8.any() and cost(rec8, np.count_nonzero(lv8)) < cost(recon, np.count_nonzero(lv)):
                t8, recon = True, rec8
                cbp_l = sum(1 << g for g in range(4) if lv8[g].any())
                luma = {"luma8": [[int(v[ZIGZAG8[k]]) for k in range(64)] for v in lv8]}
        self.recon[0][16 * y:16 * y + 16, 16 * x:16 * x + 16] = recon
        cs, cbp_c, rec = self._chroma_levels(pred[1], pred[2], x, y, qpc, False)
        for c in range(2):
            self.recon[1 + c][8 * y:8 * y + 8, 8 * x:8 * x + 8] = rec[c]
        return {"cbp_l": cbp_l, "cbp_c": cbp_c, "qp_delta": 0, "t8": t8,
                "levels": {**luma, **cs}}


def _block_pred(R, x, y, vx, vy):
    """Macroblock (x, y)'s prediction planes from reconstruction R by the
    even integer luma vector (vx, vy)."""
    return [_shifted(R[0], 16 * x + vx, 16 * y + vy, 16),
            _shifted(R[1], 8 * x + vx // 2, 8 * y + vy // 2, 8),
            _shifted(R[2], 8 * x + vx // 2, 8 * y + vy // 2, 8)]


def _spatial_direct16(pic: Picture, mb: int, col_ref, col_mv, col_intra):
    """Spatial direct prediction (8.4.1.2.2) of a macroblock whose
    neighbours and colocated macroblock move as one (16x16): per list its
    ref_idx (MinPositive of A, B and C, C replaced by D) and vector (the
    median prediction, 0 at ref_idx 0 where the colocated block is still:
    ref_idx 0 and each component within 1)."""
    def nb(dx, dy, k):
        n = pic.avail(mb, dx, dy)
        return -1 if n is None else int(pic.refidx[n, k])
    mp = lambda a, b: min(a, b) if a >= 0 and b >= 0 else max(a, b)
    refs = []
    for k in range(2):
        c = nb(1, -1, k) if pic.avail(mb, 1, -1) is not None else nb(-1, -1, k)
        refs.append(mp(nb(-1, 0, k), mp(nb(0, -1, k), c)))
    if refs[0] < 0 and refs[1] < 0:
        return [0, 0], [(0, 0), (0, 0)]
    lst = 0 if col_ref[0] >= 0 else 1
    still = not col_intra and col_ref[lst] == 0 and all(abs(v) <= 1 for v in col_mv[lst])
    mvs = []
    for k in range(2):
        if refs[k] < 0 or (refs[k] == 0 and still):
            mvs.append((0, 0))
        else:
            mvs.append(tuple(int(v) for v in _mvp16(pic, mb, refs[k], k)))
    return refs, mvs


def _shifted(plane, x0, y0, n):
    """The n x n block of ``plane`` at (x0, y0), coordinates clamped."""
    h, w = plane.shape
    ys = np.clip(np.arange(y0, y0 + n), 0, h - 1)
    xs = np.clip(np.arange(x0, x0 + n), 0, w - 1)
    return plane[ys[:, None], xs[None, :]]


def _mvp16(pic: Picture, mb: int, ref: int, lst: int = 0):
    """The 16x16 partition's motion vector prediction (8.4.1.3) in list
    ``lst`` in a picture of 16x16 macroblocks."""
    def nb(dx, dy):
        n = pic.avail(mb, dx, dy)
        return None if n is None else (int(pic.refidx[n, lst]), tuple(pic.mv[n, lst]))
    A, B, C = nb(-1, 0), nb(0, -1), nb(1, -1)
    if C is None:
        C = nb(-1, -1)
    if B is None and C is None and A is not None:
        B = C = A
    cand = [v if v is not None else (-1, (0, 0)) for v in (A, B, C)]
    same = [c for c in cand if c[0] == ref]
    if len(same) == 1:
        return same[0][1]
    return tuple(int(np.median([c[1][k] for c in cand])) for k in range(2))


def natural_stream(frames: list, qp: int = 28, refs: int = 2, gop: int = 0,
                   search: int = 6, deblock_last: int = 0, entropy: str = "cavlc",
                   high: bool = False, bframes: int = 0) -> tuple:
    """(Sequence, [sample NAL lists]) coding ``frames`` (BGR uint8): an IDR,
    then P pictures each predicted from up to ``refs`` references by one
    global vector each (the even-pixel shift that best matches the
    reference's reconstruction). ``gop`` > 0 starts a new IDR every ``gop``
    pictures. The loop filter is off (the encoder reconstructs without it),
    but for the last ``deblock_last`` pictures: no picture references them,
    so the filter changes no prediction. ``entropy`` picks the coder;
    ``high`` codes at High profile (x264's defaults: the 8x8 transform and
    Intra 8x8 on, flat scaling lists).

    ``bframes`` > 0 gives x264's default structure besides: ``bframes`` B
    pictures between P anchors, the middle one a reference (b_pyramid
    normal), weighted_pred_flag with ref_idx 0's luma weight (logWD 6) from
    the mean brightness, weighted_bipred_idc 2 (implicit), spatial direct
    (B_Skip where it predicts as well), the VUI's max_num_reorder_frames,
    the loop filter on in the last ``deblock_last`` non-reference pictures;
    the samples in decoding order (``seq.display`` their places in output
    order)."""
    h, w = frames[0].shape[:2]
    sx, px = ({"profile": 100}, {"transform_8x8_mode": 1}) if high else ({}, {})
    if bframes:
        sx = {**sx, "profile": sx.get("profile", 77), "reorder": 2 if bframes > 1 else 1}
        px = {**px, "weighted_pred": 1, "weighted_bipred_idc": 2}
    seq = Sequence(w, h, max_refs=refs, qp=qp, num_ref_default=1, entropy=entropy,
                   sps_extra=sx, pps_extra=px, log2_max_poc_lsb=8 if bframes else 5)
    enc = NaturalEncoder(qp, high)
    if bframes:
        order = b_schedule(len(frames), bframes, True)
        seq.display = [d for d, _, _, _ in order]
    else:
        order = [(k, "I" if k == 0 or (gop and k % gop == 0) else "P", True,
                  k == 0 or bool(gop and k % gop == 0)) for k in range(len(frames))]
    nonref = [k for k, e in enumerate(order) if not e[2]]
    last = set(nonref[-deblock_last:] if bframes and deblock_last else
               range(len(order) - deblock_last, len(order)))
    dpb, samples = [], []  # dpb: the references (POC, reconstruction, motion), decoding order
    for k, (disp, typ, ref, idr) in enumerate(order):
        hdr = seq.begin(idr, ref, display=disp if bframes else None)
        pic = Picture(seq, hdr)
        pic.cur_type = typ
        planes = bgr_to_yuv420(frames[disp], seq.mb_w, seq.mb_h)
        if idr:
            dpb = []
        opts = {}
        if typ == "B":
            past = sorted((e for e in dpb if e[0] < seq.poc), key=lambda e: -e[0])
            future = sorted((e for e in dpb if e[0] > seq.poc), key=lambda e: e[0])
            lists = [[(e[1], _global_vector(planes[0], e[1][0], search)) for e in lst]
                     for lst in (past, future)]
            w0 = _implicit_w0(seq.poc, past[0][0], future[0][0])
            enc.start(planes, [], [], lists=lists, col=future[0][2], w0=w0)
            opts = dict(num_ref=1, num_ref1=1)
        else:
            recons = [e[1] for e in reversed(dpb)][:refs]  # ref_idx 0: the latest
            vecs = [_global_vector(planes[0], R[0], search) for R in recons]
            wt = None
            if typ == "P" and seq.weighted:
                wt = int(np.clip(round(64 * planes[0].mean() / max(recons[0][0].mean(), 1)), 0,
                                 127))
                opts["weights"] = (6, 0, [[((wt, 0) if wt != 64 else None, None)] +
                                          [(None, None)] * (len(recons) - 1), []])
                COVERAGE[("natural_weighted_p", wt != 64)] += 1
                wt = wt if wt != 64 else None
            enc.start(planes, recons, vecs, weights=wt)
            opts["num_ref"] = len(recons) or None
        filtered = k in last
        pic.slice(0, seq.nmb, typ, enc, qp=qp, deblock=(0, 0, 0) if filtered else (1, 0, 0),
                  **opts)
        seq.mark(hdr)
        if ref:
            motion = (pic.refidx.copy(), pic.mv.copy(),
                      np.array([kd in INTRA for kd in pic.kind]))
            dpb = (dpb + [(seq.poc, enc.recon, motion)])[-refs:]
        samples.append(pic.nals)
    return seq, samples


def _implicit_w0(poc: int, poc0: int, poc1: int) -> int:
    """8.4.2.3.1's implicit w0 of two short-term references."""
    clip = lambda v: min(max(v, -128), 127)
    td = clip(poc1 - poc0)
    if not td:
        return 32
    tb = clip(poc - poc0)
    tx = int((16384 + abs(td) // 2) / td)
    dsf = (tb * tx + 32) >> 8
    return 64 - dsf if -64 <= dsf <= 128 else 32


def _global_vector(src, ref, search):
    """The even integer shift (dx, dy) within +-search minimising the mean
    absolute difference of the central region."""
    h, w = src.shape
    m = max(search, 8)
    core = src[m:h - m:2, m:w - m:2]
    best = None
    for dy in range(-search, search + 1, 2):
        for dx in range(-search, search + 1, 2):
            cand = ref[m + dy:h - m + dy:2, m + dx:w - m + dx:2]
            cost = np.abs(core - cand).mean()
            if best is None or cost < best[0]:
                best = (cost, (dx, dy))
    return best[1]


# ------------------------------------------------------------------- files
def avcc(seq: Sequence) -> bytes:
    """An avcC box body (AVCDecoderConfigurationRecord) with the
    sequence's SPS and PPS, 4-byte NAL lengths."""
    sps, pps = seq.sps(), seq.pps()
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + len(sps).to_bytes(2, "big") + sps +
            bytes([1]) + len(pps).to_bytes(2, "big") + pps)


def sample_bytes(nals: list) -> bytes:
    return b"".join(len(n).to_bytes(4, "big") + n for n in nals)


def write_mp4(path: str, seq: Sequence, samples: list, fps: int = 30, avc3: bool = False,
              config: bytes = None, ctts: bool = True) -> None:
    """An MP4 of the stream: an 'avc1' entry with the parameter sets in its
    avcC, or 'avc3' with them in the first sample. A stream whose pictures
    are reordered (``seq.display``: each sample's place in output order)
    gets, with ``ctts``, what FFmpeg's mov muxer writes for it: a ctts (each
    sample's composition offset) and an edit list from the earliest
    composition time over the media; without, neither."""
    from tests.torch_video import write_isobmff

    if avc3:
        samples = [[seq.sps(), seq.pps()] + samples[0]] + samples[1:]
    display = getattr(seq, "display", None)
    extra = {}
    if display is not None and ctts:
        shift = max(k - d for k, d in enumerate(display))
        extra["ctts"] = [d + shift - k for k, d in enumerate(display)]
        extra["elst"] = ((None, shift, 1),)
        COVERAGE[("mp4_ctts_elst",)] += 1
    write_isobmff(path, [sample_bytes(s) for s in samples], seq.height, seq.width,
                  timescale=fps, fourcc=b"avc3" if avc3 else b"avc1", brand=b"isom", chunk_samples=1,
                  avcc=avcc(seq) if config is None else config, **extra)


_READER = r"""
import ctypes, os, sys, cv2, numpy as np
libc = ctypes.CDLL(None)
out = {}
for k, p in enumerate(sys.argv[2:]):
    cap = cv2.VideoCapture(p)
    fr = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        fr.append(f)
    cap.release()
    out["n%d" % k] = np.array(len(fr))
    for i, f in enumerate(fr):
        out["f%d_%d" % (k, i)] = f
    libc.fflush(None)  # avcodec's lines come through C's stdout
    os.write(1, b"@@END %d\n" % k)
np.savez(sys.argv[1], **out)
"""


def cv2_read(paths: list, tmp: str) -> list:
    """cv2.VideoCapture's frames of each clip, read in one subprocess with
    avcodec's log on: [(frames, avcodec's error lines)]."""
    out_npz = os.path.join(tmp, "cv2_frames.npz")
    # cv2 hands avcodec's messages up to warnings (level 24) to stdout as
    # "[OPENCV:FFMPEG:<level>] ..."
    env = dict(os.environ, OPENCV_FFMPEG_DEBUG="1", OPENCV_FFMPEG_LOGLEVEL="24")
    err_path = os.path.join(tmp, "cv2_log.txt")
    with open(err_path, "w") as err:
        res = subprocess.run([sys.executable, "-c", _READER, out_npz, *paths], env=env,
                             stdout=err, stderr=subprocess.STDOUT)
    with open(err_path) as f:
        log = f.read()
    if res.returncode != 0:
        raise RuntimeError(log[-3000:])
    logs, cur = [[] for _ in paths], 0
    for line in log.splitlines():
        if line.startswith("@@END"):
            cur += 1
        elif re.match(r"\[OPENCV:FFMPEG:(\d+)\]", line) and \
                int(re.match(r"\[OPENCV:FFMPEG:(\d+)\]", line).group(1)) <= 24:
            logs[min(cur, len(paths) - 1)].append(line)
    z = np.load(out_npz)
    return [([z[f"f{k}_{i}"] for i in range(int(z[f"n{k}"]))], logs[k])
            for k in range(len(paths))]


# ------------------------------------------------------------- fixtures
# The tool cases of tests/test_torch_h264.py: random_stream's arguments
# (small sizes, cropped ones among them), each case one tool mix.
DEBLOCKS = ((0, 0, 0), (1, 0, 0), (2, 0, 0), (0, -4, 5), (2, 6, -6), (0, 3, 3))
CASES = {
    "intra_types": dict(width=64, height=48, pictures=3, weights={"I4": 3, "I16": 3, "PCM": 0.5},
                        slices=2),
    "p_partitions": dict(width=96, height=64, pictures=6,
                         weights={"P16x16": 1, "P16x8": 1, "P8x16": 1, "P8x8": 3, "P8x8ref0": 1,
                                  "I4": 0.5, "I16": 0.5}, max_refs=2),
    "skip_runs": dict(width=80, height=48, pictures=5, weights={"SKIP": 8, "P16x16": 1, "I16": 0.3}),
    "mv_outside": dict(width=70, height=38, pictures=5, far_mvd=0.4, mvd_scale=64),
    "refs_mmco_long_term": dict(width=64, height=48, pictures=14, max_refs=4, mmco=True,
                                modify=True, nonref=0.2),
    "long_term_idr": dict(width=48, height=32, pictures=8, max_refs=3, mmco=True, modify=True,
                          long_term_idr=True),
    "slices_deblocking": dict(width=96, height=80, pictures=5, slices=5, deblock=DEBLOCKS),
    "constrained_intra": dict(width=80, height=64, pictures=5,
                              weights={"I4": 3, "I16": 3, "PCM": 0.3, "P16x16": 2, "P8x8": 1,
                                       "SKIP": 2},
                              seq_args={"constrained_intra": True}, slices=2),
    "poc_type_1": dict(width=48, height=32, pictures=6, nonref=0.3, seq_args={"poc_type": 1}),
    "poc_type_2": dict(width=48, height=32, pictures=6, seq_args={"poc_type": 2}),
    "chroma_qp_offset_plus": dict(width=64, height=48, pictures=4,
                                  seq_args={"chroma_qp_offset": 7}),
    "chroma_qp_offset_minus": dict(width=64, height=48, pictures=4,
                                   seq_args={"chroma_qp_offset": -9}),
    "qp_0": dict(width=48, height=48, pictures=3, qp_walk=0, slice_qp=0, big=0.2,
                 seq_args={"qp": 0}),
    "qp_51": dict(width=48, height=48, pictures=3, qp_walk=0, slice_qp=51,
                  seq_args={"qp": 51}),
    "level_escapes": dict(width=64, height=48, pictures=3, big=0.5, qp_walk=1, slice_qp=4,
                          seq_args={"qp": 4}),
    "cropped_176x144_frame_num_wrap": dict(width=176, height=144, pictures=20, max_refs=2,
                                           idr_every=12, p_every=1,
                                           seq_args={"log2_max_frame_num": 4}),
}


# B slices and weighted prediction (tests/test_torch_h264_bslices.py):
# random_stream's arguments, each case one tool mix, written with either
# coder. B_WEIGHTS draws every B macroblock type (B_8x8 with every sub-type)
# beside a few intra and P ones.
B_WEIGHTS = {"BDIRECT": 2, "B16x16": 2, "B16x8": 2, "B8x16": 2, "B8x8": 4, "SKIP": 2, "I4": 0.4,
             "I16": 0.4, "PCM": 0.1, "P16x16": 2, "P16x8": 1, "P8x16": 1, "P8x8": 1}
B_CASES = {
    "b_partitions": dict(width=64, height=48, pictures=7, bframes=2, max_refs=2),
    "b_temporal_direct": dict(width=64, height=48, pictures=9, bframes=3, pyramid=True,
                              max_refs=3, direct="temporal"),
    "b_pyramid_implicit": dict(width=64, height=48, pictures=9, bframes=3, pyramid=True,
                               max_refs=3, direct="mixed",
                               seq_args={"pps_extra": {"weighted_bipred_idc": 2},
                                         "sps_extra": {"reorder": 2}}),
    "b_explicit_weights": dict(width=64, height=48, pictures=7, bframes=2, max_refs=3,
                               direct="mixed",
                               seq_args={"pps_extra": {"weighted_bipred_idc": 1,
                                                       "weighted_pred": 1}}),
    "b_lists_slices": dict(width=80, height=48, pictures=9, bframes=2, max_refs=3, slices=3,
                           modify=True, direct="mixed", deblock=DEBLOCKS),
    "b_temporal_slices": dict(width=80, height=48, pictures=10, bframes=2, pyramid=True,
                              max_refs=3, slices=2, modify=True, direct="temporal"),
    "b_no_direct_inference": dict(width=64, height=48, pictures=7, bframes=2, max_refs=2,
                                  direct="mixed",
                                  seq_args={"sps_extra": {"direct_8x8_inference": 0}}),
    "b_high_8x8": dict(width=64, height=48, pictures=7, bframes=2, max_refs=2, direct="mixed",
                       seq_args={"sps_extra": {"profile": 100},
                                 "pps_extra": {"transform_8x8_mode": 1,
                                               "weighted_bipred_idc": 2}}),
    "b_reorder_without_restriction": dict(width=48, height=32, pictures=14, bframes=3,
                                          pyramid=True, max_refs=3, idr_every=9),
    "p_weighted": dict(width=64, height=48, pictures=5, max_refs=2,
                       seq_args={"pps_extra": {"weighted_pred": 1}}),
}


def b_case(name: str) -> dict:
    """random_stream's arguments of a B_CASES case."""
    args = {"weights": {**B_WEIGHTS, "I8": 1} if "high" in name else B_WEIGHTS,
            **B_CASES[name]}
    seq_args = dict(args.pop("seq_args", {}))
    seq_args.setdefault("log2_max_poc_lsb", 8)
    return {**args, "seq_args": seq_args}


def b_coverage_expected() -> set:
    """What the B streams of both coders reach together: every B mb_type
    and sub_mb_type under each coder (B_Skip too), CABAC's B contexts 24-39
    under each cabac_init_idc with both bin values, every B binarisation
    leaf, both direct modes, explicit weights with and without each flag in
    P and B slices, list 1's modification, the VUI's
    max_num_reorder_frames, and the MP4's ctts and edit list."""
    out = {("cabac", t, c, b) for t in CABAC_TAGS[1:] for c in range(24, 40) for b in (0, 1)}
    out |= {("b_mb_type", t) for t in list(range(23)) + ["SKIP"]}
    out |= {("b_sub_mb_type", t) for t in range(13)}
    out |= {("cabac_b_mb_type", t) for t in range(24)}
    out |= {("cabac_b_sub_mb_type", t) for t in range(13)}
    for e in ("cavlc", "cabac"):
        out |= {("b_direct", e, m) for m in ("spatial", "temporal")}
        out.add(("vui_reorder", e, 2))
    out |= {("pred_weight", typ, lst, lum, chro) for typ, lists in (("P", (0,)), ("B", (0, 1)))
            for lst in lists for lum in (False, True) for chro in (False, True)}
    out |= {("list_modification", "B", 1), ("mp4_ctts_elst",)}
    return out


# High profile's tool mixes (tests/test_torch_h264_high.py): each CASES-like
# mix with the 8x8 transform on (Intra 8x8 among the intra types, the flag
# on every inter macroblock that may carry it) and a Cr QP offset apart from
# Cb's, then each scaling-list case. ``high_case`` gives random_stream's
# arguments.
HIGH_WEIGHTS = {"I4": 2, "I8": 3, "I16": 2, "PCM": 0.3, "P16x16": 2, "P16x8": 2, "P8x16": 2,
                "P8x8": 2, "P8x8ref0": 1, "SKIP": 2}
HIGH_CASES = {
    "intra_8x8": dict(width=64, height=48, pictures=3, weights={"I4": 2, "I8": 4, "I16": 2,
                                                                   "PCM": 0.3}, slices=2),
    "p_partitions_8x8": dict(width=96, height=64, pictures=6, max_refs=3,
                             weights={"P16x16": 1, "P16x8": 1, "P8x16": 1, "P8x8": 3,
                                      "P8x8ref0": 1, "I4": 0.5, "I8": 1, "I16": 0.5}),
    "constrained_intra_8x8": dict(width=80, height=64, pictures=4, slices=2,
                                  weights={"I4": 2, "I8": 6, "I16": 1, "PCM": 0.3, "P16x16": 2,
                                           "P8x8": 1, "SKIP": 2},
                                  seq_args={"constrained_intra": True}),
    "slices_deblocking_8x8": dict(width=96, height=80, pictures=4, slices=5, deblock=DEBLOCKS),
    "level_escapes_8x8": dict(width=64, height=48, pictures=3, big=0.5, qp_walk=1, slice_qp=4,
                              seq_args={"qp": 4}),
    "qp_51_8x8": dict(width=48, height=48, pictures=3, qp_walk=0, slice_qp=51,
                      seq_args={"qp": 51}),
}
# the scaling-list cases: (SPS lists, PPS lists) as scaling_specs patterns,
# or None for no lists
SCALING_CASES_HIGH = {
    "lists_default_by_flag": ("dddddddd", "dddddddd"),
    "lists_explicit_sps": ("vavavava", None),
    "lists_explicit_pps": (None, "vvvvavvv"),
    "lists_pps_falls_back_to_sps": ("vvvvvvvv", "avavavav"),
    "lists_pps_falls_back_to_sps_2": ("dvdvdvdv", "vavavava"),
    "lists_pps_takes_sps": ("avavavav", None),
}


def high_case(name: str, seed: int = 0) -> dict:
    """random_stream's arguments of a High case (HIGH_CASES or
    SCALING_CASES_HIGH), the lists drawn from ``seed``."""
    if name in HIGH_CASES:
        args = {"weights": HIGH_WEIGHTS, **HIGH_CASES[name]}
        sps, pps = None, None
    else:
        args = dict(width=64, height=48, pictures=4, max_refs=2, weights=HIGH_WEIGHTS,
                    slice_qp=20)
        sps, pps = SCALING_CASES_HIGH[name]
    rng = np.random.default_rng([seed, 8])
    sx = {"profile": 100}
    px = {"transform_8x8_mode": 1, "second_chroma_qp_offset": 4}
    if sps is not None:
        sx["scaling_lists"] = scaling_specs(rng, sps)
    if pps is not None:
        px["scaling_lists"] = scaling_specs(rng, pps)
    seq_args = dict(args.pop("seq_args", {}))
    seq_args.update(sps_extra=sx, pps_extra=px, chroma_qp_offset=-2)
    return {**args, "seq_args": seq_args}


def high_coverage_expected(coders=("cavlc", "cabac")) -> set:
    """What the High streams of both coders reach together: contexts
    399-435 (transform_size_8x8_flag, ctxBlockCat 5's significance map and
    levels) under each table with both bin values; every Intra 8x8 mode at
    every 8x8 block position with each availability of its top-right
    samples that can occur (block 0's from B, block 1's from C, block 2's
    from block 1, block 3's never), and every availability of the top,
    left and corner samples the reference filter reads; the 8x8 transform
    in I_NxN and in every
    inter macroblock type that may carry it; mixed 4x4/8x8 neighbours on
    both sides for nC (CAVLC), coded_block_flag (CABAC, both cbp bits) and
    Intra 8x8/4x4 mode prediction; the level escape of an 8x8 block; and
    every scaling-list case of both parameter sets under both coders. The
    field-coded contexts 436-459 are unreachable in frame coding."""
    out = {("cabac", t, c, b) for t in CABAC_TAGS for c in range(399, 436) for b in (0, 1)}
    top = (0, 3, 4, 5, 6, 7)  # the modes that read the row above
    for m in range(9):
        out |= {("intra8x8_at", m, 0, 1), ("intra8x8_at", m, 1, 0), ("intra8x8_at", m, 1, 1),
                ("intra8x8_at", m, 2, 1), ("intra8x8_at", m, 3, 0)}
        if m not in top:
            out.add(("intra8x8_at", m, 0, 0))
    out |= {("mb_type", "I8")} | {("transform_8x8", "P", k) for k in P_TYPES}
    out |= {("nc_mixed", s, c, 1 - c) for s in "AB" for c in (0, 1)}
    out |= {("cbf_from_8x8", s, b) for s in "AB" for b in (0, 1)}
    out |= {("mode_pred_mixed", size, k, s) for s in "AB" for size, k in ((4, "I8"), (8, "I4"))}
    out |= {("cabac_level_escape", 5), ("scaling_list_tail",)}
    # the reference filter's availability cases (top, left, corner); the
    # corner without the top sample needs constrained intra prediction
    out |= {("intra8x8_refs", t, l, c) for t in (0, 1) for l in (0, 1) for c in (0, 1)}
    for e in coders:
        out |= {("scaling_list", e, "sps", i, c) for i in range(8) for c in SCALING_CASES}
        out |= {("scaling_list", e, "pps", i, c) for i in range(8)
                for c in ("values", "default", "absent_B")}
        out |= {("scaling_list", e, "pps", 4, "absent_A"), ("scaling_matrix", e, "pps_takes_sps")}
    return out
