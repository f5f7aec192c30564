"""Video input without a video library: the port's own readers of the two
containers phones, cameras and cv2 scripts write into, and the samples of
the two codecs the port decodes. moda_tpu/preproc/pipeline.py::
extract_frames reads clips through cv2.VideoCapture (FFmpeg); this module
gives what that call sees:

- ``open_video(path)`` -> ``Video``: the container ("avi", "mov" or "mp4",
  told apart by the file's first bytes), the codec (fourcc, and for
  ``mp4v`` the esds objectTypeIndication), width and height, the rate as a
  numerator and denominator (cv2's CAP_PROP_FPS: FFmpeg's avg_frame_rate),
  the display rotation in degrees, and the sample table (offset and size of
  each sample, in decode order), and an 'mp4v' entry's esds
  DecoderSpecificInfo (``config``: an MPEG-4 Part 2 track's VOL; an H.264
  track's avcC). Any codec is read; ``require_supported`` refuses all but
  Motion JPEG, MPEG-4 Part 2 and H.264 in MP4/MOV (``Video.kind``).
- ISO-BMFF (.mp4, .mov, .m4v): 32-bit, 64-bit and to-the-end box sizes,
  moov before or after mdat, the first track whose mdia/hdlr is 'vide',
  the rate from mdhd's timescale and stts (timescale x samples / summed
  durations, FFmpeg's mov demuxer's avg_frame_rate), stsc/stsz/stz2/
  stco/co64, ctts (composition offsets, version 0 or 1), and tkhd's
  display matrix (0/90/180/270 degrees, as cv2 rounds it). An identity
  edit list is honoured, and so is the one FFmpeg's mov muxer writes for a
  track whose samples are reordered (one entry from the earliest
  composition time, at rate 1, over the whole media: cv2 drops no frame for
  it); any other elst, a fragmented file (moov/mvex, moof), a movie matrix
  that is not the identity and a track matrix that is not a right-angle
  rotation raise ValueError naming the box.
- AVI: 'RIFF AVI ', hdrl/strl (strh dwRate / dwScale, strf's
  BITMAPINFOHEADER), the first 'vids' stream's '##dc'/'##db' chunks walked
  in 'movi' (LIST 'rec ' included, even-size padding; idx1 is not read, its
  offsets are ambiguous) and in OpenDML 'RIFF AVIX' continuations. A
  zero-length chunk (a dropped frame) is no sample, as FFmpeg skips it.
- Motion JPEG: AVI 'MJPG'/'mjpg', QuickTime 'jpeg'/'mjpa', MP4 'mp4v'
  with objectTypeIndication 0x6C. ``Video.jpeg(i)`` gives sample i as a
  standalone JPEG: a sample without DHT gets JPEG Annex K.3's four tables
  (FFmpeg's mjpeg2jpeg tables) before its SOS. Interlaced samples (an
  'AVI1' APP0 with a field polarity, two fields in a 'mjpa' APP1, or a
  picture under 3/4 of the track's height, FFmpeg's test) raise.
- MPEG-4 Part 2: MP4 'mp4v' with objectTypeIndication 0x20, and the AVI
  fourccs FFmpeg's RIFF table maps to its mpeg4 decoder (``AVI_MPEG4``;
  FFmpeg matches them in any case, as cv2 does). preproc/m4v.py decodes
  them; ``Video.frame(i)`` decodes from the last I-VOP up to sample i.
- H.264: MP4/MOV 'avc1' and 'avc3' (``config``: the avcC, whose
  parameter sets 'avc3' may also carry in its samples). preproc/h264.py
  decodes the Baseline, Main and High tool sets in frame coding (CAVLC or
  CABAC, I, P and B slices, weighted prediction, the 8x8 transform and
  scaling matrices, progressive 8-bit 4:2:0) and refuses the rest by name;
  ``Video.frame(i)`` decodes samples until the i-th picture in output
  order, cv2's i-th read. H.264 in AVI is refused.
  MS-MPEG-4 (DIV3, MP42, MP43), MPEG-1/2, HEVC and the rest are refused.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from moda_tpu_torch.data import imageio as IO

REORDER_WINDOW = 16  # FFmpeg's MAX_REORDER_DELAY
MJPEG_OTI = 0x6C  # ISO/IEC 14496-1 objectTypeIndication of Motion JPEG (ISO 10918-1)
MPEG4_OTI = 0x20  # objectTypeIndication of MPEG-4 Part 2 visual (ISO/IEC 14496-2)
AVI_MJPEG = ("MJPG", "mjpg")
ISO_MJPEG = ("jpeg", "mjpa")
# ISO-BMFF sample entries of H.264: parameter sets in the avcC ('avc1') or
# also in the samples ('avc3')
ISO_H264 = (b"avc1", b"avc3")
# AVI fourccs of H.264 (refused by name)
AVI_H264 = ("H264", "X264", "AVC1", "DAVC", "VSSH")
# AVI fourccs that FFmpeg's RIFF table (libavformat/riff.c) maps to its mpeg4
# decoder, compared in upper case as its ff_codec_get_id does after an exact
# match (cv2 decodes 'xvid' and 'divx' as 'XVID' and 'DIVX'); each checked with
# cv2 (tests/test_torch_m4v.py). Left out: the tags FFmpeg treats otherwise
# (3IV1/3IV2, WV1F, QMP4, UMP4, GEOX/GEOV, G264, INMC).
AVI_MPEG4 = ("FMP4", "DIVX", "DX50", "XVID", "MP4S", "M4S2", "\x04\0\0\0", "ZMP4", "DIV1",
             "BLZ0", "MP4V", "SEDG", "RMP4", "WAWV", "FFDS", "FVFW", "DCOD", "MVXM", "PM4V",
             "SMP4", "DXGM", "VIDM", "M4T3", "HDX4", "DMK2", "DIGI", "EPHV", "EM4A", "M4CC",
             "SN40", "VSPX", "ULDX", "SIPP", "SM4V", "XVIX", "DREX", "PLV1", "GLV4", "GMP4",
             "MNM4", "GTM4")
ISO_TOP_LEVEL = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"uuid",
                 b"styp", b"sidx", b"moof")
# np.rot90's k for cv2.rotate by the track's rotation (cv2's ROTATE_90_CLOCKWISE
# for 90 degrees, ROTATE_90_COUNTERCLOCKWISE for 270)
ROT90_K = {0: 0, 90: -1, 180: 2, 270: 1}
# (a, b, c, d) of a display matrix in 16.16, by the degrees cv2 reads from it
# (round(atan2(b, a)), FFmpeg's av_display_rotation_get negated)
RIGHT_ANGLES = {(0x10000, 0, 0, 0x10000): 0, (0, 0x10000, -0x10000, 0): 90,
                (-0x10000, 0, 0, -0x10000): 180, (0, -0x10000, 0x10000, 0): 270}
# JPEG Annex K.3's DC/AC luminance and chrominance tables, one DHT segment
STANDARD_DHT = bytes.fromhex(
    "ffc401a2"
    "0000010501010101010100000000000000000102030405060708090a0b100002"
    "010303020403050504040000017d010203000411051221314106135161072271"
    "14328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
    "3435363738393a434445464748494a535455565758595a636465666768696a73"
    "7475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9"
    "aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4"
    "e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa01000301010101010101010100000000"
    "00000102030405060708090a0b11000201020404030407050404000102770001"
    "02031104052131061241510761711322328108144291a1b1c109233352f01562"
    "72d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a8283848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")


@dataclass
class Video:
    """One video track of a clip: what cv2.VideoCapture would decode."""

    path: str
    container: str              # "avi", "mov" or "mp4"
    fourcc: str                 # the sample entry (ISO-BMFF) or biCompression (AVI)
    oti: Optional[int]          # the esds objectTypeIndication of an 'mp4v' entry
    width: int
    height: int
    rate: Tuple[int, int]       # numerator, denominator; (0, 1) where unknown
    rotation: int               # display rotation in degrees: 0, 90, 180 or 270
    offsets: np.ndarray         # int64 [N], byte offset of each sample, decode order
    sizes: np.ndarray           # int64 [N]
    config: bytes = b""         # an 'mp4v' entry's esds DecoderSpecificInfo (the VOL),
    #                             an 'avc1'/'avc3' entry's avcC
    cts: Optional[np.ndarray] = None  # int64 [N] composition offsets (ctts), or None
    dts: Optional[np.ndarray] = None  # int64 [N] decoding times (stts), with a ctts

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def reorder_delay(self) -> int:
        """The reorder delay cv2's H.264 decoder starts from: FFmpeg's mov
        demuxer's estimate from the composition times (mov_estimate_video
        _delay: the most earlier samples, of the last 16, composed after a
        sample), which the stream's probe, ending at the first decoded
        frame, leaves as it is; 0 without a ctts."""
        if self.cts is None or self.kind != "h264":
            return 0
        pts = self.dts + self.cts
        delay = 0
        for k in range(len(pts)):
            delay = max(delay, int((pts[max(k - REORDER_WINDOW, 0):k] > pts[k]).sum()))
        return min(delay, REORDER_WINDOW)

    @property
    def fps(self) -> float:
        """The rate as cv2's CAP_PROP_FPS reports it (0.0 where unknown)."""
        return self.rate[0] / self.rate[1] if self.rate[0] else 0.0

    @property
    def kind(self) -> str:
        """The codec the port decodes it with: "mjpeg", "mpeg4" (Part 2),
        "h264", or "" (one it refuses; H.264 in AVI among them)."""
        if self.container == "avi":
            if self.fourcc in AVI_MJPEG:
                return "mjpeg"
            return "mpeg4" if self.fourcc.upper() in AVI_MPEG4 else ""
        if self.fourcc in ISO_MJPEG or (self.fourcc == "mp4v" and self.oti == MJPEG_OTI):
            return "mjpeg"
        if self.fourcc.encode("latin-1") in ISO_H264:
            return "h264"
        return "mpeg4" if self.fourcc == "mp4v" and self.oti == MPEG4_OTI else ""

    @property
    def codec(self) -> str:
        return self.fourcc if self.oti is None else \
            f"{self.fourcc} (objectTypeIndication 0x{self.oti:02X})"

    def sample(self, i: int) -> bytes:
        """The bytes of sample i as the demuxer hands them to the decoder."""
        off, size = int(self.offsets[i]), int(self.sizes[i])
        with open(self.path, "rb") as f:
            f.seek(off)
            data = f.read(size)
        if len(data) != size:
            raise ValueError(f"{self.path}: sample {i} ({size} bytes at byte {off}) runs past "
                             "the end of the file")
        return data

    def jpeg(self, i: int) -> bytes:
        """Sample i as a standalone JPEG (Annex K.3's tables inserted where it
        has no DHT), its header parsed: ValueError with its index where it is
        interlaced, progressive or not a JPEG."""
        data = self.sample(i)
        try:
            data = standalone_jpeg(data)
            h, _, _ = IO.jpeg_size(data)
            if 4 * h < 3 * self.height:
                raise ValueError(f"interlaced: a field of {h} rows in a frame of "
                                 f"{self.height}")
        except ValueError as e:
            raise ValueError(f"{self.path}: sample {i}: {e}") from None
        return data

    def frame(self, i: int, device=None) -> np.ndarray:
        """Frame i decoded, uint8 [H, W, 3] RGB, turned by the track's
        rotation as cv2.VideoCapture turns it. Motion JPEG decodes on the
        host; MPEG-4 Part 2 on ``device`` (the card unless the caller asks
        for the CPU), sample i from the last I-VOP on; H.264 there too, the
        i-th picture in output order (cv2's i-th read) from the first
        sample on."""
        require_supported(self)
        if self.kind == "mjpeg":
            rgb = IO.decode_jpeg(self.jpeg(i))
        elif self.kind == "h264":
            from moda_tpu_torch.preproc.h264 import H264Decoder

            # every sample until the i-th output: a picture may reference
            # any picture since the last IDR, and the ones before it cost
            # time only
            dec, out = H264Decoder(self, device), []
            for j in range(len(self)):
                pic = self.h264(dec.parser, j)
                dec.advance(pic)
                if pic is not None and pic.out >= 0:
                    out.append(pic.out)
                if len(out) > i:
                    break
            else:
                out += dec.parser.flush()
            if len(out) <= i:
                raise ValueError(f"{self.path}: frame {i} of {len(out)}")
            rgb = dec.picture(out[i]).cpu().numpy()[..., ::-1]
        else:
            from moda_tpu_torch.preproc.m4v import VOP_I, VOP_NOT_CODED, Mpeg4Decoder

            dec = Mpeg4Decoder(self, device)
            run = []  # the VOPs from the last I-VOP on
            for j in range(i + 1):
                v = self.vop(dec.parser, j)
                run = [v] if v.coding == VOP_I else run + [v]
            if run[-1].coding == VOP_NOT_CODED:
                raise ValueError(f"{self.path}: sample {i}: a VOP with vop_coded 0, which "
                                 "cv2 reads no frame for")
            for v in run:
                dec.advance(v)
            rgb = dec.picture().cpu().numpy()[..., ::-1]
        return np.ascontiguousarray(np.rot90(rgb, ROT90_K[self.rotation]))

    def h264(self, parser, i: int, headers_only: bool = False):
        """Sample i of an H.264 track parsed by ``parser``
        (preproc/h264.py::Parser): its picture or None; ValueError naming
        the sample."""
        try:
            return parser.parse(self.sample(i), headers_only)
        except ValueError as e:
            raise ValueError(f"{self.path}: sample {i}: {e}") from None

    def vop(self, parser, i: int):
        """Sample i of an MPEG-4 Part 2 track parsed by ``parser``
        (preproc/m4v.py::Parser): ValueError naming the sample."""
        try:
            return parser.parse(self.sample(i))
        except ValueError as e:
            raise ValueError(f"{self.path}: sample {i}: {e}") from None


def require_supported(video: Video) -> None:
    """ValueError naming the codec unless the port decodes it (``Video.kind``)."""
    if not video.kind:
        h264_in_avi = video.container == "avi" and video.fourcc.upper() in AVI_H264
        raise ValueError(
            f"{video.path}: codec {video.codec}"
            f"{' (H.264 in AVI, which the port does not read)' if h264_in_avi else ''}: the "
            "port decodes Motion JPEG (AVI MJPG/mjpg, QuickTime jpeg/mjpa, MP4 mp4v with "
            "objectTypeIndication 0x6C), MPEG-4 Part 2 (MP4 mp4v with objectTypeIndication "
            "0x20, AVI FMP4, XVID, DIVX, DX50 and FFmpeg's other mpeg4 fourccs) and H.264 in "
            "MP4/MOV (avc1, avc3) as Baseline-, Main- and High-profile streams hold it in "
            "frame coding: progressive 8-bit 4:2:0, CAVLC or CABAC, I, P and B slices, "
            "weighted prediction, the 8x8 transform, Intra 8x8 and scaling matrices (no "
            "interlace or FMO); H.264 in AVI, HEVC, MS-MPEG-4 (DIV3, MP42, MP43), MPEG-1/2 and "
            "the rest are refused")


def standalone_jpeg(data: bytes) -> bytes:
    """A Motion-JPEG sample as a JPEG any decoder reads: Annex K.3's DHT
    inserted before the SOS of a sample that has none. ValueError for an
    interlaced sample (two fields) or one that is not a JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    pos, have_dht = 2, False
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"no JPEG marker at byte {pos}")
        m = data[pos + 1]
        if m == 0xFF:  # fill byte
            pos += 1
            continue
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        if m == 0xD9:
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        if m == 0xDA:
            return data if have_dht else data[:pos] + STANDARD_DHT + data[pos:]
        if m == 0xC4:
            have_dht = True
        elif m == 0xE0 and body[:4] == b"AVI1" and len(body) > 4 and body[4] != 0:
            raise ValueError(f"interlaced: an AVI1 APP0 with field polarity {body[4]}")
        elif m == 0xE1 and body[4:8] == b"mjpg" and len(body) >= 20 and \
                struct.unpack_from(">I", body, 16)[0] != 0:
            raise ValueError("interlaced: two fields (mjpa APP1 with an offset to the next "
                             "field)")
        pos += 2 + length
    raise ValueError("JPEG without a scan (no SOS)")


# ------------------------------------------------------------------ files
def open_video(path: str) -> Video:
    """Read the container of the clip at ``path`` (AVI or ISO-BMFF, told
    apart by its first bytes): ValueError where it is neither, or where it
    holds what this reader refuses (see the module docstring)."""
    with open(path, "rb") as f:
        head = f.read(12)
        size = os.fstat(f.fileno()).st_size
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            return _read_avi(f, path, size)
        if head[4:8] in ISO_TOP_LEVEL:
            return _read_isobmff(f, path, size)
    raise ValueError(f"{path}: neither an MP4/MOV (ISO-BMFF) nor an AVI file")


# --------------------------------------------------------------- ISO-BMFF
def _boxes(buf: bytes, start: int, end: int, where: str):
    """(type, body start, box end) of each box in buf[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, pos)
        hdr = 8
        if size == 1:
            size, hdr = struct.unpack_from(">Q", buf, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise ValueError(f"{where}: box '{typ.decode('latin-1')}' at byte {pos} runs past "
                             "its parent")
        yield typ, pos + hdr, pos + size
        pos += size


def _children(buf: bytes, start: int, end: int, where: str) -> dict:
    """The first box of each type in buf[start:end]: type -> (body, end)."""
    out = {}
    for typ, b, e in _boxes(buf, start, end, where):
        out.setdefault(typ, (b, e))
    return out


def _need(boxes: dict, typ: bytes, where: str):
    if typ not in boxes:
        raise ValueError(f"{where}: no '{typ.decode()}' box")
    return boxes[typ]


def _read_isobmff(f, path: str, file_size: int) -> Video:
    brand, moov, pos = None, None, 0
    while pos + 8 <= file_size:
        f.seek(pos)
        hdr = f.read(16)
        size, typ = struct.unpack_from(">I4s", hdr)
        if size == 1:
            size = struct.unpack_from(">Q", hdr, 8)[0]
        elif size == 0:
            size = file_size - pos
        if size < 8:
            raise ValueError(f"{path}: top-level box '{typ.decode('latin-1')}' at byte {pos} "
                             f"has size {size}")
        if typ == b"moof":
            raise ValueError(f"{path}: fragmented MP4 (a top-level 'moof' box): not read")
        if typ == b"ftyp":
            brand = hdr[8:12]
        elif typ == b"moov":
            f.seek(pos)
            moov = f.read(size)
        pos += size
    if moov is None:
        raise ValueError(f"{path}: no 'moov' box")
    container = "mp4" if brand not in (None, b"qt  ") else "mov"
    where = f"{path}: moov"
    start = 16 if struct.unpack_from(">I", moov)[0] == 1 else 8
    top = _children(moov, start, len(moov), where)
    if b"mvex" in top:
        raise ValueError(f"{path}: fragmented MP4 (moov/mvex): not read")
    b, _ = _need(top, b"mvhd", where)
    v = moov[b]
    movie_ts = struct.unpack_from(">I", moov, b + (20 if v == 1 else 12))[0]
    m = struct.unpack_from(">9i", moov, b + (48 if v == 1 else 36))
    if m[:2] + m[3:5] != (0x10000, 0, 0, 0x10000):
        raise ValueError(f"{path}: mvhd: a movie display matrix other than the identity "
                         f"{m}: not read")
    for typ, tb, te in _boxes(moov, start, len(moov), where):
        if typ != b"trak":
            continue
        trak = _children(moov, tb, te, f"{where}/trak")
        mdia = _children(moov, *_need(trak, b"mdia", f"{where}/trak"), f"{where}/trak/mdia")
        hb, _ = _need(mdia, b"hdlr", f"{where}/trak/mdia")
        if moov[hb + 8:hb + 12] == b"vide":
            return _video_track(moov, trak, mdia, movie_ts, path, container)
    raise ValueError(f"{path}: no video track (no trak whose mdia/hdlr is 'vide')")


def _video_track(buf: bytes, trak: dict, mdia: dict, movie_ts: int, path: str,
                 container: str) -> Video:
    where = f"{path}: trak"
    b, _ = _need(trak, b"tkhd", where)
    m = struct.unpack_from(">9i", buf, b + (52 if buf[b] == 1 else 40))
    abcd = m[:2] + m[3:5]
    if abcd not in RIGHT_ANGLES:
        raise ValueError(f"{path}: tkhd: display matrix {m} is not a rotation by a right "
                         "angle: not read")
    rotation = RIGHT_ANGLES[abcd]

    b, _ = _need(mdia, b"mdhd", f"{where}/mdia")
    timescale = struct.unpack_from(">I", buf, b + (20 if buf[b] == 1 else 12))[0]
    stbl_w = f"{where}/mdia/minf/stbl"
    minf = _children(buf, *_need(mdia, b"minf", f"{where}/mdia"), f"{where}/mdia/minf")
    stbl = _children(buf, *_need(minf, b"stbl", f"{where}/mdia/minf"), stbl_w)

    # sample description: the codec and the coded size
    b, e = _need(stbl, b"stsd", stbl_w)
    if struct.unpack_from(">I", buf, b + 4)[0] < 1:
        raise ValueError(f"{stbl_w}: stsd without an entry")
    entry = b + 8
    esize, fourcc = struct.unpack_from(">I4s", buf, entry)
    width, height = struct.unpack_from(">HH", buf, entry + 32)
    oti, config = None, b""
    if fourcc == b"mp4v":
        eb, _ = _need(_children(buf, entry + 86, entry + esize, f"{stbl_w}/stsd/mp4v"),
                      b"esds", f"{stbl_w}/stsd/mp4v")
        oti, config = _esds(buf, eb + 4, f"{stbl_w}/stsd/mp4v/esds")
    elif fourcc in ISO_H264:
        w4 = f"{stbl_w}/stsd/{fourcc.decode()}"
        cb, ce = _need(_children(buf, entry + 86, entry + esize, w4), b"avcC", w4)
        config = bytes(buf[cb:ce])

    # sizes
    if b"stsz" in stbl:
        b, _ = stbl[b"stsz"]
        fixed, n = struct.unpack_from(">II", buf, b + 4)
        sizes = (np.full(n, fixed, np.int64) if fixed else
                 np.frombuffer(buf, ">u4", n, b + 12).astype(np.int64))
    else:
        b, _ = _need(stbl, b"stz2", stbl_w)
        bits, n = buf[b + 7], struct.unpack_from(">I", buf, b + 8)[0]
        if bits == 4:
            raw = np.frombuffer(buf, np.uint8, (n + 1) // 2, b + 12)
            sizes = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:n].astype(np.int64)
        elif bits in (8, 16):
            sizes = np.frombuffer(buf, ">u1" if bits == 8 else ">u2", n, b + 12).astype(np.int64)
        else:
            raise ValueError(f"{stbl_w}: stz2 with {bits}-bit sizes")

    # chunks -> each sample's offset
    if b"co64" in stbl:
        b, _ = stbl[b"co64"]
        chunk_off = np.frombuffer(buf, ">u8", struct.unpack_from(">I", buf, b + 4)[0], b + 8)
    else:
        b, _ = _need(stbl, b"stco", stbl_w)
        chunk_off = np.frombuffer(buf, ">u4", struct.unpack_from(">I", buf, b + 4)[0], b + 8)
    chunk_off = chunk_off.astype(np.int64)
    b, _ = _need(stbl, b"stsc", stbl_w)
    stsc = np.frombuffer(buf, ">u4", 3 * struct.unpack_from(">I", buf, b + 4)[0],
                         b + 8).reshape(-1, 3).astype(np.int64)
    if len(stsc) and (stsc[:, 2] != 1).any():
        raise ValueError(f"{stbl_w}: stsc: samples of a second sample description: not read")
    per_chunk = np.zeros(len(chunk_off), np.int64)
    for k, (first, spc, _) in enumerate(stsc):
        last = stsc[k + 1, 0] - 1 if k + 1 < len(stsc) else len(chunk_off)
        per_chunk[first - 1:last] = spc
    if per_chunk.sum() < n:
        raise ValueError(f"{stbl_w}: stsc/stco hold {per_chunk.sum()} samples, stsz {n}")
    chunk_of = np.repeat(np.arange(len(chunk_off)), per_chunk)[:n]
    first_sample = np.cumsum(per_chunk) - per_chunk
    before = np.cumsum(sizes) - sizes
    offsets = chunk_off[chunk_of] + before - before[np.minimum(first_sample[chunk_of], n - 1)] \
        if n else np.zeros(0, np.int64)

    # rate: FFmpeg's avg_frame_rate of the track (mov_read_stts)
    b, _ = _need(stbl, b"stts", stbl_w)
    stts = np.frombuffer(buf, ">u4", 2 * struct.unpack_from(">I", buf, b + 4)[0],
                         b + 8).reshape(-1, 2).astype(np.int64)
    frames, duration = int(stts[:, 0].sum()), int((stts[:, 0] * stts[:, 1]).sum())
    rate = Fraction(timescale * frames, duration) if timescale and frames and duration > 0 \
        else Fraction(0)

    # composition offsets (ctts): the earliest composition time is where
    # FFmpeg's mov muxer starts the edit list of a reordered track
    cts = None
    if b"ctts" in stbl:
        b, _ = stbl[b"ctts"]
        runs = np.frombuffer(buf, ">u4", 2 * struct.unpack_from(">I", buf, b + 4)[0],
                             b + 8).reshape(-1, 2).astype(np.int64)
        off = runs[:, 1] if buf[b] == 0 else runs[:, 1].astype(np.uint32).view(np.int32)
        cts = np.repeat(off.astype(np.int64), runs[:, 0])
        if len(cts) != n:
            raise ValueError(f"{stbl_w}: ctts holds {len(cts)} samples, stsz {n}")
    if b"edts" in trak:
        dts = np.concatenate([[0], np.cumsum(np.repeat(stts[:, 1], stts[:, 0]))])[:n]
        first_ct = int((dts + cts).min()) if cts is not None and n else 0
        _check_elst(buf, trak[b"edts"], duration, timescale, movie_ts, first_ct,
                    f"{where}/edts")
    dts = np.concatenate([[0], np.cumsum(np.repeat(stts[:, 1], stts[:, 0]))])[:n] \
        if cts is not None else None
    return Video(path, container, fourcc.decode("latin-1"), oti, width, height,
                 (rate.numerator, rate.denominator), rotation, offsets.astype(np.int64), sizes,
                 config, cts, dts)


def _esds(buf: bytes, pos: int, where: str) -> Tuple[int, bytes]:
    """objectTypeIndication of the DecoderConfigDescriptor in an esds, and
    its DecoderSpecificInfo (b"" without one)."""

    def descriptor(p):
        tag, length = buf[p], 0
        p += 1
        for _ in range(4):
            length = length << 7 | buf[p] & 0x7F
            p += 1
            if not buf[p - 1] & 0x80:
                break
        return tag, p, length

    tag, p, _ = descriptor(pos)
    if tag != 0x03:
        raise ValueError(f"{where}: no ES_Descriptor")
    flags = buf[p + 2]
    p += 3 + (2 if flags & 0x80 else 0) + (1 + buf[p + 3] if flags & 0x40 else 0) \
        + (2 if flags & 0x20 else 0)
    tag, p, length = descriptor(p)
    if tag != 0x04:
        raise ValueError(f"{where}: no DecoderConfigDescriptor")
    oti, end, q = buf[p], p + length, p + 13
    while q < end:
        tag, body, size = descriptor(q)
        if tag == 0x05:
            return oti, bytes(buf[body:body + size])
        q = body + size
    return oti, b""


def _check_elst(buf: bytes, edts, duration: int, timescale: int, movie_ts: int,
                first_ct: int, where: str) -> None:
    """ValueError unless the edit list maps the whole media once, at rate 1,
    from its first sample or (FFmpeg's mov muxer, for reordered samples)
    from its earliest composition time ``first_ct`` (or is empty)."""
    eb, _ = _need(_children(buf, *edts, where), b"elst", where)
    v, n = buf[eb], struct.unpack_from(">I", buf, eb + 4)[0]
    if n == 0:
        return
    fmt = ">QqhH" if v == 1 else ">IihH"
    entries = [struct.unpack_from(fmt, buf, eb + 8 + k * struct.calcsize(fmt)) for k in range(n)]
    seg, media_time, rate_int, rate_frac = entries[0]
    # the segment covers the media to within one tick of the movie's timescale
    # (0: the whole media)
    media = duration - (media_time if media_time == first_ct else 0)
    whole = seg == 0 or timescale == 0 or (seg + 1) * timescale > media * movie_ts
    if n != 1 or media_time not in (0, first_ct) or (rate_int, rate_frac) != (1, 0) or \
            not whole:
        raise ValueError(f"{where}/elst: an edit list other than the identity (entries "
                         f"{entries}, media duration {duration} at timescale {timescale}): "
                         "not read")


# -------------------------------------------------------------------- AVI
def _read_avi(f, path: str, file_size: int) -> Video:
    f.seek(4)
    riff_end = min(8 + struct.unpack("<I", f.read(4))[0], file_size)
    stream = strh = strf = None
    offsets, sizes = [], []

    def walk_movi(pos: int, end: int, ids) -> None:
        while pos + 8 <= end:
            f.seek(pos)
            cid, size = struct.unpack("<4sI", f.read(8))
            if cid == b"LIST":
                walk_movi(pos + 12, min(pos + 8 + size, end), ids)  # LIST 'rec '
            elif cid in ids and size:  # a zero-length chunk is a dropped frame: no sample
                if pos + 8 + size > file_size:
                    raise ValueError(f"{path}: chunk '{cid.decode('latin-1')}' at byte {pos} "
                                     "runs past the end of the file")
                offsets.append(pos + 8)
                sizes.append(size)
            pos += 8 + size + (size & 1)

    pos, end = 12, riff_end
    while True:
        while pos + 8 <= end:
            f.seek(pos)
            cid, size = struct.unpack("<4sI", f.read(8))
            kind = f.read(4) if cid in (b"LIST", b"RIFF") else b""
            if cid == b"LIST" and kind == b"hdrl":
                f.seek(pos + 12)
                stream, strh, strf = _avi_video_stream(f.read(size - 4), path)
            elif cid == b"LIST" and kind == b"movi":
                if stream is None:
                    raise ValueError(f"{path}: 'movi' before a video stream's 'strl'")
                ids = (b"%02ddc" % stream, b"%02ddb" % stream)
                walk_movi(pos + 12, min(pos + 8 + size, end), ids)
            pos += 8 + size + (size & 1)
        # OpenDML: the clip goes on in 'RIFF AVIX' lists
        pos = end + (end & 1)
        if pos + 12 > file_size:
            break
        f.seek(pos)
        cid, size, kind = struct.unpack("<4sI4s", f.read(12))
        if cid != b"RIFF" or kind != b"AVIX":
            break
        pos, end = pos + 12, min(pos + 8 + size, file_size)
    if stream is None:
        raise ValueError(f"{path}: no video stream (no 'strl' whose strh is 'vids')")
    scale, rate = struct.unpack_from("<II", strh, 20)
    if len(strf) < 20:
        raise ValueError(f"{path}: the video stream's strf holds no BITMAPINFOHEADER")
    width, height = struct.unpack_from("<ii", strf, 4)
    fourcc = strf[16:20]
    fr = Fraction(rate, scale) if rate and scale else Fraction(0)
    return Video(path, "avi", fourcc.decode("latin-1"), None, width, abs(height),
                 (fr.numerator, fr.denominator), 0, np.asarray(offsets, np.int64),
                 np.asarray(sizes, np.int64))


def _avi_video_stream(hdrl: bytes, path: str):
    """(stream number, strh, strf) of the first 'vids' stream in hdrl."""
    n, pos = 0, 0
    while pos + 8 <= len(hdrl):
        cid, size = struct.unpack_from("<4sI", hdrl, pos)
        if cid == b"LIST" and hdrl[pos + 8:pos + 12] == b"strl":
            chunks, p, end = {}, pos + 12, min(pos + 8 + size, len(hdrl))
            while p + 8 <= end:
                c, s = struct.unpack_from("<4sI", hdrl, p)
                chunks.setdefault(c, hdrl[p + 8:p + 8 + s])
                p += 8 + s + (s & 1)
            strh = chunks.get(b"strh", b"")
            if strh[:4] == b"vids":
                if len(strh) < 28:
                    raise ValueError(f"{path}: strl {n}: a strh of {len(strh)} bytes")
                return n, strh, chunks.get(b"strf", b"")
            n += 1
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no video stream (no 'strl' whose strh is 'vids')")
