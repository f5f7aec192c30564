"""Test helpers for the port's video input (moda_tpu_torch/preproc/video.py):
Motion-JPEG frames made with cv2, a minimal AVI and ISO-BMFF (MP4/MOV)
muxer in ``struct`` that stores them as it is told (the odd files cv2's
writer never makes: moov before mdat, co64, 64-bit box sizes, mixed stts
durations, a rotation matrix, edit lists, zero-length AVI chunks, OpenDML
continuations), cv2's own readings of a clip, and the writer of the
chip_smoke.py fixtures under tests/goldens/.

    python -m tests.torch_video tests/goldens   # rebuild the fixtures
    python -m tests.torch_video tests/goldens clip_div3.avi  # rebuild these alone
    python -m tests.torch_video tests/goldens clip_h264_1080p_high.mp4 clip_h264_b_small.mp4 \
        clip_h264_b_cabac_small.mp4

cv2 is the oracle here and only here: the port reads no clip through it.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import tempfile

import cv2
import numpy as np

FIXTURE_FPS = 10  # the kept indices are recorded at preproc_app's default --fps
# (name, container fourcc for cv2.VideoWriter, fps, frames, height, width); the
# scene's seed is the index. Motion JPEG, then MPEG-4 Part 2 ('mp4v' in MP4:
# objectTypeIndication 0x20; the 1080p clip has two I-VOPs, GOP 12)
FIXTURES = (("clip_1080p.mov", "MJPG", 30.0, 15, 1080, 1920),
            ("clip_small.avi", "MJPG", 29.97, 12, 240, 320),
            ("clip_small.mp4", "MJPG", 24.0, 10, 240, 320),
            ("clip_mpeg4.mp4", "mp4v", 30.0, 3, 64, 96),
            ("clip_mpeg4_1080p.mp4", "mp4v", 30.0, 15, 1080, 1920))
# H.264 in MP4 from tests/torch_h264.py's writer: (name, fps, pictures, height,
# width, mode, entropy coder). "natural": the scene's frames coded by its
# small encoder (QP 35, an IDR, then P pictures from 2 references, the loop
# filter on in the last 3); "random": its random tool mix (every I and P
# type, 3 references with memory management operations and list
# modifications, 3 slices with the three deblocking settings and offsets,
# 120 x 72 cropped from 128 x 80; under CABAC also I_PCM first, mid-row and
# last in every slice, each P slice drawing its cabac_init_idc). "_high":
# at High profile, the 8x8 transform and Intra 8x8 on: the natural clip
# with flat lists (x264's default), the random mix with explicit SPS and PPS
# scaling lists and a Cr QP offset apart from Cb's. "_b": x264's default
# structure, the natural clip (its scene fading out 3 % a frame) coded as
# IBBP with a B-ref, weighted P, implicit bi-prediction and spatial direct
# (B_Skip), the VUI's max_num_reorder_frames 2, the MP4's ctts and edit
# list; the random mix with every B type, B-refs, explicit weights in P and
# B slices, spatial and temporal direct, list modifications, 2 slices. The
# 1080p clip is coded at 1088 rows, cropped.
H264_FIXTURES = (("clip_h264_1080p_high.mp4", 30, 15, 1080, 1920, "natural_high_b", "cabac"),
                 ("clip_h264_small.mp4", 30, 12, 72, 120, "random", "cavlc"),
                 ("clip_h264_cabac_small.mp4", 30, 12, 72, 120, "random", "cabac"),
                 ("clip_h264_high_small.mp4", 30, 12, 72, 120, "random_high", "cabac"),
                 ("clip_h264_b_small.mp4", 30, 10, 48, 80, "random_b", "cavlc"),
                 ("clip_h264_b_cabac_small.mp4", 30, 10, 48, 80, "random_b", "cabac"))
# an MS-MPEG-4 v3 clip ('DIV3' AVI, FFmpeg's msmpeg4v3): the codec refusal on the card
REFUSED_FIXTURE = ("clip_div3.avi", "DIV3", 30.0, 3, 64, 96)
ROTATION_MATRIX = {0: (1, 0, 0, 1), 90: (0, 1, -1, 0), 180: (-1, 0, 0, -1), 270: (0, -1, 1, 0)}


# ---------------------------------------------------------------- frames
def _field(rng, h: int, w: int, cell: int, ch: int) -> np.ndarray:
    """[h, w, ch] float32 in [0, 1]: uniform noise on a grid of ``cell``
    pixels, cubic-interpolated."""
    small = rng.random(((h + cell - 1) // cell + 1, (w + cell - 1) // cell + 1, ch))
    big = cv2.resize(small.astype(np.float32), (small.shape[1] * cell, small.shape[0] * cell),
                     interpolation=cv2.INTER_CUBIC)
    return big[:h, :w].reshape(h, w, ch)


def scene(n: int, h: int, w: int, seed: int = 0) -> list:
    """n BGR uint8 frames of a smooth moving scene with the statistics of
    filmed video (chroma far smoother than luma): a blurred luma texture of
    h / 16 px cells under a colour field of 4x larger cells, sliding 2 px a
    frame, and a bright blob crossing it."""
    rng = np.random.default_rng(seed)
    cell = max(8, h // 16)
    wide = w + 2 * n
    luma = cv2.GaussianBlur(_field(rng, h, wide, cell, 1)[..., 0], (0, 0), cell / 10) * 200 + 28
    tex = luma[..., None] + (_field(rng, h, wide, 4 * cell, 3) - 0.5) * 60
    yy, xx = np.mgrid[:h, :w]
    frames = []
    for i in range(n):
        cy, cx, r = h * 0.5, w * (0.3 + 0.4 * i / max(n - 1, 1)), min(h, w) / 6
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        f = tex[:, 2 * i:2 * i + w] * (1 - 0.4 * blob) + blob * np.array([60, 110, 150])
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def jpegs(n: int, h: int, w: int, seed: int = 0, quality: int = 90) -> list:
    """n JPEG bytes (cv2.imencode, 4:2:0, with their DHT) of ``scene``."""
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            for f in scene(n, h, w, seed)]


def strip_dht(jpeg: bytes) -> bytes:
    """The JPEG without its DHT segments (Motion JPEG as cameras write it:
    the decoder is to use JPEG Annex K.3's tables)."""
    out, pos = [jpeg[:2]], 2
    while True:
        marker, length = jpeg[pos + 1], struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out.append(jpeg[pos:])
            return b"".join(out)
        if marker != 0xC4:
            out.append(jpeg[pos:pos + 2 + length])
        pos += 2 + length


def write_cv2_clip(path: str, fourcc: str, fps: float, frames: list) -> None:
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened(), path
    for f in frames:
        vw.write(f)
    vw.release()


# -------------------------------------------------------------- cv2's view
def cv2_packets(path: str) -> list:
    """Each packet's bytes as cv2's FFmpeg backend demuxes them (with
    CAP_PROP_ORIENTATION_AUTO off: cv2 would turn a packet as a 1 x N image
    by the track's rotation)."""
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 0)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, pkt = cap.read()
        if not ok:
            break
        out.append(pkt.tobytes())
    cap.release()
    return out


def cv2_frames(path: str):
    """(reported rate, decoded BGR frames, reported orientation) of
    cv2.VideoCapture, which rotates by the track's display matrix."""
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    rot = cap.get(cv2.CAP_PROP_ORIENTATION_META)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return fps, out, rot


def kept_indices(n: int, src_fps: float, fps: int) -> list:
    """moda_tpu/preproc/pipeline.py::extract_frames's step rule."""
    step = max(int(round((src_fps or 30.0) / fps)), 1)
    return [i for i in range(n) if i % step == 0]


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def readings(path: str, fps: int = FIXTURE_FPS, decoded: bool = False) -> dict:
    """cv2's readings of a clip: the rate, the frame count, the kept indices
    at ``fps``, SHA-256 of every raw packet and of the BGR pixels of each
    kept frame: cv2.imdecode's of the packet (Motion JPEG), or with
    ``decoded`` VideoCapture's own (FFmpeg's decoder and swscale). A decoded
    clip also records every frame's digest (``all_pixels_sha256``)."""
    src_fps, frames, _ = cv2_frames(path)
    packets = cv2_packets(path)
    kept = kept_indices(len(frames), src_fps, fps)
    out = {"fps": src_fps, "frames": len(frames), "kept_at_fps": fps, "kept": kept,
           "packet_sha256": [sha(p) for p in packets]}
    if decoded:
        out["all_pixels_sha256"] = [sha(f.tobytes()) for f in frames]
        out["pixels_sha256"] = [out["all_pixels_sha256"][i] for i in kept]
    else:
        out["pixels_sha256"] = [sha(cv2.imdecode(np.frombuffer(packets[i], np.uint8),
                                                 cv2.IMREAD_COLOR).tobytes()) for i in kept]
    return out


def write_fixtures(out_dir: str, only=None) -> dict:
    """The clips of chip_smoke.py's video phases, written by cv2.VideoWriter
    (the H.264 ones by tests/torch_h264.py), and cv2's readings of each in
    video_readings.json (of the refused MS-MPEG-4 clip, its codec). ``only``: the names to write anew, the
    others' files and readings kept."""
    os.makedirs(out_dir, exist_ok=True)
    info = {}
    readings_path = os.path.join(out_dir, "video_readings.json")
    if only is not None and os.path.exists(readings_path):
        with open(readings_path) as f:
            info = {k: v for k, v in json.load(f).items() if k not in only}
    for k, (name, fourcc, fps, n, h, w) in enumerate(FIXTURES):
        if only is not None and name not in only:
            continue
        path = os.path.join(out_dir, name)
        write_cv2_clip(path, fourcc, fps, scene(n, h, w, seed=k))
        info[name] = dict(readings(path, decoded=fourcc != "MJPG"), size=[h, w],
                          bytes=os.path.getsize(path))
    for k, (name, fps, n, h, w, mode, entropy) in enumerate(H264_FIXTURES):
        if only is not None and name not in only:
            continue
        path = os.path.join(out_dir, name)
        write_h264(path, fps, n, h, w, mode, entropy, seed=len(FIXTURES) + k)
        info[name] = dict(readings(path, decoded=True), size=[h, w],
                          bytes=os.path.getsize(path))
    name, fourcc, fps, n, h, w = REFUSED_FIXTURE
    if only is None or name in only:
        path = os.path.join(out_dir, name)
        write_cv2_clip(path, fourcc, fps, scene(n, h, w))
        info[name] = {"codec": fourcc, "bytes": os.path.getsize(path)}
    with open(os.path.join(out_dir, "video_readings.json"), "w") as f:
        json.dump(info, f, indent=1)
        f.write("\n")
    return info


def write_h264(path: str, fps: int, n: int, h: int, w: int, mode: str, entropy: str,
               seed: int) -> None:
    """An H.264 golden (H264_FIXTURES), checked valid: cv2 decodes it with
    no avcodec error or warning."""
    from tests import torch_h264 as H

    high = "_high" in mode
    if mode == "natural_high_b":
        frames = [np.clip(f * (1 - 0.03 * k), 0, 255).astype(np.uint8)
                  for k, f in enumerate(scene(n, h, w, seed=seed))]
        seq, samples = H.natural_stream(frames, qp=35, refs=3, deblock_last=3, entropy=entropy,
                                        high=True, bframes=3)
    elif mode.startswith("natural"):
        seq, samples = H.natural_stream(scene(n, h, w, seed=seed), qp=35, refs=2,
                                        deblock_last=3, entropy=entropy, high=high)
    elif mode == "random_b":
        seq, samples = H.random_stream(w, h, n, seed=seed, max_refs=3, bframes=2, pyramid=True,
                                       direct="mixed", slices=2, deblock=H.DEBLOCKS,
                                       modify=True, weights=H.B_WEIGHTS, entropy=entropy,
                                       seq_args={"pps_extra": {"weighted_bipred_idc": 1,
                                                               "weighted_pred": 1},
                                                 "sps_extra": {"reorder": 2},
                                                 "log2_max_poc_lsb": 8})
    else:
        extra = {}
        if high:
            rng = np.random.default_rng(seed)
            extra = dict(weights=H.HIGH_WEIGHTS, seq_args=dict(
                chroma_qp_offset=-2,
                sps_extra={"profile": 100, "scaling_lists": H.scaling_specs(rng, "vdvavdva")},
                pps_extra={"transform_8x8_mode": 1, "second_chroma_qp_offset": 3,
                           "scaling_lists": H.scaling_specs(rng, "avvdvavv")}))
        seq, samples = H.random_stream(w, h, n, seed=seed, max_refs=3, mmco=True,
                                       modify=True, slices=3, deblock=H.DEBLOCKS,
                                       nonref=0.2, big=0.05, entropy=entropy,
                                       pcm_places=entropy == "cabac", **extra)
    H.write_mp4(path, seq, samples, fps=fps)
    with tempfile.TemporaryDirectory() as tmp:
        (frames, logs), = H.cv2_read([path], tmp)
    assert len(frames) == n and not logs, logs


# ------------------------------------------------------------------- AVI
def _chunk(cid: bytes, body: bytes) -> bytes:
    return struct.pack("<4sI", cid, len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, typ: bytes, *parts: bytes) -> bytes:
    body = typ + b"".join(parts)
    return struct.pack("<4sI", kind, len(body)) + body


def write_avi(path: str, samples: list, h: int, w: int, rate: int = 30, scale: int = 1,
              fourcc: bytes = b"MJPG", stream: int = 0, riff_frames=None,
              index: bool = True, audio_every: int = 0, suffix: bytes = b"dc",
              rec_every: int = 0) -> None:
    """An AVI of ``samples`` (bytes each; b"" writes a zero-length chunk, a
    dropped frame) as stream ``stream`` ('##dc' chunks) at rate / scale.
    ``riff_frames`` = k puts the first k chunks in 'RIFF AVI ' and the rest
    in OpenDML 'RIFF AVIX' continuations of k each (no idx1 then);
    ``audio_every`` = k puts an audio chunk of the stream before it after
    every k video chunks; ``index`` writes idx1; ``suffix`` b"db" names
    the chunks '##db'; ``rec_every`` = k groups every k chunks in a
    LIST 'rec '."""
    avih = struct.pack("<10I4I", int(1e6 * scale / rate), 0, 0, 0x10 if index else 0,
                       len(samples), 0, stream + 1, 0, w, h, 0, 0, 0, 0)
    strls = []
    for s in range(stream):  # audio streams before the video one
        strh = struct.pack("<4s4sIHHIIIIIIII4h", b"auds", b"\0" * 4, 0, 0, 0, 0, 1, 8000, 0,
                           0, 0, 0xFFFFFFFF, 1, 0, 0, 0, 0)
        strf = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
        strls.append(_list(b"LIST", b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf)))
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0,
                       len(samples), max(map(len, samples)), 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
    strls.append(_list(b"LIST", b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf)))
    hdrl = _list(b"LIST", b"hdrl", _chunk(b"avih", avih), *strls)
    vid = b"%02d" % stream + suffix
    aud = b"00wb"

    def movi(chunk_samples):
        parts, idx, off = [], [], 4
        for i, s in enumerate(chunk_samples):
            if audio_every and stream and i and i % audio_every == 0:
                parts.append(_chunk(aud, b"\x80" * 267))
                idx.append((aud, 0, off, 267))
                off += len(parts[-1])
            parts.append(_chunk(vid, s))
            idx.append((vid, 0x10, off, len(s)))
            off += len(parts[-1])
        if rec_every:
            parts = [_list(b"LIST", b"rec ", *parts[i:i + rec_every])
                     for i in range(0, len(parts), rec_every)]
            idx.clear()  # idx1's offsets would move: no idx1
        return _list(b"LIST", b"movi", *parts), idx

    k = riff_frames or len(samples)
    first, idx = movi(samples[:k])
    tail = [_chunk(b"idx1", b"".join(struct.pack("<4sIII", *e) for e in idx))] \
        if index and riff_frames is None and not rec_every else []
    riffs = [_list(b"RIFF", b"AVI ", hdrl, first, *tail)]
    for j in range(k, len(samples), k):
        riffs.append(_list(b"RIFF", b"AVIX", movi(samples[j:j + k])[0]))
    with open(path, "wb") as f:
        f.write(b"".join(riffs))


# -------------------------------------------------------------- ISO-BMFF
def _box(typ: bytes, *parts: bytes, large: bool = False) -> bytes:
    body = b"".join(parts)
    if large:
        return struct.pack(">I4sQ", 1, typ, 16 + len(body)) + body
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(typ, struct.pack(">I", version << 24 | flags), *parts)


def _matrix(rotation: int) -> bytes:
    a, b, c, d = ROTATION_MATRIX[rotation]
    return struct.pack(">9i", a << 16, b << 16, 0, c << 16, d << 16, 0, 0, 0, 1 << 30)


def _esds(oti: int, config: bytes = b"") -> bytes:
    dsi = bytes([0x05, len(config)]) + config if config else b""
    dcd = bytes([0x04, 13 + len(dsi), oti, 0x11]) + b"\0" * 11 + dsi
    es = bytes([0x03, 3 + len(dcd) + 3]) + struct.pack(">HB", 1, 0) + dcd + bytes([0x06, 1, 2])
    return _full(b"esds", 0, 0, es)


def write_isobmff(path: str, samples: list, h: int, w: int, timescale: int = 30,
                  durations=1, fourcc: bytes = b"jpeg", oti=None, brand: bytes = b"qt  ",
                  moov_first: bool = False, co64: bool = False, large_mdat: bool = False,
                  rotation: int = 0, elst=((None, 0, 1),), chunk_samples: int = 3,
                  fragmented: bool = False, stz2: bool = False, config: bytes = b"",
                  avcc: bytes = b"", ctts=None) -> None:
    """An MP4/MOV of ``samples`` (one video track, ``fourcc`` sample entry;
    ``oti`` adds an esds with that objectTypeIndication, ``config`` its
    DecoderSpecificInfo; ``avcc`` adds an avcC box, the
    AVCDecoderConfigurationRecord of an 'avc1'/'avc3' entry) at ``timescale``
    with ``durations`` (one for all samples or one each), ``chunk_samples``
    samples a chunk (the last chunk takes the rest). ``elst``: (segment
    duration or None for the whole track, media_time, rate) entries, or
    None for no edts; ``rotation`` sets tkhd's matrix; ``fragmented`` adds
    moov/mvex; ``stz2`` writes the sizes as a 16-bit stz2; ``ctts`` (one
    composition offset a sample) adds a version 0 ctts."""
    n = len(samples)
    durs = [durations] * n if isinstance(durations, int) else list(durations)
    total = sum(durs)
    movie_ts = 1000
    movie_dur = -(-total * movie_ts // timescale)
    stts_runs = []
    for d in durs:
        if stts_runs and stts_runs[-1][1] == d:
            stts_runs[-1][0] += 1
        else:
            stts_runs.append([1, d])
    chunks = [samples[i:i + chunk_samples] for i in range(0, n, chunk_samples)]
    stsc = [(1, chunk_samples, 1)] + ([(len(chunks), len(chunks[-1]), 1)]
                                      if len(chunks[-1]) != chunk_samples else [])
    ftyp = _box(b"ftyp", brand, struct.pack(">I", 0x200), brand, b"isom" if brand != b"isom"
                else b"mp41")

    def moov(chunk_offsets):
        entry = (struct.pack(">6xH", 1) + b"\0" * 16 + struct.pack(">HHIIIH", w, h, 0x480000,
                                                                  0x480000, 0, 1)
                 + b"\0" * 32 + struct.pack(">Hh", 24, -1)
                 + (_esds(oti, config) if oti is not None else b"")
                 + (_box(b"avcC", avcc) if avcc else b""))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), _box(fourcc, entry))
        stts = _full(b"stts", 0, 0, struct.pack(">I", len(stts_runs)),
                     *(struct.pack(">II", c, d) for c, d in stts_runs))
        stsc_b = _full(b"stsc", 0, 0, struct.pack(">I", len(stsc)),
                       *(struct.pack(">III", *e) for e in stsc))
        if stz2:
            stsz = _full(b"stz2", 0, 0, struct.pack(">II", 16, n),
                         *(struct.pack(">H", len(s)) for s in samples))
        else:
            stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                         *(struct.pack(">I", len(s)) for s in samples))
        if co64:
            stco = _full(b"co64", 0, 0, struct.pack(">I", len(chunk_offsets)),
                         *(struct.pack(">Q", o) for o in chunk_offsets))
        else:
            stco = _full(b"stco", 0, 0, struct.pack(">I", len(chunk_offsets)),
                         *(struct.pack(">I", o) for o in chunk_offsets))
        ctts_b = []
        if ctts is not None:
            runs = []
            for c in ctts:
                if runs and runs[-1][1] == c:
                    runs[-1][0] += 1
                else:
                    runs.append([1, c])
            ctts_b = [_full(b"ctts", 0, 0, struct.pack(">I", len(runs)),
                            *(struct.pack(">II", k, c) for k, c in runs))]
        stbl = _box(b"stbl", stsd, stts, *ctts_b, stsc_b, stsz, stco)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\0" * 8), dinf, stbl)
        hdlr = _full(b"hdlr", 0, 0, b"\0" * 4, b"vide", b"\0" * 12, b"VideoHandler\0")
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, total, 0x55C4, 0))
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_dur), b"\0" * 8,
                     struct.pack(">hhhH", 0, 0, 0, 0), _matrix(rotation),
                     struct.pack(">II", w << 16, h << 16))
        parts = [tkhd]
        if elst is not None:
            parts.append(_box(b"edts", _full(b"elst", 0, 0, struct.pack(">I", len(elst)), *(
                struct.pack(">IiI", movie_dur if seg is None else seg, mt, int(r * 65536))
                for seg, mt, r in elst))))
        trak = _box(b"trak", *parts, mdia)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIII", 0, 0, movie_ts, movie_dur, 0x10000),
                     struct.pack(">H", 0x100), b"\0" * 10, _matrix(0), b"\0" * 24,
                     struct.pack(">I", 2))
        extra = [_box(b"mvex", _full(b"trex", 0, 0, struct.pack(">5I", 1, 1, 0, 0, 0)))] \
            if fragmented else []
        return _box(b"moov", mvhd, *extra, trak)

    payload = b"".join(b"".join(c) for c in chunks)
    mdat_hdr = 16 if large_mdat else 8
    rel, pos = [], 0
    for c in chunks:
        rel.append(pos)
        pos += sum(map(len, c))
    moov_len = len(moov([0] * len(chunks)))
    base = len(ftyp) + (moov_len if moov_first else 0) + mdat_hdr
    mdat = _box(b"mdat", payload, large=large_mdat)
    body = moov([base + r for r in rel])
    with open(path, "wb") as f:
        f.write(ftyp + (body + mdat if moov_first else mdat + body))


if __name__ == "__main__":
    for name, r in write_fixtures(sys.argv[1] if len(sys.argv) > 1 else "tests/goldens",
                                  sys.argv[2:] or None).items():
        print(name, r["bytes"], "bytes:", r.get("codec") or
              f"{r['frames']} frames @ {r['fps']} fps, kept {r['kept']}")
