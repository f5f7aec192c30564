"""The port's MPEG-4 Part 2 decoder (moda_tpu_torch/preproc/m4v.py, its host
parser native/m4v.cpp and its kernels' plain versions) against
cv2.VideoCapture, and its extract_frames against the JAX package's, on the
CPU.

Clips come from cv2.VideoWriter (FFmpeg's mpeg4 encoder at its defaults:
'mp4v' in MP4, 'XVID', 'DIVX', 'FMP4' and 'DX50' in AVI) and from the
struct muxer of tests/torch_video.py (other fourccs, bit-edited streams).
The oracles:
- every frame the port decodes is bit-equal to VideoCapture's BGR frame
  (FFmpeg's decoder and swscale): no tolerance;
- extract_frames keeps the JAX package's count, names and indices; its
  stored PNGs are VideoCapture's frames, and the JAX package's stored q95
  JPEGs lie within JPEG_MEAN (mean absolute error) and JPEG_MAX of them;
- what the port refuses raises ValueError naming the feature or the codec
  before any file is written.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.preproc import pipeline as JP
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.preproc import m4v as M
from moda_tpu_torch.preproc import pipeline as TP
from moda_tpu_torch.preproc import video as TV
from tests import torch_video as V

# the JAX package's stored frames (VideoCapture's, re-encoded by cv2.imwrite at
# quality 95) against VideoCapture's: measured 0.64-1.03 mean and 5-12 max on
# these clips (uint8 levels); the gates leave room for other seeds
JPEG_MEAN, JPEG_MAX = 2.0, 24
FRAMES = 14  # two I-VOPs: FFmpeg's default GOP is 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moving(n, h, w, speed, seed=0, dark=False, noise=False):
    """n BGR frames of ``tests/torch_video.scene``'s texture panned by
    ``speed`` px a frame right and speed / 2 down (a large ``speed`` makes
    FFmpeg pick fcode >= 2); ``dark`` blacks out a third and crushes the
    lower half to 0 (the clip edges of the half-pel averages), ``noise``
    adds seeded uniform noise (large levels, escape codes, dquant)."""
    base = V.scene(1, h + n * speed + 40, w + n * speed + 40, seed)[0].astype(int)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = base[i * speed // 2:i * speed // 2 + h, i * speed:i * speed + w].copy()
        if dark:
            f[:, :w // 3] = 0
            f[h // 2:] = np.clip(f[h // 2:] * 3 - 300, 0, 255)
        if noise:
            f = f + rng.integers(-60, 60, f.shape)
        out.append(np.ascontiguousarray(np.clip(f, 0, 255).astype(np.uint8)))
    return out


# name -> (container fourcc, extension, frames)
CLIPS = {
    "mp4v_240x320": ("mp4v", "mp4", lambda: V.scene(FRAMES, 240, 320, seed=1)),
    "xvid_64x88": ("XVID", "avi", lambda: V.scene(FRAMES, 64, 88, seed=2)),
    "divx_40x72": ("DIVX", "avi", lambda: V.scene(FRAMES, 40, 72, seed=3)),
    "fmp4_50x90": ("FMP4", "avi", lambda: V.scene(FRAMES, 50, 90, seed=4)),
    "divx_odd_51x91": ("DIVX", "avi", lambda: V.scene(FRAMES, 51, 91, seed=9)),
    "dx50_fast_120x160": ("DX50", "avi", lambda: _moving(20, 120, 160, 13, seed=5)),
    "mp4v_faster_120x160": ("mp4v", "mp4", lambda: _moving(20, 120, 160, 37, seed=6)),
    "mp4v_dark_96x128": ("mp4v", "mp4", lambda: _moving(26, 96, 128, 3, seed=7, dark=True)),
    "xvid_noise_96x128": ("XVID", "avi", lambda: _moving(FRAMES, 96, 128, 2, seed=8,
                                                         noise=True)),
}


def _clip(tmp_path, name):
    fourcc, ext, frames = CLIPS[name]
    path = str(tmp_path / f"{name}.{ext}")
    V.write_cv2_clip(path, fourcc, 30.0, frames())
    return path


def decode_all(path, device="cpu"):
    """(every picture the port decodes, in BGR; each sample's parsed VOP)."""
    clip = TV.open_video(path)
    dec = M.Mpeg4Decoder(clip, device)
    vops, out = [], []
    for i in range(len(clip)):
        v = clip.vop(dec.parser, i)
        vops.append(v)
        if dec.advance(v):
            out.append(dec.picture().numpy())
    return out, vops


# ------------------------------------------------------------------ decoding
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_frames_bit_equal_to_videocapture(tmp_path, name):
    """Every frame of a cv2-written clip, decoded on the CPU (the host
    parse, reconstruct_plain, yuv420_to_bgr_plain), equals VideoCapture's
    BGR frame: sizes with and without macroblock padding (88, 72, 90 and 91
    wide; 40, 50 and 51 high), two I-VOPs, both rounding types, fcode up to 4
    (the fast pans), black and saturated regions, noise."""
    path = _clip(tmp_path, name)
    _, vc, _ = V.cv2_frames(path)
    got, vops = decode_all(path)
    assert len(got) == len(vc) == len(vops) and TV.open_video(path).kind == "mpeg4"
    for i, (a, b) in enumerate(zip(got, vc)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: frame {i}")
    codings = [v.coding for v in vops]
    assert codings.count(M.VOP_I) >= 2 and {v.rounding for v in vops[1:12]} == {0, 1}
    if "fast" in name:
        assert max(v.fcode for v in vops) >= 2
    types = np.concatenate([v.mbs[:, M.F_TYPE] for v in vops if v.coding == M.VOP_P])
    assert (types == M.MB_INTER).any()


def test_the_clips_reach_what_the_parser_parses(tmp_path):
    """Across CLIPS the streams hold what the bit-equality above is to
    cover: intra and not-coded macroblocks inside P-VOPs, odd (half-pel)
    vectors on both axes, vectors pointing past the picture, levels past the
    VLC tables' reach (inter levels past 12: escapes), intra DCs past 1023
    at QP 4 or less (the IDCT's row
    shortcut differs there from its row formula), QP changes."""
    seen = {"intra_in_p": 0, "skip": 0, "half_x": 0, "half_y": 0, "outside": 0,
            "escaped": 0, "big_dc": 0, "qps": set()}
    for name in ("dx50_fast_120x160", "mp4v_dark_96x128", "xvid_noise_96x128"):
        path = _clip(tmp_path, name)
        _, vops = decode_all(path)
        clip = TV.open_video(path)
        mb_w, mb_h = -(-clip.width // 16), -(-clip.height // 16)
        for v in vops:
            mbs, lv = v.mbs, v.levels.astype(int)
            typ = mbs[:, M.F_TYPE]
            seen["qps"] |= set(mbs[:, M.F_QP].tolist())
            if v.coding == M.VOP_P:
                seen["intra_in_p"] += int((typ == M.MB_INTRA).sum())
                seen["skip"] += int((typ == M.MB_SKIP).sum())
                inter = mbs[typ == M.MB_INTER]
                seen["half_x"] += int((inter[:, M.F_MVX] & 1).sum())
                seen["half_y"] += int((inter[:, M.F_MVY] & 1).sum())
                k = np.nonzero(typ == M.MB_INTER)[0]
                x = 16 * (k % mb_w) + (inter[:, M.F_MVX] >> 1)
                y = 16 * (k // mb_w) + (inter[:, M.F_MVY] >> 1)
                seen["outside"] += int(((x < 0) | (y < 0) | (x + 17 > 16 * mb_w) |
                                        (y + 17 > 16 * mb_h)).sum())
            inter_rows = mbs[typ == M.MB_INTER][:, M.F_BLK:].reshape(-1)
            seen["escaped"] += int((np.abs(lv[inter_rows[inter_rows >= 0]]) > 12).sum())
            intra = mbs[typ == M.MB_INTRA][:, M.F_BLK:M.F_BLK + 4].reshape(-1)
            seen["big_dc"] += int((lv[intra, 0] * 8 > 1023).sum())
    assert all(v > 0 for k, v in seen.items() if k != "qps"), seen
    assert len(seen["qps"]) > 1, seen


def test_video_frame_decodes_from_the_last_i_vop(tmp_path):
    """Video.frame(i) of an MPEG-4 track decodes from the last I-VOP at or
    before sample i: RGB, VideoCapture's frame in RGB order."""
    path = _clip(tmp_path, "mp4v_240x320")
    _, vc, _ = V.cv2_frames(path)
    clip = TV.open_video(path)
    for i in (0, 5, 12, 13):
        np.testing.assert_array_equal(clip.frame(i, device="cpu")[..., ::-1], vc[i])


def test_a_vop_with_vop_coded_0_is_no_frame(tmp_path):
    """A P-VOP bit-edited to vop_coded 0 (its header up to the flag, then
    stuffing): cv2 reads no frame for it and keeps its reference, and so
    does the port: 13 frames from 14 samples, each equal to VideoCapture's;
    extract_frames keeps the JAX package's count."""
    src = _clip(tmp_path, "xvid_64x88")
    packets = V.cv2_packets(src)
    packets[5] = _vop_header_only(packets[5])
    path = str(tmp_path / "not_coded.avi")
    V.write_avi(path, packets, 64, 88, fourcc=b"XVID")
    _, vc, _ = V.cv2_frames(path)
    got, vops = decode_all(path)
    assert len(vc) == len(got) == 13 and vops[5].coding == M.VOP_NOT_CODED
    for a, b in zip(got, vc):
        np.testing.assert_array_equal(a, b)
    j = JP.extract_frames(path, str(tmp_path / "j"), fps=30)
    t = TP.extract_frames(path, str(tmp_path / "t"), fps=30, device="cpu")
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j]
    with pytest.raises(ValueError, match="sample 5: a VOP with vop_coded 0"):
        TV.open_video(path).frame(5, device="cpu")


def test_a_p_vop_without_a_reference(tmp_path):
    """A P-VOP with no reference: reconstruct_plain predicts it from zero,
    as from a black frame (the kernel does the same, reading nothing), and
    the decoder refuses it."""
    clip = TV.open_video(_clip(tmp_path, "xvid_64x88"))
    dec = M.Mpeg4Decoder(clip, "cpu")
    vops = [clip.vop(dec.parser, i) for i in range(3)]
    assert [v.coding for v in vops] == [M.VOP_I, M.VOP_P, M.VOP_P]
    g, v = dec.parser.geometry, vops[2]
    mbs, levels = torch.from_numpy(v.mbs), torch.from_numpy(v.levels)
    assert (mbs[:, M.F_TYPE] != M.MB_INTRA).any()
    black = torch.zeros(g.frame_bytes, dtype=torch.uint8)
    np.testing.assert_array_equal(M.reconstruct_plain(None, mbs, levels, v.rounding, g),
                                  M.reconstruct_plain(black, mbs, levels, v.rounding, g))
    with pytest.raises(ValueError, match="a P-VOP without a preceding I-VOP"):
        dec.advance(v)


@pytest.mark.parametrize("rotation", [90, 180, 270])
def test_rotated_mp4v_clips(tmp_path, rotation):
    """cv2's mp4v stream re-muxed with a tkhd display matrix (its VOL in the
    esds): VideoCapture turns its frames, and so do Video.frame and
    extract_frames (PNG), bit for bit."""
    src = _clip(tmp_path, "mp4v_240x320")
    clip = TV.open_video(src)
    path = str(tmp_path / "rotated.mp4")
    V.write_isobmff(path, [clip.sample(i) for i in range(len(clip))], 240, 320,
                    fourcc=b"mp4v", oti=0x20, config=clip.config, brand=b"isom",
                    rotation=rotation)
    _, vc, rot = V.cv2_frames(path)
    assert rot == rotation and TV.open_video(path).rotation == rotation
    np.testing.assert_array_equal(TV.open_video(path).frame(13, device="cpu")[..., ::-1], vc[13])
    paths = TP.extract_frames(path, str(tmp_path / "t"), fps=10, device="cpu")
    for p, i in zip(paths, V.kept_indices(len(vc), 30.0, 10)):
        np.testing.assert_array_equal(IO.imread(p)[..., ::-1], vc[i])


def test_a_refused_mp4_vol_raises_from_the_esds(tmp_path):
    """An mp4v clip whose esds VOL says quant_type 1 (the bit flipped in
    the file): ValueError naming the esds and the feature, nothing
    written."""
    src = _clip(tmp_path, "mp4v_240x320")
    config = TV.open_video(src).config
    byte0, f = _vol_fields(config)
    data = open(src, "rb").read()
    at = data.index(config)
    with open(src, "wb") as out:
        out.write(_flip(data, at + byte0, f["quant_type"]))
    with pytest.raises(ValueError, match="decoder configuration \\(esds\\): quant_type 1"):
        TP.extract_frames(src, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


# ------------------------------------------------------------ extract_frames
@pytest.mark.parametrize("name,fps", [("mp4v_240x320", 10), ("xvid_64x88", 15),
                                      ("fmp4_50x90", 30)])
def test_extract_frames_matches_the_jax_packages(tmp_path, name, fps):
    """The port's extract_frames (device "cpu") against the JAX package's:
    the same count, names and kept indices (every round(30 / fps)-th frame);
    the port's stored frames are 8-bit RGB PNGs of VideoCapture's frames,
    the JAX package's q95 JPEGs within JPEG_MEAN and JPEG_MAX of them."""
    path = _clip(tmp_path, name)
    src_fps, vc, _ = V.cv2_frames(path)
    j = JP.extract_frames(path, str(tmp_path / "j"), fps=fps)
    t = TP.extract_frames(path, str(tmp_path / "t"), fps=fps, device="cpu")
    kept = V.kept_indices(len(vc), src_fps, fps)
    names = ["%05d.jpg" % k for k in range(len(kept))]
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == names
    errs = []
    for p, q, i in zip(t, j, kept):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(IO.imread(p)[..., ::-1], vc[i])
        errs.append(np.abs(cv2.imread(q).astype(int) - vc[i].astype(int)))
    assert np.mean([e.mean() for e in errs]) <= JPEG_MEAN and max(e.max() for e in errs) <= JPEG_MAX


# ------------------------------------------------------------------ fourccs
@pytest.fixture(scope="module")
def xvid_packets(tmp_path_factory):
    """cv2's raw packets of the 64 x 88 'XVID' clip."""
    return V.cv2_packets(_clip(tmp_path_factory.mktemp("xvid"), "xvid_64x88"))


@pytest.mark.parametrize("fourcc", list(TV.AVI_MPEG4) + ["xvid", "divx", "fmp4", "Dx50",
                                                         "mp4v"])
def test_avi_fourccs_cv2_decodes_as_mpeg4(tmp_path, xvid_packets, fourcc):
    """cv2's XVID stream re-muxed under each AVI fourcc the port takes for
    MPEG-4 Part 2 (video.AVI_MPEG4, and some in other cases): cv2 decodes
    it, and the port reads the track as MPEG-4 Part 2 and decodes the same
    frames."""
    path = str(tmp_path / "clip.avi")
    V.write_avi(path, xvid_packets, 64, 88, fourcc=fourcc.encode("latin-1"))
    _, vc, _ = V.cv2_frames(path)
    got, _ = decode_all(path)
    assert TV.open_video(path).kind == "mpeg4" and len(got) == len(vc) == FRAMES
    for a, b in zip(got, vc):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ refusals
def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" + "1" * ((8 - (len(bits) + 1) % 8) % 8)  # next_start_code stuffing
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _vop_header_only(sample: bytes, tib: int = 5) -> bytes:
    """The sample's VOP as a vop_coded 0 VOP (cv2's 30 fps streams carry a
    5-bit vop_time_increment)."""
    i = sample.index(b"\x00\x00\x01\xb6")
    s = _bits(sample[i + 4:])
    pos = 2
    while s[pos] == "1":
        pos += 1
    return sample[:i + 4] + _bytes(s[:pos + 3 + tib] + "0")


def _vol_fields(sample: bytes):
    """(byte offset of the VOL's first bit, {field: bit offset}) of cv2's
    VOL (verid 1, vol_control_parameters with no VBV parameters)."""
    i = sample.index(b"\x00\x00\x01\x20") + 4
    s = _bits(sample[i:i + 16])
    pos = 1 + 8
    pos += 1 + (7 if s[9] == "1" else 0)
    pos += 4
    assert s[pos] == "1" and s[pos + 4] == "0", "vol_control_parameters without VBV"
    pos += 5
    f = {"shape": pos}
    pos += 2 + 1
    res = int(s[pos:pos + 16], 2)
    pos += 16 + 1
    tib = max((res - 1).bit_length(), 1)
    pos += 1 + (tib if s[pos] == "1" else 0)
    pos += 1 + 13 + 1 + 13 + 1
    f.update(interlaced=pos, sprite=pos + 2, not_8_bit=pos + 3, quant_type=pos + 4,
             resync=pos + 6, data_partitioned=pos + 7)
    return i, f


def _flip(sample: bytes, byte0: int, bit: int) -> bytes:
    b = bytearray(sample)
    b[byte0 + bit // 8] ^= 0x80 >> (bit % 8)
    return bytes(b)


def _set_bits(sample: bytes, byte0: int, bit: int, n: int, value: int) -> bytes:
    s = _bits(sample[byte0:])
    s = s[:bit] + format(value, f"0{n}b") + s[bit + n:]
    return sample[:byte0] + bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def _vol_of_size(sample: bytes, width: int, height: int) -> bytes:
    """The sample's VOL (its start code up to the next one) with its
    video_object_layer_width and height set."""
    i = sample.index(b"\x00\x00\x01\x20")
    vol = sample[i:sample.index(b"\x00\x00\x01", i + 4)]
    byte0, f = _vol_fields(vol)
    at = f["interlaced"] - 28  # width, marker, height, marker before it
    return _set_bits(_set_bits(vol, byte0, at, 13, width), byte0, at + 14, 13, height)


def _set_vop_type(sample: bytes, bits: str) -> bytes:
    i = sample.index(b"\x00\x00\x01\xb6") + 4
    b = bytearray(sample)
    b[i] = (b[i] & 0x3F) | int(bits, 2) << 6
    return bytes(b)


def _first_mb_inter4v(sample: bytes, tib: int = 5) -> bytes:
    """A P-VOP whose first macroblock is coded, with MCBPC 'inter4v, cbpc
    0' ('010'), the rest of the stream after it."""
    i = sample.index(b"\x00\x00\x01\xb6")
    s = _bits(sample[i + 4:])
    pos = 2
    while s[pos] == "1":
        pos += 1
    pos += 3 + tib + 1 + 1 + 3 + 5 + 3  # ..., vop_coded, rounding, dc thr, quant, fcode
    return sample[:i + 4] + _bytes(s[:pos] + "0" + "010" + s[pos:])


REFUSALS = {
    "quant_type": ("sample 0: quant_type 1", lambda p: [
        _flip(p[0], *_vol(p[0], "quant_type"))] + p[1:]),
    "interlaced": ("sample 0: interlaced VOL", lambda p: [
        _flip(p[0], *_vol(p[0], "interlaced"))] + p[1:]),
    "resync_markers": ("sample 0: resync markers", lambda p: [
        _flip(p[0], *_vol(p[0], "resync"))] + p[1:]),
    "data_partitioning": ("sample 0: data partitioning", lambda p: [
        _flip(p[0], *_vol(p[0], "data_partitioned"))] + p[1:]),
    "sprite": ("sample 0: sprite_enable 1", lambda p: [
        _flip(p[0], *_vol(p[0], "sprite"))] + p[1:]),
    "not_8_bit": ("sample 0: not_8_bit", lambda p: [
        _flip(p[0], *_vol(p[0], "not_8_bit"))] + p[1:]),
    "b_vop": ("sample 3: a B-VOP", lambda p: p[:3] + [_set_vop_type(p[3], "10")] + p[4:]),
    "s_vop": ("sample 4: an S-VOP", lambda p: p[:4] + [_set_vop_type(p[4], "11")] + p[5:]),
    "inter4v": ("sample 2: a macroblock with four motion vectors \\(INTER4V\\)",
                lambda p: p[:2] + [_first_mb_inter4v(p[2])] + p[3:]),
    "xvid_user_data": ("sample 0: user data 'XviD0050' names an XviD encoder", lambda p: [
        p[0].replace(b"\x00\x00\x01\xb6", b"\x00\x00\x01\xb2XviD0050\x00\x00\x01\xb6", 1)]
        + p[1:]),
    "divx_user_data": ("sample 0: user data 'DivX503b1393' names a DivX encoder", lambda p: [
        p[0].replace(b"\x00\x00\x01\xb6", b"\x00\x00\x01\xb2DivX503b1393\x00\x00\x01\xb6", 1)]
        + p[1:]),
    "xvid_fourcc_without_user_data": ("sample 0: fourcc XVID with no user data", lambda p: [
        p[0].replace(b"\x00\x00\x01\xb2Lavc", b"\x00\x00\x01\xb3Lavc", 1)] + p[1:]),
    "larger_vol": ("sample 3: the VOL changes size from 88 x 64 to 176 x 128", lambda p: p[:3]
                   + [_vol_of_size(p[0], 176, 128) + p[3]] + p[4:]),
    "smaller_vol": ("sample 7: the VOL changes size from 88 x 64 to 40 x 32", lambda p: p[:7]
                    + [_vol_of_size(p[0], 40, 32) + p[7]] + p[8:]),
}


def _vol(sample, field):
    byte0, f = _vol_fields(sample)
    return byte0, f[field]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_streams_raise_before_anything_is_written(tmp_path, case):
    """Bit-edited copies of cv2's XVID stream: each feature the port does
    not decode raises ValueError naming it and the sample, from
    extract_frames before any frame is written. (The user-data cases and an
    XVID fourcc without user data are streams FFmpeg decodes with Xvid's or
    DivX's tools and bug workarounds.)"""
    match, edit = REFUSALS[case]
    src = _clip(tmp_path, "xvid_64x88")
    path = str(tmp_path / "edited.avi")
    V.write_avi(path, edit(V.cv2_packets(src)), 64, 88, fourcc=b"XVID")
    with pytest.raises(ValueError, match=match):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


def test_the_parser_writes_no_record_past_its_buffer(xvid_packets):
    """m4v_parse given fewer macroblock records or level blocks than the
    VOP needs: ValueError, and not one byte written past what it was
    given."""
    p = M.Parser("XVID")
    p.parse(xvid_packets[0])
    nmb = p.geometry.mb_w * p.geometry.mb_h
    for n_mbs, n_levels, match in ((nmb - 1, 6 * nmb, "more than the 23 records given"),
                                   (nmb, 2, "more coded blocks than macroblocks allow")):
        mbs = np.full((nmb + 4, M.MB_FIELDS), 7, np.int32)
        levels = np.full((6 * nmb, 64), 7, np.int16)
        with pytest.raises(ValueError, match=match):
            p._run(xvid_packets[0], np.zeros(4, np.int32), mbs[:n_mbs], levels[:n_levels])
        assert (mbs[n_mbs:] == 7).all() and (levels[n_levels:] == 7).all()


@pytest.mark.parametrize("fourcc,codec", [("DIV3", "DIV3"), ("MP42", "MP42"),
                                          ("MPG2", "mpg2")])
def test_other_codecs_from_cv2_are_refused(tmp_path, fourcc, codec):
    """cv2's MS-MPEG-4 v3 and v2 and MPEG-2 AVIs (FFmpeg's msmpeg4v3,
    msmpeg4v2, mpeg2video; cv2 falls back to the 'mpg2' tag): ValueError
    naming the codec, nothing written."""
    path = str(tmp_path / "clip.avi")
    V.write_cv2_clip(path, fourcc, 30.0, V.scene(3, 64, 96))
    clip = TV.open_video(path)
    assert clip.codec == codec and clip.kind == ""
    with pytest.raises(ValueError, match=f"codec {codec}: the port decodes Motion JPEG"):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


def test_the_esds_carries_the_mp4_vol(tmp_path):
    """In cv2's MP4 the VOL is only in the esds DecoderSpecificInfo (sample
    0 starts with a GOV): the decoder is set up from the container."""
    path = _clip(tmp_path, "mp4v_240x320")
    clip = TV.open_video(path)
    assert clip.config[:4] == b"\x00\x00\x01\xb0" and b"\x00\x00\x01\x20" in clip.config
    assert b"\x00\x00\x01\x20" not in clip.sample(0) and clip.sample(0)[:4] == b"\x00\x00\x01\xb3"
    p = M.Parser(clip.fourcc, clip.config)
    assert (p.geometry.width, p.geometry.height) == (320, 240)
    with pytest.raises(ValueError, match="a VOP before any VOL header"):
        M.Parser(clip.fourcc).parse(clip.sample(0))
    assert sorted(glob.glob(str(tmp_path / "*"))) == [path]


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without a card and without device="cpu", the decoder and
    extract_frames raise instead of falling back to the CPU, before any
    frame is written."""
    path = _clip(tmp_path, "xvid_64x88")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.Mpeg4Decoder(TV.open_video(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.extract_frames(path, str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t")
