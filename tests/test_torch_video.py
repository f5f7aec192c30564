"""The port's video input (moda_tpu_torch/preproc/video.py and
pipeline.extract_frames) against cv2.VideoCapture and against
moda_tpu.preproc.pipeline.extract_frames on the CPU.

Clips come from cv2.VideoWriter (AVI 'MJPG', MOV 'jpeg', MP4 'mp4v' with
objectTypeIndication 0x6C) and from the struct muxer of tests/torch_video.py
(the odd files). The oracles:
- the rate, the frame count and the kept indices are cv2's (the JAX
  function's step rule on CAP_PROP_FPS);
- every sample's bytes equal cv2's raw packet (CAP_PROP_FORMAT -1), and the
  stored frames are the kept packets;
- pixels are bit-equal to cv2.imdecode of the packet (libjpeg-turbo);
- against VideoCapture's own frames (FFmpeg's decoder and swscale) the
  port's stored frames keep a mean absolute error at most VC_MEAN_RATIO
  times that of the JAX package's stored frames (VideoCapture's frame
  re-encoded at quality 95 and read back), and a maximum at most VC_MAX.
"""
import glob
import json
import os
import struct

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

VC_MEAN_RATIO = 1.5  # port vs VideoCapture, over the JAX package's stored frames vs VideoCapture
VC_MAX = 16          # uint8 levels: FFmpeg's chroma upsampling against libjpeg's
RATES = (24.0, 29.97, 30.0, 59.94)
SIZES = {24.0: (64, 96), 29.97: (120, 160), 30.0: (240, 320), 59.94: (64, 96)}
CONTAINERS = {"avi": "MJPG", "mov": "MJPG", "mp4": "MJPG"}
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# what cv2.VideoCapture applies for CAP_PROP_ORIENTATION_META
CV2_ROTATE = {90: cv2.ROTATE_90_CLOCKWISE, 180: cv2.ROTATE_180,
              270: cv2.ROTATE_90_COUNTERCLOCKWISE}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bgr(path):
    img = IO.imread(path)
    assert img is not None, path
    return img[..., ::-1]


def _names(d):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d, "*")))


def _vc_gate(port, jax, vc, tag):
    """The port's frames and the JAX package's against VideoCapture's."""
    err_t = [np.abs(a.astype(int) - c.astype(int)) for a, c in zip(port, vc)]
    err_j = [np.abs(b.astype(int) - c.astype(int)) for b, c in zip(jax, vc)]
    mean_t, mean_j = np.mean([e.mean() for e in err_t]), np.mean([e.mean() for e in err_j])
    assert mean_t <= VC_MEAN_RATIO * mean_j, f"{tag}: mean {mean_t:.3f} against {mean_j:.3f}"
    assert max(e.max() for e in err_t) <= VC_MAX, f"{tag}: max {max(e.max() for e in err_t)}"


def check_against_cv2(path, tmp, fps_list=(10,), rotation=0):
    """The port's open_video and extract_frames against cv2 and the JAX
    package's extract_frames on one clip, at each --fps of fps_list."""
    src_fps, vc, rot = V.cv2_frames(path)
    packets = V.cv2_packets(path)
    clip = TV.open_video(path)
    assert clip.fps == src_fps and len(clip) == len(vc) == len(packets)
    assert clip.rotation == rot == rotation
    assert [clip.sample(i) for i in range(len(clip))] == packets
    for fps in fps_list:
        j_dir, t_dir = os.path.join(tmp, f"j{fps}"), os.path.join(tmp, f"t{fps}")
        j_paths = JP.extract_frames(path, j_dir, fps=fps)
        t_paths = TP.extract_frames(path, t_dir, fps=fps)
        kept = V.kept_indices(len(vc), src_fps, fps)
        assert [os.path.basename(p) for p in t_paths] == \
            [os.path.basename(p) for p in j_paths] == ["%05d.jpg" % k for k in range(len(kept))]
        assert _names(t_dir) == _names(j_dir)
        port = [_bgr(p) for p in t_paths]
        for k, i in enumerate(kept):
            want = cv2.imdecode(np.frombuffer(packets[i], np.uint8), cv2.IMREAD_COLOR)
            if rotation:
                want = cv2.rotate(want, CV2_ROTATE[rotation])
            if rotation == 0:
                with open(t_paths[k], "rb") as f:
                    assert f.read() == packets[i], (path, fps, k)
            else:
                with open(t_paths[k], "rb") as f:
                    assert f.read(8) == b"\x89PNG\r\n\x1a\n"
            np.testing.assert_array_equal(port[k], want)
            assert port[k].shape == vc[i].shape
        _vc_gate(port, [cv2.imread(p) for p in j_paths], [vc[i] for i in kept],
                 f"{path} @ {fps}")


# ------------------------------------------------ three containers, four rates
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("ext", sorted(CONTAINERS))
def test_three_containers_at_four_rates(tmp_path, ext, rate):
    """cv2.VideoWriter's Motion JPEG in each container ('MJPG' samples in
    AVI, the 'jpeg' entry in MOV, 'mp4v' with objectTypeIndication 0x6C in
    MP4) at 24, 29.97, 30 and 59.94 fps, kept at --fps 10, 15 and 30."""
    h, w = SIZES[rate]
    path = str(tmp_path / f"clip.{ext}")
    V.write_cv2_clip(path, CONTAINERS[ext], rate, V.scene(13, h, w, seed=int(rate)))
    clip = TV.open_video(path)
    assert (clip.container, clip.codec, clip.width, clip.height) == \
        (ext, {"avi": "MJPG", "mov": "jpeg", "mp4": "mp4v (objectTypeIndication 0x6C)"}[ext], w, h)
    check_against_cv2(path, str(tmp_path), fps_list=(10, 15, 30))


# ------------------------------------------------------------- odd files
ODD_ISOBMFF = {
    "moov_first": dict(moov_first=True),
    "co64": dict(co64=True),
    "mdat_64bit_size": dict(large_mdat=True, moov_first=True, co64=True),
    "no_edit_list": dict(elst=None, chunk_samples=1),
    "mixed_stts_600": dict(timescale=600, durations=[20, 20, 20, 40, 20, 20, 20, 20, 20]),
    "mixed_stts_ntsc": dict(timescale=90000, durations=[3003] * 4 + [6006] + [3003] * 4),
    "mixed_stts_jitter": dict(timescale=600, durations=[20, 21, 19, 20, 22, 18, 20, 20, 19]),
    "mp4_brand_mp4v_6c": dict(fourcc=b"mp4v", oti=0x6C, brand=b"isom", chunk_samples=4),
    "mjpa": dict(fourcc=b"mjpa"),
    "stz2_16bit": dict(stz2=True, chunk_samples=2),
}


@pytest.mark.parametrize("case", sorted(ODD_ISOBMFF))
def test_odd_isobmff_files(tmp_path, case):
    """Files cv2 reads and its writer never makes: the rate of mixed stts
    durations is FFmpeg's avg_frame_rate (timescale x samples / summed
    durations), which cv2 reports."""
    path = str(tmp_path / "clip.mov")
    V.write_isobmff(path, V.jpegs(9, 64, 96, seed=3), 64, 96, **ODD_ISOBMFF[case])
    check_against_cv2(path, str(tmp_path), fps_list=(10, 15))


@pytest.mark.parametrize("durations,rate", [([20, 20, 20, 40, 20, 20, 20, 20, 20], (27, 1)),
                                            ([20] * 119 + [2000], (1200, 73))])
def test_mixed_stts_rate_is_the_average(tmp_path, durations, rate):
    """timescale x samples / summed durations, a long last sample included
    (600 x 9 / 200; 600 x 120 / 4380), as cv2 reports it."""
    path = str(tmp_path / "vfr.mov")
    n = len(durations)
    V.write_isobmff(path, V.jpegs(1, 16, 16) * n, 16, 16, timescale=600, durations=durations)
    clip = TV.open_video(path)
    assert clip.rate == rate and clip.fps == rate[0] / rate[1] == V.cv2_frames(path)[0]


@pytest.mark.parametrize("rotation", [90, 180, 270])
def test_rotated_clips(tmp_path, rotation):
    """A tkhd display matrix of 90, 180 or 270 degrees: frames of
    VideoCapture's shape and orientation, stored as PNG, bit-equal to
    cv2.imdecode turned as cv2.rotate turns it and within the VideoCapture
    gate."""
    path = str(tmp_path / "clip.mov")
    V.write_isobmff(path, V.jpegs(7, 64, 96, seed=rotation), 64, 96, rotation=rotation)
    check_against_cv2(path, str(tmp_path), rotation=rotation)


@pytest.mark.parametrize("ext", ["avi", "mov"])
def test_dht_less_samples(tmp_path, ext):
    """Samples without DHT (as cameras write Motion JPEG): the stored frame
    is the sample with Annex K.3's tables before its SOS and decodes
    bit-equal to cv2.imdecode of the stripped sample (libjpeg fills the
    same tables); the tables are those cv2.imencode writes."""
    full = V.jpegs(7, 64, 96, seed=5)
    tables = []
    pos = 2
    while full[0][pos + 1] != 0xDA:
        length = struct.unpack(">H", full[0][pos + 2:pos + 4])[0]
        if full[0][pos + 1] == 0xC4:
            tables.append(full[0][pos + 4:pos + 2 + length])
        pos += 2 + length
    assert TV.STANDARD_DHT[4:] == b"".join(tables)
    stripped = [V.strip_dht(j) for j in full]
    assert all(b"\xff\xc4" not in s[:s.index(b"\xff\xda")] for s in stripped)
    path = str(tmp_path / f"clip.{ext}")
    if ext == "avi":
        V.write_avi(path, stripped, 64, 96)
    else:
        V.write_isobmff(path, stripped, 64, 96)
    assert V.cv2_packets(path) == stripped
    paths = TP.extract_frames(path, str(tmp_path / "t"), fps=30)
    for p, s, f in zip(paths, stripped, full):
        want = cv2.imdecode(np.frombuffer(s, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(want, cv2.imdecode(np.frombuffer(f, np.uint8), 1))
        np.testing.assert_array_equal(_bgr(p), want)
        np.testing.assert_array_equal(cv2.imread(p), want)


@pytest.mark.parametrize("where", [(0,), (3,), (2, 3, 9)])
def test_zero_length_avi_chunks(tmp_path, where):
    """Zero-length '00dc' chunks (dropped frames) are no frames, as cv2
    (FFmpeg's avi demuxer) skips them: the count, the rate and the kept
    indices are cv2's."""
    samples = V.jpegs(10, 64, 96, seed=7)
    for k in where:
        samples.insert(k, b"")
    path = str(tmp_path / "clip.avi")
    V.write_avi(path, samples, 64, 96, rate=30000, scale=1001)
    assert len(TV.open_video(path)) == 10
    check_against_cv2(path, str(tmp_path), fps_list=(10, 15))


AVI_LAYOUTS = {"opendml": dict(riff_frames=4), "interleaved_audio": dict(stream=1, audio_every=2),
               "no_index": dict(index=False), "rec_lists_db": dict(rec_every=3, suffix=b"db")}


@pytest.mark.parametrize("layout", sorted(AVI_LAYOUTS))
def test_avi_layouts(tmp_path, layout):
    """'RIFF AVIX' continuations (OpenDML, clips past 1 GB), a video stream
    after an audio one ('01dc' between '00wb' chunks), a file without idx1
    and '##db' chunks grouped in LIST 'rec ' are walked chunk by chunk."""
    kw = AVI_LAYOUTS[layout]
    path = str(tmp_path / "clip.avi")
    V.write_avi(path, V.jpegs(11, 64, 96, seed=11), 64, 96, **kw)
    check_against_cv2(path, str(tmp_path), fps_list=(10,))


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("ext,fourcc,name", [("avi", "DIV3", "DIV3"), ("avi", "MPG2", "mpg2")])
def test_other_codecs_raise(tmp_path, ext, fourcc, name):
    """Codecs the port does not decode, from cv2 (an MS-MPEG-4 v3 'DIV3' AVI;
    an MPEG-2 AVI, which cv2 tags 'mpg2'): ValueError naming the codec;
    nothing is written. (MPEG-4 Part 2 decodes: tests/test_torch_m4v.py.)"""
    path = str(tmp_path / f"clip.{ext}")
    V.write_cv2_clip(path, fourcc, 30.0, V.scene(3, 64, 96))
    with pytest.raises(ValueError, match=f"codec {name}: the port decodes Motion JPEG"):
        TP.extract_frames(path, str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t")


# 'avc1' left this list when the port began to decode H.264 (its refusals:
# tests/test_torch_h264.py); 'avc2' is an H.264 entry the port still refuses
@pytest.mark.parametrize("fourcc", [b"avc2", b"hvc1", b"mjpb"])
def test_other_sample_entries_raise(tmp_path, fourcc):
    path = str(tmp_path / "clip.mov")
    V.write_isobmff(path, V.jpegs(2, 64, 96), 64, 96, fourcc=fourcc)
    assert TV.open_video(path).fourcc == fourcc.decode()
    with pytest.raises(ValueError, match=f"codec {fourcc.decode()}: the port decodes Motion"):
        TP.extract_frames(path, str(tmp_path / "t"))


def _interlaced(jpeg: bytes) -> bytes:
    """An 'AVI1' APP0 with field polarity 1 after SOI."""
    app0 = b"AVI1" + bytes([1, 0]) + b"\0" * 8
    return jpeg[:2] + b"\xff\xe0" + struct.pack(">H", 2 + len(app0)) + app0 + jpeg[2:]


def _progressive(h: int, w: int) -> bytes:
    img = V.scene(1, h, w)[0]
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()


@pytest.mark.parametrize("case,match", [
    ("fragmented", "fragmented MP4 \\(moov/mvex\\)"),
    ("edit_list", "elst: an edit list other than the identity"),
    ("empty_edit", "elst: an edit list other than the identity"),
    ("skewed_matrix", "tkhd: display matrix"),
    ("interlaced", "sample 1: interlaced: an AVI1 APP0"),
    ("half_height", "sample 0: interlaced: a field of 32 rows"),
    ("progressive", "sample 2: .*progressive"),
    ("not_a_video", "neither an MP4/MOV"),
])
def test_refused_files_raise(tmp_path, case, match):
    """What the readers refuse raises ValueError naming the box or the
    sample, before any frame is written."""
    path = str(tmp_path / "clip.mov")
    j = V.jpegs(3, 64, 96)
    if case == "fragmented":
        V.write_isobmff(path, j, 64, 96, fragmented=True)
    elif case == "edit_list":
        V.write_isobmff(path, j, 64, 96, elst=((None, 1, 1),))
    elif case == "empty_edit":
        V.write_isobmff(path, j, 64, 96, elst=((33, -1, 1), (None, 0, 1)))
    elif case == "skewed_matrix":
        V.write_isobmff(path, j, 64, 96)
        data = bytearray(open(path, "rb").read())
        m = data.index(b"tkhd") + 4 + 40
        data[m + 4:m + 8] = struct.pack(">i", 0x4000)  # b = 0.25: a shear
        open(path, "wb").write(bytes(data))
    elif case == "interlaced":
        path = str(tmp_path / "clip.avi")
        V.write_avi(path, [j[0], _interlaced(j[1]), j[2]], 64, 96)
    elif case == "half_height":
        path = str(tmp_path / "clip.avi")
        V.write_avi(path, V.jpegs(3, 32, 96), 64, 96)
    elif case == "progressive":
        V.write_isobmff(path, j[:2] + [_progressive(64, 96)], 64, 96)
    else:
        open(path, "wb").write(b"\0\0\0\x10notavideo" + b"\0" * 32)
    with pytest.raises(ValueError, match=match):
        TP.extract_frames(path, str(tmp_path / "t"), fps=30)
    assert not os.path.exists(tmp_path / "t")


# ----------------------------------------------------- chip_smoke fixtures
def test_committed_fixtures_match_cv2_and_the_port():
    """tests/goldens' clips (tests/torch_video.py::write_fixtures, read by
    chip_smoke.py's video phases on the card): cv2 still reads what
    video_readings.json records, and so does the port: rate, count, kept
    indices at --fps 10, each packet's SHA-256 and each kept frame's pixel
    digest (cv2.imdecode's BGR bytes of a Motion-JPEG packet; of an MPEG-4
    Part 2 clip, VideoCapture's frames, every one of which the port decodes
    on the CPU bit-equal); the MS-MPEG-4 clip is refused."""
    with open(os.path.join(GOLDENS, "video_readings.json")) as f:
        recorded = json.load(f)
    refused = V.REFUSED_FIXTURE[0]
    # the H.264 goldens' readings are held by tests/test_torch_h264_app.py
    assert sorted(recorded) == sorted([name for name, *_ in V.FIXTURES] + [refused] +
                                      [name for name, *_ in V.H264_FIXTURES])
    assert sum(r["bytes"] for r in recorded.values()) < 2_000_000
    clip = TV.open_video(os.path.join(GOLDENS, refused))
    assert clip.codec == recorded.pop(refused)["codec"]
    with pytest.raises(ValueError, match="the port decodes Motion JPEG"):
        TV.require_supported(clip)
    for name, fourcc, *_ in V.FIXTURES:
        want = recorded[name]
        path = os.path.join(GOLDENS, name)
        assert os.path.getsize(path) == want["bytes"]
        got = V.readings(path, decoded=fourcc != "MJPG")
        assert got == {k: want[k] for k in got}, name
        clip = TV.open_video(path)
        assert clip.fps == want["fps"] and len(clip) == want["frames"]
        assert clip.kind == ("mjpeg" if fourcc == "MJPG" else "mpeg4")
        assert [V.sha(clip.sample(i)) for i in range(len(clip))] == want["packet_sha256"]
        kept = V.kept_indices(len(clip), clip.fps, want["kept_at_fps"])
        assert kept == want["kept"]
        if clip.kind == "mjpeg":
            assert [V.sha(np.ascontiguousarray(clip.frame(i)[..., ::-1]).tobytes())
                    for i in kept] == want["pixels_sha256"], name
        else:
            dec = M.Mpeg4Decoder(clip, "cpu")
            assert [V.sha(dec.decode(clip.sample(i)).numpy().tobytes())
                    for i in range(len(clip))] == want["all_pixels_sha256"], name
