"""H.264 input end to end on the CPU: the committed H.264 goldens
(tests/goldens, tests/torch_video.py::H264_FIXTURES: the 1080p High-profile
CABAC clip, the small CAVLC, CABAC and High tool mixes) against cv2's
recorded readings and the port's decoder, extract_frames on the 1080p High
golden, and H.264 clips from tests/torch_h264.py's natural-content encoder
(Main and High profile) through both packages' extract_frames and
preproc_app.

The JAX package decodes with cv2.VideoCapture and re-encodes each kept
frame as a quality-95 JPEG; the port stores VideoCapture's frame bit-equal
as PNG under the .jpg name. So the port's frames are held to cv2's exactly,
the JAX package's JPEGs within JPEG_MEAN and JPEG_MAX of them (the gates of
tests/test_torch_m4v.py).
"""
import contextlib
import glob
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.cli import preproc_app as JAPP
from moda_tpu.preproc import pipeline as JP
from moda_tpu_torch.cli import preproc_app as TAPP
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.pfm import read_pfm
from moda_tpu_torch.preproc import h264 as D
from moda_tpu_torch.preproc import pipeline as TP
from moda_tpu_torch.preproc import video as TV
from tests import torch_h264 as H
from tests import torch_video as V
from tests.test_torch_preproc import write_frames

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
JPEG_MEAN, JPEG_MAX = 2.0, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [f[0] for f in V.H264_FIXTURES])
def test_committed_h264_goldens_match_cv2_and_the_port(name, tmp_path):
    """cv2 still reads what video_readings.json records of the golden (rate,
    count, kept indices, each packet's and each frame's SHA-256), with no
    avcodec error or warning, and the port decodes every frame on the CPU
    bit-equal."""
    with open(os.path.join(GOLDENS, "video_readings.json")) as f:
        want = json.load(f)[name]
    path = os.path.join(GOLDENS, name)
    assert os.path.getsize(path) == want["bytes"]
    got = V.readings(path, decoded=True)
    assert got == {k: want[k] for k in got}
    (_, logs), = H.cv2_read([path], str(tmp_path))
    assert logs == []
    clip = TV.open_video(path)
    assert clip.kind == "h264" and len(clip) == want["frames"] and clip.fps == want["fps"]
    dec = D.H264Decoder(clip, "cpu")
    frames = [f for f in map(dec.decode, map(clip.sample, range(len(clip)))) if f is not None]
    frames += dec.flush()
    assert [V.sha(f.numpy().tobytes()) for f in frames] == want["all_pixels_sha256"]


def test_extract_frames_stores_the_1080p_cabac_goldens_frames(tmp_path):
    """extract_frames (device "cpu") on the 1080p golden (High profile,
    CABAC) at --fps 5, as chip_smoke.py's phase 17 runs preproc_app on the
    card: pictures 0, 6 and 12 stored as PNGs whose pixels are cv2's
    recorded frames."""
    name = V.H264_FIXTURES[0][0]
    with open(os.path.join(GOLDENS, "video_readings.json")) as f:
        want = json.load(f)[name]
    out = TP.extract_frames(os.path.join(GOLDENS, name), str(tmp_path / "t"), fps=5,
                            device="cpu")
    kept = V.kept_indices(want["frames"], want["fps"], 5)
    assert kept == [0, 6, 12] and len(out) == len(kept)
    for p, i in zip(out, kept):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        bgr = np.ascontiguousarray(IO.imread(p)[..., ::-1])
        assert V.sha(bgr.tobytes()) == want["all_pixels_sha256"][i], i


@pytest.fixture(scope="module")
def natural(tmp_path_factory):
    """A 30 fps natural clip (10 frames of 48 x 64, the loop filter on in
    the last 3) and cv2's frames of it."""
    d = tmp_path_factory.mktemp("h264_natural")
    seq, samples = H.natural_stream(V.scene(10, 48, 64, seed=1), qp=24, deblock_last=3)
    path = str(d / "clip.mp4")
    H.write_mp4(path, seq, samples, fps=30)
    (frames, logs), = H.cv2_read([path], str(d))
    assert logs == [] and len(frames) == 10
    return path, frames


@pytest.fixture(scope="module")
def natural_high(tmp_path_factory):
    """The same scene coded at High profile (the 8x8 transform, Intra 8x8)
    and cv2's frames of it."""
    d = tmp_path_factory.mktemp("h264_natural_high")
    seq, samples = H.natural_stream(V.scene(10, 48, 64, seed=1), qp=24, deblock_last=3,
                                    high=True)
    path = str(d / "clip.mp4")
    H.write_mp4(path, seq, samples, fps=30)
    (frames, logs), = H.cv2_read([path], str(d))
    assert logs == [] and len(frames) == 10
    return path, frames


def test_extract_frames_matches_the_jax_packages(natural, natural_high, tmp_path):
    """The port's extract_frames (device "cpu") against the JAX package's at
    --fps 10, on the natural clip at Main and at High profile: the same
    names and kept indices; the port's frames 8-bit RGB PNGs of
    VideoCapture's, the JAX package's JPEGs within the gates."""
    for tag, (path, vc) in (("main", natural), ("high", natural_high)):
        j = JP.extract_frames(path, str(tmp_path / tag / "j"), fps=10)
        t = TP.extract_frames(path, str(tmp_path / tag / "t"), fps=10, device="cpu")
        kept = V.kept_indices(len(vc), 30.0, 10)
        names = ["%05d.jpg" % k for k in range(len(kept))]
        assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == names
        errs = []
        for p, q, i in zip(t, j, kept):
            with open(p, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"
            np.testing.assert_array_equal(IO.imread(p)[..., ::-1], vc[i])
            errs.append(np.abs(cv2.imread(q).astype(int) - vc[i].astype(int)))
        assert np.mean([e.mean() for e in errs]) <= JPEG_MEAN, tag
        assert max(e.max() for e in errs) <= JPEG_MAX, tag


def _files(root, pattern):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, pattern)))


def test_video_input_matches_the_jax_packages(natural, tmp_path):
    """The natural clip (10 frames at 30 fps, --fps 10: frames 0, 3, 6 and 9)
    through both packages' preproc_app.main with a --mask_dir and no
    weights (DIS flow): the same "[frames] extracted" line and database
    files; the port's frames VideoCapture's as PNG and its flo-/occ- PFMs
    bit-equal to its own run on a directory of those frames, of the JAX
    package's shapes."""
    path, vc = natural
    write_frames(tmp_path, n=4)  # masks/%05d.png for the 4 kept frames
    masks = str(tmp_path / "masks")
    os.makedirs(tmp_path / "w")
    printed = {}
    for tag, run, src in (("j", lambda a: JAPP.main(a), path),
                          ("t", lambda a: TAPP.main(a, device="cpu"), path),
                          ("d", lambda a: TAPP.main(a, device="cpu"),
                           str(tmp_path / "t/db/JPEGImages/Full-Resolution/s"))):
        buf = io.StringIO()
        argv = ["--seqname", "s", "--input", src, "--database", f"{tmp_path / tag}/db",
                "--config_dir", f"{tmp_path / tag}/cfg", "--weights_dir", str(tmp_path / "w"),
                "--img_size", "16", "--mask_dir", masks]
        with contextlib.redirect_stdout(buf):
            run(argv)
        printed[tag] = buf.getvalue()
    for tag in "jt":
        assert f"[frames] extracted 4 frames @ 10fps -> {tmp_path / tag}/db/JPEGImages" \
            f"/Full-Resolution/s" in printed[tag]
    j, t, d = (str(tmp_path / tag / "db") for tag in "jtd")
    files = [sorted(os.path.relpath(p, r) for p in glob.glob(os.path.join(r, "**", "*.*"),
                                                             recursive=True)) for r in (j, t, d)]
    assert files[0] == files[1] == files[2] and len(files[0]) > 40
    for k, f in enumerate(_files(t, "JPEGImages/Full-Resolution/s/*.jpg")):
        np.testing.assert_array_equal(IO.imread(os.path.join(t, f))[..., ::-1], vc[3 * k])
        assert open(os.path.join(t, f), "rb").read() == open(os.path.join(d, f), "rb").read()
    pfms = _files(t, "Flow*/Full-Resolution/s/*.pfm")
    assert len(pfms) == 4 * (3 + 1)
    for f in pfms:
        a, b = read_pfm(os.path.join(t, f))[0], read_pfm(os.path.join(d, f))[0]
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert read_pfm(os.path.join(j, f))[0].shape == a.shape and np.isfinite(a).all()


def test_the_card_is_the_default(natural, tmp_path, monkeypatch):
    """Without a card and without device="cpu", the decoder and
    extract_frames raise instead of falling back to the CPU, before any
    frame is written."""
    path, _ = natural
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.H264Decoder(TV.open_video(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.extract_frames(path, str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t")
