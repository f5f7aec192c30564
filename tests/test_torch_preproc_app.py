"""The port's preprocessing entry point (moda_tpu_torch/cli/preproc_app.py)
against moda_tpu's on the CPU, as a whole.

Four JPEG frames of 48 x 64 with masks go through both packages'
``preproc_app.main`` with one narrow vcn_rob.npz (tests/test_torch_preproc.py::
write_vcn_npz). Both predictors are loaded at testres 3 (a 192 x 192
network input instead of the ~2 MP protocol): the tests patch both
loaders, the packages are as they ship. Frames must be equal bytes, masks
equal pixels, the Densepose files and the config text equal, the flo-/occ-
PFMs within the flow gate. The port's line shards must hold the pair (i,
i+1) of the port's frame reader and read back through its line loader. The
refusals raise.

With a pointrend.npz and a cse.npz beside the vcn_rob.npz (seeded
detectron2-layout weights at the published widths through the JAX
package's converters; the animal class 16 raised above the score
threshold) and no --mask_dir, two 48 x 60 frames go through both packages,
both predictors at input 128: PointRend's masks equal on >= 99.9% of the
pixels, the CSE features unit-norm and within a cosine of 1 - 1e-5 of the
JAX package's, the boxes equal, the vertex maps equal on >= 99.9% of the
mask, and the closing "train with" line without --nouse_embed.
"""
import contextlib
import glob
import io
import os

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.cli import preproc_app as JAPP
from moda_tpu.preproc import checkpoints as JC
from moda_tpu_torch.cli import preproc_app as TAPP
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.dataset import build_datasets, build_line_datasets
from moda_tpu_torch.data.pfm import read_pfm
from moda_tpu_torch.preproc import checkpoints as TC
from tests.test_torch_preproc import (TESTRES, _dis_gate, _flow_gate, write_frames,
                                      write_vcn_npz)
from tests.torch_video import scene, write_cv2_clip

N_FRAMES, IMG_SIZE = 4, 16
GRAPH_FRAMES, GRAPH_INPUT, DETECT = 2, 128, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(root, frames, weights, **kw):
    argv = ["--seqname", "s", "--input", frames, "--database", f"{root}/db",
            "--config_dir", f"{root}/cfg", "--weights_dir", weights,
            "--img_size", str(IMG_SIZE)]
    for k, v in kw.items():
        argv += [f"--{k}", v]
    return argv


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("preproc_app")
    frames = write_frames(d, n=N_FRAMES)
    os.makedirs(d / "w")
    write_vcn_npz(str(d / "w" / "vcn_rob.npz"))
    mp = pytest.MonkeyPatch()
    jload, tload = JC.load_vcn_predictor, TC.load_vcn_predictor

    def jax_loader(path):
        pred = jload(path)
        pred.testres = TESTRES
        return pred

    mp.setattr(JC, "load_vcn_predictor", jax_loader)
    mp.setattr(TC, "load_vcn_predictor", lambda path, **k: tload(path, testres=TESTRES, **k))
    try:
        JAPP.main(_argv(d / "j", frames, str(d / "w"), mask_dir=str(d / "masks")))
        out = TAPP.main(_argv(d / "t", frames, str(d / "w"), mask_dir=str(d / "masks")),
                        device="cpu")
    finally:
        mp.undo()
    return d, out


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Both packages' preproc_app with PointRend and CSE weights and no
    --mask_dir; returns the root, the port's result and each package's
    printed output."""
    from moda_tpu.preproc import cse_infer as JCSE
    from moda_tpu.preproc import pointrend_infer as JPR
    from moda_tpu_torch.preproc import cse_infer, pointrend_infer

    d = tmp_path_factory.mktemp("preproc_graphs")
    frames = write_frames(d, n=GRAPH_FRAMES, w=60)
    os.makedirs(d / "w")
    write_vcn_npz(str(d / "w" / "vcn_rob.npz"))
    JC.save_pytree_npz(str(d / "w" / "pointrend.npz"), JPR.convert_pointrend_checkpoint(
        pointrend_infer.reference_state_dict(0, detect_class=DETECT)))
    cse = JCSE.convert_cse_checkpoint(cse_infer.reference_state_dict(0, n_vertices=50))
    JC.save_pytree_npz(str(d / "w" / "cse.npz"), {"backbone": cse.bp, "head": cse.hp,
                                                 "vertex_embeddings": cse.vertex_embeddings})
    mp = pytest.MonkeyPatch()
    loaders = {(pkg, name): getattr(pkg, name) for pkg in (JC, TC)
               for name in ("load_vcn_predictor", "load_pointrend_predictor",
                            "load_cse_predictor")}

    def jax_vcn(path):
        pred = loaders[JC, "load_vcn_predictor"](path)
        pred.testres = TESTRES
        return pred

    mp.setattr(JC, "load_vcn_predictor", jax_vcn)
    mp.setattr(TC, "load_vcn_predictor",
               lambda path, **k: loaders[TC, "load_vcn_predictor"](path, testres=TESTRES, **k))
    for pkg in (JC, TC):
        for name in ("load_pointrend_predictor", "load_cse_predictor"):
            mp.setattr(pkg, name, lambda path, _f=loaders[pkg, name], **k:
                       _f(path, input_size=GRAPH_INPUT, **k))
    printed = {}
    try:
        for tag, run in (("j", lambda a: JAPP.main(a)),
                         ("t", lambda a: TAPP.main(a, device="cpu"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = run(_argv(d / tag, frames, str(d / "w")))
            printed[tag] = buf.getvalue()
    finally:
        mp.undo()
    return d, out, printed


def test_pointrend_masks_and_cse_features_match_the_jax_packages(graphs):
    d, out, _ = graphs
    j, t = str(d / "j/db"), str(d / "t/db")
    masks = _files(j, "Annotations/Full-Resolution/s/*.png")
    assert len(masks) == GRAPH_FRAMES and masks == _files(t, "Annotations/Full-Resolution/s/*")
    for i, f in enumerate(masks):
        tm = IO.imread(os.path.join(t, f), gray=True)
        jm = cv2.imread(os.path.join(j, f), 0)
        assert tm.any() and set(np.unique(tm)) <= {0, 128}
        assert (tm == jm).mean() >= 0.999, f
        dp = "Densepose/Full-Resolution/s/"
        tf = read_pfm(os.path.join(t, dp + "feat-%05d.pfm" % i))[0].reshape(16, 112, 112)
        jf = read_pfm(os.path.join(j, dp + "feat-%05d.pfm" % i))[0].reshape(16, 112, 112)
        np.testing.assert_allclose(np.linalg.norm(tf, axis=0), 1.0, atol=1e-5)
        assert (tf * jf).sum(0).min() >= 1 - 1e-5
        np.testing.assert_array_equal(np.loadtxt(os.path.join(t, dp + "bbox-%05d.txt" % i)),
                                      np.loadtxt(os.path.join(j, dp + "bbox-%05d.txt" % i)))
        tv = read_pfm(os.path.join(t, dp + "%05d.pfm" % i))[0]
        jv = read_pfm(os.path.join(j, dp + "%05d.pfm" % i))[0]
        inside = tm > 0
        assert tv[inside].any() and (tv[inside] == jv[inside]).mean() >= 0.999
        assert not tv[~inside].any()
    assert out["have_cse"] and set(out["times"]) == {"frames", "masks", "densepose", "flow",
                                                     "config", "lines"}


def test_train_line_drops_nouse_embed_after_cse(graphs, both):
    """With CSE features the closing line asks for none of --nouse_embed,
    as the JAX package's does; with zero features it keeps it."""
    _, out, printed = graphs
    for tag in ("j", "t"):
        line = [x for x in printed[tag].splitlines() if "train with" in x]
        assert len(line) == 1 and "--nouse_embed" not in line[0], printed[tag]
    assert "[masks] PointRend (pointrend.npz) on cpu" in printed["t"]
    assert "[densepose] CSE (cse.npz) on cpu" in printed["t"]
    assert not both[1]["have_cse"]


def _files(root, pattern):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, pattern)))


def test_database_matches_the_jax_packages(both):
    d, out = both
    j, t = str(d / "j/db"), str(d / "t/db")
    frames = _files(j, "JPEGImages/Full-Resolution/s/*.jpg")
    assert len(frames) == N_FRAMES and frames == _files(t, "JPEGImages/Full-Resolution/s/*")
    for f in frames:
        assert open(os.path.join(j, f), "rb").read() == open(os.path.join(t, f), "rb").read()
    masks = _files(j, "Annotations/Full-Resolution/s/*.png")
    assert len(masks) == N_FRAMES and masks == _files(t, "Annotations/Full-Resolution/s/*")
    for f in masks:
        np.testing.assert_array_equal(IO.imread(os.path.join(t, f), gray=True),
                                      cv2.imread(os.path.join(j, f), 0))
    dp = _files(j, "Densepose/Full-Resolution/s/*")
    assert len(dp) == 3 * N_FRAMES and dp == _files(t, "Densepose/Full-Resolution/s/*")
    for f in dp:
        assert open(os.path.join(j, f), "rb").read() == open(os.path.join(t, f), "rb").read()
    jcfg = open(d / "j/cfg/s.config").read().replace(str(d / "j"), "ROOT")
    assert jcfg == open(out["config"]).read().replace(str(d / "t"), "ROOT")
    assert set(out["times"]) == {"frames", "masks", "densepose", "flow", "config", "lines"}


def test_flows_match_the_jax_packages(both):
    """pipeline.py:89-96's pairs (i, i + d) with d | i: 3 at d = 1 and 1 at
    d = 2 for 4 frames, each both ways; none at d = 4, 8, 16, 32."""
    d, out = both
    j, t = str(d / "j/db"), str(d / "t/db")
    pfms = _files(j, "Flow*/Full-Resolution/s/*.pfm")
    assert pfms == _files(t, "Flow*/Full-Resolution/s/*.pfm")
    assert len(pfms) == 4 * (3 + 1) and out["flow_calls"] == 2 * (3 + 1)
    for f in pfms:
        a, b = read_pfm(os.path.join(j, f))[0], read_pfm(os.path.join(t, f))[0]
        assert a.shape == b.shape and np.isfinite(b).all()
        if "occ-" in f:
            assert b.min() >= 0 and b.max() <= 1
        _flow_gate(a, b, f)


def test_line_shards_hold_the_frame_readers_pairs(both):
    d, _ = both
    cfg = str(d / "t/cfg")
    reader = build_datasets("s", IMG_SIZE, cfg)[0].reader
    base = d / "t/db/Pixels/Full-Resolution/s"
    assert sorted(os.listdir(base)) == [f"1_{i:05d}" for i in range(N_FRAMES - 1)]
    for i in range(N_FRAMES - 1):
        d0 = reader.read_raw(i, flowfw=True, dframe=1)
        d1 = reader.read_raw(i + 1, flowfw=False, dframe=1)
        rows = [np.load(base / f"1_{i:05d}" / ("%04d.npy" % r), allow_pickle=True).item()
                for r in range(IMG_SIZE)]
        img = np.concatenate([r["img"][0] for r in rows], -1)  # [2, 3, S*S]
        for k, frame in enumerate((d0, d1)):
            np.testing.assert_array_equal(
                img[k], frame["img"].reshape(-1, 3).T.astype(np.float32))
    line = build_line_datasets("s", IMG_SIZE, cfg)
    assert line[0].num_frames == N_FRAMES
    pair = line[0].sample_pair(np.random.default_rng(0), idx=1)
    assert np.isfinite(pair["frames"][0]["imgs"]).all()


def test_png_frames_are_stored_as_png_bytes(tmp_path):
    """A .png input is stored as an 8-bit RGB PNG under its .jpg name (the
    JAX package re-encodes JPEG) and decodes to the source pixels."""
    from moda_tpu_torch.cli.preproc_app import build_argparser, stage_frames

    os.makedirs(tmp_path / "in")
    img = (np.random.default_rng(0).random((10, 12, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in" / "a.png"), img)
    args = build_argparser().parse_args(_argv(tmp_path, str(tmp_path / "in"), ""))
    seq_dir = stage_frames(args)
    with open(os.path.join(seq_dir, "00000.jpg"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(IO.imread(os.path.join(seq_dir, "00000.jpg"))[..., ::-1], img)


def test_refusals(tmp_path, monkeypatch):
    """Video in a codec the port does not decode (an MS-MPEG-4 v3 clip from
    cv2) raises with the codec's name; nothing falls back. Without a card,
    main needs device='cpu'. (No vcn*.npz runs DIS:
    test_dis_flow_without_vcn_npz_matches_the_jax_packages; a cse*.npz and
    a pointrend*.npz run: test_pointrend_masks_and_cse_features_match_the_
    jax_packages; a Motion-JPEG clip runs: test_video_input_matches_the_jax_
    packages.)"""
    frames = write_frames(tmp_path, n=2)
    masks = str(tmp_path / "masks")
    os.makedirs(tmp_path / "w")
    write_cv2_clip(str(tmp_path / "clip.avi"), "DIV3", 30.0, scene(2, 48, 64))
    with pytest.raises(ValueError, match="codec DIV3: the port decodes Motion JPEG"):
        TAPP.main(_argv(tmp_path / "v", str(tmp_path / "clip.avi"), "", mask_dir=masks),
                  device="cpu")
    assert not glob.glob(str(tmp_path / "v/db/JPEGImages/Full-Resolution/s/*"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TAPP.main(_argv(tmp_path / "c", frames, str(tmp_path / "w"), mask_dir=masks))


def test_dis_flow_without_vcn_npz_matches_the_jax_packages(tmp_path):
    """No vcn*.npz under --weights_dir: both packages print the DIS line and
    write DIS flo-/occ- PFMs (pipeline.py:89-96's pairs for 3 frames, each
    both ways), the port's within the DIS gate of the JAX package's."""
    frames = write_frames(tmp_path, n=3)
    masks = str(tmp_path / "masks")
    os.makedirs(tmp_path / "w")
    printed = {}
    for tag, run in (("j", lambda a: JAPP.main(a)), ("t", lambda a: TAPP.main(a, device="cpu"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = run(_argv(tmp_path / tag, frames, str(tmp_path / "w"), mask_dir=masks))
        printed[tag] = buf.getvalue()
    assert "[flow] no VCN weights: OpenCV DIS + fb-confidence" in printed["j"]
    assert "[flow] no VCN weights: OpenCV DIS + fb-confidence on cpu" in printed["t"]
    j, t = str(tmp_path / "j/db"), str(tmp_path / "t/db")
    pfms = _files(j, "Flow*/Full-Resolution/s/*.pfm")
    assert pfms == _files(t, "Flow*/Full-Resolution/s/*.pfm")
    assert len(pfms) == 4 * (2 + 1) and out["flow_calls"] == 2 * (2 + 1)
    for f in pfms:
        a, b = read_pfm(os.path.join(j, f))[0], read_pfm(os.path.join(t, f))[0]
        assert a.shape == b.shape and np.isfinite(b).all()
        if "occ-" in f:
            assert b.min() >= 0 and b.max() <= 1
        _dis_gate(a, b, f)


# --input clips: extension -> (file extension, cv2.VideoWriter fourcc)
VIDEO_INPUTS = {"avi": ("avi", "MJPG"), "mov": ("mov", "MJPG"), "mp4": ("mp4", "MJPG"),
                "mp4v": ("mp4", "mp4v"), "xvid": ("avi", "XVID")}


@pytest.mark.parametrize("ext", sorted(VIDEO_INPUTS))
def test_video_input_matches_the_jax_packages(tmp_path, ext):
    """A clip from cv2.VideoWriter (10 frames at 30 fps, --fps 10: frames
    0, 3, 6 and 9; Motion JPEG in each container, MPEG-4 Part 2 as 'mp4v'
    MP4 and 'XVID' AVI) through both packages' preproc_app.main with a
    --mask_dir and no weights (DIS flow): the same "[frames] extracted" line
    and the same set of database files; the port's frames are the clip's
    own samples (Motion JPEG: tests/test_torch_video.py) or VideoCapture's
    frames as PNG (MPEG-4 Part 2: tests/test_torch_m4v.py), its flo-/occ-
    PFMs of the JAX package's shapes and bit-equal to its own run on a
    directory of the frames it extracted. (The JAX package's frames are
    VideoCapture's re-encoded at quality 95, other pixels: its flows are no
    oracle here.)"""
    suffix, fourcc = VIDEO_INPUTS[ext]
    clip = str(tmp_path / f"clip.{suffix}")
    write_cv2_clip(clip, fourcc, 30.0, scene(10, 48, 64, seed=1))
    write_frames(tmp_path, n=4)  # masks/%05d.png for the 4 kept frames
    masks = str(tmp_path / "masks")
    os.makedirs(tmp_path / "w")
    printed = {}
    for tag, run, src in (("j", lambda a: JAPP.main(a), clip),
                          ("t", lambda a: TAPP.main(a, device="cpu"), clip),
                          ("d", lambda a: TAPP.main(a, device="cpu"),
                           str(tmp_path / "t/db/JPEGImages/Full-Resolution/s"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(_argv(tmp_path / tag, src, str(tmp_path / "w"), mask_dir=masks))
        printed[tag] = buf.getvalue()
    for tag in "jt":
        assert f"[frames] extracted 4 frames @ 10fps -> {tmp_path / tag}/db/JPEGImages" \
            f"/Full-Resolution/s" in printed[tag]
    j, t, d = (str(tmp_path / tag / "db") for tag in "jtd")
    files = [sorted(os.path.relpath(p, r) for p in glob.glob(os.path.join(r, "**", "*.*"),
                                                             recursive=True)) for r in (j, t, d)]
    assert files[0] == files[1] == files[2] and len(files[0]) > 40
    assert len(_files(t, "JPEGImages/Full-Resolution/s/*.jpg")) == 4
    for f in _files(t, "JPEGImages/Full-Resolution/s/*.jpg"):
        assert open(os.path.join(t, f), "rb").read() == open(os.path.join(d, f), "rb").read()
    pfms = _files(t, "Flow*/Full-Resolution/s/*.pfm")
    assert len(pfms) == 4 * (3 + 1)  # the pairs (i, i + d) with d | i: 3 at d 1, 1 at d 2
    for f in pfms:
        a, b = read_pfm(os.path.join(t, f))[0], read_pfm(os.path.join(d, f))[0]
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert read_pfm(os.path.join(j, f))[0].shape == a.shape and np.isfinite(a).all()
