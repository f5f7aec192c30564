"""The port's preprocessing pieces (moda_tpu_torch/preproc/pipeline.py,
ama.py, checkpoints.py and the image I/O they need in data/imageio.py)
against moda_tpu's and cv2's on the CPU.

cv2 appears here only as the oracle of the JAX package's behaviour: the
uint8 resize is bit-equal to cv2.resize, the PBM reader to cv2.imread,
largest_cc equal to the JAX package's (cv2.connectedComponents). The
pipeline functions give the JAX package's files and arrays; compute_flows,
run in both packages with one narrow vcn_rob.npz, gives flo-/occ- PFMs
within the flow gate of tests/test_torch_vcn.py.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.preproc import ama as JA
from moda_tpu.preproc import checkpoints as JC
from moda_tpu.preproc import pipeline as JP
from moda_tpu.preproc import vcn_flow as JV
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.pfm import read_pfm
from moda_tpu_torch.preproc import ama as TA
from moda_tpu_torch.preproc import checkpoints as TC
from moda_tpu_torch.preproc import pipeline as TP
from moda_tpu_torch.preproc import vcn_flow as TV

TESTRES = 3.0  # 48 x 64 frames -> a 192 x 192 network input


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_vcn_npz(path: str, seed: int = 0, div: int = 4) -> None:
    """A converted vcn_rob.npz ({params, mean}, the layout of
    tools/convert_all_checkpoints.py) of the seeded reference-layout
    weights, written by the JAX package's save_pytree_npz."""
    sd = TV.reference_state_dict(seed, div=div)
    JC.save_pytree_npz(path, {"params": JV.convert_vcn_checkpoint(sd),
                              "mean": np.asarray([0.31, 0.33, 0.35], np.float32)})


def write_frames(d, n: int = 3, h: int = 48, w: int = 64, seed: int = 0):
    """n JPEG frames (cv2.imwrite) of a smooth texture sliding 2 px a frame,
    and masks of a box that moves with it."""
    os.makedirs(d / "frames", exist_ok=True)
    os.makedirs(d / "masks", exist_ok=True)
    rng = np.random.default_rng(seed)
    tex = cv2.GaussianBlur((rng.random((h, w + 2 * n, 3)) * 255).astype(np.uint8), (5, 5), 0)
    for i in range(n):
        cv2.imwrite(str(d / "frames" / ("%05d.jpg" % i)), np.ascontiguousarray(tex[:, 2 * i:2 * i + w]))
        m = np.zeros((h, w), np.uint8)
        m[h // 5:h - h // 6, w // 4 + i:w - w // 5 + i] = 255
        cv2.imwrite(str(d / "masks" / ("%05d.png" % i)), m)
    return str(d / "frames")


def _flow_gate(a, b, tag):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.percentile(d, 99.9) < 1e-3, f"{tag}: p99.9 {np.percentile(d, 99.9)}"
    assert d.max() < 0.5, f"{tag}: max {d.max()}"


# ------------------------------------------------------------- image I/O
@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("src,dst", [((48, 64), (192, 192)), ((37, 53), (128, 192)),
                                     ((60, 80), (45, 70)), ((48, 64), (24, 32)),
                                     ((21, 17), (7, 5)), ((64, 48), (33, 21))])
def test_uint8_resize_is_cv2(cn, src, dst):
    """uint8 INTER_LINEAR: cv2's fixed-point path, enlarging and shrinking,
    the exact 2x shrink (cv2's INTER_AREA) included."""
    rng = np.random.default_rng(cn + src[0])
    img = (rng.random(src + (cn,)) * 255).astype(np.uint8)
    img = img[..., 0] if cn == 1 else img
    got = IO.resize(img, dst[::-1])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1]))


@pytest.mark.parametrize("kind", ["P1", "P4"])
def test_pbm_reader_is_cv2(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    bits = rng.random((13, 21)) > 0.5
    p = str(tmp_path / "sil.pbm")
    if kind == "P4":
        with open(p, "wb") as f:
            f.write(b"P4\n# a comment\n21 13\n" + np.packbits(bits, axis=1).tobytes())
    else:
        with open(p, "w") as f:
            f.write("P1\n# a comment\n21 13\n"
                    + "\n".join(" ".join(str(int(v)) for v in r) for r in bits) + "\n")
    np.testing.assert_array_equal(IO.imread(p, gray=True), cv2.imread(p, 0))
    np.testing.assert_array_equal(IO.imread(p)[..., ::-1], cv2.imread(p))


def test_largest_cc_is_the_jax_packages():
    """8-connectivity (diagonal touches join), a tie between two equal
    components (the first in raster order wins), one component, and masks
    without foreground."""
    rng = np.random.default_rng(0)
    masks = [(rng.random((40, 50)) > 0.6).astype(np.uint8) for _ in range(4)]
    tie = np.zeros((20, 20), np.uint8)
    tie[12:16, 2:6] = 1
    tie[2:6, 12:16] = 1  # first in raster order
    diag = np.zeros((10, 10), np.uint8)
    diag[2, 2] = diag[3, 3] = diag[4, 4] = 1
    diag[7, 0:2] = 1  # 2 px: the 3 diagonal pixels are one larger component
    masks += [tie, diag, np.zeros((8, 9), np.uint8), np.ones((5, 5), np.uint8)]
    for m in masks:
        want, got = JP.largest_cc(m), TP.largest_cc(m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert TP.largest_cc(tie)[3, 13] == 1 and TP.largest_cc(diag)[4, 4] == 1


# ------------------------------------------------------- pipeline pieces
def test_fb_confidence():
    """Within 1e-6: the port's remap of the 2-channel flow takes cv2's
    1/32-pixel weights but sums the four taps in another order (1 ulp)."""
    rng = np.random.default_rng(1)
    fw = (rng.standard_normal((30, 40, 2)) * 3).astype(np.float32)
    bw = (rng.standard_normal((30, 40, 2)) * 3).astype(np.float32)
    got = TP.fb_confidence(fw, bw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, JP.fb_confidence(fw, bw), rtol=0, atol=1e-6)


def test_write_config(tmp_path):
    a = JP.write_config(str(tmp_path / "j"), "seq", "/data/x", (48, 64))
    b = TP.write_config(str(tmp_path / "t"), "seq", "/data/x", (48, 64))
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("with_cse", [False, True])
def test_write_dp_features(tmp_path, with_cse):
    """Zero features without a CSE backend; with one, the callback sees the
    BGR frame and the mask, as the JAX package's does."""
    frames = write_frames(tmp_path)

    def cse_fn(img, mask):
        feat = np.resize(img[..., 0].astype(np.float32) / 255.0, (16, 112, 112))
        return feat, img[..., 2].astype(np.float32) * mask, np.asarray([1, 2, 30, 40.5])

    for pkg, root in ((JP, "j"), (TP, "t")):
        ann = tmp_path / root / "Annotations" / "Full-Resolution" / "s"
        os.makedirs(ann)
        cv2.imwrite(str(ann / "00001.png"), cv2.imread(str(tmp_path / "masks/00001.png")))
        pkg.write_dp_features(frames, str(tmp_path / root), "s",
                              cse_fn=cse_fn if with_cse else None)
    names = sorted(os.listdir(tmp_path / "j/Densepose/Full-Resolution/s"))
    assert names == sorted(os.listdir(tmp_path / "t/Densepose/Full-Resolution/s"))
    assert len(names) == 9
    for n in names:
        a = open(tmp_path / "j/Densepose/Full-Resolution/s" / n, "rb").read()
        assert a == open(tmp_path / "t/Densepose/Full-Resolution/s" / n, "rb").read(), n


def test_write_masks(tmp_path):
    """A segmentation callback over the BGR frames; the largest component
    stored at 128."""
    frames = write_frames(tmp_path)

    def mask_fn(img):
        return (img[..., 0] > img[..., 2]).astype(np.uint8)

    JP.write_masks(frames, str(tmp_path / "j"), "s", mask_fn)
    TP.write_masks(frames, str(tmp_path / "t"), "s", mask_fn)
    for p in sorted(glob.glob(str(tmp_path / "j/Annotations/Full-Resolution/s/*.png"))):
        got = IO.imread(p.replace("/j/", "/t/"), gray=True)
        np.testing.assert_array_equal(got, cv2.imread(p, 0))
        assert set(np.unique(got)) <= {0, 128}


def test_compute_flow_cse():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((16, 9, 11)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(TP.compute_flow_cse(a, b), JP.compute_flow_cse(a, b))


def test_pmat_to_rtk(tmp_path):
    from scipy.spatial.transform import Rotation as R
    rng = np.random.default_rng(3)
    for k in range(3):
        K = np.asarray([[500.0 + 10 * k, 0, 320], [0, 510, 240], [0, 0, 1]])
        Rm = R.from_rotvec(rng.standard_normal(3) * 0.5).as_matrix()
        P = K @ np.concatenate([Rm, rng.standard_normal((3, 1))], 1) * (k - 1.5)
        np.savetxt(tmp_path / "Camera0.Pmat.cal", P)
        p = str(tmp_path / "Camera0.Pmat.cal")
        np.testing.assert_array_equal(TA.read_pmat(p), JA.read_pmat(p))
        np.testing.assert_array_equal(TA.pmat_to_rtk(P), JA.pmat_to_rtk(P))


def test_ama_to_davis(tmp_path):
    """Images stored so that they decode to the source pixels (PNG bytes
    under the .jpg names; the JAX package re-encodes JPEG), masks equal to
    the JAX package's, a missing silhouette an empty mask."""
    ama = tmp_path / "ama"
    os.makedirs(ama / "images")
    os.makedirs(ama / "silhouettes")
    rng = np.random.default_rng(4)
    srcs = []
    for i in range(3):
        img = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(ama / "images" / ("Image0-%04d.png" % i)), img)
        srcs.append(img)
        if i < 2:
            bits = rng.random((20, 30)) > 0.5
            with open(ama / "silhouettes" / ("silhouette0-%04d.pbm" % i), "wb") as f:
                f.write(b"P4\n30 20\n" + np.packbits(bits, axis=1).tobytes())
    assert JA.ama_to_davis(str(ama), str(tmp_path / "j"), "a") == 3
    assert TA.ama_to_davis(str(ama), str(tmp_path / "t"), "a") == 3
    for i in range(3):
        got = IO.imread(str(tmp_path / "t/JPEGImages/Full-Resolution/a" / ("%05d.jpg" % i)))
        np.testing.assert_array_equal(got[..., ::-1], srcs[i])
        m = "Annotations/Full-Resolution/a/%05d.png" % i
        np.testing.assert_array_equal(IO.imread(str(tmp_path / "t" / m), gray=True),
                                      cv2.imread(str(tmp_path / "j" / m), 0))
    assert IO.imread(str(tmp_path / "t/Annotations/Full-Resolution/a/00002.png")).max() == 0


def test_checkpoint_npz_crosses_both_ways(tmp_path, monkeypatch):
    """A tree saved by either package loads in the other; the CSE and
    PointRend loaders build their predictors from the JAX package's files
    (seeded detectron2-layout weights through its converters), on the card
    unless asked for the CPU."""
    tree = {"params": {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
                       "b": np.ones(2)}, "mean": np.asarray([0.1, 0.2, 0.3])}
    JC.save_pytree_npz(str(tmp_path / "j.npz"), tree)
    TC.save_pytree_npz(str(tmp_path / "t.npz"), tree)
    for src, load in (("j", TC.load_pytree_npz), ("t", JC.load_pytree_npz)):
        got = TC.flatten_tree(load(str(tmp_path / f"{src}.npz")))
        want = TC.flatten_tree(tree)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
    assert TC.unflatten_tree(TC.flatten_tree(tree)).keys() == tree.keys()
    from moda_tpu.preproc import cse_infer as JCSE
    from moda_tpu.preproc import pointrend_infer as JPR
    from moda_tpu_torch.preproc import cse_infer, pointrend_infer

    cse = JCSE.convert_cse_checkpoint(cse_infer.reference_state_dict(0, hidden=8, n_vertices=5))
    JC.save_pytree_npz(str(tmp_path / "cse.npz"), {"backbone": cse.bp, "head": cse.hp,
                                                  "vertex_embeddings": cse.vertex_embeddings})
    JC.save_pytree_npz(str(tmp_path / "pointrend.npz"), JPR.convert_pointrend_checkpoint(
        pointrend_infer.reference_state_dict(0, num_classes=4)))
    pred = TC.load_cse_predictor(str(tmp_path / "cse.npz"), device="cpu", input_size=64)
    assert isinstance(pred, cse_infer.CSEPredictor) and pred.input_size == 64
    assert pred.head.conv8.out_channels == 8 and pred.vertex_embeddings.shape == (5, 16)
    pred = TC.load_pointrend_predictor(str(tmp_path / "pointrend.npz"), device="cpu",
                                       num_classes=4, keep_classes=(1,))
    assert isinstance(pred, pointrend_infer.PointRendPredictor) and pred.keep_classes == (1,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load, name in ((TC.load_cse_predictor, "cse.npz"),
                       (TC.load_pointrend_predictor, "pointrend.npz")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(str(tmp_path / name))


def _dis_gate(a, b, tag):
    """DIS flo-/occ- PFMs against the JAX package's (cv2's DIS): the
    endpoint (or confidence) difference with median <= 1e-3 and p99 <= 0.05
    (tests/test_torch_dis.py's gate)."""
    a, b = np.asarray(a), np.asarray(b)
    d = np.linalg.norm(a - b, axis=-1) if a.ndim == 3 else np.abs(a - b)
    assert np.median(d) <= 1e-3 and np.percentile(d, 99) <= 0.05, \
        f"{tag}: median {np.median(d):.2e}, p99 {np.percentile(d, 99):.2e}"


def test_refusals(tmp_path, monkeypatch):
    """Video in a codec the port does not decode raises (an MS-MPEG-4 v3
    clip from cv2: tests/test_torch_video.py holds the Motion-JPEG route,
    tests/test_torch_m4v.py MPEG-4 Part 2);
    DIS, the JAX package's flow without VCN weights, runs (on the CPU when
    asked; without a card and without the request, compute_flows raises
    instead of falling back)."""
    from tests.torch_video import scene, write_cv2_clip

    write_cv2_clip(str(tmp_path / "video.avi"), "DIV3", 30.0, scene(2, 48, 64))
    with pytest.raises(ValueError, match="codec DIV3: the port decodes Motion JPEG"):
        TP.extract_frames(str(tmp_path / "video.avi"), str(tmp_path / "nonexistent"))
    frames = write_frames(tmp_path, n=2)
    img0, img1 = (TP.read_bgr(p) for p in sorted(glob.glob(os.path.join(frames, "*.jpg"))))
    flow = TP.dis_flow(img0, img1, device="cpu")
    assert flow.shape == (48, 64, 2) and flow.dtype == np.float32 and np.isfinite(flow).all()
    _dis_gate(flow, JP.dis_flow(img0, img1), "dis_flow")
    TP.compute_flows(frames, str(tmp_path / "t"), "s", flow_fn=None, device="cpu")
    assert len(glob.glob(str(tmp_path / "t/Flow*/Full-Resolution/s/*.pfm"))) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.compute_flows(frames, str(tmp_path / "c"), "s", flow_fn=None)


def test_compute_flows_with_dis_matches_the_jax_packages(tmp_path):
    """Three frames, no flow_fn: DIS both ways for the pairs (0, 1), (1, 2)
    and (0, 2) in both packages; flo- and occ- PFMs within the DIS gate."""
    frames = write_frames(tmp_path)
    JP.compute_flows(frames, str(tmp_path / "j"), "s")
    TP.compute_flows(frames, str(tmp_path / "t"), "s", device="cpu")
    files = sorted(glob.glob(str(tmp_path / "j/Flow*/Full-Resolution/s/*.pfm")))
    assert len(files) == 12
    for p in files:
        a, b = read_pfm(p)[0], read_pfm(p.replace("/j/", "/t/"))[0]
        assert a.shape == b.shape and np.isfinite(b).all()
        _dis_gate(a, b, os.path.relpath(p, tmp_path))


def test_compute_flows_with_one_vcn_npz(tmp_path):
    """Three frames: the pairs (0, 1), (1, 2) at d = 1 and (0, 2) at d = 2,
    each both ways, through VCN+ loaded from the same npz by both packages
    (testres 3: a 192 x 192 input). The port flips its RGB frames to BGR,
    as cv2.imread gives them to the JAX package's flow_fn."""
    frames = write_frames(tmp_path)
    write_vcn_npz(str(tmp_path / "vcn_rob.npz"))
    jpred = JC.load_vcn_predictor(str(tmp_path / "vcn_rob.npz"))
    jpred.testres = TESTRES
    tpred = TC.load_vcn_predictor(str(tmp_path / "vcn_rob.npz"), device="cpu", testres=TESTRES)
    np.testing.assert_array_equal(tpred.mean, jpred.mean)
    JP.compute_flows(frames, str(tmp_path / "j"), "s", flow_fn=jpred.as_flow_fn())
    TP.compute_flows(frames, str(tmp_path / "t"), "s", flow_fn=tpred.as_flow_fn())
    assert tpred.calls == 6
    files = sorted(glob.glob(str(tmp_path / "j/Flow*/Full-Resolution/s/*.pfm")))
    assert len(files) == 12
    for p in files:
        a, b = read_pfm(p)[0], read_pfm(p.replace("/j/", "/t/"))[0]
        assert a.shape == b.shape and np.isfinite(b).all()
        _flow_gate(a, b, os.path.relpath(p, tmp_path))
