"""The port's checkpoint converter (``python -m moda_tpu_torch.cli.
convert_app``) against tools/convert_all_checkpoints.py on the CPU.

Seeded checkpoints in the released file formats (detectron2 ``.pkl``, a
pickle of numpy under 'model', and ``.pth``, a torch zip; VCN+'s
``vcn_rob.pth`` with 'state_dict' and 'mean_L') go through both tools. The
npz files must hold the same keys, dtypes and bits, and a file written by
either tool must load in the other package's predictor. The acceptance
route (--golden_dir) scores a golden frame whose mask and features come
from the port's own predictors on cv2's BGR read of the frame, so a
correct reading through the port's imread and read_pfm scores IoU 1 and
cosine 1.
"""
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.preproc import checkpoints as JCK
from moda_tpu_torch.cli import convert_app
from moda_tpu_torch.data.pfm import write_pfm
from moda_tpu_torch.preproc import checkpoints as TCK
from moda_tpu_torch.preproc import cse_infer as TC
from moda_tpu_torch.preproc import pointrend_infer as TP
from moda_tpu_torch.preproc import vcn_flow as TV
from tools import convert_all_checkpoints as JTOOL

SMALL = 64  # predictors' input_size in the acceptance test


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_npz_bit_equal(a, b):
    fa, fb = _npz(a), _npz(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def seeded_pointrend():
    """8 classes; class 2 scores above the 0.3 threshold."""
    return TP.reference_state_dict(3, num_classes=8, detect_class=2)


@pytest.mark.parametrize("fmt", ["pkl", "pth"])
def test_files_are_the_jax_tools(tmp_path, fmt):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    pr = seeded_pointrend()
    cse = TC.reference_state_dict(4, hidden=32, n_vertices=20)
    for name, sd in (("pointrend_r50", pr), ("cse_r50", cse)):
        if fmt == "pkl":
            with open(wdir / f"{name}.pkl", "wb") as f:
                pickle.dump({"model": sd, "__author__": "seed"}, f)
        else:
            torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                        "iteration": 0}, wdir / f"{name}.pth")
    vcn = {k: torch.from_numpy(v) for k, v in TV.reference_state_dict(5, div=8).items()}
    torch.save({"state_dict": vcn, "mean_L": [[0.30, 0.32, 0.34]]}, wdir / "vcn_rob.pth")

    assert convert_app.main(["--weights_dir", str(wdir), "--out_dir", str(tmp_path / "t")]) == 0
    assert JTOOL.main(["--weights_dir", str(wdir), "--out_dir", str(tmp_path / "j")]) == 0
    for name in ("pointrend.npz", "cse.npz", "vcn_rob.npz"):
        assert_npz_bit_equal(tmp_path / "t" / name, tmp_path / "j" / name)
    manifest = json.load(open(tmp_path / "t" / "manifest.json"))
    assert set(manifest) == {"vcn", "pointrend", "cse"}

    # a file of either tool loads in the other package's predictor
    tp = TCK.load_pointrend_predictor(str(tmp_path / "j" / "pointrend.npz"), device="cpu",
                                      num_classes=8)
    assert tp.net.coarse.num_classes == 8
    tc = TCK.load_cse_predictor(str(tmp_path / "j" / "cse.npz"), device="cpu")
    assert tc.head.n_convs == 8 and tc.vertex_embeddings.shape == (20, 16)
    jp = JCK.load_pointrend_predictor(str(tmp_path / "t" / "pointrend.npz"), num_classes=8)
    jc = JCK.load_cse_predictor(str(tmp_path / "t" / "cse.npz"))
    assert jp.num_classes == 8 and jc.vertex_embeddings.shape == (20, 16)


def test_no_weights_and_no_golden_artifacts(tmp_path):
    assert convert_app.main(["--weights_dir", str(tmp_path),
                             "--out_dir", str(tmp_path / "out")]) == 2
    with open(tmp_path / "cse_x.pkl", "wb") as f:
        pickle.dump({"model": TC.reference_state_dict(0, hidden=8)}, f)
    gdir = tmp_path / "golden"
    gdir.mkdir()
    cv2.imwrite(str(gdir / "frame.jpg"), np.zeros((8, 8, 3), np.uint8))
    assert convert_app.main(["--weights_dir", str(tmp_path), "--out_dir", str(tmp_path / "o"),
                             "--golden_dir", str(gdir)], device="cpu") == 2


def test_acceptance_reads_the_golden_frame_as_cv2(tmp_path, monkeypatch):
    """Golden mask and features made by the port's predictors from cv2's
    BGR read of frame.jpg: the tool's own read must score IoU 1 and cosine
    1; negated golden features fail the cosine check."""
    wdir, gdir = tmp_path / "weights", tmp_path / "golden"
    wdir.mkdir()
    gdir.mkdir()
    with open(wdir / "pointrend_x.pkl", "wb") as f:
        pickle.dump({"model": seeded_pointrend()}, f)
    with open(wdir / "cse_x.pkl", "wb") as f:
        pickle.dump({"model": TC.reference_state_dict(6, hidden=32)}, f)
    yy, xx = np.mgrid[0:48, 0:56]
    img = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1).astype(np.uint8)
    cv2.imwrite(str(gdir / "frame.jpg"), img)
    bgr = cv2.imread(str(gdir / "frame.jpg"))

    load_pr, load_cse = TCK.load_pointrend_predictor, TCK.load_cse_predictor
    monkeypatch.setattr(TCK, "load_pointrend_predictor",
                        lambda p, **k: load_pr(p, input_size=SMALL, num_classes=8, **k))
    monkeypatch.setattr(TCK, "load_cse_predictor",
                        lambda p, **k: load_cse(p, input_size=SMALL, **k))
    out = tmp_path / "out"
    assert convert_app.main(["--weights_dir", str(wdir), "--out_dir", str(out)]) == 0
    mask = TCK.load_pointrend_predictor(str(out / "pointrend.npz"), device="cpu")(bgr)[0]
    assert mask.any()
    cv2.imwrite(str(gdir / "mask.png"), mask * 255)
    feat = TCK.load_cse_predictor(str(out / "cse.npz"), device="cpu")(bgr, mask)[0]
    write_pfm(str(gdir / "feat.pfm"), feat.reshape(16 * 112, 112))

    argv = ["--weights_dir", str(wdir), "--out_dir", str(out), "--golden_dir", str(gdir)]
    assert convert_app.main(argv, device="cpu") == 0
    report = json.load(open(out / "acceptance.json"))
    assert set(report) == {"mask_iou", "cse_cosine"}
    assert report["mask_iou"]["value"] == 1.0
    assert report["cse_cosine"]["value"] > 1 - 1e-6
    write_pfm(str(gdir / "feat.pfm"), -feat.reshape(16 * 112, 112))
    assert convert_app.main(argv, device="cpu") == 1
    assert not json.load(open(out / "acceptance.json"))["cse_cosine"]["pass"]
    assert os.path.exists(out / "manifest.json")
