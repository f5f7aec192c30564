"""The port's PointRend graph (moda_tpu_torch/preproc/pointrend_infer.py,
bridge.pointrend_from_jax) against moda_tpu's on the CPU.

Heads on tests/test_pointrend_infer.py's ``make_heads_sd`` weights: RPN,
box (its fc1 rows cross from the JAX tree's HWC flatten back to torch's
CHW), coarse and point heads within 1e-4 of the JAX heads on the same ROI
features. ``point_sample`` within 1e-6 of the JAX sampler; the host
functions (anchors, delta decoding, NMS, level assignment) bit-equal; the
converter's tree bit-equal to the JAX converter's.

End to end, the seeded detectron2-layout checkpoint at the published widths
(``pointrend_infer.reference_state_dict``; its stem BatchNorm holds the
pixels' variance, so the heads are not saturated: make_backbone_sd's
levels read hundreds and its detections are zero-area boxes at score 1)
runs through both predictors at input 128 with 2 subdivision steps, on
all classes (the raised class wins) and on the person class alone: the
same class, the score within 1e-4, the box within 1e-2 px, the masks equal
on >= 99.9% of the pixels. Frames are 96 x 120, so no resize is an exact 2x shrink (where
cv2 switches to INTER_AREA, ROADMAP.md §3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.preproc import pointrend_infer as JP
from moda_tpu_torch import bridge
from moda_tpu_torch.preproc import pointrend_infer as TP
from tests.test_cse_infer import make_backbone_sd
from tests.test_pointrend_infer import make_heads_sd
from tests.test_torch_resnet_fpn import assert_trees_bit_equal

INPUT, STEPS = 128, 2
DETECT = 16  # the seeded weights' raised class (an animal)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def heads():
    sd = make_backbone_sd()
    sd.update(make_heads_sd())
    params = JP.convert_pointrend_checkpoint(sd)
    return sd, params, bridge.pointrend_from_jax(params)


@pytest.fixture(scope="module")
def predictors():
    """The seeded checkpoint through both converters and both predictors
    (the JAX one compiles once for the file)."""
    sd = TP.reference_state_dict(0, detect_class=DETECT)
    jp = JP.PointRendPredictor(JP.convert_pointrend_checkpoint(sd), input_size=INPUT,
                               score_thresh=0.0, subdivision_steps=STEPS)
    tp = TP.PointRendPredictor(TP.convert_pointrend_checkpoint(sd), input_size=INPUT,
                               score_thresh=0.0, subdivision_steps=STEPS, device="cpu")
    return sd, jp, tp


def _nchw(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def test_converter_tree_is_the_jax_packages(heads):
    sd, params, _ = heads
    assert_trees_bit_equal(TP.convert_pointrend_checkpoint(sd), params)
    seeded = TP.reference_state_dict(1, num_classes=8)
    assert_trees_bit_equal(TP.convert_pointrend_checkpoint(seeded),
                           JP.convert_pointrend_checkpoint(seeded))
    del seeded["roi_heads.mask_point_head.fc2.bias"]
    with pytest.raises(KeyError, match="fc2.bias"):
        TP.convert_pointrend_checkpoint(seeded)


def test_rpn_head_matches_the_jax_packages(heads):
    _, params, net = heads
    x = np.random.default_rng(0).random((1, 256, 16, 12)).astype(np.float32)
    jl, jd = JP.RPNHead().apply({"params": params["rpn"]}, _nchw(x))
    with torch.no_grad():
        tl, td = net.rpn(torch.from_numpy(x))
    # flattened as _proposals does: (h, w, anchor) rows
    np.testing.assert_allclose(tl[0].permute(1, 2, 0).numpy().reshape(-1),
                               np.asarray(jl[0]).reshape(-1), atol=1e-4)
    np.testing.assert_allclose(td[0].permute(1, 2, 0).numpy().reshape(-1, 4),
                               np.asarray(jd[0]).reshape(-1, 4), atol=1e-4)


def test_box_head_matches_the_jax_packages(heads):
    """The ROI's NCHW flatten against the JAX tree's HWC-ordered fc1 rows."""
    _, params, net = heads
    roi = np.random.default_rng(1).random((3, 256, 7, 7)).astype(np.float32)
    js, jd = JP.BoxHead().apply({"params": params["box_head"]}, _nchw(roi))
    with torch.no_grad():
        ts, td = net.box_head(torch.from_numpy(roi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


def test_coarse_head_matches_the_jax_packages(heads):
    _, params, net = heads
    roi = np.random.default_rng(2).random((2, 256, 14, 14)).astype(np.float32)
    want = JP.CoarseMaskHead().apply({"params": params["coarse"]}, _nchw(roi))
    with torch.no_grad():
        got = net.coarse(torch.from_numpy(roi))
    assert got.shape == (2, 80, 7, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_point_head_matches_the_jax_packages(heads):
    _, params, net = heads
    rng = np.random.default_rng(3)
    fine = rng.random((1, 10, 256)).astype(np.float32)
    coarse = rng.random((1, 10, 80)).astype(np.float32)
    want = JP.PointHead().apply({"params": params["point"]}, jnp.asarray(fine),
                                jnp.asarray(coarse))
    with torch.no_grad():
        got = net.point(torch.from_numpy(fine), torch.from_numpy(coarse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_point_sample_matches_the_jax_sampler():
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((9, 11, 6)).astype(np.float32)
    pts = (rng.random((40, 2)) * 1.2 - 0.1).astype(np.float32)  # some off the map
    want = np.asarray(JP.point_sample(jnp.asarray(feat), jnp.asarray(pts)))
    got = TP.point_sample(torch.from_numpy(feat.transpose(2, 0, 1)), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_host_functions_are_the_jax_packages():
    rng = np.random.default_rng(5)
    for h, w, stride, size in ((5, 7, 4, 32), (8, 8, 64, 512)):
        np.testing.assert_array_equal(TP.make_anchors(h, w, stride, size),
                                      JP.make_anchors(h, w, stride, size))
    anchors = TP.make_anchors(6, 6, 16, 128)
    deltas = (rng.standard_normal((len(anchors), 4)) * 3).astype(np.float32)
    for wts in ((1.0, 1.0, 1.0, 1.0), TP.BOX_WEIGHTS):
        got, want = TP.decode_deltas(anchors, deltas, wts), JP.decode_deltas(anchors, deltas, wts)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    boxes = np.clip(TP.decode_deltas(anchors, deltas * 0.3), 0, 96).astype(np.float32)
    scores = rng.standard_normal(len(boxes)).astype(np.float32)
    full = JP.nms(boxes, scores, 0.7)
    assert TP.nms(boxes, scores, 0.7) == full
    assert TP.nms(boxes, scores, 0.7, max_keep=20) == full[:20]
    assert TP.nms(boxes, scores, 0.3, max_keep=1000) == JP.nms(boxes, scores, 0.3)
    lv = boxes[:50] * np.asarray([1, 1, 9, 9], np.float32)
    np.testing.assert_array_equal(TP.assign_fpn_level(lv), JP.assign_fpn_level(lv))


@pytest.mark.parametrize("keep", [None, (0,)])
def test_predictor_matches_the_jax_packages(predictors, keep):
    _, jp, tp = predictors
    jp.keep_classes = tp.keep_classes = keep  # read at each call, outside the jit
    img = (np.random.default_rng(6).random((96, 120, 3)) * 255).astype(np.uint8)
    jm, js, jb = jp(img)
    tm, ts, tb = tp(img)
    assert tm.shape == (96, 120) and tm.dtype == np.uint8
    assert jb is not None and tb is not None and jm.any()
    jimp, jhw = jax_input(img)
    jdet = jp._detect(jp._features(jnp.asarray(jimp)), jhw)
    imp, _, hw = TP.pad_resized(img, INPUT)
    tdet = tp._detect(tp.features(imp), hw)
    assert hw == jhw and tdet[1] == jdet[1] == (DETECT if keep is None else 0)
    assert abs(ts - js) <= 1e-4 and abs(tdet[2] - jdet[2]) <= 1e-4
    np.testing.assert_allclose(tb, jb, atol=1e-2, rtol=0)
    assert (tm == jm).mean() >= 0.999


def jax_input(img):
    """The JAX predictor's padded input (cv2's float resize) and the
    resized frame's (height, width), as its __call__ makes them."""
    import cv2

    H, W = img.shape[:2]
    s = INPUT / max(H, W)
    imr = cv2.resize(img.astype(np.float32), (int(round(W * s)), int(round(H * s))))
    imp = np.zeros((INPUT, INPUT, 3), np.float32)
    imp[: imr.shape[0], : imr.shape[1]] = imr
    return imp, imr.shape[:2]


def test_no_detection_gives_an_empty_mask(predictors):
    _, jp, tp = predictors
    img = (np.random.default_rng(7).random((40, 50, 3)) * 255).astype(np.uint8)
    thresh = tp.score_thresh
    tp.score_thresh = jp.score_thresh = 1.01
    try:
        for m, s, b in (tp(img), jp(img)):
            assert m.shape == (40, 50) and not m.any() and s == 0.0 and b is None
    finally:
        tp.score_thresh = jp.score_thresh = thresh


def test_predictor_needs_a_card_unless_asked_for_cpu(heads, monkeypatch):
    _, params, _ = heads
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.PointRendPredictor(params)
    with pytest.raises(ValueError, match="80 classes"):
        TP.PointRendPredictor(params, num_classes=81, device="cpu")
