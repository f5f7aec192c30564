"""The port's DensePose-CSE graph (moda_tpu_torch/preproc/cse_infer.py,
bridge.cse_from_jax) against moda_tpu's on the CPU.

The head's weights are tests/test_cse_infer.py's ``make_head_sd`` (2 convs
of 64: within 1e-4 of the JAX head, whose ConvTranspose the JAX converter
stores flipped as an input-dilated conv); ``roi_align`` within 1e-6, box by
box against the JAX crop; the converters bit-equal to the JAX package's.
End to end, the seeded detectron2-layout checkpoint at the published widths
(``cse_infer.reference_state_dict``: 8 convs of 512, E = 16, a table of 50
vertices) runs through both predictors at input 128: per-pixel cosine >= 1 -
1e-5, the vertex map equal on >= 99.9% of the mask's pixels, the box equal.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.preproc import cse_infer as JC
from moda_tpu_torch import bridge
from moda_tpu_torch.preproc import cse_infer as TC
from moda_tpu_torch.preproc.checkpoints import flatten_tree
from tests.test_cse_infer import make_head_sd
from tests.test_torch_resnet_fpn import assert_trees_bit_equal

INPUT = 128
N_VERTICES = 50


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def predictors():
    """One seeded checkpoint through both converters and both predictors
    (the JAX one compiles once for the file)."""
    sd = TC.reference_state_dict(0, n_vertices=N_VERTICES)
    jpred = JC.convert_cse_checkpoint(sd)
    jpred.input_size = INPUT
    tree = TC.convert_cse_checkpoint(sd)
    tpred = TC.CSEPredictor(tree["backbone"], tree["head"], tree["vertex_embeddings"],
                            input_size=INPUT, device="cpu")
    return sd, jpred, tree, tpred


def test_converters_are_the_jax_packages(predictors):
    sd, jpred, tree, _ = predictors
    assert_trees_bit_equal(tree, {"backbone": jpred.bp, "head": jpred.hp,
                                  "vertex_embeddings": jpred.vertex_embeddings})
    head = make_head_sd(n_convs=2, hidden=64)
    assert_trees_bit_equal(TC.convert_cse_head(head, n_convs=2),
                           JC.convert_cse_head(head, n_convs=2))
    sd = dict(sd)
    del sd["roi_heads.densepose_predictor.embed_lowres.bias"]
    with pytest.raises(KeyError, match="embed_lowres.bias"):
        TC.convert_cse_checkpoint(sd)


def test_head_matches_the_jax_packages():
    sd = make_head_sd(n_convs=2, hidden=64)
    params = JC.convert_cse_head(sd, n_convs=2)
    x = np.random.default_rng(0).random((1, 256, 14, 14)).astype(np.float32)
    want = np.asarray(JC.CSEHead(n_convs=2, hidden=64).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    head = TC.CSEHead(n_convs=2, hidden=64)
    bridge.load_params(head, params)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 28, 28, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the ConvTranspose crosses back to the JAX layout bit for bit
    back = bridge.export_params(head)
    np.testing.assert_array_equal(back["predictor_kernel"], params["predictor_kernel"])


def test_roi_align_matches_the_jax_crop():
    """Boxes inside, across and outside the map (clamped taps), one batched
    call against the JAX crop box by box."""
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((13, 17, 8)).astype(np.float32)
    boxes = np.asarray([[3.2, 5.7, 40.1, 33.9], [0, 0, 68, 52], [-9.5, -3, 20, 11.25],
                        [50, 40, 90, 80], [7.5, 7.5, 8.5, 8.0]], np.float32)
    got = TC.roi_align(torch.from_numpy(feat.transpose(2, 0, 1)), torch.from_numpy(boxes),
                       7, 0.25).numpy()
    for i, b in enumerate(boxes):
        want = np.asarray(JC.roi_align(jnp.asarray(feat), jnp.asarray(b), 7, 0.25))
        np.testing.assert_allclose(got[i].transpose(1, 2, 0), want, atol=1e-6, rtol=0)
    one = TC.roi_align(torch.from_numpy(feat.transpose(2, 0, 1)), torch.from_numpy(boxes[0]),
                       7, 0.25)
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_predictor_matches_the_jax_packages(predictors):
    _, jpred, _, tpred = predictors
    rng = np.random.default_rng(2)
    img = (rng.random((96, 80, 3)) * 255).astype(np.uint8)
    mask = np.zeros((96, 80), np.uint8)
    mask[20:70, 15:60] = 1
    mask[30:40, 25:30] = 0
    jf, jv, jb = jpred(img, mask)
    tf, tv, tb = tpred(img, mask)
    assert tf.shape == (16, 112, 112) and tf.dtype == np.float32 and tv.shape == (96, 80)
    np.testing.assert_array_equal(tb, jb)
    cos = (tf * jf).sum(0) / (np.linalg.norm(tf, axis=0) * np.linalg.norm(jf, axis=0))
    assert cos.min() >= 1 - 1e-5, cos.min()
    np.testing.assert_allclose(np.linalg.norm(tf, axis=0), 1.0, atol=1e-5)
    inside = mask > 0
    assert (tv[inside] == jv[inside]).mean() >= 0.999
    assert (tv[~inside] == 0).all() and 0 < tv.max() < N_VERTICES


def test_empty_mask_gives_zeros_and_the_frame(predictors):
    _, jpred, _, tpred = predictors
    img = np.zeros((30, 40, 3), np.uint8)
    mask = np.zeros((30, 40), np.uint8)
    calls = tpred.calls
    for got, want in zip(tpred(img, mask), jpred(img, mask)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tpred.calls == calls  # the graph did not run


def test_detectron2_files_read_as_the_jax_package_reads_them(tmp_path):
    """.pkl (pickle of numpy under 'model') and .pth (torch zip) give the
    JAX reader's dict."""
    sd = make_head_sd(n_convs=2, hidden=8)
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump({"model": sd, "__author__": "seed"}, f)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 3},
               tmp_path / "m.pth")
    for name in ("m.pkl", "m.pth"):
        got = TC.load_detectron2_state_dict(str(tmp_path / name))
        want = JC.load_detectron2_state_dict(str(tmp_path / name))
        assert got.keys() == want.keys() and set(sd) <= set(got)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_predictor_needs_a_card_unless_asked_for_cpu(predictors, monkeypatch):
    _, _, tree, _ = predictors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.CSEPredictor(tree["backbone"], tree["head"])
    flat = flatten_tree(tree["head"])
    del flat["conv3/bias"]
    with pytest.raises(KeyError, match="conv3/bias"):
        TC.CSEPredictor(tree["backbone"], bridge.unflatten(flat), device="cpu")

