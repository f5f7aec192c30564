"""The port's VCN+ flow net (moda_tpu_torch/preproc/vcn_flow.py) against
moda_tpu's on the CPU.

One seeded state dict in the reference's layout
(``vcn_flow.reference_state_dict``, every channel width divided by 4)
feeds both converters, which must give equal trees; the port runs the JAX
tree through ``bridge.vcn_from_jax``. Each function of the graph is held
against the JAX one on the same numpy inputs within 1e-5 of the largest
value (fp32 convolutions and sums in another order read ~1e-6).
``vcn_forward`` and the predictor are held as the reference's own test
holds the JAX graph (tests/test_vcn_flow.py:90-96): the flow within 1e-3
px on 99.9% of the pixels and 0.5 px everywhere (the truncated soft-argmax
can flip a window where two costs tie within rounding), the occlusion
logits within 1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from moda_tpu.preproc import vcn_flow as JV
from moda_tpu_torch import bridge
from moda_tpu_torch.preproc import vcn_flow as TV

DIV = 4
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    sd = TV.reference_state_dict(0, div=DIV)
    pj = JV.convert_vcn_checkpoint(sd)
    return sd, pj, bridge.vcn_from_jax(pj)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _flow_gate(fj, ft, tag):
    d = np.abs(np.asarray(fj) - np.asarray(ft))
    assert np.percentile(d, 99.9) < 1e-3, f"{tag}: p99.9 {np.percentile(d, 99.9)}"
    assert d.max() < 0.5, f"{tag}: max {d.max()}"


def test_converters_agree(params, tmp_path):
    """convert_vcn_checkpoint of both packages gives equal trees, from the
    state dict and from a vcn_rob.pth (torch pickle, 'state_dict' +
    'mean_L') through load_vcn_checkpoint."""
    sd, pj, _ = params
    ft = bridge.flatten(TV.convert_vcn_checkpoint(sd))
    fj = bridge.flatten(pj)
    assert ft.keys() == fj.keys() and len(ft) > 100
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    mean = np.asarray([[0.3, 0.32, 0.34], [0.36, 0.38, 0.4]], np.float32)
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "mean_L": mean}, tmp_path / "vcn_rob.pth")
    (pt2, mt), (pj2, mj) = (TV.load_vcn_checkpoint(str(tmp_path / "vcn_rob.pth")),
                            JV.load_vcn_checkpoint(str(tmp_path / "vcn_rob.pth")))
    np.testing.assert_array_equal(mt, mj)
    a, b = bridge.flatten(pt2), bridge.flatten(pj2)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_reference_state_dict_has_the_published_widths():
    """At div 1 the builder's tensors have VCN's published widths
    (gengshan-y/VCN models/VCN.py, submodule.py): the PSPNet stem 16-16-32,
    blocks 64/128/128/128, outputs (128, 128, 128, 64, 64), butterfly
    projections to 16 (12 at the finest level), fusion stacks
    128-128-128-96-64-32 whose input and output widths follow the graph."""
    sd = TV.reference_state_dict(1, div=1)
    shape = {k[len("module."):]: v.shape for k, v in sd.items()}
    assert shape["pspnet.convbnrelu1_1.cbr_unit.0.weight"] == (16, 3, 3, 3)
    assert shape["pspnet.convbnrelu1_3.cbr_unit.0.weight"] == (32, 16, 3, 3)
    assert [shape[f"pspnet.res_block{b}.0.convbn2.cb_unit.0.weight"][0]
            for b in (3, 5, 6, 7)] == [64, 128, 128, 128]
    assert [shape[f"pspnet.iconv{i}.cbr_unit.0.weight"][:2] for i in (5, 4, 3, 2)] == \
        [(128, 192), (128, 192), (64, 128), (64, 64)]
    assert [shape[f"f{n}.proj.0.conv1.weight"][:2] for n in (6, 5, 4, 3, 2)] == \
        [(16, 128), (16, 128), (16, 128), (16, 64), (12, 64)]
    assert [shape[f"dc{n}_conv1.0.weight"][1] for n in (6, 5, 4, 3, 2)] == \
        [128 + 4 * 16, 128 + 4 * 32, 128 + 4 * 48, 64 + 16 * 16, 64 + 16 * 16 + 4 * 12]
    assert [shape[f"dc{n}_conv7.weight"][0] for n in (6, 5, 4, 3, 2)] == \
        [32, 64, 96, 128, 152]
    assert [shape[f"dc2_conv{i}.0.weight"][0] for i in range(1, 7)] == \
        [128, 128, 128, 96, 64, 32]
    assert shape["dc2_convo.6.weight"] == (1, 32, 3, 3)
    assert shape["f2.conva1.downsample.conv1.0.weight"] == (12, 12, 1, 1, 1)
    assert shape["f6.conva1.downsample.conv1.weight"] == (16, 16, 1, 1, 1)
    assert shape["p2.conv2.weight"] == (12, 12, 3, 3, 1)


@pytest.mark.parametrize("fac", [1, 2])
def test_corr_volume(fac):
    rng = np.random.default_rng(fac)
    ref, tgt = (rng.standard_normal((1, 6, 10, 13)).astype(np.float32) for _ in range(2))
    want = JV.corr_volume(jnp.asarray(ref), jnp.asarray(tgt), 4, fac)
    got = TV.corr_volume(_t(ref), _t(tgt), 4, fac)
    assert tuple(got.shape) == (1, 6, 9, 2 * (4 // fac) + 1, 10, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fac", [1, 2])
def test_flow_reg(fac):
    """The soft-argmax flow and entropies, with planted ties (the first
    index of the flattened (u, v) window wins in both packages)."""
    rng = np.random.default_rng(3 + fac)
    v = 2 * (4 // fac) + 1
    cost = rng.standard_normal((3, 9, v, 6, 7)).astype(np.float32) * 3
    cost[0, 1, 1, 2, 3] = cost[0, 7, v - 1, 2, 3] = cost[0, :, :, 2, 3].max() + 1
    cost[1, :, :, 0, 0] = 0.5  # a flat window
    fj, ej = JV.flow_reg(jnp.asarray(cost), 4, fac)
    ft, et = TV.flow_reg(_t(cost), 4, fac)
    assert _rel(ft, fj) < REL_TOL and _rel(et, ej) < REL_TOL


def test_warp_by_flow():
    """Clamped gathers, the strict in-range mask and zero outside, with
    flows that leave the image on every side."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 10, 12)).astype(np.float32)
    flo = (rng.standard_normal((2, 2, 10, 12)) * 4).astype(np.float32)
    flo[0, :, 0, 0] = 0.0  # on the border: outside the strict mask
    oj, mj = JV.warp_by_flow(jnp.asarray(x), jnp.asarray(flo))
    ot, mt = TV.warp_by_flow(_t(x), _t(flo))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < mt.float().mean() < 1
    assert _rel(ot, oj) < REL_TOL


@pytest.mark.parametrize("level,block,stride", [(0, "conva1", 2), (0, "convb1", 1),
                                                (4, "conva1", 2), (4, "convb2", 1)])
def test_sep_conv4d(params, level, block, stride):
    """sepConv4d (both convs, the second's (h, w) stride only when full) and
    the residual block with its downsample (projfeat4d, or a 1x1 sepConv4d
    at the finest level)."""
    _, pj, pt = params
    full = level == 4
    c = pj[f"level{level}"]["f"][block]["conv1"]["conv1"]["w"].shape[0]
    x = np.random.default_rng(level).standard_normal((1, c, 9, 9, 6, 8)).astype(np.float32)
    pjb, ptb = pj[f"level{level}"]["f"][block], pt[f"level{level}"]["f"][block]
    want = JV.sep_conv4d(jnp.asarray(x), pjb["conv1"], stride=stride, full=full)
    got = TV.sep_conv4d(_t(x), ptb["conv1"], stride=stride, full=full)
    assert _rel(got, want) < REL_TOL
    want = JV.sep_conv4d_block(jnp.asarray(x), pjb, stride=stride, full=full)
    got = TV.sep_conv4d_block(_t(x), ptb, stride=stride, full=full)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("level", [0, 4])
def test_butterfly4d(params, level):
    """The (u, v) U-net: 9 -> 5 -> 3 over (u, v) and back by resizes of
    ratios 3->5 and 5->9 (and over (h, w) at the finest level)."""
    _, pj, pt = params
    p = pj[f"level{level}"]["f"]
    c = p["proj"]["w"].shape[1]
    x = np.random.default_rng(7 + level).standard_normal((1, c, 9, 9, 7, 9)).astype(np.float32)
    want = JV.butterfly4d(jnp.asarray(x), p, full=level == 4)
    got = TV.butterfly4d(_t(x), pt[f"level{level}"]["f"], full=level == 4)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("shape,uv,hw", [((1, 3, 3, 3, 5, 6), (5, 5), (9, 11)),
                                         ((2, 2, 5, 5, 4, 4), (9, 9), (4, 7))])
def test_six_axis_resizes(shape, uv, hw):
    """_resize_uv and _resize_hw6: two axes of a 6-D tensor resized through
    F.interpolate's 3-D and 2-D modes, against jax.image.resize."""
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    assert _rel(TV._resize_uv(_t(x), uv), JV._resize_uv(jnp.asarray(x), uv)) < REL_TOL
    assert _rel(TV._resize_hw6(_t(x), hw), JV._resize_hw6(jnp.asarray(x), hw)) < REL_TOL
    with pytest.raises(ValueError, match="shrinks"):
        TV._resize_hw6(_t(x), (shape[4] - 1, shape[5]))


@pytest.mark.parametrize("hw", [(2, 3), (3, 4), (6, 10)])
def test_pyramid_pooling(params, hw):
    _, pj, pt = params
    c = pj["pspnet"]["pyramid_pooling"]["path0"]["w"].shape[1]
    x = np.random.default_rng(11).standard_normal((2, c) + hw).astype(np.float32)
    want = JV.pyramid_pooling(jnp.asarray(x), pj["pspnet"]["pyramid_pooling"])
    got = TV.pyramid_pooling(_t(x), pt["pspnet"]["pyramid_pooling"])
    assert _rel(got, want) < REL_TOL
    with pytest.raises(ValueError, match="at least 2 px"):
        TV.pyramid_pooling(_t(x[:, :, :1]), pt["pspnet"]["pyramid_pooling"])


def test_pspnet_forward(params):
    _, pj, pt = params
    im = (np.random.default_rng(12).random((2, 3, 128, 192)) - 0.33).astype(np.float32)
    want = JV.pspnet_forward(jnp.asarray(im), pj["pspnet"])
    got = TV.pspnet_forward(_t(im), pt["pspnet"])
    for g, w in zip(got, want):
        assert _rel(g, w) < REL_TOL


@pytest.fixture(scope="module")
def jax_predictor(params):
    """The JAX predictor at testres 3; its jitted graph for a 192 x 256
    input also runs the tests' direct vcn_forward calls (one compile)."""
    return JV.VCNFlowPredictor(params[1], mean=np.asarray([0.31, 0.33, 0.35], np.float32),
                               testres=3.0)


def test_vcn_forward_and_predictor(params, jax_predictor):
    """The graph on one 192 x 256 input, and the predictor on one uint8 pair
    of 60 x 80 at testres 3 (a 192 x 256 input: frames enlarged by cv2's
    8-bit resize, the flow brought back by its float resize)."""
    _, pj, pt = params
    rng = np.random.default_rng(13)
    im = (rng.random((2, 3, 192, 256)) - 0.33).astype(np.float32)
    fj, oj = jax_predictor._run((192, 256))(pj, jnp.asarray(im))
    with torch.inference_mode():
        ft, ot = TV.vcn_forward(pt, _t(im))
    assert ft.shape == (1, 2, 192, 256) and ot.shape == (1, 48, 64)
    _flow_gate(fj, ft, "vcn_forward")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-3)

    img = (rng.random((60, 90, 3)) * 255).astype(np.uint8)
    a, b = np.ascontiguousarray(img[:, 4:84]), np.ascontiguousarray(img[:, :80])
    jp = jax_predictor
    tp = TV.VCNFlowPredictor(pt, mean=jp.mean, testres=3.0)
    assert tp.input_size(60, 80) == (192, 256)
    (fj, oj), (ft, ot) = jp(a, b), tp(a, b)
    assert ft.shape == (60, 80, 3) and ot.shape == (60, 80) and tp.calls == 1
    np.testing.assert_array_equal(ft[..., 2], 1.0)
    _flow_gate(fj, ft, "predictor")
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-3)


def _double(tree):
    return {k: _double(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.double()


def test_he_scaled_weights_in_float64(jax_predictor):
    """With He-scaled weights (the builder's conv weights times sqrt(6):
    variance 2/fan_in) the fusion logits grow until fp32 rounding of the
    conv sums alone puts the two packages' flows ~1e-3 px apart, at the
    edge of the gate above. In
    float64 both graphs agree within 1e-9 px (flow) and 1e-9 (occlusion
    logits), so that gap is rounding, not a defect: each package's fp32
    flow is as far from the float64 one, and the port's is held within
    1.5x of JAX's distance. Prints the readings (pytest -s)."""
    sd = TV.reference_state_dict(0, div=DIV)
    pj = JV.convert_vcn_checkpoint({k: v * np.float32(np.sqrt(6.0)) if v.ndim >= 4 else v
                                    for k, v in sd.items()})
    pt = bridge.vcn_from_jax(pj)
    im = (np.random.default_rng(13).random((2, 3, 192, 256)) - 0.33).astype(np.float32)
    fj32 = np.asarray(jax_predictor._run((192, 256))(pj, jnp.asarray(im))[0])
    with jax.enable_x64(True):
        pj64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), pj)
        im64 = jnp.asarray(im.astype(np.float64))
        # LLVM's optimisation off: half the compile time of this one-off graph
        f64 = jax.jit(JV.vcn_forward).lower(pj64, im64).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        fj64, oj64 = (np.asarray(a) for a in f64(pj64, im64))
    with torch.inference_mode():
        ft32 = TV.vcn_forward(pt, _t(im))[0].numpy()
        ft64, ot64 = (a.numpy() for a in TV.vcn_forward(_double(pt), _t(im).double()))
    assert fj64.dtype == ft64.dtype == np.float64
    d64 = float(np.abs(fj64 - ft64).max())
    assert d64 < 1e-9 and np.abs(oj64 - ot64).max() < 1e-9, d64

    def reading(a, b):
        d = np.abs(a - b)
        return float(np.percentile(d, 99.9)), float(d.max())

    fp32_gap, jax_err, port_err = reading(fj32, ft32), reading(fj32, fj64), reading(ft32, ft64)
    print(f"He-scaled VCN at 192 x 256: fp32 JAX against the port p99.9 / max {fp32_gap}; "
          f"float64 JAX against the port max {d64:.3e}; fp32 against float64: JAX {jax_err}, "
          f"the port {port_err}")
    assert port_err[0] <= 1.5 * jax_err[0] and port_err[1] <= 1.5 * jax_err[1]
