"""The port's ResNet-50 + FPN backbone (moda_tpu_torch/fields/resnet_fpn.py,
bridge.resnet_fpn_from_jax) against moda_tpu's on the CPU.

The detectron2-layout weights are tests/test_cse_infer.py's
``make_backbone_sd``; both packages' converters must give bit-equal trees,
and the JAX ResNetFPN (XLA at HIGHEST precision) and the port's, on that
tree, p2-p5 within atol 2e-3 / rtol 1e-3 (test_cse_infer.py's gate of JAX
against torch) on a square input and on an odd one, where the FPN's
repeat-and-crop upsampling meets sizes that are not doublings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.fields import resnet_fpn as JR
from moda_tpu_torch import bridge
from moda_tpu_torch.fields import resnet_fpn as TR
from moda_tpu_torch.preproc.checkpoints import flatten_tree
from tests.test_cse_infer import make_backbone_sd


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def backbone():
    sd = make_backbone_sd()
    jtree = JR.convert_resnet50_fpn(sd)
    fwd = jax.jit(lambda x: JR.ResNetFPN().apply({"params": jtree}, x))
    return sd, jtree, fwd, bridge.resnet_fpn_from_jax(TR.convert_resnet50_fpn(sd))


def assert_trees_bit_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_converter_tree_is_the_jax_packages(backbone):
    sd, jtree, _, _ = backbone
    assert_trees_bit_equal(TR.convert_resnet50_fpn(sd), jtree)
    seeded = TR.reference_backbone_sd(np.random.default_rng(0))
    assert_trees_bit_equal(TR.convert_resnet50_fpn(seeded), JR.convert_resnet50_fpn(seeded))
    del seeded["backbone.fpn_output3.bias"]
    with pytest.raises(KeyError, match="fpn_output3.bias"):
        TR.convert_resnet50_fpn(seeded)


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_backbone_matches_the_jax_packages(backbone, hw):
    """72 x 88 gives levels of 18 x 22, 9 x 11, 5 x 6 and 3 x 3."""
    _, _, jfwd, net = backbone
    img = np.random.default_rng(hw[1]).random((1, 3) + hw).astype(np.float32)
    want = jfwd(jnp.asarray(img.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = net(torch.from_numpy(img))
    for lvl in (2, 3, 4, 5):
        w = np.asarray(want[f"p{lvl}"])
        g = got[f"p{lvl}"].numpy().transpose(0, 2, 3, 1)
        assert g.shape == w.shape == (1, -(-hw[0] // 2 ** lvl), -(-hw[1] // 2 ** lvl), 256)
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3, err_msg=f"p{lvl}")


@pytest.mark.parametrize("small, large", [((4, 4), (6, 7)), ((3, 3), (5, 6)), ((2, 5), (4, 9))])
def test_top_down_upsampling_is_repeat_and_crop(small, large):
    """The JAX FPN's jnp.repeat x2 then a crop (resnet_fpn.py:116-117), not
    nearest interpolation to the size (for 4 -> 6 that picks rows 0,0,1,2,2,3
    where repeat-and-crop picks 0,0,1,1,2,2)."""
    x = np.arange(np.prod(small), dtype=np.float32).reshape((1, 1) + small)
    want = np.repeat(np.repeat(x, 2, axis=2), 2, axis=3)[:, :, :large[0], :large[1]]
    got = TR._up2(torch.from_numpy(x), torch.zeros((1, 1) + large)).numpy()
    np.testing.assert_array_equal(got, want)
    if small == (4, 4):
        near = torch.nn.functional.interpolate(torch.from_numpy(x), size=large).numpy()
        assert not np.array_equal(near, want)


def test_seeded_weights_keep_the_levels_in_range():
    """reference_backbone_sd's stem BatchNorm holds the pixels' variance, so
    on a mean-subtracted random frame every level reads a few units."""
    net = bridge.resnet_fpn_from_jax(
        TR.convert_resnet50_fpn(TR.reference_backbone_sd(np.random.default_rng(0))))
    img = np.random.default_rng(1).random((1, 3, 64, 64)).astype(np.float32) * 255 - 116
    with torch.no_grad():
        out = net(torch.from_numpy(img))
    rms = [float(out[f"p{lvl}"].pow(2).mean().sqrt()) for lvl in (2, 3, 4, 5)]
    assert all(0.5 < r < 50 for r in rms), rms
