"""moda_tpu_torch.fields against the flax modules of moda_tpu.fields: the
same flax-initialized parameters (through moda_tpu_torch.bridge) and the
same inputs, values and gradients in fp32 (atol/rtol 1e-5; 1e-4 on the
deep heads' gradients, whose sums run over 8 layers of width 256).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.fields import nets as JN
from moda_tpu_torch import bridge
from moda_tpu_torch.fields import nets as TN
from tests.torch_parity import both_models

OFFSET = (0, 5, 12)


def _modules():
    """name -> (flax module, torch module, input maker, atol)."""
    rng = np.random.default_rng(3)
    fid = lambda: np.asarray([0, 3, 5, 11, 7], np.int32)  # noqa: E731
    return {
        "nerf_rgb": (JN.NeRFMLP(D=8, W=64, in_channels_xyz=63, in_channels_dir=27,
                                out_channels=3),
                     TN.NeRFMLP(D=8, W=64, in_channels_xyz=63, in_channels_dir=27,
                                out_channels=3),
                     lambda: rng.normal(size=(7, 90)).astype(np.float32), 1e-5),
        "nerf_raw": (JN.NeRFMLP(D=5, W=32, in_channels_xyz=63, in_channels_dir=0,
                                out_channels=16, raw_feat=True),
                     TN.NeRFMLP(D=5, W=32, in_channels_xyz=63, in_channels_dir=0,
                                out_channels=16, raw_feat=True),
                     lambda: rng.normal(size=(7, 63)).astype(np.float32), 1e-5),
        "dq_head": (JN.DQRTHead(num_bodies=4, in_channels=16),
                    TN.DQRTHead(num_bodies=4, in_channels=16),
                    lambda: rng.normal(size=(5, 16)).astype(np.float32), 1e-4),
        "rt_head": (JN.RTHead(num_bodies=3, use_quat=False, in_channels=16),
                    TN.RTHead(num_bodies=3, use_quat=False, in_channels=16),
                    lambda: rng.normal(size=(5, 16)).astype(np.float32), 1e-4),
        "frame_code": (JN.FrameCode(num_freq=10, embedding_dim=8, vid_offset=OFFSET),
                       TN.FrameCode(num_freq=10, embedding_dim=8, vid_offset=OFFSET),
                       fid, 1e-5),
        "rt_exp_mlp": (JN.RTExpMLP(max_t=12, t_embed_dim=16, vid_offset=OFFSET),
                       TN.RTExpMLP(max_t=12, t_embed_dim=16, vid_offset=OFFSET),
                       fid, 1e-4),
        "rt_exp_mlp_delta": (JN.RTExpMLP(max_t=12, t_embed_dim=16, vid_offset=OFFSET, delta=True),
                             TN.RTExpMLP(max_t=12, t_embed_dim=16, vid_offset=OFFSET,
                                         delta=True), fid, 1e-4),
        "embed_code": (JN.EmbedCode(num=12, dim=8), TN.EmbedCode(num=12, dim=8), fid, 1e-5),
    }


@pytest.mark.parametrize("name", sorted(_modules()))
def test_module_matches_flax(name):
    fmod, tmod, make, atol = _modules()[name]
    x = make()
    params = fmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    if name.startswith("rt_exp_mlp"):
        # move the base table off identity so its 10x gradient path shows
        params = jax.tree_util.tree_map(lambda v: v, params)
        params["base_rt"]["se3"] = params["base_rt"]["se3"] + 0.05 * jax.random.normal(
            jax.random.key(1), params["base_rt"]["se3"].shape)
    # the checkpoint layout ("/"-joined keys) loads, and export gives back
    # the JAX tree leaf for leaf
    bridge.load_params(tmod, bridge.flatten(params))
    exported = bridge.flatten(bridge.export_params(tmod))
    for k, v in bridge.flatten(params).items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    jout = fmod.apply({"params": params}, jnp.asarray(x))
    tx = torch.tensor(x) if x.dtype.kind == "f" else torch.tensor(x).long()
    tout = tmod(tx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=atol, rtol=1e-5)
    cot = np.random.default_rng(5).normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(lambda p: (fmod.apply({"params": p}, jnp.asarray(x)) * cot).sum())(params)
    names = [n for n, _ in tmod.named_parameters()]
    tg = torch.autograd.grad((tout * torch.tensor(cot)).sum(), list(tmod.parameters()),
                             allow_unused=True)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jflat) == {n.replace(".", "/") for n in names}
    for n, g in zip(names, tg):
        ref = jflat[n.replace(".", "/")]
        got = np.zeros_like(ref) if g is None else g.numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got / scale, ref / scale, atol=atol, err_msg=n)


def test_nerf_sigma_only_matches_flax():
    fmod = JN.NeRFMLP(D=8, W=64, in_channels_xyz=63, in_channels_dir=27, out_channels=3)
    tmod = TN.NeRFMLP(D=8, W=64, in_channels_xyz=63, in_channels_dir=27, out_channels=3)
    x = np.random.default_rng(4).normal(size=(9, 63)).astype(np.float32)
    params = fmod.init(jax.random.key(2), jnp.zeros((1, 90)))["params"]
    bridge.load_params(tmod, params)
    ref = fmod.apply({"params": params}, jnp.asarray(x), sigma_only=True)
    got = tmod(torch.tensor(x), sigma_only=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_initializers_match_flax_distributions():
    """lecun-normal kernels (truncated at 2 std, variance 1/fan_in), zero
    biases, N(0, 1) embedding tables."""
    m = TN.NeRFMLP(D=2, W=256, in_channels_xyz=256, in_channels_dir=0, out_channels=4)
    TN.reset_denses(m, torch.Generator().manual_seed(0))
    k = m.xyz_2.kernel.detach()
    std = 1.0 / np.sqrt(256)
    assert abs(float(k.std()) - std) / std < 0.03
    assert float(k.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert float(m.xyz_2.bias.abs().max()) == 0.0
    e = TN.EmbedCode(num=64, dim=256)
    e.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(e.weight.std()) - 1.0) < 0.03


def test_compute_rts_matches_jax():
    cfg, model, params, mvars, tmodel = both_models()
    ref = model.compute_rts(params)
    got = tmodel.compute_rts()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    fid = jnp.asarray([0, 1, 4])
    np.testing.assert_allclose(tmodel.body_rts(torch.tensor([0, 1, 4])).detach().numpy(),
                               np.asarray(model.body_rts(params, fid)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tmodel.body_rts_rest().detach().numpy(),
                               np.asarray(model.body_rts_rest(params)), atol=1e-5, rtol=1e-5)
