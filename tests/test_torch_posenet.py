"""The port's pretrained posenet (moda_tpu_torch/preproc/posenet.py, the
FrozenBN part of fields/resnet_fpn.py, the .pth route of
train/warmup_pose.py) against moda_tpu's on the CPU.

One random reference-layout checkpoint (tests/test_posenet.py's torch
Sequential(Encoder, RTHead), random weights and running statistics, saved
as a ``.pth`` under the ``module.nerf_root_rts.`` prefix) feeds both
packages. The port's net is built two ways, from the ``.pth`` and through
``bridge.posenet_from_jax`` from the JAX converter's Flax parameters; the
two hold bit-equal parameters and give bit-equal outputs. Against the JAX
net (XLA convolutions at HIGHEST precision) outputs and predicted cameras
agree within 1e-4 relative to the largest value (they read 1.8e-7 and
3.0e-7: fp32 convolutions summed in another order).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from moda_tpu.config import MoDAConfig as JConfig
from moda_tpu.data import dataset as JD
from moda_tpu.fields.resnet_fpn import _fold_bn as j_fold_bn
from moda_tpu.preproc import posenet as JP
from moda_tpu.train import trainer as JT
from moda_tpu.train.warmup_pose import PoseWarmup as JPoseWarmup
from moda_tpu_torch import bridge
from moda_tpu_torch.config import DataInfo, MoDAConfig
from moda_tpu_torch.data import dataset as TD
from moda_tpu_torch.data import synthetic as TS
from moda_tpu_torch.data.synth_mesh import MeshScene
from moda_tpu_torch.fields.resnet_fpn import FrozenBN, _fold_bn
from moda_tpu_torch.preproc import posenet as TP
from moda_tpu_torch.train.trainer import Trainer
from moda_tpu_torch.train.warmup_pose import PoseWarmup
from tests.test_posenet import Encoder, RTHead

REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_state_dict(seed: int = 0) -> dict:
    """A reference-layout posenet state dict (torch tensors) with seeded
    random weights and running statistics, as tests/test_posenet.py builds
    it."""
    g = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(Encoder(), RTHead())
    with torch.no_grad():
        for k, v in list(net.named_parameters()) + list(net.named_buffers()):
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) * 0.5 + 0.75)
            elif not k.endswith("num_batches_tracked"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    return {"module.nerf_root_rts." + k: v for k, v in net.state_dict().items()}


def write_reference_pth(path: str, seed: int = 0) -> dict:
    sd = reference_state_dict(seed)
    torch.save(sd, path)
    return sd


def _rel_max(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(.pth path, the JAX converter's Flax parameters)."""
    path = str(tmp_path_factory.mktemp("posenet") / "posenet.pth")
    sd = write_reference_pth(path)
    return path, JP.convert_posenet_checkpoint({k: v.numpy() for k, v in sd.items()})


def test_fold_bn_and_frozen_bn_match_jax():
    rng = np.random.default_rng(0)
    sd = {"a.weight": rng.normal(size=5).astype(np.float32),
          "a.bias": rng.normal(size=5).astype(np.float32),
          "a.running_mean": rng.normal(size=5).astype(np.float32),
          "a.running_var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    for d in (sd, {k: v for k, v in sd.items() if "running" not in k}):
        for a, b in zip(_fold_bn(d, "a"), j_fold_bn(d, "a")):
            np.testing.assert_array_equal(a, b)
    bn = FrozenBN(5)
    s, b = _fold_bn(sd, "a")
    bn.scale.data, bn.bias.data = torch.from_numpy(s), torch.from_numpy(b)
    x = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(bn(torch.from_numpy(x)).numpy(),
                                  x * s[:, None, None] + b[:, None, None])
    assert not any(p.requires_grad for p in bn.parameters())


def test_ref_posenet_matches_jax_through_pth_and_bridge(ckpt):
    path, jparams = ckpt
    net_pth = TP.load_posenet(path)
    net_bridge = bridge.posenet_from_jax(jparams)
    for (n, a), (_, b) in zip(net_pth.named_parameters(), net_bridge.named_parameters()):
        assert torch.equal(a, b), n
    x = np.random.default_rng(3).normal(size=(2, 16, 112, 112)).astype(np.float32)
    want = np.asarray(JP.RefPoseNet().apply({"params": jparams},
                                            jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    with torch.no_grad():
        got = net_pth(torch.from_numpy(x)).numpy()
        assert torch.equal(net_bridge(torch.from_numpy(x)), torch.from_numpy(got))
    assert got.shape == (2, 12)
    assert _rel_max(got, want) <= REL_TOL, _rel_max(got, want)


def test_predict_rtk_matches_jax(ckpt):
    path, jparams = ckpt
    feats = np.random.default_rng(4).normal(size=(3, 112, 112, 16)).astype(np.float32)
    want = JP.predict_rtk(jparams, feats)
    got = TP.predict_rtk(TP.load_posenet(path), feats)
    assert _rel_max(got, want) <= REL_TOL, _rel_max(got, want)
    np.testing.assert_array_equal(got[:, 3], [[0, 0, 0, 1]] * 3)
    for R in got[:, :3, :3]:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


@pytest.fixture(scope="module")
def jax_warm(ckpt):
    """The JAX package's PoseWarmup with the .pth loaded (its init compiles
    once a module)."""
    jw = JPoseWarmup(np.zeros((4, 3), np.float32), np.zeros((0, 3), np.int32),
                     np.zeros((4, 16), np.float32), d_mean=1.0)
    jw.load(ckpt[0])
    return jw


def test_pose_warmup_loads_the_pth(ckpt, jax_warm):
    """PoseWarmup.load('*.pth') takes the pretrained posenet; its predict is
    predict_rtk's (the full rotation and translation), and the JAX
    warmup's within the tolerance."""
    path, _ = ckpt
    w = PoseWarmup(np.zeros((4, 3), np.float32), np.zeros((0, 3), np.int32),
                   np.zeros((4, 16), np.float32), d_mean=1.0, device="cpu")
    w.load(path)
    assert w.ref_net is not None
    feats = np.random.default_rng(5).normal(size=(2, 112, 112, 16)).astype(np.float32)
    got = w.predict(feats)
    np.testing.assert_array_equal(got, TP.predict_rtk(TP.load_posenet(path), feats))
    assert _rel_max(got, jax_warm.predict(feats)) <= REL_TOL


def test_trainer_cold_start_takes_the_pth(ckpt, jax_warm, tmp_path):
    """--pose_cnn_path <.pth>: the trainer's cold start loads the posenet
    (no warmup training: no rotation-loss log line, no pose_cnn.npz) and
    installs extract_cams_cnn's cameras over a 4-frame MeshScene (its
    template as the prior, so the OOD filter runs); they are
    the JAX trainer's from the same posenet within 1e-4 relative."""
    path, _ = ckpt
    cfg_dir = str(tmp_path / "cfg")
    TS.write_frame_dataset(str(tmp_path / "db"), cfg_dir, "flap",
                           MeshScene(img_size=32, num_frames=4))
    cfg = MoDAConfig(num_bones=3, img_size=16, nsample=4, ndepth=8, feat_ndepth_grid=4,
                     render_size=0, checkpoint_dir=str(tmp_path), logname="t",
                     warmup_pose_ep=1, pose_cnn_path=path)
    info = DataInfo(offset=(0, 4), intrinsics=((32.0, 32.0, 16.0, 16.0),))
    tr = Trainer(cfg, info, device="cpu")
    tr.load_prior_mesh(str(tmp_path / "db" / "Densepose" / "Full-Resolution" / "flap" /
                           "prior.pkl"))
    tr.eval_datasets = TD.build_datasets("flap", 16, cfg_dir)
    tr.cold_start()
    assert tr.pose_cnn.ref_net is not None
    assert not os.path.exists(os.path.join(tr.save_dir, "pose_cnn.npz"))
    rows = [json.loads(line) for line in open(tr.log_path)]
    assert not any("warmup_pose_rot_loss" in r for r in rows)
    assert [r["extract_cams_n"] for r in rows if "extract_cams_n" in r] == [4]
    assert tr.latest_vars["idk"].sum() == 4 and np.isfinite(tr.latest_vars["rtk"]).all()

    installed = []
    jself = types.SimpleNamespace(
        pose_cnn=jax_warm, cfg=JConfig.from_json(cfg.to_json()), prior_embeds=tr.prior_embeds,
        model=types.SimpleNamespace(obj_scale=tr.model.obj_scale), data_info=info,
        set_cameras_from_rtk_files=installed.append)
    JT.Trainer.extract_cams_cnn(jself, JD.build_datasets("flap", 16, cfg_dir), save=False)
    assert _rel_max(tr.latest_vars["rtk"], installed[0]) <= REL_TOL


def test_chip_smoke_checkpoint_has_the_reference_layout():
    """chip_smoke.py builds its posenet .pth without the test's torch copy of
    the reference net: the same keys, shapes and dtypes, and it converts."""
    import chip_smoke

    sd = chip_smoke.posenet_state_dict(0)
    ref = reference_state_dict(0)
    assert sd.keys() == ref.keys()
    for k in ref:
        assert sd[k].shape == ref[k].shape and sd[k].dtype == ref[k].dtype, k
    net = TP.RefPoseNet()
    net.load_state_dict(TP.convert_posenet_checkpoint(sd))
