"""The port's pose-CNN cold start against moda_tpu's: render_pose_batch,
the PoseCNN (fields/cnn.py) through bridged parameters, PoseWarmup's
optimizer steps, the pose_cnn.npz layout, Trainer.extract_cams_cnn on a
frame dataset, the trainer's warmup -> extract -> preset chain (the
round-5 camera-install regression test of tests/test_trainer.py), and the
whole chain through train_app on the CPU.

Tolerances: render_pose_batch within 1e-5 (the crops' bilinear resize);
the CNN forward within 1e-5 relative L2; two PoseWarmup steps from the same
parameters and batches within 1e-4 relative L2 of the parameters;
extract_cams_cnn's cameras within 1e-5.
"""
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.config import MoDAConfig as JConfig
from moda_tpu.data import dataset as JD
from moda_tpu.fields.cnn import PoseCNN as JPoseCNN
from moda_tpu.train import trainer as JT
from moda_tpu.train import warmup_pose as JW
from moda_tpu_torch import bridge
from moda_tpu_torch.config import DataInfo, MoDAConfig
from moda_tpu_torch.data import dataset as TD
from moda_tpu_torch.data import synthetic as TS
from moda_tpu_torch.data.synth_mesh import MeshScene
from moda_tpu_torch.fields import cnn as TC
from moda_tpu_torch.preproc.posenet import RefPoseNet
from moda_tpu_torch.train import trainer as TT
from moda_tpu_torch.train import warmup_pose as TW
from tests.test_torch_posenet import write_reference_pth

CROP = 112


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: the tests run in several processes at
    once, and torch's thread pools on every core slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _prior():
    """The MeshScene's template, unit-normalized as load_prior_mesh does."""
    s = MeshScene(img_size=32, num_frames=2)
    v = s.rest_verts - s.rest_verts.mean(0, keepdims=True)
    return (v / np.abs(v).max()).astype(np.float32), s.faces.astype(np.int32), s.vert_feats


@pytest.fixture(scope="module")
def jax_warm():
    """One JAX PoseWarmup for the file (its init and its jitted step are
    the costly part); each test sets the parameters it starts from."""
    v, f, e = _prior()
    return JW.PoseWarmup(v, f, e, d_mean=3.0, total_steps=4)


@pytest.fixture(scope="module")
def jax_cnn(jax_warm):
    """The JAX PoseCNN's initial parameters with every leaf perturbed, so
    the zero-initialized biases take part."""
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32),
        jax_warm.params)


def test_same_padding_is_flax_s():
    assert TC.same_pads(112, 7, 2) == (2, 3)
    assert TC.same_pads(56, 3, 2) == (0, 1)
    assert TC.same_pads(7, 3, 2) == (1, 1)
    assert TC.same_pads(14, 3, 1) == (1, 1)
    assert TC.same_pads(14, 1, 2) == (0, 0)
    gn = [m for m in TC.PoseCNN().modules() if isinstance(m, torch.nn.GroupNorm)]
    assert gn and all(m.eps == 1e-6 and m.num_groups == 8 for m in gn)
    assert (TC.PoseCNN().head.bias == 0).all()


def test_render_pose_batch_matches_jax():
    """The same batch from the same numpy seed: cameras equal, feature crops
    within 1e-5 (the native rasterizer is the same source; the crops'
    bilinear resize is the port's)."""
    v, f, e = _prior()
    fj, rj = JW.render_pose_batch(v, f, e, 3.0, 6, np.random.default_rng(4))
    ft, rt = TW.render_pose_batch(v, f, e, 3.0, 6, np.random.default_rng(4))
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5)
    assert np.abs(fj).sum(axis=(1, 2, 3)).min() > 0  # every crop saw the mesh


def test_pose_cnn_forward_matches_jax(jax_cnn):
    """PoseCNN on bridged parameters: the [N, 12] poses within 1e-5
    relative L2 of flax's; export gives the JAX tree back exactly."""
    net = TC.PoseCNN()
    bridge.load_params(net, jax_cnn)
    x = np.random.default_rng(1).normal(size=(2, CROP, CROP, 16)).astype(np.float32)
    want = np.asarray(JPoseCNN().apply({"params": jax_cnn}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 12)
    assert _rel(got, want) <= 1e-5
    back = bridge.flatten(bridge.export_params(net))
    ref = bridge.flatten(jax_cnn)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_pose_warmup_steps_in_lockstep(jax_warm, jax_cnn):
    """Two optimizer steps of both warmups from the same parameters on the
    same batches: the same rotation errors and, after them, parameters
    within 1e-4 relative L2 (optax.adamw with its cosine schedule against
    torch's AdamW with the same schedule)."""
    v, f, e = _prior()
    jw = jax_warm
    jw.params = jax.tree_util.tree_map(jnp.asarray, jax_cnn)
    jw.opt_state = jw.opt.init(jw.params)
    tw = TW.PoseWarmup(v, f, e, d_mean=3.0, total_steps=4, device="cpu")
    bridge.load_params(tw.net, jax_cnn)
    rng = np.random.default_rng(2)
    for _ in range(2):
        feats, rtk = TW.render_pose_batch(v, f, e, 3.0, 2, rng)
        jw.params, jw.opt_state, jrot = jw._step(jw.params, jw.opt_state, jnp.asarray(feats),
                                                 jnp.asarray(rtk))
        trot = tw.step(feats, rtk)
        assert abs(float(trot) - float(jrot)) <= 1e-5 * max(1.0, abs(float(jrot)))
    got = bridge.flatten(bridge.export_params(tw.net))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, jw.params))
    keys = sorted(want)
    assert _rel(np.concatenate([got[k].ravel() for k in keys]),
                np.concatenate([want[k].ravel() for k in keys])) <= 1e-4
    # the steps moved the parameters by far more than the tolerance
    start = bridge.flatten(jax_cnn)
    moved = _rel(np.concatenate([want[k].ravel() for k in keys]),
                 np.concatenate([start[k].ravel() for k in keys]))
    assert moved > 1e-3


def test_pose_cnn_npz_moves_between_packages(jax_warm, jax_cnn, tmp_path):
    """pose_cnn.npz written by either package loads in the other with every
    parameter equal (the forward's parity is the test above); a .pth is the
    reference's posenet and loads beside the CNN, leaving it as it was
    (tests/test_torch_posenet.py holds that net against JAX's)."""
    v, f, e = _prior()
    jw = jax_warm
    jw.params = jax.tree_util.tree_map(jnp.asarray, jax_cnn)
    jw.save(str(tmp_path / "j.npz"))
    tw = TW.PoseWarmup(v, f, e, d_mean=3.0, device="cpu")
    tw.load(str(tmp_path / "j.npz"))
    want = bridge.flatten(jax_cnn)
    got = bridge.flatten(bridge.export_params(tw.net))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.no_grad():
        for p in tw.net.parameters():
            p.mul_(0.5)
    tw.save(str(tmp_path / "t.npz"))
    jw.load(str(tmp_path / "t.npz"))
    back = bridge.flatten(jax.tree_util.tree_map(np.asarray, jw.params))
    for k in want:
        np.testing.assert_array_equal(back[k], 0.5 * want[k], err_msg=k)
    write_reference_pth(str(tmp_path / "posenet.pth"))
    tw.load(str(tmp_path / "posenet.pth"))
    assert isinstance(tw.ref_net, RefPoseNet)
    for k, v in bridge.flatten(bridge.export_params(tw.net)).items():
        np.testing.assert_array_equal(v, 0.5 * want[k], err_msg=k)


# ----------------------------------------------------- cameras from the CNN
def _frame_fixture(root, img_size=32, num_frames=5):
    cfg_dir = str(root / "cfg")
    TS.write_frame_dataset(str(root / "db"), cfg_dir, "flap",
                           MeshScene(img_size=img_size, num_frames=num_frames))
    prior = str(root / "db" / "Densepose" / "Full-Resolution" / "flap" / "prior.pkl")
    return cfg_dir, prior


def _port_trainer(tmp_path, num_frames, **kw):
    cfg = MoDAConfig(num_bones=3, img_size=16, nsample=4, ndepth=8, feat_ndepth_grid=4,
                     sample_grid3d=8, render_size=0, checkpoint_dir=str(tmp_path), logname="t",
                     **kw)
    info = DataInfo(offset=(0, num_frames), intrinsics=((32.0, 32.0, 16.0, 16.0),))
    return TT.Trainer(cfg, info, device="cpu")


def test_extract_cams_cnn_matches_jax(jax_warm, jax_cnn, tmp_path):
    """Both trainers' extract_cams_cnn over a frame dataset, from the same
    CNN parameters: the same cameras (within 1e-5) and OOD verdicts, which
    on this fixture's vertex maps accept some frames and reject others (so
    the nearest-valid substitution runs); the port writes
    init-cam/cam-%05d.txt and installs the cameras."""
    cfg_dir, prior = _frame_fixture(tmp_path)
    tr = _port_trainer(tmp_path, 5)
    tr.load_prior_mesh(prior)
    tr.pose_cnn = TW.PoseWarmup(tr.prior_verts_unit, tr.prior_faces, tr.prior_embeds, 3.0,
                                device="cpu")
    bridge.load_params(tr.pose_cnn.net, jax_cnn)
    jw = jax_warm  # predict reads only the parameters
    jw.params = jax.tree_util.tree_map(jnp.asarray, jax_cnn)
    installed = []
    jself = types.SimpleNamespace(
        pose_cnn=jw, cfg=JConfig.from_json(tr.cfg.to_json()), prior_embeds=tr.prior_embeds,
        model=types.SimpleNamespace(obj_scale=tr.model.obj_scale), data_info=tr.data_info,
        set_cameras_from_rtk_files=installed.append)
    jrtk, jvalid = JT.Trainer.extract_cams_cnn(jself, JD.build_datasets("flap", 16, cfg_dir),
                                               save=False)
    trtk, tvalid = tr.extract_cams_cnn(TD.build_datasets("flap", 16, cfg_dir))
    assert trtk.shape == (5, 4, 4)
    np.testing.assert_allclose(trtk, jrtk, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert 0 < tvalid.sum() < 5
    np.testing.assert_allclose(tr.latest_vars["rtk"], installed[0], rtol=0, atol=1e-5)
    assert tr.latest_vars["idk"].sum() == 5
    for i in range(5):
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(tr.save_dir, "init-cam", "cam-%05d.txt" % i)), trtk[i],
            rtol=1e-6, atol=1e-6)


def test_warmup_pose_installs_cnn_cameras(tmp_path, monkeypatch):
    """Regression (the JAX package's round-5 cold-start fix, ported):
    train() follows the pose warmup with extract_cams_cnn and then
    preset_rootmlp when no cameras are installed (the reference's
    warmup_pose -> extract_cams -> warmup_rootmlp chain,
    train_utils.py:871-921, 662-666); with cameras installed
    (use_rtk_file) the CNN's do not overwrite them; with no dataset that
    has a frame reader, a warning is logged (the JAX trainer skips
    silently)."""
    def run(sub, idk, eval_datasets):
        tr = _port_trainer(tmp_path / sub, 2, num_epochs=1, warmup_pose_ep=1,
                           warmup_rootmlp=True)
        tr.eval_datasets = eval_datasets
        calls = []

        def fake_warmup(self, n):
            calls.append("warmup")
            self.pose_cnn = object()

        def fake_extract(self, ds, save=True):
            calls.append("extract")
            rtk = np.tile(np.eye(4, dtype=np.float32)[None], (self.data_info.num_fr, 1, 1))
            rtk[:, 2, 3] = 3.0
            rtk[:, 3] = np.asarray(self.data_info.intrinsics[0])
            self.set_cameras_from_rtk_files(rtk)
            return rtk, np.ones(len(rtk), bool)

        monkeypatch.setattr(TT.Trainer, "warmup_pose", fake_warmup)
        monkeypatch.setattr(TT.Trainer, "extract_cams_cnn", fake_extract)
        monkeypatch.setattr(TT.Trainer, "preset_rootmlp", lambda self: calls.append("preset"))
        monkeypatch.setattr(TT.Trainer, "train_one_epoch",
                            lambda self, *a, **k: calls.append("epoch"))
        tr.latest_vars["idk"][:] = idk
        tr.train()
        return tr, calls

    reader = [types.SimpleNamespace(reader=object(), num_frames=2)]
    _, calls = run("a", 0, reader)
    assert calls[:3] == ["warmup", "extract", "preset"]
    _, calls = run("b", 1, reader)
    assert "extract" not in calls and "preset" in calls
    tr, calls = run("c", 0, None)
    assert calls[:2] == ["warmup", "epoch"]
    rows = [json.loads(line) for line in open(tr.log_path)]
    assert any("extract_cams_skipped" in r for r in rows)


def test_cold_start_through_train_app(tmp_path, monkeypatch):
    """The slice end to end on the CPU, through train_app on a frame
    dataset without line shards or camera files in use: the pose warmup
    (2 steps at batch 16, full widths), extract_cams_cnn over all frames,
    the root preset, one 2-step epoch on the frame route at small widths,
    and the eval grid with its observed-image and feature-error columns."""
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.viz.render_vis import png_size

    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    cfg_dir, prior = _frame_fixture(tmp_path, img_size=24, num_frames=4)
    tr = train_app.main(
        ["--seqname", "flap", "--config_dir", cfg_dir, "--logname", "c",
         "--checkpoint_dir", str(tmp_path / "log"), "--num_epochs", "1", "--batch_size", "2",
         "--nsample", "4", "--ndepth", "8", "--img_size", "16", "--sample_grid3d", "12",
         "--feat_ndepth_grid", "4", "--num_bones", "3", "--warmup_shape_ep", "0",
         "--warmup_pose_ep", "1", "--prior_mesh_path", prior, "--warmup_rootmlp",
         "--render_size", "8", "--chunk", "64", "--n_data_workers", "1"], device="cpu")
    rows = [json.loads(line) for line in open(tr.log_path)]
    (warm,) = [r for r in rows if "warmup_pose_rot_loss" in r]
    assert warm["warmup_pose_steps"] == 2 and np.isfinite(warm["warmup_pose_rot_loss"])
    (cams,) = [r for r in rows if "extract_cams_n" in r]
    assert cams["extract_cams_n"] == 4 and 0 <= cams["extract_cams_valid"] <= 1
    assert os.path.exists(os.path.join(tr.save_dir, "pose_cnn.npz"))
    assert sorted(os.listdir(os.path.join(tr.save_dir, "init-cam"))) == [
        "cam-%05d.txt" % i for i in range(4)]
    steps = [r for r in rows if "total_loss" in r]
    assert steps and all(np.isfinite(r["total_loss"]) for r in steps)
    assert not [r for r in rows if "eval_render_error" in r or "eval_frames_unreadable" in r]
    # 3 x 3 tiles (9 frames) of the observed image, rgb, silhouette, flow and
    # feature error
    assert png_size(os.path.join(tr.save_dir, "eval-000.png")) == (3 * 8, 3 * 8 * 5)
    with open(prior, "rb") as f:
        assert len(pickle.load(f)["embeddings"]) == len(tr.prior_embeds)


def test_cold_start_with_the_eval_grid_off(tmp_path, monkeypatch):
    """train_app with --render_size 0 (no eval grid) and the cold start:
    no eval datasets are built, so extract_cams_cnn reads the loader's frame
    datasets at img_size. (The JAX package builds eval datasets at
    render_size 0 and its extract_cams_cnn then divides by that size.)"""
    from moda_tpu_torch.cli import train_app

    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    cfg_dir, prior = _frame_fixture(tmp_path, img_size=24, num_frames=4)
    tr = train_app.main(
        ["--seqname", "flap", "--config_dir", cfg_dir, "--logname", "c",
         "--checkpoint_dir", str(tmp_path / "log"), "--num_epochs", "1", "--batch_size", "2",
         "--nsample", "4", "--ndepth", "8", "--img_size", "16", "--sample_grid3d", "12",
         "--feat_ndepth_grid", "4", "--num_bones", "3", "--warmup_shape_ep", "0",
         "--warmup_pose_ep", "1", "--prior_mesh_path", prior, "--render_size", "0",
         "--chunk", "64", "--n_data_workers", "1"], device="cpu")
    assert tr.eval_datasets is None
    rows = [json.loads(line) for line in open(tr.log_path)]
    (cams,) = [r for r in rows if "extract_cams_n" in r]
    assert cams["extract_cams_n"] == 4
    assert sorted(os.listdir(os.path.join(tr.save_dir, "init-cam"))) == [
        "cam-%05d.txt" % i for i in range(4)]
    assert tr.latest_vars["idk"].sum() == 4
    steps = [r for r in rows if "total_loss" in r]
    assert steps and all(np.isfinite(r["total_loss"]) for r in steps)
    assert not os.path.exists(os.path.join(tr.save_dir, "eval-000.png"))
