"""The port's trainer and its host pieces against moda_tpu's:

- the schedule functions over a grid of progress and epochs at the three
  stage configurations of scripts/template.sh (equal);
- checkpoints written by either package load in the other (leaves
  bit-equal), and merge_params' surgery under frame/bone-count mismatch;
- get_near_far, sample_mesh_points, reset_nf, reset_hparams' decisions,
  the per-step scalars and _consume_step_outputs, rollback included, on
  the same numpy inputs (equal);
- warmup_shape for 3 steps and reinit_bones with the same draws (relative
  L2 <= 1e-5, untouched leaves bit-equal);
- a step's aux keeps the parameter values its loss saw;
- the port's train_app on the CPU for two short epochs, and for one with
  the eval grid (render_size > 0) at the JAX trainer's epochs;
- a two-epoch run of both trainers in lockstep with the draws passed in
  (slow): the state the port's trainer brings to each step against
  JAX's, each step's losses, and the same decisions (its docstring gives
  the readings, of the sound trainer and of planted faults, that set the
  bounds).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.config import DataInfo, MoDAConfig
from moda_tpu.extract.mesh import Mesh as JMesh
from moda_tpu.train import ckpt as JCK
from moda_tpu.train import schedule as JSCH
from moda_tpu.train import trainer as JT
from moda_tpu_torch import bridge
from moda_tpu_torch.config import DataInfo as TDataInfo
from moda_tpu_torch.config import MoDAConfig as TMoDAConfig
from moda_tpu_torch.extract.mesh import Mesh as TMesh
from moda_tpu_torch.train import ckpt as TCK
from moda_tpu_torch.train import schedule as TSCH
from moda_tpu_torch.train import trainer as TT
from tests.torch_parity import INIT_KW, JaxTrainerDraws

# the stage flags of scripts/template.sh (init, ft1, ft2)
STAGES = {
    "init": dict(warmup_shape_ep=5, warmup_rootmlp=True, eikonal_wt=0.001, nsample=4),
    "ft1": dict(model_path="x", warmup_steps=0.0, nf_reset=1.0, bound_reset=1.0,
                dskin_steps=0.0, fine_steps=1.0, anneal_freq=False, freeze_proj=True,
                proj_end=1.0),
    "ft2": dict(model_path="x", warmup_steps=0.0, nf_reset=0.0, bound_reset=0.0,
                dskin_steps=0.0, fine_steps=0.0, anneal_freq=False, freeze_root=True,
                use_unc=True, img_wt=1.0, reset_beta=True, eikonal_wt=0.1),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_schedule_matches_jax(stage):
    for extra in ({}, {"anneal_freq": True}, {"freeze_cvf": True, "freeze_shape": True}):
        jc = MoDAConfig(num_epochs=120, **dict(STAGES[stage], **extra))
        tc = TMoDAConfig.from_json(jc.to_json())
        for progress in np.linspace(0.0, 1.0, 23):
            for step in (0, 1, 50):
                for counter in (-0.5, 0.0, 0.01):
                    for ft in (False, True):
                        a = JSCH.compute_indicators(jc, float(progress), step, counter, ft)
                        b = TSCH.compute_indicators(tc, float(progress), step, counter, ft)
                        assert vars(a) == vars(b)
            assert JSCH.use_fine_samples(jc, progress) == TSCH.use_fine_samples(tc, progress)
            assert JSCH.embedding_alpha(jc, progress) == TSCH.embedding_alpha(tc, progress)
        for epoch in range(0, 121, 7):
            assert JSCH.use_dskin(jc, epoch, 120) == TSCH.use_dskin(tc, epoch, 120)
            for ft in (False, True):
                assert JSCH.use_bones(jc, epoch, ft) == TSCH.use_bones(tc, epoch, ft)


def test_ckpt_crosses_packages_and_surgery(tmp_path):
    rng = np.random.default_rng(0)
    params = {"nerf_coarse": {"a": rng.normal(size=(3, 4)).astype(np.float32),
                              "b": {"c": rng.normal(size=2).astype(np.float32)}},
              "bones": rng.normal(size=(4, 10)).astype(np.float32),
              "ks_param": rng.normal(size=(1, 4)).astype(np.float32)}
    lv = {"rtk": rng.normal(size=(5, 4, 4)).astype(np.float32), "idk": np.ones(5, np.float32)}
    mv = {"near_far": rng.normal(size=(5, 2)).astype(np.float32)}
    meta = {"num_fr": 5, "num_bones": 4}
    JCK.save_checkpoint(str(tmp_path / "j"), jax.tree_util.tree_map(jnp.asarray, params), lv,
                        mv, meta=meta)
    TCK.save_checkpoint(str(tmp_path / "t"), params, lv, mv, meta=meta)
    TCK.copy_checkpoint(str(tmp_path / "t"), str(tmp_path / "t2"))
    for src in ("j", "t2"):  # each package's file in the port's loader
        p2, lv2, mv2, meta2 = TCK.load_checkpoint(str(tmp_path / src))
        for k, v in bridge.flatten(params).items():
            np.testing.assert_array_equal(bridge.flatten(p2)[k], v)
        np.testing.assert_array_equal(lv2["rtk"], lv["rtk"])
        np.testing.assert_array_equal(mv2["near_far"], mv["near_far"])
        assert meta2 == meta
    pj, lvj, _, _ = JCK.load_checkpoint(str(tmp_path / "t"))  # the port's file in JAX's
    for k, v in bridge.flatten(params).items():
        np.testing.assert_array_equal(np.asarray(bridge.flatten(pj)[k]), v)
    np.testing.assert_array_equal(lvj["idk"], lv["idk"])

    # surgery, mirroring tests/test_trainer.py::test_ckpt_roundtrip_and_surgery
    init = {"nerf_coarse": {"a": np.zeros((3, 4), np.float32), "b": {"c": np.ones(2)}},
            "bones": np.zeros((4, 10), np.float32), "ks_param": np.zeros((2, 4), np.float32)}
    loaded = TCK.load_checkpoint(str(tmp_path / "j"))[0]
    jinit = jax.tree_util.tree_map(jnp.asarray, init)
    jloaded = JCK.load_checkpoint(str(tmp_path / "j"))[0]
    for fr, bo in ((False, True), (True, False), (True, True), (False, False)):
        mt = bridge.flatten(TCK.merge_params(init, loaded, fr, bo))
        mj = bridge.flatten(jax.tree_util.tree_map(np.asarray,
                                                   JCK.merge_params(jinit, jloaded, fr, bo)))
        assert mt.keys() == mj.keys()
        for k in mj:
            np.testing.assert_array_equal(mt[k], mj[k], err_msg=f"{k} {fr} {bo}")
    merged = TCK.merge_params(init, loaded, num_fr_match=False, num_bones_match=True)
    np.testing.assert_array_equal(merged["nerf_coarse"]["a"], params["nerf_coarse"]["a"])
    np.testing.assert_array_equal(merged["ks_param"], 0.0)  # shape mismatch and video key
    np.testing.assert_array_equal(merged["bones"], params["bones"])
    merged = TCK.merge_params(init, loaded, num_fr_match=True, num_bones_match=False)
    np.testing.assert_array_equal(merged["bones"], 0.0)


def test_near_far_and_surface_samples_match_jax():
    rng = np.random.default_rng(1)
    nf = np.tile(np.asarray([[0.0, 6.0]], np.float32), (5, 1))
    rtk = np.tile(np.eye(4, dtype=np.float32)[None], (5, 1, 1))
    rtk[:, :3, :3] = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    rtk[:, 2, 3] = rng.uniform(2, 5, size=5)
    idk = np.asarray([1, 0, 1, 1, 0], np.float32)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 0.3
    np.testing.assert_array_equal(TT.get_near_far(nf, rtk, idk, pts),
                                  JT.get_near_far(nf, rtk, idk, pts))
    np.testing.assert_array_equal(TT.get_near_far(nf, rtk, idk * 0, pts), nf)
    np.testing.assert_array_equal(TT._box_corners(np.asarray([[-1, -2, -3], [1, 2, 3.0]])),
                                  JT._box_corners(np.asarray([[-1, -2, -3], [1, 2, 3.0]])))
    from moda_tpu_torch.viz.render_vis import unit_sphere
    v, f = unit_sphere(1)
    a = TT.sample_mesh_points(TMesh(vertices=v, faces=f), 300, np.random.default_rng(2))
    b = JT.sample_mesh_points(JMesh(vertices=v, faces=f), 300, np.random.default_rng(2))
    np.testing.assert_array_equal(a, b)
    assert (TT.sample_mesh_points(TMesh(), 7, np.random.default_rng(0)) == 0).all()


def _trainers(tmp_path, draws=False, loader=None, **kw):
    """A JAX Trainer and a port Trainer (CPU) with the JAX one's parameters
    and model state, the same GT-like cameras installed in both."""
    cfg_kw = dict(INIT_KW, checkpoint_dir=str(tmp_path), logname="x", num_epochs=10,
                  render_size=0, sample_grid3d=16)
    cfg_kw.update(kw)
    jcfg = MoDAConfig(**cfg_kw)
    info = DataInfo(offset=(0, 6), intrinsics=((20.0, 20.0, 8.0, 8.0),))
    jtr = JT.Trainer(jcfg, info, loader=loader, save_dir=str(tmp_path / "jax"))
    ttr = TT.Trainer(TMoDAConfig.from_json(jcfg.to_json()),
                     TDataInfo(offset=info.offset, intrinsics=info.intrinsics),
                     loader=loader, save_dir=str(tmp_path / "port"), device="cpu",
                     draws=JaxTrainerDraws(jcfg) if draws else None)
    bridge.load_params(ttr.model, jtr.params)
    bridge.load_mvars(ttr.model, jtr.mvars)
    ttr.mvars_host = {k: np.asarray(getattr(jtr.mvars, k)).copy() for k in TT.MVAR_FIELDS}
    rtk = np.tile(np.eye(4, dtype=np.float32)[None], (6, 1, 1))
    ang = np.linspace(0, 1.5, 6)
    rtk[:, 0, 0], rtk[:, 0, 2], rtk[:, 2, 0], rtk[:, 2, 2] = (np.cos(ang), np.sin(ang),
                                                              -np.sin(ang), np.cos(ang))
    rtk[:, 2, 3] = 0.3
    rtk[:, 3] = (20.0, 20.0, 8.0, 8.0)
    for tr in (jtr, ttr):
        tr.set_cameras_from_rtk_files(rtk.copy())
    return jtr, ttr


def _same_latest_vars(jtr, ttr):
    assert jtr.latest_vars.keys() == ttr.latest_vars.keys()
    for k, v in jtr.latest_vars.items():
        np.testing.assert_array_equal(ttr.latest_vars[k], v, err_msg=k)


def _same_mvars(jtr, ttr):
    for k in TT.MVAR_FIELDS:
        np.testing.assert_array_equal(getattr(ttr.model.mvars, k).numpy(),
                                      np.asarray(getattr(jtr.mvars, k)), err_msg=k)
        np.testing.assert_array_equal(ttr.mvars_host[k], np.asarray(getattr(jtr.mvars, k)))


def _logs(tr):
    if not os.path.exists(tr.log_path):
        return []
    return [json.loads(line) for line in open(tr.log_path)]


def test_trainer_host_decisions_match_jax(tmp_path):
    """reset_nf, reset_hparams over a run of epochs and mesh states, the
    per-step scalars, and _consume_step_outputs (sil history, dead-density
    counter, rollback from 'latest') on the same numpy inputs."""
    jtr, ttr = _trainers(tmp_path)
    jtr.optimizer = jtr.make_optimizer()
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    ttr.optimizer = ttr.make_optimizer()
    ttr._reset_opt_state()
    jtr.reset_nf()
    ttr.reset_nf()
    _same_mvars(jtr, ttr)
    _same_latest_vars(jtr, ttr)

    calls = {"jax": [], "port": []}
    jtr.reinit_bones = lambda: calls["jax"].append(jtr._ep)
    ttr.reinit_bones = lambda: calls["port"].append(ttr._ep)
    verts = np.random.default_rng(3).normal(size=(200, 3)).astype(np.float32) * 0.1
    meshes = [(0, 0.0), (200, 0.10), (200, 0.04), (50, 0.2), (200, 0.2), (200, 0.15)]
    for epoch in range(10):
        nv, frac = meshes[epoch % len(meshes)]
        for tr, M in ((jtr, JMesh), (ttr, TMesh)):
            tr._ep = epoch
            tr.mesh_rest = M(vertices=verts[:nv] * (1 + epoch))
            tr.mesh_rest.frac_occupied = frac
            tr.latest_vars["sil_err"][:] = np.linspace(0, 1, 6) * epoch
            tr.reset_hparams(epoch)
        assert jtr._root_freeze_epoch == ttr._root_freeze_epoch
        assert jtr.counter_frz_rebone == ttr.counter_frz_rebone
        _same_latest_vars(jtr, ttr)
        _same_mvars(jtr, ttr)
        for progress, step in ((0.1, 0), (0.1, 1), (0.7, 3)):
            a, b = jtr._extras_scalars(progress, step), ttr._extras_scalars(progress, step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == b[k] and a[k].dtype == b[k].dtype, k
    assert calls["jax"] == calls["port"] == [0, 2, 6]

    # deferred step outputs, rollback included: both save 'latest' first
    jtr.save("latest")
    ttr.save("latest")
    saved = bridge.flatten(jax.tree_util.tree_map(np.asarray, jtr.params))
    for tr in (jtr, ttr):
        tr.total_steps_done = 300
    rng = np.random.default_rng(4)
    for i in range(6):
        fid = rng.integers(0, 6, size=4)
        host_out = {"rtk": rng.normal(size=(4, 4, 4)).astype(np.float32),
                    "frame_err": rng.uniform(size=6).astype(np.float32),
                    "frame_cnt": (rng.uniform(size=6) > 0.5).astype(np.float32)}
        aux = {"total_loss": np.float32(rng.uniform()), "nerf_coarse_g": np.float32(i % 3),
               "shape_frozen": np.float32(0.0), "root_step_rejected": np.float32(i % 2),
               "nerf_root_rts_g": np.float32(500.0 if i == 4 else 1.0)}
        with torch.no_grad():  # parameters move between the save and the rollback
            for p in ttr.model.parameters():
                p.add_(1.0)
        for tr in (jtr, ttr):
            tr.total_steps_done += 1
            tr._consume_step_outputs(fid, aux, host_out, epoch=1, step_in_epoch=50 * (i % 2))
        _same_latest_vars(jtr, ttr)
        assert jtr._root_rejected_ep == ttr._root_rejected_ep
        assert jtr._dead_density_steps == ttr._dead_density_steps
    assert _logs(jtr) == _logs(ttr)
    assert jtr._last_rollback == ttr._last_rollback == 305
    for n, p in ttr.model.named_parameters():  # rolled back, then moved once more
        np.testing.assert_array_equal(p.detach().numpy(), saved[n.replace(".", "/")] + 1.0,
                                      err_msg=n)


def test_fetch_outputs_packed_roundtrip():
    aux = {"a": torch.tensor(1.5), "b": torch.tensor(2, dtype=torch.int32)}
    host = {"rtk": torch.arange(32, dtype=torch.float32).reshape(2, 4, 4),
            "fe": torch.tensor([0.1, 0.2, 0.0])}
    a2, h2 = TT.Trainer._finish_fetch(TT.Trainer._start_fetch(aux, host))
    assert a2["a"] == 1.5 and a2["b"] == 2.0 and a2["a"].shape == ()
    np.testing.assert_array_equal(h2["rtk"], np.arange(32).reshape(2, 4, 4))
    np.testing.assert_allclose(h2["fe"], [0.1, 0.2, 0.0], atol=1e-7)


def test_step_aux_holds_the_values_the_loss_saw(tmp_path):
    """The step updates the parameters in place after the loss: the aux
    entries read from parameters (beta, skin_scale, ...) must keep the
    values the loss used, as the JAX step's do, not the updated ones."""
    from moda_tpu_torch.train.step import StepExtras

    ttr = TT.Trainer(TMoDAConfig(**dict(INIT_KW, lineload=True, render_size=0,
                                        checkpoint_dir=str(tmp_path))),
                     TDataInfo(offset=(0, 6), intrinsics=((20.0, 20.0, 8.0, 8.0),)),
                     device="cpu")
    ttr.optimizer = ttr.make_optimizer()
    ttr._reset_opt_state()
    step, ns, _ = ttr.get_step_fn(False, False, True)
    from tests.torch_parity import one_step, tiny_batch, torch_batch
    batch = torch_batch(tiny_batch(np.random.default_rng(0), ttr.cfg, lineload=True))
    scal = ttr._extras_scalars(0.5, 1)
    extras = StepExtras(**{k: torch.tensor(v) for k, v in scal.items()},
                        shape_samp=torch.zeros(8, 3), shape_samp_valid=torch.tensor(0.0))
    before = {k: getattr(ttr.model, k).detach().clone() for k in ("skin_aux", "nerf_beta_feat")}
    aux, _ = one_step(step, batch, extras, generator=torch.Generator().manual_seed(0))
    assert float(aux["grad_finite"]) == 1.0
    assert not torch.equal(ttr.model.skin_aux, before["skin_aux"])  # the step moved it
    assert float(aux["skin_scale"]) == float(before["skin_aux"][0])
    assert float(aux["skin_const"]) == float(before["skin_aux"][1])
    assert float(aux["beta_feat"]) == float(before["nerf_beta_feat"][0])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_warmup_shape_and_reinit_bones_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(JT, "ITERS_PER_EPOCH", 3)
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 3)
    jtr, ttr = _trainers(tmp_path, draws=True)
    before = bridge.flatten(jax.tree_util.tree_map(np.asarray, jtr.params))
    lj, lt = jtr.warmup_shape(1), ttr.warmup_shape(1)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)

    def compare(changed):
        """Changed groups: relative L2 over the group's leaves together. Per
        leaf it does not hold at 1e-5 for the zero-initialized biases, whose
        values are all Adam steps: the shape loss's gradients differ between
        the frameworks by ~1e-4 relative in the first layers (the 2^9-
        frequency embed's fp32 sin/cos), and Adam normalizes the smallest
        gradients, where that difference is largest."""
        jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jtr.params))
        got, want = {g: [] for g in changed}, {g: [] for g in changed}
        for n, p in ttr.model.named_parameters():
            k = n.replace(".", "/")
            if k.split("/")[0] in changed:
                got[k.split("/")[0]].append(p.detach().numpy().ravel())
                want[k.split("/")[0]].append(jflat[k].ravel())
            else:
                np.testing.assert_array_equal(p.detach().numpy(), jflat[k], err_msg=k)
                np.testing.assert_array_equal(jflat[k], before[k], err_msg=k)
        for g in changed:
            err = _rel(np.concatenate(got[g]), np.concatenate(want[g]))
            assert err <= 1e-5, (g, err)
        return jflat

    after = compare({"nerf_coarse", "nerf_beta"})
    assert _rel(after["nerf_coarse/xyz_1/kernel"], before["nerf_coarse/xyz_1/kernel"]) > 1e-6

    from moda_tpu_torch.viz.render_vis import unit_sphere
    v, f = unit_sphere(2)
    v = (v * np.asarray([0.12, 0.08, 0.1])).astype(np.float32)
    for tr, M in ((jtr, JMesh), (ttr, TMesh)):
        tr.mesh_rest = M(vertices=v, faces=f)
        tr.reinit_bones()
    before = after
    compare({"nerf_coarse", "nerf_beta", "nerf_body_rts", "bones"})
    bias = ttr.model.nerf_body_rts.trunk.rgb.bias
    assert (bias == 0).all() and ttr.model.bones.shape == (INIT_KW["num_bones"], 10)


def test_train_app_runs_on_the_cpu(tmp_path, monkeypatch):
    """The port's stage-1 route end to end at small size: train_app on a
    synthetic line-shard dataset, two epochs of two steps: losses finite,
    the epoch line written, the mesh extracted, checkpoints that load back
    bit-equal to the live parameters."""
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=16, num_frames=6))
    tr = train_app.main(
        ["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"), "--logname", "v",
         "--checkpoint_dir", str(tmp_path / "log"), "--num_epochs", "2", "--lineload",
         "--batch_size", "2", "--nsample", "4", "--ndepth", "8", "--img_size", "16",
         "--sample_grid3d", "12", "--feat_ndepth_grid", "4", "--num_bones", "3",
         "--use_rtk_file", "--warmup_shape_ep", "1", "--warmup_rootmlp", "--eikonal_wt",
         "0.001", "--noppr_eikonal", "--dskin_steps", "1", "--render_size", "0",
         "--n_data_workers", "1"], device="cpu")
    rows = _logs(tr)
    steps = [r for r in rows if "total_loss" in r]
    assert [r["step"] for r in steps] == [1, 3]
    assert all(np.isfinite(r["total_loss"]) and r["grad_finite"] == 1.0 for r in steps)
    assert np.isfinite([r["shape_init_loss"] for r in rows if "shape_init_loss" in r]).all()
    epochs = [r for r in rows if "epoch_time" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    for k in ("mesh_verts", "t_mesh", "t_save", "t_load", "t_dispatch", "steps_per_s"):
        assert k in epochs[-1], k
    for tag in ("latest", "1", "2"):
        assert os.path.exists(os.path.join(tr.save_dir, f"{tag}.params.npz"))
    assert os.path.exists(os.path.join(tr.save_dir, "mesh_cam-latest.obj"))
    params = bridge.flatten(TCK.load_checkpoint(os.path.join(tr.save_dir, "latest"))[0])
    for n, p in tr.model.named_parameters():
        np.testing.assert_array_equal(params[n.replace(".", "/")], p.detach().numpy())
    assert tr.total_steps_done == 4 and tr.latest_vars["idk"].sum() > 0


def test_train_app_writes_the_eval_grid(tmp_path, monkeypatch):
    """The eval grid at render_size 8 (the full raw frame: the line-shard
    fixture's placeholder frames cannot be decoded, which is logged once):
    eval-000.png of 3 x 3 tiles, each the rgb, silhouette and flow columns,
    no eval_render_error, and its time in the epoch line. The renders run
    the plain view: no kernel route is taken on the CPU either way."""
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.viz.render_vis import png_size

    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=16, num_frames=6))
    tr = train_app.main(
        ["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"), "--logname", "v",
         "--checkpoint_dir", str(tmp_path / "log"), "--num_epochs", "1", "--lineload",
         "--batch_size", "2", "--nsample", "4", "--ndepth", "8", "--img_size", "16",
         "--sample_grid3d", "12", "--feat_ndepth_grid", "4", "--num_bones", "3",
         "--use_rtk_file", "--warmup_shape_ep", "1", "--warmup_rootmlp", "--eikonal_wt",
         "0.001", "--noppr_eikonal", "--dskin_steps", "1", "--render_size", "8", "--chunk",
         "48", "--n_data_workers", "1"], device="cpu")
    rows = _logs(tr)
    assert not [r for r in rows if "eval_render_error" in r]
    assert [r["eval_frames_unreadable"] for r in rows if "eval_frames_unreadable" in r] == [9]
    assert png_size(os.path.join(tr.save_dir, "eval-000.png")) == (3 * 8, 3 * 8 * 3)
    epoch = [r for r in rows if "epoch_time" in r][0]
    assert 0 < epoch["t_eval"] < epoch["epoch_time"]


def _flat_np(tree):
    return bridge.flatten(jax.tree_util.tree_map(np.asarray, tree))


def _group_rel(got, want):
    """Relative L2 per optimizer group of two flat parameter dicts."""
    groups = {}
    for k, v in want.items():
        a, b = groups.setdefault(k.split("/")[0], ([], []))
        a.append(np.ravel(got[k]))
        b.append(np.ravel(v))
    return {g: _rel(np.concatenate(a), np.concatenate(b)) for g, (a, b) in groups.items()}


def _moved_rel(got, want, base):
    """||got - want|| / ||want - base|| over all leaves: how far the port's
    state lies from JAX's, in units of how far JAX's moved since ``base``."""
    d = np.concatenate([np.ravel(got[k] - want[k]) for k in want])
    m = np.concatenate([np.ravel(want[k] - base[k]) for k in want])
    return float(np.linalg.norm(d) / (np.linalg.norm(m) + 1e-30))


@pytest.mark.slow
def test_two_trainers_agree_over_two_epochs(tmp_path, monkeypatch):
    """Both trainers from the same parameters, batches and draws: shape
    warmup, two epochs of two steps (bone re-init and optimizer reset at
    both epochs, extraction, deferred bookkeeping, checkpoints), run in
    lockstep.

    The trajectory cannot be held free-running: in this configuration one
    package against itself, from parameters perturbed by 1e-6 relative,
    already logs losses 5.6x apart by the fourth step (the first Adam steps
    give full-learning-rate updates to gradients at rounding level). So
    each port step starts from the JAX trainer's state at that step: the
    test first compares the state the port's trainer brought to the step
    (parameters, optimizer count and moments, model state, the step's
    scalars), then loads JAX's parameters and optimizer state into the
    captured parameters and the optimizer, and compares the step's losses.
    Whatever the trainer does between steps (warmup, re-init, resets,
    bookkeeping) thus shows at the next step against one step's numeric
    drift only.

    Readings on a CPU, sound trainer [bound] and planted faults:
    - the state each step starts from, ||port - JAX|| over all parameters
      in units of JAX's move since the previous step: <= 0.071 [0.5];
      1.00 with step 0's update undone in the port's loop;
    - the optimizer count: equal [equal]; 2 against 0 at step 2 with the
      epoch-1 optimizer reset left out (moments 4.8e13 relative, against
      zeros); the moments: <= 5.8e-3 relative L2 [0.05];
    - each step's losses (the logged steps 1 and 3 among them), relative:
      the eikonal term <= 5.0e-3 [1e-2] (it differentiates the 2^9-
      frequency features, see test_torch_step.py), the total less it
      <= 1.1e-4 and every other term <= 6.8e-4 [2e-3]; with step 1's batch
      uploaded again at step 2, the total 0.94 and flo_loss 11.7."""
    from moda_tpu.train.step import StepExtras as JExtras
    from moda_tpu_torch.data.dataset import PairLoader, build_line_datasets
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.train.optim import OptState

    monkeypatch.setattr(JT, "ITERS_PER_EPOCH", 2)
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=16, num_frames=6))
    loader = PairLoader(build_line_datasets("syn", 16, str(tmp_path / "cfg")), 2, seed=1,
                        num_threads=1, npix=20)
    batches = [next(loader) for _ in range(4)]
    loader.close()
    kw = dict(num_epochs=2, lineload=True, warmup_shape_ep=1, warmup_rootmlp=True,
              dskin_steps=1.0, nf_reset=0.0)
    jtr, ttr = _trainers(tmp_path, draws=True, **kw)
    class Batches:  # the recorded batches, through PairLoader's next_chunk
        next_chunk = PairLoader.next_chunk

        def __init__(self):
            self.it = iter(list(batches))

        def __next__(self):
            return next(self.it)

    jtr.loader, ttr.loader = iter(list(batches)), Batches()
    losses = ("total_loss", "img_loss", "sil_loss", "flo_loss", "feat_rnd_loss", "proj_loss",
              "cyc_loss", "root_sm_loss", "ekl_loss", "bone_loc_loss", "visibility_loss")

    jrec = []  # the JAX trainer's state at each step, and the step's losses
    jget = jtr.get_step_fn

    def jget_rec(*a, **k):
        fn = jget(*a, **k)

        def rec(params, opt_state, mvars, batch, extras, keys):
            out = fn(params, opt_state, mvars, batch, extras, keys)
            jrec.append({
                "params": _flat_np(params), "count": int(opt_state.count),
                "mu": _flat_np(opt_state.adam.mu), "nu": _flat_np(opt_state.adam.nu),
                "mvars": {f: np.asarray(getattr(mvars, f)) for f in TT.MVAR_FIELDS},
                # base_rt reaches the step only under use_cam
                "extras": {f: np.asarray(getattr(extras, f)) for f in JExtras._fields
                           if f != "base_rt"},
                "loss": {k: float(out[2][k]) for k in losses}})
            jrec[-1]["loss"]["total-ekl"] = float(out[2]["total_loss"] - out[2]["ekl_loss"])
            return out
        return rec

    jtr.get_step_fn = jget_rec
    jtr.train()

    readings = []  # per port step: what its trainer brought, then its losses
    tget = ttr.get_step_fn

    def tget_rec(*a, **k):
        fn, ns_u, ns_a = tget(*a, **k)

        def rec(batches, extras0, per_step, generator=None, draws=None):
            # the port's trainer makes one step a call here (steps_chunk 0)
            extras = extras0._replace(**{f: v[0] for f, v in per_step.items()})
            j = jrec[len(readings)]
            base = jrec[len(readings) - 1]["params"] if readings else None
            st = ttr.optimizer.state
            got = {n.replace(".", "/"): p.detach().numpy().copy()
                   for n, p in ttr.model.named_parameters()}
            r = {"count": (int(st.count), j["count"]),
                 "params": _group_rel(got, j["params"]),
                 "moved": _moved_rel(got, j["params"], base) if base else None,
                 "mu": _rel(np.concatenate([st.mu[n].numpy().ravel() for n in st.mu]),
                            np.concatenate([j["mu"][n.replace(".", "/")].ravel()
                                            for n in st.mu])),
                 "nu": _rel(np.concatenate([st.nu[n].numpy().ravel() for n in st.nu]),
                            np.concatenate([j["nu"][n.replace(".", "/")].ravel()
                                            for n in st.nu])),
                 "mvars": {f: _rel(getattr(ttr.model.mvars, f).numpy(), j["mvars"][f])
                           for f in TT.MVAR_FIELDS},
                 "extras": {f: _rel(np.asarray(getattr(extras, f).numpy(), np.float64),
                                    np.asarray(v, np.float64))
                            for f, v in j["extras"].items()}}
            bridge.load_params(ttr.model, j["params"])  # into the captured parameters
            ttr.optimizer.state = OptState(
                count=torch.tensor(j["count"], dtype=torch.int32),
                mu={n: torch.as_tensor(j["mu"][n.replace(".", "/")]).clone() for n in st.mu},
                nu={n: torch.as_tensor(j["nu"][n.replace(".", "/")]).clone() for n in st.nu})
            aux, host_out = fn(batches, extras0, per_step, generator=generator, draws=draws)
            got = {k: float(aux[k][0]) for k in losses}
            got["total-ekl"] = float(aux["total_loss"][0] - aux["ekl_loss"][0])
            r["loss"] = {k: abs(v - j["loss"][k]) / max(abs(j["loss"][k]), 1e-12)
                         for k, v in got.items()}
            readings.append(r)
            return aux, host_out
        return rec, ns_u, ns_a

    ttr.get_step_fn = tget_rec
    ttr.train()
    def loss_ok(k, e):
        return e <= (1e-2 if k in ("ekl_loss", "total_loss") else 2e-3)

    assert len(readings) == len(jrec) == 4
    assert jtr.total_steps_done == ttr.total_steps_done == 4
    for i, r in enumerate(readings):
        assert r["count"][0] == r["count"][1], (i, r["count"])
        assert r["mu"] <= 0.05 and r["nu"] <= 0.05, (i, r["mu"], r["nu"])
        if i == 0:  # warmup, root preset, epoch-0 re-init from the same start
            assert max(r["params"].values()) <= 1e-5, (i, r["params"])
        else:
            assert r["moved"] <= 0.5, (i, r["moved"], r["params"])
        for f, e in r["mvars"].items():
            assert e <= 1e-6, (i, f, e)
        for f, e in r["extras"].items():
            assert e <= (1e-3 if f == "shape_samp" else 0.0), (i, f, e)
        for k, e in r["loss"].items():
            assert loss_ok(k, e), (i, k, e)

    lj, lt = _logs(jtr), _logs(ttr)
    sj = [r for r in lj if "total_loss" in r]
    st = [r for r in lt if "total_loss" in r]
    assert [r["step"] for r in sj] == [r["step"] for r in st] == [1, 3]
    for a, b in zip(st, sj):  # the logged lines are the lockstep steps' losses
        for k in losses:
            assert loss_ok(k, abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)), (b["step"], k)
    for key in ("mesh_verts", "frac_occupied", "root_freeze_epoch", "warmup_epoch"):
        assert [r[key] for r in lj if key in r] == [r[key] for r in lt if key in r], key
    np.testing.assert_array_equal(ttr.latest_vars["idk"], jtr.latest_vars["idk"])
    np.testing.assert_array_equal(ttr.latest_vars["obj_bound"], jtr.latest_vars["obj_bound"])
