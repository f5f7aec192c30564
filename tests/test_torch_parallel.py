"""Data parallelism over processes (moda_tpu_torch/parallel/dist.py): two
gloo ranks on the CPU, spawned with a timeout, against the port's
one-process step on the same global batch and draws, and train_app as two
ranks under a torchrun-like environment. The contract is the JAX
package's (tests/test_parallel_parity.py): a sharded step computes what
one device computes on the whole batch."""
import json
import os

import numpy as np
import pytest
import torch

from moda_tpu_torch.parallel import dist
from tests import torch_dist as TD


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one process (its first step) and as two ranks (STEPS
    steps), from the same seeds."""
    torch.set_num_threads(1)
    one = {n: TD.run_case(n, 1) for n in TD.CASES}
    ranks = TD.spawn(2, str(tmp_path_factory.mktemp("ranks")), "steps", (list(TD.CASES), STEPS))
    return one, ranks


def test_layout_keeps_the_micro_batches():
    """Rank r holds pairs r*m/n ... (r+1)*m/n of each micro-batch of m
    pairs, in both halves: the ranks' local micro-batch j together are the
    one-process micro-batch j (train/step.py::micro_batches), and every
    pair keeps both of its frames on one rank."""
    B, world, accu = 12, 2, 3
    mb = B // accu
    idx = [dist.pair_index(r, world, B // world, accu) for r in range(world)]
    assert sorted(np.concatenate(idx).tolist()) == list(range(2 * B))
    for r in range(world):
        first, second = np.split(idx[r], 2)
        np.testing.assert_array_equal(second, first + B)
    for j in range(accu):
        local = [np.split(i, 2)[0].reshape(accu, -1)[j] for i in idx]
        assert sorted(np.concatenate(local).tolist()) == list(range(j * mb, (j + 1) * mb))
    batch = {"frameid": np.arange(2 * B), "imgs": np.arange(2 * B)[:, None] * np.ones((1, 3))}
    got = dist.shard_batch(batch, 1, world, accu)
    np.testing.assert_array_equal(got["frameid"], idx[1])
    with pytest.raises(ValueError, match="does not divide"):
        dist.shard_batch(batch, 0, 5, 1)
    with pytest.raises(ValueError, match="does not divide"):
        dist.shard_batch(batch, 0, 2, 4)


def test_a_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card of its own"):
        dist.init_process(1, 2, port=TD.free_port())


@pytest.mark.parametrize("name", sorted(TD.CASES))
def test_two_ranks_match_one_process(runs, name):
    """One step, two ranks against one process on the same global batch and
    draws (init: a draws dict at the global shapes; ft2: the generator's
    draws, the global top-k of the active sampling, the fine pass and
    accu_steps 2). Tolerances with reasons: the forward reads the gathered
    global tensors in the one-process order, so the losses agree to fp32
    rounding of the per-row MLP products (rtol 1e-6; bit-equal on this
    CPU). The gradients sum each rank's share in another order; the
    feat-match transport's backward (20 Sinkhorn iterations on
    exp(-(1 - cost) / 0.03)) magnifies that to 2.1e-4 of nerf_feat's norm
    (7e-8 with use_ot off), so group norms are held at 1e-3: a gradient
    counted once too often or not at all moves them by O(1). Adam's first
    step is ~lr x sign(g), so a gradient within rounding of 0 can flip:
    parameters are held at 2 lr x the group LR multiplier (10 at most)."""
    one, ranks = runs
    a1, a2 = one[name]["aux"][0], ranks[0][name]["aux"][0]
    for k in ("total_loss", "img_loss", "sil_loss", "flo_loss", "ekl_loss", "visibility_loss",
              "unc_loss", "feat_rnd_loss", "proj_loss"):
        if k in a1:
            np.testing.assert_allclose(float(a2[k]), float(a1[k]), rtol=1e-6, err_msg=k)
    groups = [k for k in a1 if k.endswith("_g")]
    assert len(groups) >= 12
    for k in groups:
        np.testing.assert_allclose(float(a2[k]), float(a1[k]), rtol=1e-3, atol=1e-9, err_msg=k)
    for k in ("rtk", "frame_err", "frame_cnt"):
        np.testing.assert_array_equal(ranks[0][name]["host"][0][k].numpy(),
                                      one[name]["host"][0][k].numpy(), err_msg=k)
    B2 = 2 * TD.CASES[name][6]
    assert ranks[0][name]["host"][0]["frameid"].shape == (B2,)
    atol = 20 * float(a1["lr"])
    for n, p in one[name]["params1"].items():
        np.testing.assert_allclose(ranks[0][name]["params1"][n].numpy(), p.numpy(), atol=atol,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", sorted(TD.CASES))
def test_replicas_stay_bit_identical(runs, name):
    """After STEPS steps the two ranks hold the same parameters, bit for bit
    (each rank also compared digests, Comm.check_same), and report the
    same aux and host outputs at every step."""
    r0, r1 = ranks = runs[1]
    assert r0[name]["digest"] == r1[name]["digest"]
    for n, p in r0[name]["params"].items():
        assert torch.equal(p, r1[name]["params"][n]), n
    for s in range(STEPS):
        for part in ("aux", "host"):
            for k, v in r0[name][part][s].items():
                assert torch.equal(v, r1[name][part][s][k]), (s, part, k)
    assert len(ranks) == 2


def _app_argv(tmp_path, ckpt_dir: str, batch: int = 4):
    return ["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"), "--logname", "dp",
            "--checkpoint_dir", ckpt_dir, "--num_epochs", "2", "--lineload",
            "--batch_size", str(batch), "--nsample", "4", "--ndepth", "8", "--img_size", "16",
            "--sample_grid3d", "12", "--feat_ndepth_grid", "4", "--num_bones", "3",
            "--use_rtk_file", "--warmup_shape_ep", "1", "--warmup_rootmlp", "--eikonal_wt",
            "0.001", "--noppr_eikonal", "--dskin_steps", "1", "--render_size", "8",
            "--chunk", "64", "--n_data_workers", "1", "--steps_chunk", "2"]


def test_train_app_runs_as_two_ranks(tmp_path):
    """train_app as two ranks (WORLD_SIZE 2 in torchrun's variables, gloo on
    the CPU), two epochs of ITERS_PER_EPOCH = 2 steps, one call of
    --steps_chunk 2 each, at a global batch of 4 pairs: rank 0 alone writes (rank 1 is given a
    checkpoint directory of its own, which must stay absent), the epoch
    lines carry both ranks' time splits and the replica digest, both
    ranks end with the same parameters and host records."""
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=16, num_frames=6))
    argv = [_app_argv(tmp_path, str(tmp_path / "log")),
            _app_argv(tmp_path, str(tmp_path / "log_rank1"))]
    out = tmp_path / "out"
    out.mkdir()
    r0, r1 = TD.spawn(2, str(out), "app", (argv, 2, False), timeout=300)
    assert not (tmp_path / "log_rank1").exists()
    assert r0["total_steps_done"] == r1["total_steps_done"] == 2 * 2
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    for k, v in r0["latest_vars"].items():
        np.testing.assert_array_equal(v, r1["latest_vars"][k], err_msg=k)
    rows = [json.loads(r) for r in open(os.path.join(r0["save_dir"], "log.jsonl"))]
    epochs = [r for r in rows if "epoch_time" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    for r in epochs:
        assert r["world_size"] == 2 and r["steps_chunk"] == 2 and len(r["ranks"]) == 2
        assert len(r["replica_digest"]) == 16
        assert all(x["t_steps"] > 0 for x in r["ranks"])
    steps = [r for r in rows if "total_loss" in r]
    assert steps and all(np.isfinite(r["total_loss"]) and r["grad_finite"] == 1.0 for r in steps)
    for tag in ("latest", "1", "2"):
        assert os.path.exists(os.path.join(r0["save_dir"], f"{tag}.params.npz"))
    assert os.path.exists(os.path.join(r0["save_dir"], "eval-000.png"))


def test_fine_tune_ranks_resync_after_the_warmups(tmp_path, monkeypatch):
    """A fine-tune stage (--model_path) as two ranks, with the shape warmup
    and --warmup_rootmlp: reset_nf does not run there, so the broadcast
    after the pre-epoch work is what keeps the replicas equal. Rank 1's
    warmup and root preset each move its parameters by 1e-6 (a card may
    part them in the last bits); the run passes the epoch-end digest check
    and both ranks end with the same parameters only if rank 0's state
    reaches every rank before the first epoch."""
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.train import trainer as TT

    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=16, num_frames=6))
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    first = train_app.main(_app_argv(tmp_path, str(tmp_path / "log1"))
                           + ["--num_epochs", "1"], device="cpu")
    tune = ["--model_path", os.path.join(first.save_dir, "latest"), "--num_epochs", "1"]
    argv = [_app_argv(tmp_path, str(tmp_path / "log")) + tune,
            _app_argv(tmp_path, str(tmp_path / "log_rank1")) + tune]
    out = tmp_path / "out"
    out.mkdir()
    r0, r1 = TD.spawn(2, str(out), "app", (argv, 2, True), timeout=300)
    assert r0["nudged"] == 0 and r1["nudged"] == 2
    assert r0["total_steps_done"] == r1["total_steps_done"] == 2
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    rows = [json.loads(r) for r in open(os.path.join(r0["save_dir"], "log.jsonl"))]
    assert [len(r["replica_digest"]) for r in rows if "epoch_time" in r] == [16]


def test_train_app_refuses_an_indivisible_batch(tmp_path, monkeypatch):
    """A global batch that the ranks (times accu_steps) do not divide
    raises before any process group forms; the JAX package replicates it
    instead (ROADMAP §3)."""
    from moda_tpu_torch.cli import train_app

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not divide"):
        train_app.main(_app_argv(tmp_path, str(tmp_path / "log"), batch=3), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        train_app.main(_app_argv(tmp_path, str(tmp_path / "log"), batch=6)
                       + ["--accu_steps", "2"], device="cpu")
    assert not (tmp_path / "log").exists()


@pytest.mark.slow
def test_two_ranks_match_jax_sharded_step(tmp_path):
    """The port's two-rank step against moda_tpu's step sharded over the
    8-virtual-device mesh, in test_parallel_parity.py's setting (ft2: the
    fine pass, active top-k over the sharded ray axis, accu_steps 2), with
    the JAX key's draws given to the port and its own top-k. Tolerances as
    test_torch_step.py's ft2 whole-step comparison: the losses at 1e-4
    (no eikonal term in this setting), group norms at 1e-2, parameters at
    20 lr0. (16 frames instead of 8: the batch's frame ids run to 15.)"""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as G
    from moda_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from moda_tpu.train.optim import MoDAOptimizer
    from moda_tpu.train.step import StepExtras
    from moda_tpu.train import step as JS
    from moda_tpu_torch import bridge
    from tests.torch_parity import jax_draws

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU backend (conftest)")
    # 16 frames: the 8-pair batch names frames 0-15 (JAX clamps an index
    # past the table, the port raises)
    cfg, model, params, mvars = G._tiny_setup(lineload=True, num_fr=16)
    batch = G._tiny_batch(cfg, n_pairs=8, lineload=True, seed=3)
    opt = MoDAOptimizer(cfg, total_steps=100)
    kw = dict(nsample=2, ndepth=cfg.ndepth, use_fine=True, use_dskin=True, use_bones=True,
              nsample_active=2, accu_steps=2)
    jstep = JS.make_train_step(model, opt, donate=False, **kw)
    ex = dict(progress=0.5, loss_select=1, root_update=1.0, body_update=1.0, shape_update=0.0,
              cvf_update=0.0, sil_err_median=1e9, shape_samp=np.zeros((64, 3), np.float32),
              shape_samp_valid=0.0, embed_alpha=10.0)
    key = jax.random.key(7)
    mesh = make_mesh(8)
    with mesh:
        jp, _, jaux, _ = jstep(replicate(params, mesh), replicate(opt.init(params), mesh),
                               replicate(mvars, mesh), shard_batch(batch, mesh),
                               replicate(StepExtras(**{k: jnp.asarray(v) for k, v in ex.items()}),
                                         mesh), key)
    nb = {k: np.asarray(v) for k, v in batch.items()}
    mb = 4
    micro = [{k: np.concatenate([v[j * mb:(j + 1) * mb], v[8 + j * mb:8 + (j + 1) * mb]])
              for k, v in nb.items()} for j in range(2)]
    draws = [jax_draws(k, cfg, b, 2, 2, use_fine=True)
             for k, b in zip(jax.random.split(key, 2), micro)]
    setup = {"cfg": cfg.to_json(), "info": (tuple(model.offset), ((40.0, 40.0, 16.0, 16.0),)),
             "params": jax.tree_util.tree_map(np.asarray, params),
             "mvars": {f: np.asarray(getattr(mvars, f)) for f in
                       ("near_far", "alpha", "obj_bound", "vis_min", "vis_len", "beta_is_active")},
             "batch": nb, "extras": ex, "kw": kw, "draws": draws}
    path = str(tmp_path / "setup.pt")
    torch.save(setup, path)
    out = tmp_path / "out"
    out.mkdir()
    r0, r1 = TD.spawn(2, str(out), "saved", path, timeout=600)
    taux = r0["aux"]
    assert "ekl_loss" not in jaux  # eikonal_wt 0 in this setting
    for k in ("total_loss", "img_loss", "sil_loss", "flo_loss", "unc_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    for k in ("nerf_coarse_g", "nerf_feat_g", "nerf_skin_g", "nerf_root_rts_g", "pose_code_g",
              "nerf_body_rts_g", "bones_g", "nerf_unc_g"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-2, err_msg=k)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jp))
    lr0 = cfg.learning_rate / 25.0
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
        np.testing.assert_allclose(p.numpy(), jflat[n.replace(".", "/")], atol=20 * lr0,
                                   rtol=0, err_msg=n)
