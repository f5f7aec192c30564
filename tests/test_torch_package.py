"""Package rules of moda_tpu_torch: it imports neither JAX nor anything of
moda_tpu, and its entry points run on the card unless asked for the CPU."""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "moda_tpu_torch"
# the card's machine is not promised an image codec, so none may load either
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "moda_tpu", "cv2", "imageio", "PIL")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: the tests run in several processes at
    once, and torch's thread pools on every core slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_import_loads_no_jax_and_no_moda_tpu():
    code = ("import sys, moda_tpu_torch, moda_tpu_torch.train.step, moda_tpu_torch.bridge\n"
            "import moda_tpu_torch.train.trainer, moda_tpu_torch.cli.train_app\n"
            "import moda_tpu_torch.extract.mesh, moda_tpu_torch.data.dataset\n"
            "import moda_tpu_torch.cli.extract_app, moda_tpu_torch.cli.eval_root_app\n"
            "import moda_tpu_torch.evals.ama, moda_tpu_torch.evals.sim3\n"
            "import moda_tpu_torch.render.evalrender, moda_tpu_torch.viz.render_vis\n"
            "import moda_tpu_torch.data.frames, moda_tpu_torch.data.imageio\n"
            "import moda_tpu_torch.train.warmup_pose, moda_tpu_torch.fields.cnn\n"
            "import moda_tpu_torch.fields.cse, moda_tpu_torch.render.s3im\n"
            "import moda_tpu_torch.train.cse_distill, moda_tpu_torch.viz.nvs\n"
            "import moda_tpu_torch.viz.match, moda_tpu_torch.cli.nvs_app\n"
            "import moda_tpu_torch.cli.match_app, moda_tpu_torch.preproc.posenet\n"
            "import moda_tpu_torch.parallel, moda_tpu_torch.parallel.dist\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_preprocessing_loads_no_jax_no_cv2_and_no_moda_tpu():
    """The preprocessing entry point and every module it imports (VCN+, the
    pipeline, AMA conversion, the checkpoint loaders, the uint8 resize and
    PBM reader of data/imageio.py, scipy's labelling, the video readers of
    preproc/video.py reading and decoding committed clips: Motion JPEG,
    MPEG-4 Part 2 through preproc/m4v.py and H.264 through preproc/h264.py
    on the CPU), the detectron2
    graphs (ResNet-50 + FPN, DensePose-CSE, PointRend) and the checkpoint
    converter load none of FORBIDDEN: the card's machine has no cv2 and no
    JAX."""
    code = ("import sys, moda_tpu_torch.cli.preproc_app, moda_tpu_torch.preproc.pipeline\n"
            "import moda_tpu_torch.preproc.ama, moda_tpu_torch.preproc.vcn_flow\n"
            "import moda_tpu_torch.preproc.checkpoints, moda_tpu_torch.bridge\n"
            "import moda_tpu_torch.preproc.cse_infer, moda_tpu_torch.preproc.pointrend_infer\n"
            "import moda_tpu_torch.fields.resnet_fpn, moda_tpu_torch.cli.convert_app\n"
            "import moda_tpu_torch.preproc.video, moda_tpu_torch.preproc.m4v\n"
            "import moda_tpu_torch.preproc.h264\n"
            "import numpy as np\n"
            "from moda_tpu_torch.preproc.pipeline import largest_cc\n"
            "largest_cc(np.eye(4, dtype=np.uint8))\n"
            f"from moda_tpu_torch.preproc.video import open_video\n"
            f"clip = open_video({str(PKG.parent / 'tests/goldens/clip_small.avi')!r})\n"
            "clip.frame(len(clip) - 1)\n"
            f"clip = open_video({str(PKG.parent / 'tests/goldens/clip_mpeg4.mp4')!r})\n"
            "clip.frame(len(clip) - 1, device='cpu')\n"
            f"clip = open_video({str(PKG.parent / 'tests/goldens/clip_h264_small.mp4')!r})\n"
            "clip.frame(len(clip) - 1, device='cpu')\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_nothing_forbidden():
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def _tiny():
    from moda_tpu_torch.config import DataInfo, MoDAConfig
    cfg = MoDAConfig(num_bones=3, img_size=16, nsample=4, ndepth=8, feat_ndepth_grid=4)
    return cfg, DataInfo(offset=(0, 6), intrinsics=((20.0, 20.0, 8.0, 8.0),))


def _step_factory():
    # kept out of the test bodies: tests/conftest.py marks every test whose
    # source names make_train_step as slow, and these two are quick
    from moda_tpu_torch.train.step import make_train_step
    return make_train_step


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.train.optim import MoDAOptimizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, info = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoDAModel(cfg, info)
    model = MoDAModel(cfg, info, device="cpu")
    assert model.device.type == "cpu"
    opt = MoDAOptimizer(cfg, total_steps=10)
    kw = dict(nsample=4, ndepth=8, use_fine=False, use_dskin=False, use_bones=True)
    build_step = _step_factory()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_step(model, opt, **kw)
    build_step(model, opt, device="cpu", **kw)


def test_later_slices_refuse_explicitly(tmp_path):
    """The step's branches build and run: nerf_dis, flowbw without bones,
    ft_cse, s3im_loss, freeze_coarse, accu_steps > 1 and use_bones=False in
    the model, the step and the trainer; so do K steps a call
    (chunk_steps / steps_chunk > 1), refused before their slice. (The name
    is older: the training routes refuse nothing now; more than one process:
    test_train_app_refuses_later_slices.) The reference's .pth posenet,
    refused before its slice, now loads."""
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import StepExtras
    from tests.torch_dist import one_step

    cfg, info = _tiny()
    t = torch.tensor
    extras = StepExtras(progress=t(0.5), loss_select=t(1), root_update=t(1.0),
                        body_update=t(1.0), shape_update=t(0.0), cvf_update=t(0.0),
                        sil_err_median=t(1e9), shape_samp=torch.zeros(8, 3),
                        shape_samp_valid=t(0.0), embed_alpha=t(10.0))
    P, fid = cfg.img_size ** 2, t([0, 1, 1, 2])
    batch = {"imgs": torch.rand(4, 3, P), "masks": torch.ones(4, 1, P),
             "vis2d": torch.ones(4, 1, P), "flow": torch.zeros(4, 2, P),
             "occ": torch.ones(4, 1, P), "dp_feats": torch.rand(4, 16, P),
             "kaug": t([[1.0, 1.0, 0.0, 0.0]]).repeat(4, 1), "frameid": fid,
             "frameid_sub": fid, "dataid": torch.zeros(4, dtype=torch.long)}
    build_step = _step_factory()
    args = dict(nsample=2, ndepth=8, use_fine=True, use_dskin=True, use_bones=True)
    for kw, step_kw in ((dict(nerf_dis=True), {}), (dict(ft_cse=True, s3im_loss=True), {}),
                        (dict(freeze_coarse=True), {}), ({}, dict(accu_steps=2)),
                        (dict(flowbw=True, lbs=False, neudbs=False),
                         dict(use_bones=False, use_dskin=False))):
        model = MoDAModel(cfg.replace(**kw), info, device="cpu")
        step = build_step(model, MoDAOptimizer(cfg, total_steps=10), device="cpu",
                          **dict(args, **step_kw))
        aux, _ = one_step(step, batch, extras, generator=torch.Generator().manual_seed(0))
        assert float(aux["grad_finite"]) == 1.0 and torch.isfinite(aux["total_loss"]), kw
    with pytest.raises(ValueError, match="nolbs"):
        MoDAModel(cfg.replace(flowbw=True), info, device="cpu")
    # two steps in one call: stacked batches and per-step scalars in,
    # stacked outputs out
    from moda_tpu_torch.train.step import CHUNK_STEP_FIELDS
    model = MoDAModel(cfg, info, device="cpu")
    step = build_step(model, MoDAOptimizer(cfg, total_steps=10), device="cpu", chunk_steps=2,
                      **args)
    per_step = {f: torch.stack([torch.as_tensor(getattr(extras, f), dtype=torch.float32)] * 2)
                for f in CHUNK_STEP_FIELDS}
    aux, host = step({k: torch.stack([v, v]) for k, v in batch.items()}, extras, per_step,
                     generator=torch.Generator().manual_seed(0))
    assert aux["total_loss"].shape == (2,) and host["rtk"].shape == (2, 4, 4, 4)
    assert torch.isfinite(aux["total_loss"]).all() and (aux["grad_finite"] == 1).all()

    # the trainer: K steps a call, the branches, the eval renders and the
    # pose-CNN cold start build
    from moda_tpu_torch.train.trainer import Trainer
    from moda_tpu_torch.train.warmup_pose import PoseWarmup
    tcfg = cfg.replace(checkpoint_dir=str(tmp_path))
    assert Trainer(tcfg.replace(steps_chunk=2), info, device="cpu").steps_chunk == 2
    for kw in (dict(accu_steps=2), dict(s3im_loss=True), dict(freeze_coarse=True),
               dict(ft_cse=True, nerf_dis=True)):
        Trainer(tcfg.replace(**kw), info, device="cpu")
    tr = Trainer(tcfg.replace(warmup_pose_ep=1), info, device="cpu")
    assert tr.cfg.render_size == 64
    # the reference's .pth posenet checkpoint loads (tests/test_torch_posenet.py)
    from tests.test_torch_posenet import write_reference_pth
    w = PoseWarmup(tr.prior_verts_unit, tr.prior_faces, tr.prior_embeds, 3.0, device="cpu")
    write_reference_pth(str(tmp_path / "posenet.pth"))
    w.load(str(tmp_path / "posenet.pth"))
    assert w.ref_net is not None


def test_config_loads_a_jax_config():
    from moda_tpu.config import MoDAConfig as JConfig
    from moda_tpu_torch.config import MoDAConfig

    j = JConfig(nsample=6, freeze_proj=True, num_bones=11)
    t = MoDAConfig.from_json(j.to_json())
    assert t.to_json() == j.to_json()


def test_train_app_refuses_later_slices(tmp_path, monkeypatch):
    """train_app runs the step's branches (nerf_dis, S3IM, freeze_coarse and
    accu_steps together; flowbw without bones; ft_cse on the frame route),
    --steps_chunk 2 on either data route and two ranks (WORLD_SIZE 2),
    which it refused before their slice (the name is older: it refuses
    none of them now); extract_app needs a checkpoint. Datasets without
    line shards are read through the frame route
    (tests/test_torch_frames.py), a video without frames raises."""
    import shutil

    from moda_tpu_torch.cli import extract_app, train_app
    from moda_tpu_torch.data.synthetic import (SynthScene, write_frame_dataset,
                                               write_line_dataset)
    from moda_tpu_torch.train import trainer as TT

    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=8, num_frames=3))
    argv = ["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"),
            "--checkpoint_dir", str(tmp_path)]
    # the step's branches run through train_app (one two-step epoch); ft_cse
    # on the frame route, whose batches carry the full crops its CSE net reads
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    write_frame_dataset(str(tmp_path / "fdb"), str(tmp_path / "fcfg"), "synf",
                        SynthScene(img_size=16, num_frames=3))
    small = ["--checkpoint_dir", str(tmp_path), "--batch_size", "2", "--nsample", "4",
             "--ndepth", "8", "--sample_grid3d", "8", "--feat_ndepth_grid", "4",
             "--num_bones", "3", "--num_epochs", "1", "--render_size", "0",
             "--n_data_workers", "1", "--use_rtk_file"]
    lines = argv[:4] + ["--lineload", "--img_size", "8"]
    for name, data, flags in (
            ("dis", lines, ["--nerf_dis", "--s3im_loss", "--freeze_coarse", "--accu_steps", "2"]),
            ("flowbw", lines, ["--flowbw", "--nolbs", "--noneudbs"]),
            ("cse", ["--seqname", "synf", "--config_dir", str(tmp_path / "fcfg"),
                     "--img_size", "16"], ["--ft_cse"]),
            ("chunk_lines", lines, ["--steps_chunk", "2"]),
            ("chunk_frames", ["--seqname", "synf", "--config_dir", str(tmp_path / "fcfg"),
                              "--img_size", "16"], ["--steps_chunk", "2"])):
        tr = train_app.main(data + small + flags + ["--logname", name], device="cpu")
        steps = [json.loads(r) for r in open(tr.log_path) if '"total_loss"' in r]
        assert steps and all(np.isfinite(r["total_loss"]) for r in steps), flags
        if name == "cse":
            assert "csenet_loss" in steps[0]
        if name.startswith("chunk"):
            assert tr.steps_chunk == 2 and tr.total_steps_done == 2
    with pytest.raises(SystemExit, match="model_path"):
        extract_app.main(argv + ["--lineload"], device="cpu")
    # two ranks (torchrun's variables, gloo on the CPU): both train and agree
    from tests import torch_dist as TD
    out = tmp_path / "ranks"
    out.mkdir()
    two = [lines + small + ["--logname", "dp", "--batch_size", "4"]] * 2
    r0, r1 = TD.spawn(2, str(out), "app", (two, 2, False), timeout=300)
    assert r0["total_steps_done"] == r1["total_steps_done"] == 2
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    monkeypatch.setenv("WORLD_SIZE", "2")  # without torchrun's other variables
    with pytest.raises(RuntimeError, match="torchrun"):
        train_app.main(argv + ["--lineload"], device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    shutil.rmtree(tmp_path / "db" / "JPEGImages")
    with pytest.raises(FileNotFoundError):
        train_app.main(argv, device="cpu")


def test_accu_steps_trainer_updates_once_per_call(tmp_path, monkeypatch):
    """accu_steps = 2: the port's trainer makes ITERS_PER_EPOCH step calls an
    epoch, each of two micro-batches and one optimizer update, and advances
    its iteration count by 2 a call; after num_epochs the optimizer's count
    is the one-cycle schedule's total_steps and the iterations reach
    final_steps. The JAX trainer sizes the schedule the same way
    (moda_tpu/train/trainer.py:168-171) but makes ITERS_PER_EPOCH *
    accu_steps calls an epoch (:700), each a whole update: twice the
    schedule's steps, so its learning rate ends its cycle half-way. (No
    bone re-init after epoch 0, so the count runs over both epochs.)"""
    from types import SimpleNamespace

    from moda_tpu.config import MoDAConfig as JConfig
    from moda_tpu.train import trainer as JT
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.train import trainer as TT

    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    monkeypatch.setattr(JT, "ITERS_PER_EPOCH", 2)
    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=8, num_frames=3))
    calls = []
    get_step = TT.Trainer.get_step_fn

    def counted(self, *a, **k):
        fn, ns_u, ns_a = get_step(self, *a, **k)
        return (lambda *b, **kw: calls.append(1) or fn(*b, **kw)), ns_u, ns_a

    monkeypatch.setattr(TT.Trainer, "get_step_fn", counted)
    tr = train_app.main(["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"),
                         "--checkpoint_dir", str(tmp_path), "--lineload", "--img_size", "8",
                         "--batch_size", "2", "--nsample", "4", "--ndepth", "8",
                         "--sample_grid3d", "8", "--feat_ndepth_grid", "4", "--num_bones", "3",
                         "--num_epochs", "2", "--accu_steps", "2", "--render_size", "0",
                         "--reinit_bone_steps", "1",
                         "--n_data_workers", "1", "--use_rtk_file"], device="cpu")
    total = tr.optimizer.total_steps
    assert total == 2 * TT.ITERS_PER_EPOCH and len(calls) == total
    assert int(tr.optimizer.state.count) == total
    assert tr.total_steps_done == tr.final_steps == 2 * total
    jcfg = JConfig.from_json(tr.cfg.to_json())
    jtr = SimpleNamespace(cfg=jcfg)
    jtr.final_steps = JT.Trainer.final_steps.fget(jtr)
    jax_updates = jcfg.num_epochs * JT.ITERS_PER_EPOCH * jcfg.accu_steps  # trainer.py:700
    assert JT.Trainer.make_optimizer(jtr).total_steps == total
    assert jax_updates == 2 * total


def test_pair_loader_close_leaves_no_thread_exception(tmp_path, monkeypatch):
    """close() stops and joins the workers; none dies with an unhandled
    exception, also when closed with the queue full, and the loader has no
    chunk assembler that could outlive it: next_chunk starts no thread and
    raises once the loader is closed."""
    import threading

    from moda_tpu_torch.data.dataset import PairLoader, build_line_datasets
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    errors = []
    monkeypatch.setattr(threading, "excepthook", lambda args: errors.append(args))
    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=8, num_frames=4))
    ds = build_line_datasets("syn", 8, str(tmp_path / "cfg"))
    for npix in (6, None):
        loader = PairLoader(ds, 2, num_threads=3, num_prefetch=2, npix=npix)
        before = threading.active_count()
        next(loader)
        loader.next_chunk(2)
        assert threading.active_count() == before
        loader.close()
        assert not any(t.is_alive() for t in loader.threads)
        with pytest.raises(RuntimeError, match="closed"):
            loader.next_chunk(2)
    assert errors == []

