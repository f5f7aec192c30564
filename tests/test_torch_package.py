"""Package rules of moda_tpu_torch: it imports neither JAX nor anything of
moda_tpu, and its entry points run on the card unless asked for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "moda_tpu_torch"
# the card's machine is not promised an image codec, so none may load either
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "moda_tpu", "cv2", "imageio", "PIL")


def test_import_loads_no_jax_and_no_moda_tpu():
    code = ("import sys, moda_tpu_torch, moda_tpu_torch.train.step, moda_tpu_torch.bridge\n"
            "import moda_tpu_torch.train.trainer, moda_tpu_torch.cli.train_app\n"
            "import moda_tpu_torch.extract.mesh, moda_tpu_torch.data.dataset\n"
            "import moda_tpu_torch.cli.extract_app, moda_tpu_torch.cli.eval_root_app\n"
            "import moda_tpu_torch.evals.ama, moda_tpu_torch.evals.sim3\n"
            "import moda_tpu_torch.render.evalrender, moda_tpu_torch.viz.render_vis\n"
            "import moda_tpu_torch.data.frames, moda_tpu_torch.data.imageio\n"
            "import moda_tpu_torch.train.warmup_pose, moda_tpu_torch.fields.cnn\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
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
    """What the ported slices do not run raises, naming a later slice:
    nerf_dis, flowbw, ft_cse, s3im_loss, freeze_coarse, accu_steps and
    chunk_steps > 1, use_bones=False, and the trainer's refusals."""
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.train.optim import MoDAOptimizer

    from moda_tpu_torch.render.losses import total_loss

    cfg, info = _tiny()
    for flag in ("nerf_dis", "flowbw", "ft_cse"):
        with pytest.raises(NotImplementedError, match="later slice"):
            MoDAModel(cfg.replace(**{flag: True}), info, device="cpu")
    for flag in ("s3im_loss", "freeze_coarse"):
        with pytest.raises(NotImplementedError, match="later slice"):
            total_loss(MoDAModel(cfg.replace(**{flag: True}), info, device="cpu"), {}, {}, None,
                       {})
    model = MoDAModel(cfg.replace(use_unc=True), info, device="cpu")
    opt = MoDAOptimizer(cfg, total_steps=10)
    build_step = _step_factory()
    args = dict(nsample=2, ndepth=8, use_fine=True, use_dskin=True, use_bones=True,
                nsample_active=2)
    build_step(model, opt, device="cpu", **args)
    for kw in (dict(accu_steps=2), dict(chunk_steps=2), dict(use_bones=False)):
        with pytest.raises(NotImplementedError, match="later slice"):
            build_step(model, opt, device="cpu", **dict(args, **kw))

    # the trainer: K steps per dispatch, gradient accumulation, s3im and
    # freeze_coarse; the eval renders and the pose-CNN cold start run
    from moda_tpu_torch.train.trainer import Trainer
    from moda_tpu_torch.train.warmup_pose import PoseWarmup
    tcfg = cfg.replace(checkpoint_dir=str(tmp_path))
    for kw in (dict(steps_chunk=2), dict(accu_steps=2), dict(s3im_loss=True),
               dict(freeze_coarse=True)):
        with pytest.raises(NotImplementedError, match="later slice"):
            Trainer(tcfg.replace(**kw), info, device="cpu")
    tr = Trainer(tcfg.replace(warmup_pose_ep=1), info, device="cpu")
    assert tr.cfg.render_size == 64
    # the reference's .pth posenet checkpoint waits for the preprocessing slice
    w = PoseWarmup(tr.prior_verts_unit, tr.prior_faces, tr.prior_embeds, 3.0, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        w.load(str(tmp_path / "posenet.pth"))


def test_config_loads_a_jax_config():
    from moda_tpu.config import MoDAConfig as JConfig
    from moda_tpu_torch.config import MoDAConfig

    j = JConfig(nsample=6, freeze_proj=True, num_bones=11)
    t = MoDAConfig.from_json(j.to_json())
    assert t.to_json() == j.to_json()


def test_train_app_refuses_later_slices(tmp_path, monkeypatch):
    """train_app refuses the trainer's unported flags and more than one
    process, naming a later slice, on either data route; extract_app needs
    a checkpoint. Datasets without line shards are read through the frame
    route (tests/test_torch_frames.py), a video without frames raises."""
    import shutil

    from moda_tpu_torch.cli import extract_app, train_app
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                       SynthScene(img_size=8, num_frames=3))
    argv = ["--seqname", "syn", "--config_dir", str(tmp_path / "cfg"),
            "--checkpoint_dir", str(tmp_path)]
    for route in ([], ["--lineload"]):
        with pytest.raises(NotImplementedError, match="later slice"):
            train_app.main(argv + route + ["--steps_chunk", "2"], device="cpu")
    with pytest.raises(SystemExit, match="model_path"):
        extract_app.main(argv + ["--lineload"], device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="later slice"):
        train_app.main(argv + ["--lineload"], device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    shutil.rmtree(tmp_path / "db" / "JPEGImages")
    with pytest.raises(FileNotFoundError):
        train_app.main(argv, device="cpu")


def test_pair_loader_close_leaves_no_thread_exception(tmp_path, monkeypatch):
    """close() stops and joins the workers; none dies with an unhandled
    exception, also when closed with the queue full, and the loader has no
    chunk assembler that could outlive it."""
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
        next(loader)
        loader.close()
        assert not any(t.is_alive() for t in loader.threads)
        assert not hasattr(loader, "next_chunk")
    assert errors == []

