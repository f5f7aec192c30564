"""Package rules of moda_tpu_torch: it imports neither JAX nor anything of
moda_tpu, and its entry points run on the card unless asked for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "moda_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "moda_tpu")


def test_import_loads_no_jax_and_no_moda_tpu():
    code = ("import sys, moda_tpu_torch, moda_tpu_torch.train.step, moda_tpu_torch.bridge\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'moda_tpu') or "
            "m.startswith(('jax.', 'flax.', 'optax.', 'moda_tpu.'))]\n"
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


def test_later_slices_refuse_explicitly():
    """What the init/ft1/ft2 slices do not port raises, naming a later slice:
    nerf_dis, flowbw, ft_cse, s3im_loss, freeze_coarse, accu_steps and
    chunk_steps > 1, and use_bones=False."""
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


def test_config_loads_a_jax_config():
    from moda_tpu.config import MoDAConfig as JConfig
    from moda_tpu_torch.config import MoDAConfig

    j = JConfig(nsample=6, freeze_proj=True, num_bones=11)
    t = MoDAConfig.from_json(j.to_json())
    assert t.to_json() == j.to_json()
