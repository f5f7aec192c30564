"""The port's eval renders against moda_tpu's, at render size 8:

- build_rays_image with and without the paired-frame camera (every key
  within 1e-5 relative L2; ids equal);
- make_frame_renderer with and without flow, with a chunk of 24 rays for
  the 64 of a frame, so the last chunk is padded (every output within 1e-4
  relative L2), given the draws of the JAX renderer's fixed key;
- Trainer.eval_renders: the grid PNG against the JAX trainer's, without
  eval datasets and with a frame reader (at most one count of 255 apart:
  the float grids agree to ~1e-6, and quantizing to uint8 can carry a
  value across an integer step).
"""
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.render import rays as JRB
from moda_tpu.render.evalrender import make_frame_renderer as j_renderer
from moda_tpu.train.trainer import Trainer as JTrainer
from moda_tpu_torch.render import rays as TRB
from moda_tpu_torch.render.evalrender import make_frame_renderer as t_renderer
from moda_tpu_torch.train.trainer import Trainer as TTrainer
from tests.torch_parity import INFO, both_models, to_t

RS = 8
CHUNK = 24
# one configuration for the file (each JAX init is a ~10 s compile): with
# the uncertainty MLP, so the unc inputs and the grid's unc column are
# covered too
CFG = dict(use_unc=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _cams(n=2):
    """n cameras [n,4,4] looking at the origin from ~0.3, slightly turned."""
    out = []
    for i in range(n):
        a = 0.3 * i
        R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rtk = np.zeros((4, 4), np.float32)
        rtk[:3, :3] = R
        rtk[:3, 3] = [0.01 * i, -0.01, 0.3]
        rtk[3] = [20.0, 18.0, 4.0, 3.5]
        out.append(rtk)
    return np.stack(out)


def _eval_draws(cfg, chunk):
    """The draws the JAX renderer's default key(0) makes in every chunk
    (render_rays' split into 4, inference_deform's split of the last into 6)."""
    kd = jax.random.split(jax.random.split(jax.random.key(0), 4)[3], 6)
    S = cfg.ndepth
    return {"symm_u": to_t(jax.random.uniform(kd[0], (chunk, S, 1))),
            "sigma_noise": to_t(jax.random.normal(kd[1], (chunk, S))),
            "vis_neg": to_t(jax.random.uniform(kd[3], (chunk, S, 3), minval=-1.0, maxval=1.0))}


@pytest.mark.parametrize("flow", [False, True])
def test_build_rays_image_matches_jax(flow):
    cfg, jmodel, params, mvars, tmodel = both_models(**CFG)
    rtk = _cams(2)
    kaug = np.asarray([[1.0, 1.0, 0.0, 0.0], [0.9, 1.1, 0.5, -0.5]], np.float32)
    fid, did = np.asarray([1, 3]), np.asarray([0, 0])
    tgt = dict(rtk_target=rtk[::-1].copy(), frameid_target=np.asarray([2, 4])) if flow else {}
    jr = JRB.build_rays_image(jmodel, params, mvars, jnp.asarray(rtk), jnp.asarray(kaug),
                              jnp.asarray(fid), jnp.asarray(did), RS,
                              **{k: jnp.asarray(v) for k, v in tgt.items()})
    with torch.no_grad():
        tr = TRB.build_rays_image(tmodel, torch.as_tensor(rtk), torch.as_tensor(kaug),
                                  torch.as_tensor(fid), torch.as_tensor(did), RS,
                                  **{k: torch.as_tensor(v) for k, v in tgt.items()})
    assert sorted(tr) == sorted(jr)
    assert ("bone_rts_target" in tr) == flow and "xysn" in tr
    for k in jr:
        assert tr[k].shape == jr[k].shape, k
        assert _rel(tr[k].numpy(), jr[k]) <= 1e-5, k


@pytest.mark.parametrize("flow", [False, True])
def test_frame_renderer_matches_jax(flow):
    """64 rays in chunks of 24: the third is padded with 8 copies of the
    last ray, in both packages."""
    cfg, jmodel, params, mvars, tmodel = both_models(**CFG)
    rtk = _cams(2)
    args = (rtk[:1], np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32), [1], [0])
    tgt = dict(rtk_target=rtk[1:], frameid_target=[2]) if flow else {}
    jout = j_renderer(jmodel, RS, cfg.ndepth, chunk=CHUNK, with_flow=flow)(
        params, mvars, *[jnp.asarray(a) for a in args],
        **{k: jnp.asarray(v) for k, v in tgt.items()})
    tout = t_renderer(tmodel, RS, cfg.ndepth, chunk=CHUNK, with_flow=flow)(
        *args, draws=_eval_draws(cfg, CHUNK), **tgt)
    assert sorted(tout) == sorted(jout)
    assert ("flo_coarse" in tout) == flow and ("unc_pred" in tout) == flow
    for k in jout:
        assert tout[k].shape == jout[k].shape == (RS, RS, jout[k].shape[-1]), k
        assert _rel(tout[k], jout[k]) <= 1e-4, k


class _Reader:
    """A render_size frame reader for the eval grid's observed columns."""

    def read_raw(self, idx, flowfw=True, dframe=1):
        rng = np.random.default_rng(idx)
        return {"kaug": np.asarray([1.0, 1.0, 0.2, -0.1], np.float32),
                "img": rng.uniform(size=(RS, RS, 3)).astype(np.float32),
                "dp_feat_rsmp": rng.normal(size=(16, RS, RS)).astype(np.float32)}


def _trainer_like(trainer_cls, tmp_path, name, **attrs):
    """The attributes the trainers' eval_renders and _eval_frame_obs read,
    on the shared models (a trainer of its own would draw other
    parameters), with those two methods bound."""
    (tmp_path / name).mkdir()
    tr = types.SimpleNamespace(data_info=INFO, save_dir=str(tmp_path / name), **attrs)
    tr._eval_frame_obs = types.MethodType(trainer_cls._eval_frame_obs, tr)
    return tr


@pytest.mark.parametrize("reader", [False, True])
def test_eval_renders_grid_matches_jax(tmp_path, reader):
    """Both trainers' eval_renders on the same parameters, cameras and
    eval datasets (none: the full raw frame, as the port's train_app has;
    or a reader: observed image, crop kaug and feature error), with the
    uncertainty column."""
    cfg, jmodel, params, mvars, tmodel = both_models(**CFG)
    cfg = cfg.replace(render_size=RS, chunk=CHUNK)
    eval_ds = [types.SimpleNamespace(reader=_Reader())] if reader else None
    lv = {"rtk": np.concatenate([_cams(3)] * 2)[:INFO.num_fr]}
    jtr = _trainer_like(JTrainer, tmp_path, "jax", model=jmodel, params=params, mvars=mvars,
                        cfg=cfg, latest_vars=lv, eval_datasets=eval_ds)
    jpath = JTrainer.eval_renders(jtr, 0)
    from moda_tpu_torch.config import MoDAConfig
    ttr = _trainer_like(TTrainer, tmp_path, "port", model=tmodel, device=tmodel.device,
                        cfg=MoDAConfig.from_json(cfg.to_json()), latest_vars=lv,
                        eval_datasets=eval_ds)
    tpath = TTrainer.eval_renders(ttr, 0)

    jimg = cv2.imread(jpath)[..., ::-1]
    timg = cv2.imread(tpath)[..., ::-1]
    cols = 6 if reader else 4  # [img,] rgb, sil, flow, [feat error,] unc
    assert timg.shape == jimg.shape == (3 * RS, 3 * RS * cols, 3)
    diff = np.abs(timg.astype(int) - jimg.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (diff.max(), (diff == 0).mean())


class _WideReader(_Reader):
    """A reader whose CSE features come at twice render_size, so the grid's
    feature-error column resizes them (bilinear, trainer.py:494)."""

    def read_raw(self, idx, flowfw=True, dframe=1):
        out = super().read_raw(idx, flowfw, dframe)
        rng = np.random.default_rng(100 + idx)
        out["dp_feat_rsmp"] = rng.normal(size=(16, 2 * RS, 2 * RS)).astype(np.float32)
        return out


def test_eval_renders_resizes_the_observed_features(tmp_path):
    """The grid's feature-error column from observed features at twice the
    render size: resized through the port's cv2-semantic resize, the grid
    matches the JAX trainer's (cv2.resize) within one count of 255."""
    cfg, jmodel, params, mvars, tmodel = both_models(**CFG)
    cfg = cfg.replace(render_size=RS, chunk=CHUNK)
    eval_ds = [types.SimpleNamespace(reader=_WideReader())]
    lv = {"rtk": np.concatenate([_cams(3)] * 2)[:INFO.num_fr]}
    jtr = _trainer_like(JTrainer, tmp_path, "jax", model=jmodel, params=params, mvars=mvars,
                        cfg=cfg, latest_vars=lv, eval_datasets=eval_ds)
    jimg = cv2.imread(JTrainer.eval_renders(jtr, 0))[..., ::-1]
    from moda_tpu_torch.config import MoDAConfig
    ttr = _trainer_like(TTrainer, tmp_path, "port", model=tmodel, device=tmodel.device,
                        cfg=MoDAConfig.from_json(cfg.to_json()), latest_vars=lv,
                        eval_datasets=eval_ds)
    timg = cv2.imread(TTrainer.eval_renders(ttr, 0))[..., ::-1]
    assert timg.shape == jimg.shape == (3 * RS, 3 * RS * 6, 3)
    diff = np.abs(timg.astype(int) - jimg.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (diff.max(), (diff == 0).mean())
