"""Shared helpers for the tests that hold moda_tpu_torch against moda_tpu.

Both packages get the same inputs (numpy, from a seed) and the same
parameters (the JAX init, copied into the port through
moda_tpu_torch.bridge); JAX runs on the CPU, the port on the CPU in fp32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moda_tpu.config import DataInfo, MoDAConfig
from moda_tpu.fields.model import MoDAModel
from moda_tpu.render import rays as RB
from moda_tpu_torch import bridge
from moda_tpu_torch.config import MoDAConfig as TMoDAConfig
from moda_tpu_torch.fields.model import MoDAModel as TMoDAModel

INIT_KW = dict(num_bones=3, img_size=16, nsample=4, ndepth=8, use_unc=False,
               feat_ndepth_grid=4, eikonal_wt=0.001)
INFO = DataInfo(offset=(0, 6), intrinsics=((20.0, 20.0, 8.0, 8.0),))


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_init(cfg_json: str):
    # JAX arrays are immutable, so one init (a jit compile of its own) serves
    # every test of a process that asks for the same configuration
    cfg = MoDAConfig.from_json(cfg_json)
    model = MoDAModel(cfg, INFO)
    params, mvars = model.init(jax.random.key(0))
    return cfg, model, params, mvars


def both_models(**cfg_kw):
    """(jax cfg, jax model, jax params, jax mvars, torch model) with a fresh
    port model whose parameters are copied from the JAX init."""
    kw = dict(INIT_KW)
    kw.update(cfg_kw)
    cfg, model, params, mvars = _jax_init(MoDAConfig(**kw).to_json())
    tcfg = TMoDAConfig.from_json(cfg.to_json())
    from moda_tpu_torch.config import DataInfo as TDataInfo
    tmodel = TMoDAModel(tcfg, TDataInfo(offset=INFO.offset, intrinsics=INFO.intrinsics),
                        device="cpu")
    bridge.load_params(tmodel, params)
    bridge.load_mvars(tmodel, mvars)
    return cfg, model, params, mvars, tmodel


def tiny_batch(rng, cfg, n_pairs=2, lineload=False):
    """numpy batch (the layout of tests/test_render_pipeline.py)."""
    P = cfg.img_size if lineload else cfg.img_size * cfg.img_size
    bs2 = 2 * n_pairs

    def img(c):
        return rng.uniform(size=(bs2, c, P)).astype(np.float32)

    fid = np.asarray([0, 2, 1, 3][:n_pairs] + [1, 3, 2, 4][:n_pairs], np.int32)
    batch = {
        "imgs": img(3), "masks": (img(1) > 0.5).astype(np.float32),
        "vis2d": np.ones((bs2, 1, P), np.float32), "flow": img(2) * 0.1, "occ": img(1),
        "dp_feats": img(16), "kaug": np.tile(np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32),
                                             (bs2, 1)),
        "frameid": fid, "frameid_sub": fid, "dataid": np.zeros((bs2,), np.int32),
    }
    if lineload:
        batch["lineid"] = rng.integers(0, cfg.img_size, size=bs2).astype(np.int32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v))
            for k, v in batch.items()}


def jax_draws(key, cfg, batch, nsample: int, nsample_active: int = 0, use_fine: bool = False):
    """Replay the JAX key-split tree of one step (train/step.py:141,
    render/rays.py:130 and :153, render/pipeline.py:521, :290 of both
    inference_deform passes, sampling.sample_pdf, losses eikonal) and return
    the draws it makes, as torch tensors for the port."""
    bs2 = batch["frameid"].shape[0]
    R, S, G = bs2 * (nsample + nsample_active), cfg.ndepth, cfg.feat_ndepth_grid
    S0 = S // 2 if use_fine else S
    k_rays, k_render, k_loss = jax.random.split(key, 3)
    k_px, k_act = jax.random.split(k_rays)
    lineid = batch.get("lineid")
    lineid = None if lineid is None else jnp.asarray(lineid)
    draws = {"pix_ids": RB.sample_pixel_ids(k_px, bs2, nsample, cfg.img_size, lineid)}
    if nsample_active:
        draws["cand_ids"] = RB.sample_pixel_ids(k_act, bs2, 4 * (nsample + nsample_active),
                                                cfg.img_size, lineid)
    kr = jax.random.split(k_render, 4)
    draws["z_u"] = jax.random.uniform(kr[0], (R, S0))
    if use_fine:
        kc = jax.random.split(kr[1], 6)
        draws["coarse_symm_u"] = jax.random.uniform(kc[0], (R, S0, 1))
        draws["coarse_sigma_noise"] = jax.random.normal(kc[1], (R, S0))
        draws["pdf_u"] = jax.random.uniform(kr[2], (R, S0))
    kd = jax.random.split(kr[3], 6)
    draws.update({
        "symm_u": jax.random.uniform(kd[0], (R, S, 1)),
        "sigma_noise": jax.random.normal(kd[1], (R, S)),
        "grid_noise": jax.random.normal(kd[2], (G ** 3, 3)),
        "vis_neg": jax.random.uniform(kd[3], (R, S, 3), minval=-1.0, maxval=1.0),
        "eik_idx": jax.random.randint(k_loss, (1000,), 0, R * S),
    })
    out = {k: to_t(v) for k, v in draws.items()}
    for k in ("pix_ids", "cand_ids", "eik_idx"):
        if k in out:
            out[k] = out[k].long()
    return out


def jax_grads_by_name(grads) -> dict:
    return bridge.flatten(jax.tree_util.tree_map(np.asarray, grads))


def assert_grads_match(jax_flat: dict, torch_named: dict, groups=None, atol=2e-3):
    """Per-leaf gradients, each normalized by the JAX leaf's max."""
    for name, gt in torch_named.items():
        key = name.replace(".", "/")
        if groups is not None and key.split("/")[0] not in groups:
            continue
        gr = jax_flat[key]
        scale = float(np.abs(gr).max()) + 1e-8
        np.testing.assert_allclose(gt.detach().numpy() / scale, gr / scale, atol=atol,
                                   err_msg=key)
