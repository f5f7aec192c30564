"""build_rays -> render_rays -> total_loss of moda_tpu_torch against moda_tpu
at the init-stage configuration (tiny widths of the render tests, fp32,
JAX parameters bridged into the port, the JAX path's random draws passed
to the port).

Tolerances mirror the JAX package's kernel-route parity case
(tests/test_render_pipeline.py::_pallas_parity_case): rendered outputs
atol 5e-4 / rtol 5e-3, loss rtol 1e-4, per-leaf gradients normalized by
the leaf's max atol 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.render import losses as L
from moda_tpu.render import rays as RB
from moda_tpu.render.pipeline import render_rays
from moda_tpu.train.step import batch_rtk, sil_loss_filter, sil_loss_filter_line
from moda_tpu_torch.render import losses as TL
from moda_tpu_torch.render.pipeline import render_rays as t_render_rays
from moda_tpu_torch.render.rays import build_rays as t_build_rays
from moda_tpu_torch.train import step as TS
from tests.torch_parity import (assert_grads_match, both_models, jax_batch, jax_draws,
                                jax_grads_by_name, tiny_batch, torch_batch)

GROUPS = ["nerf_coarse", "nerf_feat", "nerf_vis", "nerf_beta", "nerf_beta_feat", "bones",
          "skin_aux", "pose_code", "rest_pose_code", "nerf_body_rts", "env_code",
          "nerf_root_rts", "ks_param"]


def _extras(rng, R):
    return {"loss_select": 1, "shape_samp": (rng.normal(size=(32, 3)) * 0.1).astype(np.float32),
            "shape_samp_valid": 1.0, "progress": 0.5}


def _jax_loss(cfg, model, params, mvars, batch, key, ex, lineload):
    k_rays, k_render, k_loss = jax.random.split(key, 3)
    rtk_all3 = model.compute_rts(params)
    rtk = batch_rtk(model, params, rtk_all3, batch)
    rays = RB.build_rays(model, params, mvars, batch, rtk, k_rays, cfg.nsample,
                         embed_alpha=jnp.asarray(7.5))
    rendered = render_rays(model, params, mvars, rays, k_render, cfg.ndepth)
    if lineload:
        keep, _, _ = sil_loss_filter_line(rendered["sil_loss_samp"] * cfg.sil_wt, rays["errid"],
                                          rays["frameid"], model.num_fr, cfg.img_size, 0.5,
                                          cfg.warmup_steps)
    else:
        keep, _, _ = sil_loss_filter(rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"],
                                     model.num_fr, 1e9, 0.5, cfg.warmup_steps)
    extras = {k: jnp.asarray(v) for k, v in ex.items()}
    extras["invalid_mask"] = keep
    rtk_all = jnp.zeros((model.num_fr, 4, 4)).at[:, :3].set(rtk_all3)
    total, aux = L.total_loss(model, params, mvars, rendered, rays, rtk_all, extras, k_loss)
    return total, (rendered, aux)


def _torch_loss(cfg, tmodel, batch, draws, ex, lineload):
    rtk_all3 = tmodel.compute_rts()
    rtk = TS.batch_rtk(tmodel, rtk_all3, batch)
    rays = t_build_rays(tmodel, batch, rtk, cfg.nsample, embed_alpha=torch.tensor(7.5),
                        draws=draws)
    rendered = t_render_rays(tmodel, rays, cfg.ndepth, draws=draws)
    if lineload:
        keep, _, _ = TS.sil_loss_filter_line(rendered["sil_loss_samp"] * cfg.sil_wt,
                                             rays["errid"], rays["frameid"], tmodel.num_fr,
                                             cfg.img_size, 0.5, cfg.warmup_steps)
    else:
        keep, _, _ = TS.sil_loss_filter(rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"],
                                        tmodel.num_fr, 1e9, 0.5, cfg.warmup_steps)
    extras = {k: torch.as_tensor(v) for k, v in ex.items()}
    extras["invalid_mask"] = keep
    rtk_all = torch.cat([rtk_all3, torch.zeros(tmodel.num_fr, 1, 4)], 1)
    total, aux = TL.total_loss(tmodel, rendered, rays, rtk_all, extras, draws=draws)
    return total, rendered, aux


@pytest.mark.parametrize("lineload,use_pallas", [(False, False), (True, False), (False, True)],
                         ids=["batch", "lineload", "batch-bf16-sinkhorn"])
def test_render_and_loss_match_jax(rng, lineload, use_pallas):
    """use_pallas=True also rounds the feat-match Sinkhorn's K to bf16 on
    both sides (that flag keys it on any device; the MLPs stay fp32 on the
    CPU). Its bf16 cotangents add up in another order in each framework,
    which reaches only nerf_feat: that group is held at 5e-3 there."""
    cfg, model, params, mvars, tmodel = both_models(lineload=lineload, use_pallas=use_pallas)
    nb = tiny_batch(rng, cfg, lineload=lineload)
    ex = _extras(rng, None)
    key = jax.random.key(3)
    draws = jax_draws(key, cfg, nb, cfg.nsample)

    (total, (rendered, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(cfg, model, p, mvars, jax_batch(nb), key, ex, lineload),
        has_aux=True))(params)

    ttotal, trendered, taux = _torch_loss(cfg, tmodel, torch_batch(nb), draws, ex, lineload)
    names = [n for n, _ in tmodel.named_parameters()]
    tgrads = torch.autograd.grad(ttotal, [p for _, p in tmodel.named_parameters()],
                                 allow_unused=True)

    np.testing.assert_allclose(float(ttotal.detach()), float(total), rtol=1e-4)
    for k in sorted(aux):
        if k in taux:
            np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert set(trendered) == set(rendered)
    for k in sorted(rendered):
        np.testing.assert_allclose(trendered[k].detach().numpy(), np.asarray(rendered[k]),
                                   atol=5e-4, rtol=5e-3, err_msg=k)
    tg = {n: (torch.zeros_like(p) if g is None else g)
          for (n, p), g in zip(tmodel.named_parameters(), tgrads)}
    assert len(tg) == len(names)
    jg = jax_grads_by_name(grads)
    if use_pallas:
        assert_grads_match(jg, tg, groups=[g for g in GROUPS if g != "nerf_feat"], atol=2e-3)
        assert_grads_match(jg, tg, groups=["nerf_feat"], atol=5e-3)
    else:
        assert_grads_match(jg, tg, groups=GROUPS, atol=2e-3)
