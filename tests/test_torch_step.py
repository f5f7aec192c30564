"""The port's optimizer chain and train step against moda_tpu's.

- the same gradients through reject_nonfinite, apply_freeze_masks,
  clip_by_group and the Adam + one-cycle update of both packages: the
  parameters, moments and count after two updates (rtol 1e-5, atol 1e-7);
- the line-level silhouette filter and its masked median;
- one whole step through both make_train_step functions (auto-marked slow
  by tests/conftest.py), with the JAX step's random draws given to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.train import optim as JO
from moda_tpu.train import step as JS
from moda_tpu_torch import bridge
from moda_tpu_torch.train import optim as TO
from moda_tpu_torch.train import step as TS
from tests.torch_parity import (both_models, jax_batch, jax_draws, one_step, tiny_batch,
                                torch_batch)


def _flat_params(tmodel):
    return {n: p.detach().clone() for n, p in tmodel.named_parameters()}


def _jax_chain(opt, grads, state, params, cfg, ind):
    grads, finite = JO.reject_nonfinite(grads)
    grads = JO.apply_freeze_masks(grads, ind, cfg)
    grads, norms = JO.clip_by_group(grads, cfg.clip_scale)
    new_p, new_s = opt.update(grads, state, params)
    new_p = jax.tree_util.tree_map(lambda n, o: jnp.where(finite, n, o), new_p, params)
    return new_p, new_s, norms


def _torch_chain(opt, grads, state, params, cfg, ind):
    grads, finite = TO.reject_nonfinite(grads)
    grads = TO.apply_freeze_masks(grads, ind, cfg)
    grads, norms = TO.clip_by_group(grads, cfg.clip_scale)
    new_p, new_s = opt.update(grads, state, params, finite)
    return new_p, new_s, norms


@pytest.mark.parametrize("body_update", [1.0, 0.0])
def test_optimizer_chain_matches_jax(body_update):
    cfg, _, params, _, tmodel = both_models()
    rng = np.random.default_rng(11)
    tparams = _flat_params(tmodel)
    jopt, topt = JO.MoDAOptimizer(cfg, 50), TO.MoDAOptimizer(cfg, 50)
    jstate, tstate = jopt.init(params), topt.init(tparams)
    ind = {"root_update": 1.0, "body_update": body_update, "shape_update": 0.0,
           "cvf_update": 0.0}
    for it in range(2):
        # group scales chosen so some groups clip and others do not
        g = {k: (rng.normal(size=v.shape) * (30.0 if k.startswith("nerf_coarse") else 0.01))
             .astype(np.float32) for k, v in bridge.flatten(
                 jax.tree_util.tree_map(np.asarray, params)).items()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, bridge.unflatten(g))
        tgrads = {n: torch.tensor(g[n.replace(".", "/")]) for n in tparams}
        jind = {k: jnp.asarray(v) for k, v in ind.items()}
        tind = {k: torch.tensor(v) for k, v in ind.items()}
        params, jstate, jnorms = _jax_chain(jopt, jgrads, jstate, params, cfg, jind)
        tparams, tstate, tnorms = _torch_chain(topt, tgrads, tstate, tparams, cfg, tind)
        for k, v in jnorms.items():
            np.testing.assert_allclose(float(tnorms[k]), float(v), rtol=1e-5, err_msg=k)
    jp = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    jmu = bridge.flatten(jax.tree_util.tree_map(np.asarray, jstate.adam.mu))
    jnu = bridge.flatten(jax.tree_util.tree_map(np.asarray, jstate.adam.nu))
    assert int(tstate.count) == int(jstate.count) == 2
    for n in tparams:
        k = n.replace(".", "/")
        np.testing.assert_allclose(tparams[n].numpy(), jp[k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.mu[n].numpy(), jmu[k], rtol=1e-5, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(tstate.nu[n].numpy(), jnu[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)


def test_nonfinite_step_keeps_params_and_moments():
    """A step with a non-finite gradient keeps the old parameters, the old
    Adam moments and the count (the JAX step keeps the parameters only)."""
    cfg = TO.MoDAOptimizer.__init__.__globals__  # noqa: F841  (module import check)
    from moda_tpu_torch.config import MoDAConfig
    opt = TO.MoDAOptimizer(MoDAConfig(), 10)
    params = {"nerf_coarse.a": torch.ones(3), "bones": torch.ones(2)}
    state = opt.init(params)
    p1, s1 = opt.update({k: torch.full_like(v, 0.5) for k, v in params.items()}, state, params,
                        torch.tensor(True))
    bad = {"nerf_coarse.a": torch.tensor([1.0, float("nan"), 0.0]), "bones": torch.ones(2)}
    g, finite = TO.reject_nonfinite(bad)
    assert not bool(finite)
    p2, s2 = opt.update(g, s1, p1, finite)
    assert int(s2.count) == int(s1.count) == 1
    for k in params:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=0)
        torch.testing.assert_close(s2.mu[k], s1.mu[k], rtol=0, atol=0)
        torch.testing.assert_close(s2.nu[k], s1.nu[k], rtol=0, atol=0)


def test_onecycle_schedule_matches_jax():
    js, ts = JO.onecycle_lr(1e-3, 1000, 10), TO.onecycle_lr(1e-3, 1000, 10)
    for s in (0, 1, 199, 200, 201, 600, 1000, 1200):
        np.testing.assert_allclose(float(ts(s)), float(js(s)), rtol=1e-6)


def test_loss_filters_match_jax():
    rng = np.random.default_rng(2)
    num_fr, img, R = 6, 16, 40
    err = (rng.uniform(size=(R, 1)) * (rng.uniform(size=(R, 1)) > 0.3)).astype(np.float32)
    err[:5] *= 50.0  # one hot frame
    frameid = rng.integers(0, num_fr, R).astype(np.int32)
    frameid[:5] = 2
    errid = (frameid * img + rng.integers(0, img, R)).astype(np.int32)
    errid[-1] = num_fr * img + 3  # out of range: dropped, as segment_sum drops it
    j = JS.sil_loss_filter_line(jnp.asarray(err), jnp.asarray(errid), jnp.asarray(frameid),
                                num_fr, img, 0.5, 0.4)
    t = TS.sil_loss_filter_line(torch.tensor(err), torch.tensor(errid).long(),
                                torch.tensor(frameid).long(), num_fr, img, 0.5, 0.4)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    j = JS.sil_loss_filter(jnp.asarray(err), jnp.asarray(frameid), num_fr, 0.05, 0.5, 0.4)
    t = TS.sil_loss_filter(torch.tensor(err), torch.tensor(frameid).long(), num_fr, 0.05,
                           0.5, 0.4)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    for n in (0, 1, 4, 7):
        x = rng.uniform(size=9).astype(np.float32)
        m = np.zeros(9, bool)
        m[rng.choice(9, n, replace=False)] = True
        np.testing.assert_allclose(float(TS.masked_median(torch.tensor(x), torch.tensor(m))),
                                   float(JS.masked_median(jnp.asarray(x), jnp.asarray(m))))


def test_whole_step_matches_jax(rng):
    """One init-stage step through both make_train_step functions."""
    cfg, model, params, mvars, tmodel = both_models(lineload=True)
    nb = tiny_batch(rng, cfg, lineload=True)
    ex_np = dict(progress=0.5, loss_select=1, root_update=1.0, body_update=1.0,
                 shape_update=0.0, cvf_update=0.0, sil_err_median=1e9,
                 shape_samp=(rng.normal(size=(32, 3)) * 0.1).astype(np.float32),
                 shape_samp_valid=1.0, embed_alpha=10.0)
    jopt = JO.MoDAOptimizer(cfg, total_steps=100)
    jstep = JS.make_train_step(model, jopt, nsample=cfg.nsample, ndepth=cfg.ndepth,
                               use_fine=False, use_dskin=False, use_bones=True, donate=False)
    key = jax.random.key(4)
    jp, _, jaux, _ = jstep(params, jopt.init(params), mvars, jax_batch(nb),
                           JS.StepExtras(**{k: jnp.asarray(v) for k, v in ex_np.items()}), key)
    topt = TO.MoDAOptimizer(cfg, total_steps=100)
    tstep = TS.make_train_step(tmodel, topt, nsample=cfg.nsample, ndepth=cfg.ndepth,
                               use_fine=False, use_dskin=False, use_bones=True, device="cpu")
    taux, _ = one_step(tstep, torch_batch(nb), TS.StepExtras(**{k: torch.tensor(v)
                                                                 for k, v in ex_np.items()}),
                       draws=jax_draws(key, cfg, nb, cfg.nsample))
    for k in ("total_loss", "img_loss", "sil_loss", "flo_loss", "grad_finite"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    # Tolerances with reasons. The skinning softmax (logits x -1000 e^ls)
    # leaves ~1e-5 relative differences in the canonical points between
    # the frameworks' fp32 summation orders; the eikonal term differentiates
    # 2^9-frequency features there (1e-3), and the camera and pose gradients
    # reach the points through the flow reprojection's perspective division
    # (1e-2 on their group norms).
    np.testing.assert_allclose(float(taux["ekl_loss"]), float(jaux["ekl_loss"]), rtol=1e-3)
    for k in ("nerf_coarse_g", "nerf_feat_g", "nerf_root_rts_g", "pose_code_g",
              "nerf_body_rts_g", "bones_g"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-2, err_msg=k)
    # Adam's first step is ~lr * sign(g): a gradient within rounding of 0 can
    # take either sign, so parameters agree to within 2 lr x the group's LR
    # multiplier (10 at most)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jp))
    lr0 = cfg.learning_rate / 25.0
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n.replace(".", "/")],
                                   atol=20 * lr0, rtol=0, err_msg=n)


# (cfg overrides, nsample, nsample_active, use_fine) of bench.py's ft1 and
# ft2 stages at the tiny widths; both run the delta-skin MLP
FT_STAGES = {
    "ft1": (dict(lineload=True, nsample=3, freeze_proj=True, eikonal_wt=0.0), 3, 0, False),
    "ft2": (dict(lineload=True, use_unc=True, eikonal_wt=0.1), 2, 2, True),
}


@pytest.mark.parametrize("stage", sorted(FT_STAGES))
def test_whole_step_matches_jax_ft(rng, stage):
    """One ft1 / ft2 step through both make_train_step functions, with the
    JAX step's draws (candidate pool, fine-pass and both passes' draws)
    given to the port. Tolerances and their reasons as in
    test_whole_step_matches_jax."""
    kw, ns, na, use_fine = FT_STAGES[stage]
    cfg, model, params, mvars, tmodel = both_models(**kw)
    nb = tiny_batch(rng, cfg, lineload=True)
    ex_np = dict(progress=0.5, loss_select=1, root_update=1.0, body_update=1.0,
                 shape_update=0.0, cvf_update=0.0, sil_err_median=1e9,
                 shape_samp=(rng.normal(size=(32, 3)) * 0.1).astype(np.float32),
                 shape_samp_valid=1.0, embed_alpha=10.0)
    jopt = JO.MoDAOptimizer(cfg, total_steps=100)
    jstep = JS.make_train_step(model, jopt, nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine,
                               use_dskin=True, use_bones=True, nsample_active=na, donate=False)
    # at random weights some keys send a predicted point to within a hair of
    # the camera plane, where the reprojection's perspective division makes
    # the pose and skin gradients ill-conditioned in both packages (proj_err
    # in the thousands): this key keeps every reprojection in the image
    key = jax.random.key(3)
    jp, _, jaux, _ = jstep(params, jopt.init(params), mvars, jax_batch(nb),
                           JS.StepExtras(**{k: jnp.asarray(v) for k, v in ex_np.items()}), key)
    topt = TO.MoDAOptimizer(cfg, total_steps=100)
    tstep = TS.make_train_step(tmodel, topt, nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine,
                               use_dskin=True, use_bones=True, nsample_active=na, device="cpu")
    taux, _ = one_step(tstep, torch_batch(nb), TS.StepExtras(**{k: torch.tensor(v)
                                                                 for k, v in ex_np.items()}),
                       draws=jax_draws(key, cfg, nb, ns, na, use_fine=use_fine))
    terms = ["img_loss", "sil_loss", "flo_loss", "proj_loss", "grad_finite"]
    if stage == "ft2":
        # eikonal 0.1 at the full frequency window makes the eikonal term
        # most of the loss (|grad sdf| ~ 15 at random weights): ~1e-6 of
        # canonical-point difference moves 2^9-frequency features by ~5e-4
        # rad, so that term is held at 2e-3 and the rest of the loss at 1e-4
        terms.append("unc_loss")
        np.testing.assert_allclose(float(taux["ekl_loss"]), float(jaux["ekl_loss"]), rtol=2e-3)
        np.testing.assert_allclose(float(taux["total_loss"] - taux["ekl_loss"]),
                                   float(jaux["total_loss"] - jaux["ekl_loss"]), rtol=1e-4)
    else:
        terms.append("total_loss")
    for k in terms:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    groups = ["nerf_coarse_g", "nerf_feat_g", "nerf_skin_g", "nerf_root_rts_g", "pose_code_g",
              "nerf_body_rts_g", "bones_g"] + (["nerf_unc_g"] if stage == "ft2" else [])
    for k in groups:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-2, err_msg=k)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jp))
    lr0 = cfg.learning_rate / 25.0
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n.replace(".", "/")],
                                   atol=20 * lr0, rtol=0, err_msg=n)
