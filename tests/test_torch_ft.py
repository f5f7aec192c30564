"""The ft1/ft2 additions of moda_tpu_torch against moda_tpu on the CPU: the
uncertainty MLP in both input layouts, uncertainty-guided active sampling,
the unc loss term, the activation-stash mode of the fused kernel and the
new parameter groups across the bridge (render_rays at the ft2
configuration: tests/test_torch_ft_render.py). Inputs are made from a
numpy seed, parameters are the JAX init bridged into the port, and the JAX
path's random draws are handed to the port (tests/torch_parity.py::jax_draws).

The JAX side runs through its flax modules and, with MODA_FORCE_PALLAS=1
MODA_PALLAS_F32=1, through its Pallas kernels in interpret mode (fp32), as
tests/test_render_pipeline.py::_pallas_parity_case does.

Tolerances: losses and the MLP's outputs rtol 1e-4; gradients per leaf,
normalized by the JAX leaf's max, atol 2e-3 (torch_parity.assert_grads_match).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.render import losses as L
from moda_tpu.render import rays as RB
from moda_tpu.train.step import batch_rtk
from moda_tpu_torch import bridge
from moda_tpu_torch.ops import fused_mlp as TFM
from moda_tpu_torch.render import losses as TL
from moda_tpu_torch.render.rays import build_rays as t_build_rays
from moda_tpu_torch.train import step as TS
from tests.test_torch_fused_mlp import CASES, _compare, _jax_named, _jax_run, _torch_run
from tests.torch_parity import (assert_grads_match, both_models, jax_batch, jax_draws,
                                jax_grads_by_name, tiny_batch, to_t, torch_batch)

FT2_KW = dict(use_unc=True, eikonal_wt=0.1, symm_shape=True, lineload=True)
NS, NA = 2, 2  # ft2's 2 uniform + 2 active pixels per entry


def kernel_route(monkeypatch, route):
    if route == "pallas":
        monkeypatch.setenv("MODA_FORCE_PALLAS", "1")
        monkeypatch.setenv("MODA_PALLAS_F32", "1")


@pytest.mark.parametrize("route", ["flax", "pallas"])
@pytest.mark.parametrize("layout", ["per_point", "code_dir"])
def test_unc_mlp_matches_jax(monkeypatch, route, layout):
    """apply_unc: the candidate scores' layout (embedded xyt and the video
    code concatenated per point) and the prediction's (raw xyt embedded in
    the launch, the video code as code_dir)."""
    kernel_route(monkeypatch, route)
    _, model, params, _, tmodel = both_models(use_unc=True)
    rng = np.random.default_rng(5)
    n = 12
    xyt = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    vid = rng.normal(size=(n, 32)).astype(np.float32)
    alpha = 7.3

    def jfn(p, xyt, vid):
        if layout == "per_point":
            x = jnp.concatenate([model.embed_xyz(xyt, alpha), vid], -1)
            return model.apply_unc(p, x)
        return model.apply_unc(p, xyt, code_dir=vid, embed_raw=True, embed_alpha=alpha)

    cot = rng.normal(size=(n, 1)).astype(np.float32)

    @jax.jit
    def jrun(p, xyt, vid, cot):
        out, vjp = jax.vjp(jfn, p, xyt, vid)
        return out, vjp(cot)

    jout, (jg, jgx, jgv) = jrun(params, jnp.asarray(xyt), jnp.asarray(vid), jnp.asarray(cot))

    txyt, tvid = to_t(xyt).requires_grad_(True), to_t(vid).requires_grad_(True)
    if layout == "per_point":
        tout = tmodel.apply_unc(torch.cat([tmodel.embed_xyz(txyt, alpha), tvid], -1))
    else:
        tout = tmodel.apply_unc(txyt, code_dir=tvid, embed_raw=True, embed_alpha=alpha)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-6)
    leaves = [txyt, tvid] + list(tmodel.nerf_unc.parameters())
    # raw_feat: the sigma head is not in the graph, as in JAX (zero gradient)
    tg = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad((tout * to_t(cot)).sum(), leaves, allow_unused=True))]
    for t, j in zip(tg[:2], (jgx, jgv)):
        scale = float(np.abs(np.asarray(j)).max()) + 1e-8
        np.testing.assert_allclose(t.numpy() / scale, np.asarray(j) / scale, atol=2e-3)
    named = {f"nerf_unc.{n}": g for (n, _), g in zip(tmodel.nerf_unc.named_parameters(),
                                                     tg[2:])}
    assert_grads_match(jax_grads_by_name(jg), named)


def test_build_rays_active_sampling_matches_jax():
    """nsample_active=2: the same candidate pool (JAX's cand_ids) gives the
    same top-k selection, ray order and per-ray unc fields."""
    cfg, model, params, mvars, tmodel = both_models(**FT2_KW)
    nb = tiny_batch(np.random.default_rng(1), cfg, lineload=True)
    key = jax.random.key(6)
    k_rays = jax.random.split(key, 3)[0]
    rtk = batch_rtk(model, params, model.compute_rts(params), jax_batch(nb))
    jrays = jax.jit(lambda p, b: RB.build_rays(model, p, mvars, b, rtk, k_rays, NS,
                                               nsample_active=NA,
                                               embed_alpha=jnp.asarray(7.5)))(params,
                                                                             jax_batch(nb))
    draws = jax_draws(key, cfg, nb, NS, NA, use_fine=True)
    tb = torch_batch(nb)
    trtk = TS.batch_rtk(tmodel, tmodel.compute_rts(), tb)
    trays = t_build_rays(tmodel, tb, trtk, NS, nsample_active=NA,
                         embed_alpha=torch.tensor(7.5), draws=draws)
    assert set(trays) == set(jrays)
    assert trays["xys"].shape[0] == 2 * 2 * (NS + NA)
    for k in sorted(jrays):
        np.testing.assert_allclose(trays[k].detach().numpy(), np.asarray(jrays[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_unc_loss_term_matches_jax():
    """total_loss with use_unc: the unc head regresses the detached masked
    photometric error; the term and its gradient wrt unc_pred."""
    cfg, model, params, mvars, tmodel = both_models(use_unc=True)
    rng = np.random.default_rng(9)
    R = 10

    def u(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    rendered = {"img_loss_samp": u(R, 1), "sil_loss_samp": u(R, 1), "sil_at_samp_flo": u(R, 1),
                "sil_coarse": u(R, 1), "frnd_loss_samp": u(R, 1), "flo_loss_samp": u(R, 1),
                "feat_err": u(R, 1), "proj_err": u(R, 1), "unc_pred": u(R, 1)}
    rays = {"sil_at_samp": (u(R, 1) > 0.3).astype(np.float32),
            "vis_at_samp": np.ones((R, 1), np.float32)}
    extras = {"loss_select": 1, "invalid_mask": (u(R, 1) > 0.2).astype(np.float32),
              "progress": 0.5}
    rtk_all = np.zeros((model.num_fr, 4, 4), np.float32)

    def jloss(unc):
        rj = {k: jnp.asarray(v) for k, v in rendered.items()}
        rj["unc_pred"] = unc
        return L.total_loss(model, params, mvars, rj, {k: jnp.asarray(v) for k, v in rays.items()},
                            jnp.asarray(rtk_all), {k: jnp.asarray(v) for k, v in extras.items()},
                            jax.random.key(0))

    (total, aux), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(rendered["unc_pred"]))
    rt = {k: to_t(v) for k, v in rendered.items()}
    rt["unc_pred"].requires_grad_(True)
    ttotal, taux = TL.total_loss(tmodel, rt, {k: to_t(v) for k, v in rays.items()},
                                 to_t(rtk_all), {k: torch.as_tensor(v) for k, v in extras.items()})
    assert float(taux["unc_loss"].detach()) > 0
    for k in ("unc_loss", "total_loss", "img_loss"):
        np.testing.assert_allclose(float(taux[k].detach()), float(aux[k]), rtol=1e-5, err_msg=k)
    tg, = torch.autograd.grad(ttotal, rt["unc_pred"])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_stash_kernel(monkeypatch, name):
    """MODA_PALLAS_STASH=1: the JAX kernel's stash route (the forward writes
    the activation stack, the backward reads it) against the port's plain
    version, which is the plain version of K1s/K2s as well; on the CPU the
    port's wrapper still launches nothing."""
    monkeypatch.setenv("MODA_PALLAS_STASH", "1")
    assert TFM.stash_enabled()
    j_outs, j_grads = _jax_run(name, jnp.float32)
    before = dict(TFM.launches)
    t_outs, t_named, need_dx = _torch_run(name, torch.float32)
    assert TFM.launches == before
    for to, jo in zip(t_outs, j_outs):
        np.testing.assert_allclose(to, np.asarray(jo), atol=1e-5, rtol=1e-5)
    _compare(t_named, _jax_named(j_grads), need_dx, 2e-4)


def test_ft_leaves_cross_the_bridge_both_ways():
    """nerf_unc, vid_code and nerf_skin move from the JAX tree into the port
    and back unchanged."""
    _, _, params, _, tmodel = both_models(use_unc=True)
    back = bridge.flatten(bridge.export_params(tmodel))
    src = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    for group in ("nerf_unc", "vid_code", "nerf_skin"):
        keys = [k for k in src if k.split("/")[0] == group]
        assert keys and set(keys) == {k for k in back if k.split("/")[0] == group}
        for k in keys:
            np.testing.assert_array_equal(back[k], src[k], err_msg=k)
