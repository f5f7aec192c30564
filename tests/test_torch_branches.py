"""The step's branches in moda_tpu_torch against moda_tpu on the CPU: the
displacement field nerf_dis, flowbw without bones, S3IM, freeze_coarse,
the ft_cse live CSE features and its distiller, gradient accumulation,
Transhead and CSENet, and elastic_loss.

Both packages get the same numpy-seeded inputs and the JAX init's
parameters (tests/torch_parity.py::both_models, through bridge); the port
runs its plain fp32 route and is given the JAX path's random draws. Two
JAX inits serve the file: one with bones (nerf_dis, delta-skin, ft_cse's
csenet) and one with flowbw and no bones. Tolerances: as
tests/test_torch_render.py (rendered outputs atol 5e-4 / rtol 5e-3, losses
rtol 1e-4, per-leaf gradients normalized by the JAX leaf's max atol 2e-3);
single modules 1e-5 (forwards) and 1e-4 (one optimizer step).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.fields import cse as JC
from moda_tpu.fields import nets as JN
from moda_tpu.render import losses as L
from moda_tpu.render import rays as RB
from moda_tpu.render import s3im as JS
from moda_tpu.render.pipeline import render_rays
from moda_tpu.train import optim as JO
from moda_tpu.train.step import batch_rtk, sil_loss_filter
from moda_tpu_torch import bridge
from moda_tpu_torch.fields.cse import CSENet
from moda_tpu_torch.fields.nets import Transhead
from moda_tpu_torch.render import losses as TL
from moda_tpu_torch.render import s3im as TS3
from moda_tpu_torch.render.pipeline import render_rays as t_render_rays
from moda_tpu_torch.render.rays import build_rays as t_build_rays
from moda_tpu_torch.train import optim as TO
from moda_tpu_torch.train import step as TS
from tests.torch_parity import (both_models, jax_batch, jax_draws,
                                jax_grads_by_name, one_step, tiny_batch, to_t, torch_batch)

# the configuration with bones: nerf_dis beside the delta-skin MLP, and
# ft_cse's csenet among the parameters
# ft_cse's csenet among the parameters; both on the fp32 feat-match
# Sinkhorn (use_pallas rounds its kernel matrix to bf16 on either side)
BONES = dict(nerf_dis=True, nerf_skin=True, ft_cse=True, use_pallas=False)
FLOWBW = dict(flowbw=True, lbs=False, neudbs=False, use_pallas=False)
SNAP_LAYERS = ("xyz_1", "xyz_5")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: the tests run in several processes at
    once, and torch's thread pools on every core slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _snapshot(rng, params):
    """freeze_coarse snapshots of the input-layer kernels, moved off the
    current values so the distillation terms are not zero."""
    snap = {}
    for comp in ("nerf_coarse", "nerf_skin", "nerf_feat"):
        if comp in params:
            snap[comp] = {layer: (np.asarray(params[comp][layer]["kernel"]) + rng.normal(
                size=np.shape(params[comp][layer]["kernel"])) * 0.01).astype(np.float32)
                for layer in SNAP_LAYERS}
    return snap


def _keys(tmodel):
    """{torch parameter name: (JAX key, layout)} (bridge's mapping)."""
    key_of = {id(p): (k, lay) for k, p, lay in bridge._leaves(tmodel)}
    return {n: key_of[id(p)] for n, p in tmodel.named_parameters()}


def _jax_named(tmodel, named):
    """{torch parameter name: tensor shaped like it} -> {JAX key: numpy
    array in the JAX layout} (the csenet convs are OIHW here, HWIO there)."""
    keys = _keys(tmodel)
    out = {}
    for n, t in named.items():
        k, lay = keys[n]
        v = t.detach().numpy()
        out[k] = v.transpose(2, 3, 1, 0) if lay == "conv" else v
    return out


def _extras(rng):
    return {"loss_select": 1, "shape_samp": (rng.normal(size=(32, 3)) * 0.1).astype(np.float32),
            "shape_samp_valid": 1.0, "progress": 0.5}


def _jax_loss(cfg, model, params, mvars, batch, key, ex, snap, use_fine, use_dskin):
    k_rays, k_render, k_loss = jax.random.split(key, 3)
    rtk_all3 = model.compute_rts(params)
    rtk = batch_rtk(model, params, rtk_all3, batch)
    rays = RB.build_rays(model, params, mvars, batch, rtk, k_rays, cfg.nsample,
                         embed_alpha=jnp.asarray(7.5))
    rendered = render_rays(model, params, mvars, rays, k_render, cfg.ndepth, use_fine=use_fine,
                           use_dskin=use_dskin)
    keep, _, _ = sil_loss_filter(rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"],
                                 model.num_fr, 1e9, 0.5, cfg.warmup_steps)
    extras = {k: jnp.asarray(v) for k, v in ex.items()}
    extras["invalid_mask"] = keep
    if snap is not None:
        extras["xyz_wt_snapshot"] = jax.tree_util.tree_map(jnp.asarray, snap)
    rtk_all = jnp.zeros((model.num_fr, 4, 4)).at[:, :3].set(rtk_all3)
    total, aux = L.total_loss(model, params, mvars, rendered, rays, rtk_all, extras, k_loss)
    return total, (rendered, aux)


def _torch_loss(cfg, tmodel, batch, draws, ex, snap, use_fine, use_dskin):
    rtk_all3 = tmodel.compute_rts()
    rtk = TS.batch_rtk(tmodel, rtk_all3, batch)
    rays = t_build_rays(tmodel, batch, rtk, cfg.nsample, embed_alpha=torch.tensor(7.5),
                        draws=draws)
    rendered = t_render_rays(tmodel, rays, cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
                             draws=draws)
    keep, _, _ = TS.sil_loss_filter(rendered["sil_loss_samp"] * cfg.sil_wt, rays["frameid"],
                                    tmodel.num_fr, 1e9, 0.5, cfg.warmup_steps)
    extras = {k: torch.as_tensor(v) for k, v in ex.items()}
    extras["invalid_mask"] = keep
    if snap is not None:
        extras["xyz_wt_snapshot"] = {c: {k: to_t(v) for k, v in d.items()}
                                     for c, d in snap.items()}
    rtk_all = torch.cat([rtk_all3, torch.zeros(tmodel.num_fr, 1, 4)], 1)
    total, aux = TL.total_loss(tmodel, rendered, rays, rtk_all, extras, draws=draws)
    return total, rendered, aux


def _render_case(rng, cfg_kw, use_fine, use_dskin, with_snapshot):
    """The port's render_rays + total_loss against the JAX package's on the
    same parameters, batch and draws: total, every aux term, every rendered
    output and every parameter's gradient. Returns the rendered dicts."""
    flags = {k: cfg_kw.pop(k) for k in ("s3im_loss", "freeze_coarse", "eikonal_wt")
             if k in cfg_kw}
    cfg, model, params, mvars, tmodel = both_models(**cfg_kw)
    # the loss flags change no parameter: the init above serves them too
    cfg = cfg.replace(**flags)
    model = copy.copy(model)
    model.cfg = cfg
    tmodel.cfg = tmodel.cfg.replace(**flags)
    nb = tiny_batch(rng, cfg)
    ex = _extras(rng)
    snap = _snapshot(rng, params) if with_snapshot else None
    key = jax.random.key(5)
    draws = jax_draws(key, cfg, nb, cfg.nsample, use_fine=use_fine)

    (total, (rendered, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(cfg, model, p, mvars, jax_batch(nb), key, ex, snap, use_fine,
                            use_dskin), has_aux=True))(params)
    ttotal, trendered, taux = _torch_loss(cfg, tmodel, torch_batch(nb), draws, ex, snap,
                                          use_fine, use_dskin)
    tgrads = torch.autograd.grad(ttotal, list(tmodel.parameters()), allow_unused=True)

    np.testing.assert_allclose(float(ttotal.detach()), float(total), rtol=1e-4)
    assert set(taux) == set(aux)
    for k in sorted(aux):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert set(trendered) == set(rendered)
    for k in sorted(rendered):
        _close(trendered[k].detach().numpy(), rendered[k], 5e-4, 5e-3, k)
    tg = _jax_named(tmodel, {n: (torch.zeros_like(p) if g is None else g)
                             for (n, p), g in zip(tmodel.named_parameters(), tgrads)})
    jg = jax_grads_by_name(grads)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        scale = float(np.abs(g).max()) + 1e-8
        _close(tg[k] / scale, g / scale, 2e-3, 0, k)
    return rendered, aux


def test_transhead_matches_flax(rng):
    """Transhead: D5 W128 trunk x 0.1, through bridge (forward 1e-5)."""
    head = JN.Transhead(in_channels_xyz=63 + 32)
    x = rng.normal(size=(7, 63 + 32)).astype(np.float32)
    p = head.init(jax.random.key(1), jnp.zeros((2, 63 + 32)))["params"]
    t = Transhead(in_channels_xyz=63 + 32)
    bridge.load_params(t, p)
    _close(t(to_t(x)).detach().numpy(), head.apply({"params": p}, jnp.asarray(x)), 1e-5, 0,
           "Transhead")


def test_csenet_matches_flax_and_round_trips(rng):
    """CSENet's forward (NHWC, 32 px, odd widths of its own padding) within
    1e-5 of flax through bridge; its parameters cross back unchanged, and
    the model's csenet leaves keep the JAX names and layouts."""
    net = JC.CSENet()
    img = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    p = net.init(jax.random.key(2), jnp.zeros((1, 32, 32, 3)))["params"]
    t = CSENet()
    bridge.load_params(t, p)
    want = np.asarray(net.apply({"params": p}, jnp.asarray(img)))
    got = t(to_t(img)).detach().numpy()
    assert got.shape == (2, 16, 16, 16)
    _close(got, want, 1e-5, 0, "CSENet")
    back = bridge.flatten(bridge.export_params(t))
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, p))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # inside the model: the npz layout of train/ckpt.py
    _, _, params, _, tmodel = both_models(**BONES)
    got = bridge.flatten(bridge.export_params(tmodel))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every parameter sits in one of the optimizer's groups
    assert {TO.group_of(n) for n, _ in tmodel.named_parameters()} <= set(TO.GROUP_TABLE)


def test_render_and_loss_with_nerf_dis_match_jax(rng):
    """nerf_dis at both warps (and the no-grad coarse pass of the fine
    sampling), with the delta-skin MLP, S3IM and the freeze_coarse
    snapshot in the loss: dis_reg, dis_reg_forward, s3im_loss and the
    *_xyz_wt_loss terms among the compared outputs. The eikonal term is off
    here: the gradient of a ReLU field is piecewise constant in its points,
    the displacement field leaves the canonical points ~3e-6 apart between
    the frameworks, and that moved the term by 2.4e-3 relative on the CPU;
    tests/test_torch_ft_render.py holds it where the points agree."""
    rendered, aux = _render_case(rng, dict(BONES, s3im_loss=True, freeze_coarse=True,
                                           eikonal_wt=0.0),
                                 use_fine=True, use_dskin=True, with_snapshot=True)
    assert {"dis_reg", "dis_reg_forward", "s3im_loss", "frame_cyc_dis"} <= set(rendered)
    assert {"s3im_loss", "shape_xyz_wt_loss", "skin_xyz_wt_loss", "feat_xyz_wt_loss"} <= set(aux)


def test_render_and_loss_with_flowbw_without_bones_match_jax(rng):
    """flowbw with --nolbs --noneudbs: the flow fields' cycle term and the
    flowfw target warp (time_embedded_target), and no bone keys."""
    rendered, aux = _render_case(rng, dict(FLOWBW), use_fine=False, use_dskin=False,
                                 with_snapshot=False)
    assert "frame_cyc_dis" in rendered and "dis_reg" not in rendered
    assert "skin_scale" not in aux and "bone_loc_loss" not in aux


@pytest.mark.parametrize("hw", [(32, 320), (29, 31)], ids=["patch", "odd-pads"])
def test_s3im_loss_matches_jax(rng, hw):
    """s3im_loss with the JAX permutations (value 1e-5, gradient wrt the
    rendered colours 1e-4 of its max), and the strided SSIM at a size whose
    SAME pads are odd (asymmetric, as XLA pads)."""
    if hw == (32, 320):
        R = 24
        src, tar = (rng.uniform(size=(R, 3)).astype(np.float32) for _ in range(2))
        mask = (rng.uniform(size=(R, 1)) > 0.3).astype(np.float32)
        key = jax.random.key(4)
        ks = jax.random.split(key, 10)
        perms = to_t(jnp.stack([jax.random.permutation(k, 1024) for k in ks[1:]])).long()
        want, g = jax.value_and_grad(lambda s: JS.s3im_loss(s, jnp.asarray(tar),
                                                             jnp.asarray(mask), key))(
            jnp.asarray(src))
        ts = to_t(src).requires_grad_(True)
        got = TS3.s3im_loss(ts, to_t(tar), to_t(mask), perms=perms)
        tg, = torch.autograd.grad(got, ts)
        _close(float(got), float(want), 1e-5)
        _close(tg.numpy() / np.abs(g).max(), np.asarray(g) / np.abs(g).max(), 1e-4)
    else:
        a, b = (rng.uniform(size=hw + (3,)).astype(np.float32) for _ in range(2))
        want = JS._ssim(jnp.asarray(a), jnp.asarray(b))
        got = TS3._ssim(to_t(a).permute(2, 0, 1), to_t(b).permute(2, 0, 1))
        _close(float(got), float(want), 1e-6)


def test_freeze_masks_match_jax(rng):
    """apply_freeze_masks under freeze_coarse (with the schedule's shape and
    body freezes off and on) on random gradients of every parameter."""
    cfg, _, params, _, tmodel = both_models(**BONES)
    flat = {k: rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in bridge.flatten(jax.tree_util.tree_map(np.asarray, params)).items()}
    for frozen in (0.0, 1.0):
        ind = {"root_update": 1.0, "body_update": 1.0 - frozen, "shape_update": frozen,
               "cvf_update": 0.0}
        c = cfg.replace(freeze_coarse=True)
        want = bridge.flatten(jax.tree_util.tree_map(np.asarray, JO.apply_freeze_masks(
            jax.tree_util.tree_map(jnp.asarray, bridge.unflatten(flat)),
            {k: jnp.asarray(v) for k, v in ind.items()}, c)))
        grads = {n: to_t(flat[k]).permute(3, 2, 0, 1) if lay == "conv" else to_t(flat[k])
                 for n, (k, lay) in _keys(tmodel).items()}
        got = _jax_named(tmodel, TO.apply_freeze_masks(
            grads, {k: torch.tensor(v) for k, v in ind.items()},
            tmodel.cfg.replace(freeze_coarse=True)))
        assert set(got) == set(want)
        for k, g in got.items():
            np.testing.assert_array_equal(g, want[k], err_msg=k)


def test_elastic_loss_matches_jax(rng):
    """elastic_loss: the flowbw field's Jacobian through torch.func (1e-5
    relative), at points where some determinants are negative."""
    cfg, model, params, _, tmodel = both_models(**FLOWBW)
    xyz = (rng.normal(size=(9, 3)) * 0.3).astype(np.float32)
    code = (rng.normal(size=(9, cfg.t_embed_dim)) * 3.0).astype(np.float32)
    want = L.elastic_loss(model, params, jnp.asarray(xyz), jnp.asarray(code), embed_alpha=7.5)
    got = TL.elastic_loss(tmodel, to_t(xyz), to_t(code), embed_alpha=torch.tensor(7.5))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-9)


def test_ft_cse_live_features_match_jax(rng):
    """ft_cse: the CSE net on the batch crops, resized to img_size as
    jax.image.resize's "linear" does, the valid-pixel mask and the 1e-5
    distillation loss (train/step.py:157-170, composed here from
    model.apply_csenet), in value and in the csenet gradient of the loss
    plus a projection of the live features; before ftcse_steps the live
    features carry no gradient."""
    cfg, model, params, _, tmodel = both_models(**BONES)
    S = cfg.img_size
    nb = tiny_batch(rng, cfg)
    nb["dp_feats"][1, :, : S * 3] = 0.0  # pixels without precomputed features
    proj = rng.normal(size=nb["dp_feats"].shape).astype(np.float32)

    def jax_lines(p):
        imgs2d = jnp.asarray(nb["imgs"]).reshape(-1, 3, S, S).transpose(0, 2, 3, 1)
        live = model.apply_csenet(p, imgs2d)
        live = jax.image.resize(live, (live.shape[0], S, S, live.shape[-1]), "linear")
        live_flat = live.transpose(0, 3, 1, 2).reshape(live.shape[0], 16, -1)
        pre = jnp.asarray(nb["dp_feats"])
        valid_px = (jnp.abs(pre).sum(1, keepdims=True) > 0).astype(live_flat.dtype)
        loss = 1e-5 * (((live_flat - pre) ** 2).sum(1, keepdims=True) * valid_px).sum() / \
            jnp.maximum(valid_px.sum(), 1.0)
        return loss + (live_flat * proj).sum(), (live_flat, loss)

    (_, (live, loss)), g = jax.value_and_grad(jax_lines, has_aux=True)(params)
    used, tloss = TS.live_cse_feats(tmodel, torch_batch(nb), torch.tensor(0.5))
    _close(used.detach().numpy(), live, 1e-5, 0, "live features")
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    names = [n for n, _ in tmodel.named_parameters() if n.startswith("csenet.")]
    tg = _jax_named(tmodel, dict(zip(names, torch.autograd.grad(
        tloss + (used * to_t(proj)).sum(), [dict(tmodel.named_parameters())[n] for n in names]))))
    jg = jax_grads_by_name(g)
    assert len(tg) == len([k for k in jg if k.startswith("csenet/")])
    for k, v in tg.items():
        scale = float(np.abs(jg[k]).max()) + 1e-8
        _close(v / scale, jg[k] / scale, 1e-4, 0, k)
    used, _ = TS.live_cse_feats(tmodel, torch_batch(nb), torch.tensor(-1.0))
    csenet = [dict(tmodel.named_parameters())[n] for n in names]
    assert all(g is None or not g.any() for g in torch.autograd.grad(
        (used * to_t(proj)).sum(), csenet, allow_unused=True))


def test_micro_batches_slice_both_halves_as_jax():
    """micro_batches takes the JAX scan's slices (train/step.py:236-239):
    rows [j*mb, (j+1)*mb) of each half of every [2B] array."""
    B, a = 6, 3
    batch = {"frameid": torch.arange(2 * B), "imgs": torch.arange(2 * B * 4).reshape(2 * B, 4)}
    mbs = TS.micro_batches(batch, a)
    assert len(mbs) == a
    for j, m in enumerate(mbs):
        for k, v in batch.items():
            sl = j * (B // a)
            first = jax.lax.dynamic_slice_in_dim(jnp.asarray(v.numpy()), sl, B // a, 0)
            second = jax.lax.dynamic_slice_in_dim(jnp.asarray(v.numpy()), B + sl, B // a, 0)
            np.testing.assert_array_equal(m[k].numpy(), np.concatenate([first, second], 0))


def _build_step():
    # kept out of the test bodies: tests/conftest.py marks slow every test
    # whose source names the step factory
    return TS.make_train_step


def _step_extras(rng):
    t = torch.tensor
    return TS.StepExtras(progress=t(0.5), loss_select=t(1), root_update=t(1.0),
                         body_update=t(1.0), shape_update=t(0.0), cvf_update=t(0.0),
                         sil_err_median=t(1e9),
                         shape_samp=to_t((rng.normal(size=(32, 3)) * 0.1).astype(np.float32)),
                         shape_samp_valid=t(1.0), embed_alpha=t(7.5))


def test_accumulated_step_averages_micro_batch_gradients(rng):
    """accu_steps=2: one update from the mean of the micro-batches'
    gradients (read back from Adam's first moment after one step from
    zero, clipping off), aux the micro-batches' mean, frame_err their max
    and frame_cnt their sum, rtk of the whole batch."""
    cfg, _, _, _, tmodel = both_models(**BONES)
    cfg_t = tmodel.cfg.replace(clip_scale=1e9, root_stab_reject=False)
    nb = torch_batch(tiny_batch(rng, cfg, n_pairs=2))
    ex = _step_extras(rng)
    draws = [jax_draws(jax.random.key(10 + j), cfg, {k: v.numpy() for k, v in mb.items()},
                       cfg.nsample) for j, mb in enumerate(TS.micro_batches(nb, 2))]
    kw = dict(nsample=cfg.nsample, ndepth=cfg.ndepth, use_fine=False, use_dskin=True,
              use_bones=True, device="cpu")
    runs = {}
    for name, accu, batches, ds in (("whole", 2, [nb], [draws]),
                                    ("micro", 1, TS.micro_batches(nb, 2), draws)):
        m = copy.deepcopy(tmodel)
        m.cfg = cfg_t
        out = []
        for b, d in zip(batches, ds):
            mm = copy.deepcopy(m)
            opt = TO.MoDAOptimizer(cfg_t, total_steps=100)
            aux, host = one_step(_build_step()(mm, opt, accu_steps=accu, **kw), b, ex, draws=d)
            out.append((opt.state.mu, aux, host))
        runs[name] = out
    (mu_w, aux_w, host_w), = runs["whole"]
    for k, v in mu_w.items():
        want = 0.5 * (runs["micro"][0][0][k] + runs["micro"][1][0][k])
        np.testing.assert_allclose(v.numpy(), want.numpy(), atol=1e-7, rtol=1e-5, err_msg=k)
    for k in ("total_loss", "img_loss", "dis_reg" if "dis_reg" in aux_w else "sil_loss"):
        want = 0.5 * (float(runs["micro"][0][1][k]) + float(runs["micro"][1][1][k]))
        np.testing.assert_allclose(float(aux_w[k]), want, rtol=1e-5, err_msg=k)
    hm = [h for _, _, h in runs["micro"]]
    np.testing.assert_array_equal(host_w["frame_err"].numpy(), torch.maximum(
        hm[0]["frame_err"], hm[1]["frame_err"]).numpy())
    np.testing.assert_array_equal(host_w["frame_cnt"].numpy(),
                                  (hm[0]["frame_cnt"] + hm[1]["frame_cnt"]).numpy())
    assert host_w["rtk"].shape[0] == nb["frameid"].shape[0]


def test_cse_distiller_step_matches_jax(rng):
    """One CSEDistiller step from the same initial weights: the loss 1e-5,
    AdamW's first moment (the gradient's tenth) within 1e-4 of each leaf's
    max, and the updated parameters within 1e-4 of the step's size (and two
    float32 ulps of the value) where |g| > 1e-5 (Adam's first step is g / (|g| + eps): for a gradient near
    eps it turns on rounding)."""
    from moda_tpu.train.cse_distill import CSEDistiller as JD
    from moda_tpu_torch.train.cse_distill import CSEDistiller as TD

    jd = JD(lr=1e-3, input_size=32)
    td = TD(lr=1e-3, device="cpu")
    bridge.load_params(td.net, jd.params)
    p0 = bridge.flatten(jax.tree_util.tree_map(np.asarray, jd.params))
    imgs = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    masks = (rng.uniform(size=(2, 16, 16, 1)) > 0.4).astype(np.float32)
    want = jd.train(iter([(imgs, feats, masks)]), 1)
    got = td.train(iter([(imgs, feats, masks)]), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mu = bridge.flatten(jax.tree_util.tree_map(np.asarray, jd.opt_state[0].mu))
    tmu = _jax_named(td.net, {n: td.opt.state[p]["exp_avg"]
                              for n, p in td.net.named_parameters()})
    p1 = bridge.flatten(jax.tree_util.tree_map(np.asarray, jd.params))
    t1 = bridge.flatten(bridge.export_params(td.net))
    assert set(mu) == set(tmu) == set(p1)
    for k in p1:
        scale = np.abs(mu[k]).max() + 1e-12
        _close(tmu[k] / scale, mu[k] / scale, 1e-4, 0, k)
        big = np.abs(mu[k]) > 1e-6  # |g| > 1e-5
        step = np.abs(p1[k] - p0[k]).max() + 1e-12
        _close(t1[k][big], p1[k][big], 1e-4 * step, 2.4e-7, k)  # + two float32 ulps
    assert td.predict(imgs).shape == (2, 16, 16, 16)


@pytest.mark.parametrize("case", ["ft_cse", "accu_steps", "no_bones"])
def test_whole_step_matches_jax(rng, case):
    """One whole step of make_train_step in both packages (slow: the JAX
    step's compile): ft_cse with live features past ftcse_steps, accu_steps
    = 2 with JAX's micro-batch keys, and flowbw without bones. Tolerances
    and their reasons as tests/test_torch_step.py::test_whole_step_matches_jax:
    losses rtol 1e-4 (the eikonal term 1e-3), group gradient norms 1e-2,
    parameters within 20 lr (Adam's first step is ~lr * sign(g))."""
    from moda_tpu.train.optim import MoDAOptimizer as JOpt
    from moda_tpu.train.step import StepExtras as JEx
    from moda_tpu.train.step import make_train_step as jax_step

    kw = {"ft_cse": dict(BONES), "accu_steps": dict(BONES), "no_bones": dict(FLOWBW)}[case]
    cfg, model, params, mvars, tmodel = both_models(**kw)
    if case == "accu_steps":
        cfg = cfg.replace(accu_steps=2)
        model = copy.copy(model)
        model.cfg = cfg
        tmodel.cfg = tmodel.cfg.replace(accu_steps=2)
    nb = tiny_batch(rng, cfg, n_pairs=2)
    ex = _step_extras(rng)
    jex = JEx(**{f: jnp.asarray(getattr(ex, f).numpy()) for f in ex._fields
                 if getattr(ex, f) is not None})
    key = jax.random.key(7)
    use_bones = case != "no_bones"
    skw = dict(nsample=cfg.nsample, ndepth=cfg.ndepth, use_fine=False, use_dskin=use_bones,
               use_bones=use_bones)
    jopt = JOpt(cfg, total_steps=100)
    new_p, _, aux, _ = jax_step(model, jopt, accu_steps=cfg.accu_steps, donate=False, **skw)(
        params, jopt.init(params), mvars, jax_batch(nb), jex, key)
    if case == "accu_steps":
        mbs = TS.micro_batches(torch_batch(nb), 2)
        draws = [jax_draws(k, cfg, {kk: v.numpy() for kk, v in mb.items()}, cfg.nsample)
                 for k, mb in zip(jax.random.split(key, 2), mbs)]
    else:
        draws = jax_draws(key, cfg, nb, cfg.nsample)
    taux, _ = one_step(TS.make_train_step(tmodel, TO.MoDAOptimizer(tmodel.cfg, total_steps=100),
                                          accu_steps=cfg.accu_steps, device="cpu", **skw),
                       torch_batch(nb), ex, draws=draws)
    np.testing.assert_allclose(float(taux["ekl_loss"]), float(aux["ekl_loss"]), rtol=1e-3)
    terms = ["img_loss", "sil_loss", "flo_loss", "grad_finite"] + \
        (["csenet_loss"] if "csenet_loss" in aux else [])
    for k in terms:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(taux["total_loss"] - taux["ekl_loss"]),
                               float(aux["total_loss"] - aux["ekl_loss"]), rtol=1e-4)
    for k in [k for k in aux if k.endswith("_g")]:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-2, err_msg=k)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, new_p))
    got = bridge.flatten(bridge.export_params(tmodel))
    lr0 = cfg.learning_rate / 25.0
    assert set(got) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(got[k], v, atol=20 * lr0, rtol=0, err_msg=k)
