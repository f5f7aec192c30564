"""fused_mlp_plain (moda_tpu_torch) against the JAX fused kernel
(moda_tpu.ops.fused_mlp.nerf_mlp_pallas_multi in Pallas interpret mode, as
tests/test_fused_mlp.py runs it on the CPU), at the three init-stage call
site architectures and a per-ray trunk-code case, outputs and gradients
(x, codes, window, every weight).

Tolerances (gradients scaled by the larger of 1 and the leaf's max): fp32
mode against the fp32 kernel, outputs atol/rtol 1e-5 and gradients 2e-4
(the JAX kernel tests use 1e-4 to 2e-4); bf16 mode against the fp32 path,
outputs 3e-2 and gradients 0.3 (the JAX bf16 kernel tests' bounds), and
gradients 1e-2 against the JAX kernel's bf16 mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.core.embedding import window_vec
from moda_tpu.fields.nets import NeRFMLP
from moda_tpu.ops import fused_mlp as FM
from moda_tpu_torch import bridge
from moda_tpu_torch.fields.nets import NeRFMLP as TNeRFMLP
from moda_tpu_torch.ops import fused_mlp as TFM

# name: (nets [(D, W, in_dir, out, raw_feat, use_ct, use_cd)], R, S, ct, cd, need_dx)
CASES = {
    "site1_trunk_feat": ([(8, 256, 27 + 64, 3, False, False, True),
                          (5, 128, 0, 16, True, False, False)], 2, 8, 0, 91, True),
    "site2_feat_grid": ([(5, 128, 0, 16, True, False, False)], 20, 1, 0, 0, False),
    "site3_vis": ([(5, 64, 0, 1, True, False, False)], 24, 1, 0, 0, False),
    "skin_ct": ([(5, 64, 0, 25, True, True, False)], 3, 8, 32, 0, True),
}


# both sides round identically; what is left is fp32 summation order and
# the rare bf16 rounding it flips
BF16_GRAD_TOL = 1e-2


def _setup(name):
    specs, R, S, ct, cd, need_dx = CASES[name]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(R * S, 3)) * 0.3).astype(np.float32)
    ctc = rng.normal(size=(R, ct)).astype(np.float32) if ct else None
    cdc = rng.normal(size=(R, cd)).astype(np.float32) if cd else None
    win = np.asarray(window_vec(10, 3, jnp.asarray(7.3)))
    jnets, tnets = [], []
    for i, (D, W, in_dir, out, raw, use_ct, use_cd) in enumerate(specs):
        in_xyz = 63 + (ct if use_ct else 0)
        mod = NeRFMLP(D=D, W=W, in_channels_xyz=in_xyz, in_channels_dir=in_dir,
                      out_channels=out, raw_feat=raw)
        p = mod.init(jax.random.key(i), jnp.zeros((1, in_xyz + in_dir)))["params"]
        jnets.append(dict(params=p, D=D, in_xyz=in_xyz, in_dir=in_dir, skips=(4,),
                          raw_feat=raw, use_ct=use_ct, use_cd=use_cd))
        tm = TNeRFMLP(D=D, W=W, in_channels_xyz=in_xyz, in_channels_dir=in_dir,
                      out_channels=out, raw_feat=raw)
        bridge.load_params(tm, p)
        tnets.append((tm, use_ct, use_cd))
    cots = [rng.normal(size=(R * S, s[3] + (0 if s[4] else 1))).astype(np.float32)
            for s in specs]
    return specs, S, need_dx, x, ctc, cdc, win, jnets, tnets, cots


def _jax_run(name, cdt):
    specs, S, need_dx, x, ctc, cdc, win, jnets, _, cots = _setup(name)

    def loss(params, x, ctc, cdc, win):
        nets = [dict(n, params=p) for n, p in zip(jnets, params)]
        outs = FM.nerf_mlp_pallas_multi(
            nets, jnp.asarray(x), code_trunk=ctc, code_dir=cdc, samples_per_ray=S,
            need_dx=need_dx, block_points=16, block_points_bwd=16, embed_freqs=10,
            embed_window=win, compute_dtype=cdt)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    args = ([n["params"] for n in jnets], jnp.asarray(x),
            None if ctc is None else jnp.asarray(ctc),
            None if cdc is None else jnp.asarray(cdc), jnp.asarray(win))
    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return outs, grads


def _torch_run(name, cdt):
    specs, S, need_dx, x, ctc, cdc, win, _, tnets, cots = _setup(name)
    tx = torch.tensor(x, requires_grad=True)
    tct = None if ctc is None else torch.tensor(ctc, requires_grad=True)
    tcd = None if cdc is None else torch.tensor(cdc, requires_grad=True)
    twin = torch.tensor(win, requires_grad=True)
    outs = TFM.nerf_mlp_fused(tnets, tx, code_trunk=tct, code_dir=tcd, samples_per_ray=S,
                              need_dx=need_dx, embed_freqs=10, embed_window=twin,
                              compute_dtype=cdt)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots))
    leaves = [tx, twin] + [t for t in (tct, tcd) if t is not None] + \
        [p for m, _, _ in tnets for p in m.parameters()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    named = {"x": grads[0], "win": grads[1]}
    k = 2
    for nm, t in (("ct", tct), ("cd", tcd)):
        if t is not None:
            named[nm] = grads[k]
            k += 1
    for i, (m, _, _) in enumerate(tnets):
        for pn, _ in m.named_parameters():
            named[f"{i}/{pn.replace('.', '/')}"] = grads[k]
            k += 1
    return [o.detach().numpy() for o in outs], named, need_dx


def _jax_named(grads):
    pg, gx, gct, gcd, gwin = grads
    named = {"x": np.asarray(gx), "win": np.asarray(gwin)}
    if gct is not None:
        named["ct"] = np.asarray(gct)
    if gcd is not None:
        named["cd"] = np.asarray(gcd)
    for i, p in enumerate(pg):
        for k, v in bridge.flatten(jax.tree_util.tree_map(np.asarray, p)).items():
            named[f"{i}/{k}"] = v
    return named


def _compare(t_named, j_named, need_dx, tol):
    for k, jg in j_named.items():
        if k == "x" and not need_dx:
            continue
        tg = t_named[k]
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(tg / scale, jg / scale, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fp32_matches_jax_kernel(name):
    j_outs, j_grads = _jax_run(name, jnp.float32)
    t_outs, t_named, need_dx = _torch_run(name, torch.float32)
    for to, jo in zip(t_outs, j_outs):
        np.testing.assert_allclose(to, np.asarray(jo), atol=1e-5, rtol=1e-5)
    _compare(t_named, _jax_named(j_grads), need_dx, 2e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bf16_matches_jax(name):
    """bf16 mode: outputs within 3e-2 of the fp32 path, gradients within
    0.3 of it (the bounds of tests/test_fused_mlp.py for the bf16 kernel),
    and gradients within BF16_GRAD_TOL of the JAX kernel's own bf16 mode,
    which rounds the same operands and cotangents."""
    j_outs, j_grads = _jax_run(name, jnp.float32)
    t_outs, t_named, need_dx = _torch_run(name, torch.bfloat16)
    for to, jo in zip(t_outs, j_outs):
        np.testing.assert_allclose(to, np.asarray(jo), atol=3e-2, rtol=3e-2)
    _compare(t_named, _jax_named(j_grads), need_dx, 0.3)
    _, jb_grads = _jax_run(name, jnp.bfloat16)
    _compare(t_named, _jax_named(jb_grads), need_dx, BF16_GRAD_TOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    """On the CPU the wrapper takes the plain version and launches nothing;
    the kernel route is decided by the tensor's device alone."""
    _, S, need_dx, x, ctc, cdc, win, _, tnets, _ = _setup("site3_vis")
    before = dict(TFM.launches)
    out = TFM.nerf_mlp_fused(tnets, torch.tensor(x), samples_per_ray=S, embed_freqs=10,
                             embed_window=torch.tensor(win), compute_dtype=torch.bfloat16,
                             kernel=True)[0]
    ref = TFM.nerf_mlp_fused(tnets, torch.tensor(x), samples_per_ray=S, embed_freqs=10,
                             embed_window=torch.tensor(win), compute_dtype=torch.bfloat16)[0]
    assert TFM.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
