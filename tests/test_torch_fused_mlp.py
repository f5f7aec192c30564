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
import ctypes
import re

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


@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("S", [1, 64, 128])
def test_bwd_geometry_matches_brute_force_grouping(S, bm):
    """K2's blocks and code-gradient slots against a walk over the points:
    a slot is a maximal run of consecutive points in one block and one ray,
    numbered in point order, every block holds bm // rows_slot of them (the
    last one's padding rows too), and ray r's code gradient is the sum of
    slots [r * bpr, (r + 1) * bpr). Ray counts leave the last block partial
    where S < bm."""
    for R in (1, 2, 3, 5, 7, 66):
        n = R * S
        geo = TFM.bwd_geometry(n, S, bm)
        blocks = sorted({p // bm for p in range(n)})
        assert geo.nblocks == len(blocks) and geo.npad == geo.nblocks * bm
        assert geo.npad - bm < n <= geo.npad
        runs = []  # [(block, ray), points] of each maximal run
        for p in range(n):
            key = (p // bm, p // S)
            if not runs or runs[-1][0] != key:
                runs.append([key, 0])
            runs[-1][1] += 1
        assert {c for _, c in runs} == {geo.rows_slot}
        assert geo.nslots == geo.nblocks * geo.spb == geo.npad // geo.rows_slot
        for blk in blocks[:-1]:
            assert sum(1 for (b, _), _ in runs if b == blk) == geo.spb
        for i, ((_, ray), _) in enumerate(runs):
            assert i // geo.bpr == ray
        assert len(runs) == R * geo.bpr <= geo.nslots


@pytest.mark.parametrize("S", [3, 48, 80])
def test_bwd_geometry_rejects_rays_across_blocks(S):
    with pytest.raises(NotImplementedError, match=r"needs S \|"):
        TFM.bwd_geometry(10 * S, S)


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


# ------------------------------------------------------------ the dW GEMM
# call sites' nets [(D, W, in_dir, out, raw_feat, use_ct, use_cd)], ct, cd
_TRUNK_FEAT = ([(8, 256, 27 + 64, 3, False, False, True), (5, 128, 0, 16, True, False, False)],
               0, 91)
_VIS = ([(5, 64, 0, 1, True, False, False)], 0, 0)
_SKIN = ([(5, 64, 0, 25, True, True, False)], 128, 0)
_FEAT = ([(5, 128, 0, 16, True, False, False)], 0, 0)
_UNC = ([(8, 256, 32, 1, True, False, True)], 0, 32)
# name: (nets, points, S) at the backward call sites of the init, ft1 and ft2
# steps
DW_SITES = {
    "trunk_feat_r2048": (_TRUNK_FEAT, 262144, 128), "trunk_feat_r3072": (_TRUNK_FEAT, 393216, 128),
    "vis_r2048": (_VIS, 524288, 1), "vis_r3072": (_VIS, 786432, 1),
    "skin_r2048": (_SKIN, 262144, 128), "skin_r3072": (_SKIN, 393216, 128),
    "feat_grid": (_FEAT, 8000, 1), "kp_reproj_r2048": (_SKIN, 2048, 1),
    "kp_reproj_r3072": (_SKIN, 3072, 1), "unc_pred": (_UNC, 2048, 1),
}


def _dw_shapes(nets):
    """The dW GEMM's task shapes (kin, nout) of a launch, as K2 builds them
    (every layer with a D stack, in the padded layout of _Layout)."""
    return [(k, n) for k, n, _ in _dw_tasks(nets)]


def _dw_tasks(nets):
    specs, ct, cd = nets
    mods = [(TNeRFMLP(D=D, W=W, in_channels_xyz=63 + (ct if use_ct else 0),
                      in_channels_dir=in_dir, out_channels=out, raw_feat=raw), use_ct, use_cd)
            for D, W, in_dir, out, raw, use_ct, use_cd in specs]
    return TFM.dw_task_shapes(mods, 63, ct, cd, emb=(3, 10, True))


def test_dw_task_shapes_share_the_final_layers_a_stack():
    """At the trunk+feature launch: the trunk's sigma head (task 8) and
    final layer (task 9) read one A stack, the feature head's dropped sigma
    has no task, and every other task reads an A stack of its own."""
    tasks = _dw_tasks(_TRUNK_FEAT)
    assert len(tasks) == 12 + 8
    assert tasks[8] == (256, 16, 8) and tasks[9] == (256, 256, 8)
    assert [a for _, _, a in tasks] == list(range(9)) + [8] + list(range(10, 20))
    # the trunk's dir layer: 256 + the cd code padded from 91 to 96
    assert tasks[10][:2] == (352, 128)


def _check_plan(shapes, npad, plan):
    tiles_of = {}
    for i, t in enumerate(plan.tiles):
        tiles_of.setdefault(t.task, []).append((i, t))
    assert sorted(tiles_of) == list(range(len(shapes)))
    for task, (kin, nout) in enumerate(shapes):
        cover = np.zeros((kin, nout), np.int64)
        for _, t in tiles_of[task]:
            assert t.mw % 16 == 0 and t.nw % 16 == 0
            assert 0 < t.mw <= TFM.DW_TM and 0 < t.nw <= TFM.DW_TN
            cover[t.m0:t.m0 + t.mw, t.n0:t.n0 + t.nw] += 1
        assert (cover == 1).all()
    # each tile's items: splits 0..nsplit-1 whose point ranges tile [0, npad)
    by_tile = {}
    for it in plan.items:
        by_tile.setdefault(it.tile, []).append(it)
    assert sorted(by_tile) == list(range(len(plan.tiles)))
    for ti, t in enumerate(plan.tiles):
        its = sorted(by_tile[ti], key=lambda it: it.split)
        assert [it.split for it in its] == list(range(t.nsplit))
        assert its[0].p0 == 0 and its[-1].p1 == npad
        for a, b in zip(its, its[1:]):
            assert a.p1 == b.p0
        for it in its:
            assert it.p0 % TFM.DW_KC == 0 and it.p1 % TFM.BM_B == 0 and it.p0 < it.p1 <= npad
    # partials: disjoint, in tile order, within part_floats
    off = 0
    for t in plan.tiles:
        assert t.part_off == off
        blocks = -(-t.mw // 64) * -(-t.nw // 32)
        assert t.kslices & (t.kslices - 1) == 0 and blocks * t.kslices <= TFM.DW_WARPS \
            < 2 * blocks * t.kslices
        off += t.nsplit * t.kslices * t.mw * t.nw
    assert off == plan.part_floats
    # the costliest item first
    costs = [TFM._dw_cost(plan.tiles[it.tile].mw, plan.tiles[it.tile].nw) * (it.p1 - it.p0)
             for it in plan.items]
    assert costs[0] >= 0.95 * max(costs)


@pytest.mark.parametrize("site", sorted(DW_SITES))
def test_dw_plan_covers_every_tile_and_point_once(site):
    """dw_plan at the task shapes and point counts of each backward call
    site: every (task, output element) in exactly one tile, every tile's
    points [0, npad) in exactly one item, no item reading a row at or past
    npad, partials disjoint and under 64 MB; at one and two resident CTAs
    per SM of an H100 (132 SMs)."""
    nets, n, S = DW_SITES[site]
    shapes = _dw_shapes(nets)
    npad = TFM.bwd_geometry(n, S).npad
    for slots in (132, 264):
        plan = TFM.dw_plan(shapes, npad, slots)
        _check_plan(shapes, npad, plan)
        assert plan.part_floats * 4 < 64 * 2 ** 20
        assert len(plan.items) <= min(TFM.DW_WAVES * slots, TFM.DW_MAX_ITEMS) + len(plan.tiles)


def _emulate(a, d, plan):
    """The kernel's arithmetic in plain PyTorch: one fp32 partial per item
    and k-slice (k-slice z of an item sums its 16-point steps j with
    j % kslices == z), summed per tile in the order split * kslices + z."""
    out = [torch.zeros(ai.shape[1], di.shape[1]) for ai, di in zip(a, d)]
    parts = {}
    for it in plan.items:
        t = plan.tiles[it.tile]
        steps = torch.arange(it.p0, it.p1) // 16 - it.p0 // 16
        for z in range(t.kslices):
            rows = torch.arange(it.p0, it.p1)[steps % t.kslices == z]
            parts[(it.tile, it.split * t.kslices + z)] = (
                a[t.task][rows, t.m0:t.m0 + t.mw].float().t() @
                d[t.task][rows, t.n0:t.n0 + t.nw].float())
    for ti, t in enumerate(plan.tiles):
        acc = torch.zeros(t.mw, t.nw)
        for s in range(t.nsplit * t.kslices):
            acc = acc + parts[(ti, s)]
        out[t.task][t.m0:t.m0 + t.mw, t.n0:t.n0 + t.nw] = acc
    return out


@pytest.mark.parametrize("slots", [1, 4, 132])
def test_dw_plan_emulation_matches_plain(slots):
    """The plan's partials and their fixed-order reduction give
    dw_gemm_plain within 1e-5, at odd widths (16, 32, 192, 352), a 32-point
    tail and an A stack with more rows than npad."""
    shapes = [(352, 128), (64, 256), (16, 16), (32, 16), (192, 32)]
    npad = 128 * 21 + 32
    rng = np.random.default_rng(slots)
    a = [torch.tensor(rng.normal(size=(npad + 32, k)), dtype=torch.float32).to(torch.bfloat16)
         for k, _ in shapes]
    d = [torch.tensor(rng.normal(size=(npad, n)), dtype=torch.float32).to(torch.bfloat16)
         for _, n in shapes]
    plan = TFM.dw_plan(shapes, npad, slots)
    _check_plan(shapes, npad, plan)
    assert max(t.nsplit for t in plan.tiles) == 1 if slots == 1 else \
        max(t.nsplit for t in plan.tiles) > 1
    for e, r in zip(_emulate(a, d, plan), TFM.dw_gemm_plain(a, d, npad)):
        torch.testing.assert_close(e, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()))


def test_dw_gemm_plain_gives_the_plain_bf16_weight_gradients(monkeypatch):
    """On the bf16 A/D stacks of the plain bf16 route (each product's bf16
    input and its bf16-rounded output gradient), dw_gemm_plain gives that
    route's weight gradients, which test_plain_bf16_matches_jax holds against
    the JAX kernel."""
    _, S, need_dx, x, ctc, cdc, win, _, tnets, cots = _setup("site1_trunk_feat")
    seen, mm = [], TFM._mm

    def recording_mm(a, b, cdt):
        out = mm(a, b, cdt)
        out.retain_grad()
        seen.append((a.detach().to(torch.bfloat16), b, out))
        return out

    monkeypatch.setattr(TFM, "_mm", recording_mm)
    outs = TFM.nerf_mlp_fused(tnets, torch.tensor(x), code_dir=torch.tensor(cdc),
                              samples_per_ray=S, need_dx=need_dx, embed_freqs=10,
                              embed_window=torch.tensor(win), compute_dtype=torch.bfloat16)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    assert len(seen) == 12 + 8  # every weight of both nets but the dropped sigma
    a = [s[0] for s in seen]
    d = [s[2].grad.to(torch.bfloat16) for s in seen]
    for (_, w, _), dw in zip(seen, TFM.dw_gemm_plain(a, d)):
        torch.testing.assert_close(dw, w.grad, rtol=1e-5, atol=1e-5 * float(w.grad.abs().max()))


_CU = TFM._SRC.read_text()


def _cu_fields(struct: str):
    """(name, kind) of each field of a struct in csrc/fused_mlp.cu, in order:
    kind "int", "ptr", or (element struct, length) for an array."""
    src = re.sub(r"//[^\n]*", "", _CU)
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    consts = {k: int(v) for k, v in re.findall(r"#define (MAX\w+) (\d+)", _CU)}
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        typ, star, names = re.match(r"(?:const )?(\w+)\s*(\*?)\s*(.*)", decl).groups()
        for nm in names.split(","):
            nm = nm.strip()
            ptr = bool(star) or nm.startswith("*")
            name, dims = re.match(r"\*?\s*(\w+)\s*(?:\[(.*)\])?", nm).groups()
            if dims:
                out.append((name, (typ, eval(dims, {}, consts))))
            else:
                out.append((name, "ptr" if ptr else typ))
    return out


def _ctypes_fields(cls):
    out = []
    for name, ct in cls._fields_:
        if ct is ctypes.c_int:
            out.append((name, "int"))
        elif ct is ctypes.c_void_p:
            out.append((name, "ptr"))
        else:
            out.append((name, (ct._type_.__name__.lstrip("_"), ct._length_)))
    return out


@pytest.mark.parametrize("struct", ["LayerDesc", "NetDesc", "FusedDesc", "GemmTask", "DwDesc"])
def test_ctypes_mirror_matches_cuda_source(struct):
    """The ctypes Structures of ops/fused_mlp.py name the fields of
    csrc/fused_mlp.cu's descriptors in the same order with the same kinds:
    a mismatch would corrupt a launch without an error."""
    assert _ctypes_fields(getattr(TFM, f"_{struct}")) == _cu_fields(struct)


def test_dw_constants_match_cuda_source():
    """The plan's tile, stage and padding sizes are the kernel's."""
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\s", _CU)}
    assert (defines["DW_TM"], defines["DW_TN"], defines["DW_KC"], defines["DW_BOX"],
            defines["DW_WARPS"], defines["MAXNETS"], defines["MAXLAYERS"]) == (
        TFM.DW_TM, TFM.DW_TN, TFM.DW_KC, TFM.DW_BOX, TFM.DW_WARPS, TFM.MAXNETS, TFM.MAXLAYERS)
    # the ring: 3 stages of 128 x 128 tiles fit in 227 KB, 4 of the W = 64 launches' tiles
    assert TFM.dw_boxes([(352, 128), (256, 16)]) == (2, 2)
    assert TFM.dw_stages(*TFM.dw_boxes([(256, 256)])) == 3
    assert TFM.dw_stages(*TFM.dw_boxes([(192, 64), (64, 64)])) == 4
