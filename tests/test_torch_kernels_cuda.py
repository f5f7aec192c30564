"""The hand-written CUDA kernels (K1 forward, K2 backward of the fused
NeRF MLP) against their plain PyTorch version on the card. They have no
CPU or interpret mode, so these tests need a CUDA card: they carry the
``cuda`` marker and skip without one. Run on a card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.

Tolerance: relative L2 error against the plain version in bf16 mode, 1e-2
on outputs and 2e-2 on gradients (both round the same operands and
cotangents to bf16; only fp32 summation order differs). DIS's patch search
(csrc/dis.cu) is bit-equal to its plain version: both round each float32
operation once, in the same order. So are the MPEG-4 Part 2 kernels
(csrc/m4v.cu) and the H.264 kernels (csrc/h264.cu): integer arithmetic
throughout.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-MLP kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("S,ct,cd,W,raw", [(32, 0, 24, 64, False), (1, 0, 0, 64, True),
                                           (64, 16, 0, 32, True)])
def test_kernel_matches_plain(cuda_device, S, ct, cd, W, raw):
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator().manual_seed(0)
    m = NeRFMLP(D=5, W=W, in_channels_xyz=63 + ct, in_channels_dir=cd, out_channels=5,
                raw_feat=raw)
    reset_denses(m, gen)
    m = m.to(cuda_device)
    R = 200 // S + 3
    x = torch.randn(R * S, 3, generator=gen).to(cuda_device).requires_grad_(True)
    ctc = torch.randn(R, ct, generator=gen).to(cuda_device).requires_grad_(True) if ct else None
    cdc = torch.randn(R, cd, generator=gen).to(cuda_device).requires_grad_(True) if cd else None
    leaves = [t for t in (x, ctc, cdc) if t is not None] + list(m.parameters())

    def run(kernel):
        out = FM.nerf_mlp_fused([(m, ct > 0, cd > 0)], x, code_trunk=ctc, code_dir=cdc,
                                samples_per_ray=S, embed_freqs=10,
                                compute_dtype=torch.bfloat16, kernel=kernel)[0]
        # a raw_feat net has no sigma output: the plain version leaves the
        # sigma head out of the graph, the kernel returns zero gradients
        g = torch.autograd.grad((out * torch.linspace(-1, 1, out.numel(), device=out.device)
                                 .reshape(out.shape)).sum(), leaves, allow_unused=True)
        return out.detach(), [torch.zeros_like(t) if gt is None else gt.detach()
                              for t, gt in zip(leaves, g)]

    before = dict(FM.launches)
    ko, kg = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd"] == before["fwd"] + 1 and FM.launches["bwd"] == before["bwd"] + 1
    po, pg = run(False)
    assert float((ko - po).norm() / po.norm()) <= 1e-2
    for a, b in zip(kg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2


def _grads(out, leaves, cot):
    g = torch.autograd.grad((out * cot).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(t) if gt is None else gt.detach() for t, gt in zip(leaves, g)]


@pytest.mark.parametrize("layout", ["embedded", "per_point_dir", "per_point_dir_embed"])
def test_kernel_new_input_layouts(cuda_device, layout):
    """The inputs the ft2 uncertainty MLP gives the kernels: x embedded
    outside the launch (no in-kernel embed, F = 0) with the video code per
    point in x's last columns (the candidate scores), and raw xyt embedded
    in the launch with the code as a per-point code_dir (the prediction).
    A normal cotangent at the prediction's 2,048 points: the one-wide head's
    bias gradient is the cotangent's sum, which a symmetric one cancels."""
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator().manual_seed(1)
    cd = 0 if layout == "embedded" else 32
    m = NeRFMLP(D=8, W=256, in_channels_xyz=63, in_channels_dir=cd, out_channels=1,
                raw_feat=True)
    reset_denses(m, gen)
    m = m.to(cuda_device)
    n = 2048
    embed = layout == "per_point_dir_embed"
    x = torch.randn(n, 3 if embed else 63 + cd, generator=gen).to(cuda_device)
    cdc = torch.randn(n, cd, generator=gen).to(cuda_device) if embed else None
    x.requires_grad_(True)
    leaves = [x] + ([cdc.requires_grad_(True)] if embed else []) + list(m.parameters())
    cot = torch.randn(n, 1, generator=gen).to(cuda_device)

    def run(kernel):
        out = FM.nerf_mlp_fused([(m, False, embed)], x, code_dir=cdc,
                                embed_freqs=10 if embed else 0,
                                compute_dtype=torch.bfloat16, kernel=kernel)[0]
        return out.detach(), _grads(out, leaves, cot)

    before = dict(FM.launches)
    ko, kg = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd"] == before["fwd"] + 1 and FM.launches["bwd"] == before["bwd"] + 1
    po, pg = run(False)
    assert float((ko - po).norm() / po.norm()) <= 1e-2
    for a, b in zip(kg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2


@pytest.mark.parametrize("S,ct,cd,W,raw", [(32, 0, 24, 64, False), (64, 16, 0, 32, True)])
def test_stash_matches_remat(cuda_device, monkeypatch, S, ct, cd, W, raw):
    """MODA_PALLAS_STASH=1: K1s and K2s launch instead of K1 and K2; the
    forward is K1's bit for bit, and K2s's gradients are K2's (K2
    recomputes the forward in K1's summation order, K2s reads it); both
    within K2's tolerance of the plain version."""
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator().manual_seed(2)
    m = NeRFMLP(D=5, W=W, in_channels_xyz=63 + ct, in_channels_dir=cd, out_channels=5,
                raw_feat=raw)
    reset_denses(m, gen)
    m = m.to(cuda_device)
    R = 200 // S + 3
    x = torch.randn(R * S, 3, generator=gen).to(cuda_device).requires_grad_(True)
    ctc = torch.randn(R, ct, generator=gen).to(cuda_device).requires_grad_(True) if ct else None
    cdc = torch.randn(R, cd, generator=gen).to(cuda_device).requires_grad_(True) if cd else None
    leaves = [t for t in (x, ctc, cdc) if t is not None] + list(m.parameters())
    cot = torch.randn(R * S, 5 + (0 if raw else 1), generator=gen).to(cuda_device)

    def run(kernel):
        out = FM.nerf_mlp_fused([(m, ct > 0, cd > 0)], x, code_trunk=ctc, code_dir=cdc,
                                samples_per_ray=S, embed_freqs=10,
                                compute_dtype=torch.bfloat16, kernel=kernel)[0]
        return out.detach(), _grads(out, leaves, cot)

    ro, rg = run(True)
    monkeypatch.setenv("MODA_PALLAS_STASH", "1")
    before = dict(FM.launches)
    so, sg = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd_stash"] == before["fwd_stash"] + 1
    assert FM.launches["bwd_stash"] == before["bwd_stash"] + 1
    assert FM.launches["fwd"] == before["fwd"] and FM.launches["bwd"] == before["bwd"]
    with torch.no_grad():  # no gradient wanted: nothing is stashed
        FM.nerf_mlp_fused([(m, ct > 0, cd > 0)], x, code_trunk=ctc, code_dir=cdc,
                          samples_per_ray=S, embed_freqs=10, compute_dtype=torch.bfloat16,
                          kernel=True)
    assert FM.launches["fwd"] == before["fwd"] + 1
    po, pg = run(False)
    assert torch.equal(so, ro)
    for a, b, p in zip(sg, rg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2
        assert float((a - p).norm() / (p.norm() + 1e-12)) <= 2e-2


# three call sites' nets at small point counts: S -> (nets [(D, W, in_dir, out,
# raw_feat, use_ct, use_cd)], ct, cd); the trunk + feature head at S = 128,
# the skin MLP at 64 (the coarse pass), the visibility MLP at 1
SITE_NETS = {128: ([(8, 256, 27 + 64, 3, False, False, True), (5, 128, 0, 16, True, False, False)],
                   0, 91),
             64: ([(5, 64, 0, 25, True, True, False)], 128, 0),
             1: ([(5, 64, 0, 1, True, False, False)], 0, 0)}


def _site(cuda_device, S, R, seed):
    specs, ct, cd = SITE_NETS[S]
    return _nets_run(cuda_device, specs, ct, cd, S, R, seed)


def _nets_run(cuda_device, specs, ct, cd, S, R, seed):
    """run(kernel) -> (outputs, gradients of every leaf) of nets ``specs``
    [(D, W, in_dir, out, raw_feat, use_ct, use_cd)] in one launch on R rays
    of S points, raw xyz embedded in the launch, seeded inputs and
    cotangents."""
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator().manual_seed(seed)
    mods = []
    for D, W, in_dir, out, raw, use_ct, use_cd in specs:
        m = NeRFMLP(D=D, W=W, in_channels_xyz=63 + (ct if use_ct else 0), in_channels_dir=in_dir,
                    out_channels=out, raw_feat=raw)
        reset_denses(m, gen)
        mods.append((m.to(cuda_device), use_ct, use_cd))
    x = (torch.randn(R * S, 3, generator=gen) * 0.3).to(cuda_device).requires_grad_(True)
    ctc = torch.randn(R, ct, generator=gen).to(cuda_device).requires_grad_(True) if ct else None
    cdc = torch.randn(R, cd, generator=gen).to(cuda_device).requires_grad_(True) if cd else None
    leaves = [t for t in (x, ctc, cdc) if t is not None] + \
        [p for m, _, _ in mods for p in m.parameters()]
    cots = [torch.randn(R * S, out + (0 if raw else 1), generator=gen).to(cuda_device)
            for _, _, _, out, raw, _, _ in specs]

    def run(kernel):
        outs = FM.nerf_mlp_fused(mods, x, code_trunk=ctc, code_dir=cdc, samples_per_ray=S,
                                 embed_freqs=10, compute_dtype=torch.bfloat16, kernel=kernel)
        g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), leaves,
                                allow_unused=True)
        return ([o.detach() for o in outs],
                [torch.zeros_like(t) if gt is None else gt.detach() for t, gt in zip(leaves, g)])
    return run


@pytest.mark.parametrize("S", [1, 64, 128])
def test_kernel_matches_plain_at_block_edges(cuda_device, S):
    """Each S of the call sites with a point count that does not fill the
    grid evenly: at S = 1 the last backward block is partial (n % BM_B != 0);
    at S = 64 and 128 a block always holds whole rays or whole parts of one
    (n = R * S), so an odd ray count leaves a ray's slots and blocks uneven
    instead."""
    from moda_tpu_torch.ops import fused_mlp as FM

    R = 3 * FM.BM_B + 17 if S == 1 else 3
    assert S > 1 or (R * S) % FM.BM_B
    run = _site(cuda_device, S, R, seed=3)
    before = dict(FM.launches)
    ko, kg = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd"] == before["fwd"] + 1 and FM.launches["bwd"] == before["bwd"] + 1
    po, pg = run(False)
    for a, b in zip(ko, po):
        assert float((a - b).norm() / b.norm()) <= 1e-2
    for a, b in zip(kg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2


# one net a case at the edges of block_gemm's products (csrc/fused_mlp.cu):
# (D, W, in_dir, out, raw_feat, use_ct, use_cd), ct, cd, S
PRODUCT_EDGES = {
    # the 16-wide sigma head (ds2) and a 16-wide rgb head: products whose K
    # (16) is below a warp's four-fragment step
    "sigma_and_rgb16_heads": ((5, 128, 0, 16, False, False, False), 0, 0, 1),
    # a 96-wide dir code (91 padded): the dir layer's second K-segment
    "dir_code_96": ((5, 128, 91, 3, False, False, True), 0, 91, 128),
    # W 256 with that code: the dir layer's backward is 352 columns wide
    # (22 tiles over 8 warps), the skip layer's 320 (64 + 256)
    "dir_352_skip_320": ((8, 256, 91, 3, False, False, True), 0, 91, 128),
    # a per-ray trunk code (ct > 0): layer 0's and the skip layer's second
    # K-segment, and the skip layer's backward 320 columns (64 + 128 + 128)
    "trunk_code": ((5, 128, 0, 3, True, True, False), 128, 0, 64),
    # W 64: four column tiles, half the warps without one
    "w64": ((5, 64, 0, 25, True, True, False), 128, 0, 64),
}


@pytest.mark.parametrize("case", sorted(PRODUCT_EDGES))
def test_kernel_matches_plain_at_product_edges(cuda_device, case):
    """K1 and K2 against the plain version where products have partial
    steps, segments and column tiles, at phase 3's tolerances (outputs 1e-2,
    gradients 2e-2)."""
    from moda_tpu_torch.ops import fused_mlp as FM

    spec, ct, cd, S = PRODUCT_EDGES[case]
    run = _nets_run(cuda_device, [spec], ct, cd, S, 3 if S > 1 else 5 * FM.BM_B + 9, seed=5)
    before = dict(FM.launches)
    ko, kg = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd"] == before["fwd"] + 1 and FM.launches["bwd"] == before["bwd"] + 1
    po, pg = run(False)
    for a, b in zip(ko, po):
        assert float((a - b).norm() / b.norm()) <= 1e-2
    for a, b in zip(kg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2


def test_backward_is_deterministic(cuda_device):
    """No atomics: the same inputs give bit-identical gradients run to run
    (column sums run inside one warp in a fixed order; per-CTA partials are
    summed in a fixed order)."""
    run = _site(cuda_device, 128, 5, seed=4)
    _, g1 = run(True)
    _, g2 = run(True)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _dw_stacks(device, shapes, npad, a_rows, seed):
    gen = torch.Generator().manual_seed(seed)
    a = [torch.randn(a_rows, k, generator=gen).to(torch.bfloat16) for k, _ in shapes]
    for t in a:  # rows past npad (a K1s stack's) must never be read
        t[npad:] = float("nan")
    d = [torch.randn(npad, n, generator=gen).to(torch.bfloat16) for _, n in shapes]
    return [t.to(device) for t in a], [t.to(device) for t in d]


# (task shapes (kin, nout), npad, rows of A): a 32-point tail (npad % 64 ==
# 32) with the trunk's dir layer (352), its first layer and a skip layer
# (320); the heads' 16-wide rows and columns, the W = 64 nets' rgb layer
# (32) and the feature head's skip layer (192); an A stack with more rows
# than npad, as K1s leaves it (rows rounded up to BM_F)
DW_CASES = {
    "tail_352_320": ([(352, 128), (64, 256), (320, 256)], 64 * 97 + 32, 64 * 97 + 32),
    "widths_16_32_192": ([(16, 16), (256, 16), (32, 16), (192, 128), (128, 64)], 4096, 4096),
    "k2s_rows": ([(192, 64), (256, 64), (64, 16)], 64 * 40 + 32, 64 * 41),
}


@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_dw_gemm_matches_plain(cuda_device, case):
    """The dW GEMM alone against its plain fp32 version: relative L2 error
    at most 1e-4 per task (both sum the same bf16 products in fp32; only the
    order differs), at ragged tails, odd widths and a longer A stack."""
    from moda_tpu_torch.ops import fused_mlp as FM

    shapes, npad, a_rows = DW_CASES[case]
    a, d = _dw_stacks(cuda_device, shapes, npad, a_rows, seed=5)
    before = FM.launches["dw"]
    out = FM.dw_gemm(a, d, npad)
    torch.cuda.synchronize()
    assert FM.launches["dw"] == before + 1
    ref = FM.dw_gemm_plain(a, d, npad)
    for (k, n), o, r in zip(shapes, out, ref):
        assert o.shape == (k, n) and torch.isfinite(o).all()
        assert float((o - r).norm() / r.norm()) <= 1e-4


def test_dw_gemm_is_deterministic(cuda_device):
    """Fixed-order partials: two runs give the same bits."""
    from moda_tpu_torch.ops import fused_mlp as FM

    shapes, npad, a_rows = DW_CASES["tail_352_320"]
    a, d = _dw_stacks(cuda_device, shapes, npad, a_rows, seed=6)
    o1 = FM.dw_gemm(a, d, npad)
    o2 = FM.dw_gemm(a, d, npad)
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))


def test_kernel_matches_plain_at_the_dis_site(cuda_device):
    """The displacement field nerf_dis's launch: D5 W128 with a 128-wide
    per-ray trunk code and a 3-wide head, 128 samples a ray (the first site
    pairing W = 128 with a code): K1/K2 against the plain version, two
    backwards bit-identical, and the dW GEMM at its task shapes within 1e-4
    (relative L2) of its plain version."""
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator().manual_seed(7)
    S, R, ct = 128, 37, 128
    m = NeRFMLP(D=5, W=128, in_channels_xyz=63 + ct, in_channels_dir=0, out_channels=3,
                raw_feat=True)
    reset_denses(m, gen)
    m = m.to(cuda_device)
    x = (torch.randn(R * S, 3, generator=gen) * 0.3).to(cuda_device).requires_grad_(True)
    ctc = torch.randn(R, ct, generator=gen).to(cuda_device).requires_grad_(True)
    leaves = [x, ctc] + list(m.parameters())
    cot = torch.randn(R * S, 3, generator=gen).to(cuda_device)

    def run(kernel):
        out = FM.nerf_mlp_fused([(m, True, False)], x, code_trunk=ctc, samples_per_ray=S,
                                embed_freqs=10, compute_dtype=torch.bfloat16,
                                kernel=kernel, site="dis_test")[0]
        return out.detach(), _grads(out, leaves, cot)

    before = dict(FM.launches)
    ko, kg = run(True)
    _, kg2 = run(True)
    torch.cuda.synchronize()
    assert FM.launches["fwd"] == before["fwd"] + 2 and FM.launches["bwd"] == before["bwd"] + 2
    assert all(torch.equal(a, b) for a, b in zip(kg, kg2))
    po, pg = run(False)
    assert float((ko - po).norm() / po.norm()) <= 1e-2
    for a, b in zip(kg, pg):
        assert float((a - b).norm() / (b.norm() + 1e-12)) <= 2e-2
    shapes = [(k, n) for k, n, _ in FM.dw_task_shapes([(m, True, False)], 63, ct, 0, S,
                                                      emb=(3, 10, True))]
    npad = FM.bwd_geometry(R * S, S).npad
    a, d = _dw_stacks(cuda_device, shapes, npad, npad, seed=8)
    out = FM.dw_gemm(a, d, npad)
    for o, r in zip(out, FM.dw_gemm_plain(a, d, npad)):
        assert float((o - r).norm() / r.norm()) <= 1e-4


@pytest.mark.parametrize("prop", [True, False])
@pytest.mark.parametrize("h,w,u", [(120, 160, 0.5), (816, 64, 0.5), (8, 23, 0.5),
                                   (120, 160, 10.0)])
def test_dis_patch_search_matches_plain(cuda_device, h, w, u, prop):
    """dis_patch_search against patch_search_plain on one h x w scale (a
    seeded smooth texture and a shifted copy, the coarser flow normal with
    deviation u px): the same float32 operations in the same order, so
    bit-equal. 816 x 64 has stripes of 34 patch rows (a warp takes two),
    8 x 23 one patch row, and u = 10 (the flow scaled by 20) sends samples
    to the clamps of the extended I1 on every side."""
    from moda_tpu_torch.preproc import dis_flow as D

    args = _dis_scale(h, w, u, cuda_device)
    p = D.DISParams(use_spatial_propagation=prop)
    before = D.launches["patch_search"]
    S = D.patch_search(*args, p)
    torch.cuda.synchronize()
    assert D.launches["patch_search"] == before + 1
    assert torch.equal(S, D.patch_search_plain(*args, p))


@pytest.mark.parametrize("prop", [True, False])
def test_dis_patch_search_refuses_a_grid_that_misses_patches(cuda_device, prop):
    """The C entry point takes the CTA count from ``search_geometry`` and
    refuses one that does not cover the scale's patches exactly, rather than
    leave a stripe or a patch unsearched."""
    from moda_tpu_torch.preproc import dis_flow as D

    h, w = 120, 160
    I0, I1e, gx, gy, U, st = _dis_scale(h, w, 0.5, cuda_device)
    hs, ws = D.patch_grid(h, w)
    S = torch.empty((2, hs, ws), dtype=torch.float32, device=cuda_device)
    g = D.search_geometry(hs, ws, prop)
    npass = 2 if prop else 1
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    lib = D.build_library()

    def launch(ctas):
        return lib.moda_dis_patch_search(
            I0.data_ptr(), I1e.data_ptr(), gx.data_ptr(), gy.data_ptr(), U[0].data_ptr(),
            U[1].data_ptr(), st.data_ptr(), S[0].data_ptr(), S[1].data_ptr(), h, w, hs, ws,
            D.STRIDE, npass, D.GD_ITER // npass, ctas, g.warps, g.stripe, stream)

    assert launch(g.ctas - 1) != 0 and launch(g.ctas + 1) != 0
    assert launch(g.ctas) == 0
    torch.cuda.synchronize()


def _dis_scale(h, w, u, dev):
    """One h x w scale's patch-search inputs (I0, I1e, gx, gy, U, st) on dev:
    a seeded smooth texture and a shifted copy, the coarser flow normal with
    deviation u px."""
    import torch.nn.functional as F
    from moda_tpu_torch.preproc import dis_flow as D

    gen = torch.Generator().manual_seed(0)
    tex = F.avg_pool2d(torch.rand(1, 1, h + 20, w + 20, generator=gen) * 255, 5, 1)[0, 0]
    g0 = tex[4:4 + h, 4:4 + w].round().to(torch.uint8)
    g1 = tex[5:5 + h, 6:6 + w].round().to(torch.uint8)
    gx, gy = D.spatial_gradient(g0)
    st = D.structure_tensor(gx, gy)
    ext = F.pad(g1[None, None].float(), (D.BORDER,) * 4, mode="replicate")[0, 0].to(torch.uint8)
    U = torch.randn(2, h, w, generator=gen) * u
    return [t.to(dev) for t in (g0, ext, gx, gy, U, st)]


def _random_vop(mb_w, mb_h, coding, seed):
    """A seeded VOP in the parser's layout (mbs int32 [nmb, 10], levels
    int16 [blocks, 64]): every macroblock intra in an I-VOP; in a P-VOP a
    mix of intra, inter and not-coded ones with vectors up to 4 macroblocks
    past the picture's edges; QP 1-31 a macroblock; sparse levels with some
    at the extremes (escape-3 levels of +-2047, DCs near 2047)."""
    from moda_tpu_torch.preproc import m4v as M

    gen = torch.Generator().manual_seed(seed)
    nmb = mb_w * mb_h
    mbs = torch.full((nmb, M.MB_FIELDS), -1, dtype=torch.int32)
    typ = torch.zeros(nmb, dtype=torch.int32) if coding == M.VOP_I else \
        torch.randint(0, 3, (nmb,), generator=gen, dtype=torch.int32)
    mbs[:, M.F_TYPE] = typ
    mbs[:, M.F_QP] = torch.randint(1, 32, (nmb,), generator=gen, dtype=torch.int32)
    mv = torch.randint(-128, 128, (nmb, 2), generator=gen, dtype=torch.int32)
    mbs[:, M.F_MVX:M.F_MVY + 1] = torch.where((typ == M.MB_INTER)[:, None], mv, 0)
    coded = torch.rand(nmb, 6, generator=gen) < 0.6
    coded |= (typ == M.MB_INTRA)[:, None]
    coded &= (typ != M.MB_SKIP)[:, None]
    n = int(coded.sum())
    mbs[:, M.F_BLK:] = torch.where(coded, (coded.view(-1).cumsum(0) - 1).view(nmb, 6), -1)
    levels = torch.where(torch.rand(n, 64, generator=gen) < 0.15,
                         torch.randint(-40, 41, (n, 64), generator=gen), 0)
    wild = torch.rand(n, 64, generator=gen) < 0.01
    levels = torch.where(wild, torch.randint(-2048, 2048, (n, 64), generator=gen), levels)
    levels[:, 0] = torch.where(torch.rand(n, generator=gen) < 0.5,
                               torch.randint(0, 256, (n,), generator=gen), levels[:, 0])
    return mbs, levels.to(torch.int16)


@pytest.mark.parametrize("mb_w,mb_h", [(1, 1), (6, 4), (120, 68)])
@pytest.mark.parametrize("rounding", [0, 1])
def test_m4v_reconstruct_matches_plain(cuda_device, mb_w, mb_h, rounding):
    """m4v_reconstruct against reconstruct_plain on seeded VOPs (an I-VOP,
    then a P-VOP predicted from it with vectors reaching past every edge):
    integer arithmetic throughout, so bit-equal; one launch a VOP."""
    from moda_tpu_torch.preproc import m4v as M

    g = M.Geometry(16 * mb_w - 6, 16 * mb_h - 2, mb_w, mb_h)
    ref = None
    for coding, seed in ((M.VOP_I, 0), (M.VOP_P, 1)):
        mbs, levels = _random_vop(mb_w, mb_h, coding, seed + 10 * rounding)
        before = M.launches["m4v_reconstruct"]
        got = M.reconstruct(None if ref is None else ref.to(cuda_device), mbs.to(cuda_device),
                            levels.to(cuda_device), rounding, g)
        torch.cuda.synchronize()
        assert M.launches["m4v_reconstruct"] == before + 1
        want = M.reconstruct_plain(ref, mbs, levels, rounding, g)
        assert torch.equal(got.cpu(), want)
        ref = want


@pytest.mark.parametrize("mb_w,mb_h", [(6, 4), (120, 68)])
def test_m4v_reconstruct_without_a_reference_predicts_from_zero(cuda_device, mb_w, mb_h):
    """m4v_reconstruct given no reference and a seeded P-VOP's macroblocks
    (intra, inter, not coded): it reads nothing, predicts every macroblock
    from zero, and equals reconstruct_plain with no reference and with a
    black one."""
    from moda_tpu_torch.preproc import m4v as M

    g = M.Geometry(16 * mb_w, 16 * mb_h, mb_w, mb_h)
    mbs, levels = _random_vop(mb_w, mb_h, M.VOP_P, 3)
    got = M.reconstruct(None, mbs.to(cuda_device), levels.to(cuda_device), 1, g)
    torch.cuda.synchronize()
    want = M.reconstruct_plain(None, mbs, levels, 1, g)
    assert torch.equal(got.cpu(), want)
    black = torch.zeros(g.frame_bytes, dtype=torch.uint8)
    assert torch.equal(want, M.reconstruct_plain(black, mbs, levels, 1, g))


@pytest.mark.parametrize("width,height", [(1920, 1080), (90, 50), (1, 2), (33, 17)])
def test_yuv420_to_bgr_matches_plain(cuda_device, width, height):
    """yuv420_to_bgr against yuv420_to_bgr_plain on seeded planes (every
    byte value, odd sizes cropped from their macroblock padding): bit-equal."""
    from moda_tpu_torch.preproc import m4v as M

    g = M.Geometry(width, height, -(-width // 16), -(-height // 16))
    gen = torch.Generator().manual_seed(width)
    frame = torch.randint(0, 256, (g.frame_bytes,), generator=gen, dtype=torch.uint8)
    before = M.launches["yuv420_to_bgr"]
    got = M.yuv420_to_bgr(frame.to(cuda_device), g)
    torch.cuda.synchronize()
    assert M.launches["yuv420_to_bgr"] == before + 1
    assert torch.equal(got.cpu(), M.yuv420_to_bgr_plain(frame, g))


@pytest.mark.parametrize("name", ["clip_mpeg4.mp4", "clip_mpeg4_1080p.mp4"])
def test_m4v_decoder_matches_cv2_on_the_goldens(cuda_device, name):
    """Mpeg4Decoder on the card over every sample of a committed cv2 clip:
    each picture's SHA-256 equals cv2.VideoCapture's recorded one
    (tests/goldens/video_readings.json), two kernel launches a VOP."""
    import hashlib
    import json
    import os

    from moda_tpu_torch.preproc import m4v as M
    from moda_tpu_torch.preproc.video import open_video

    goldens = os.path.join(os.path.dirname(__file__), "goldens")
    with open(os.path.join(goldens, "video_readings.json")) as f:
        want = json.load(f)[name]["all_pixels_sha256"]
    clip = open_video(os.path.join(goldens, name))
    dec = M.Mpeg4Decoder(clip, cuda_device)
    M.reset_launches()
    got = [hashlib.sha256(dec.decode(clip.sample(i)).cpu().numpy().tobytes()).hexdigest()
           for i in range(len(clip))]
    assert got == want
    assert M.launches == {"m4v_reconstruct": len(clip), "yuv420_to_bgr": len(clip)}


def _h264_writer():
    """tests/torch_h264.py loaded by its path (another installed package may
    be named ``tests`` where the card is)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "torch_h264.py")
    spec = importlib.util.spec_from_file_location("torch_h264", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _h264_stepwise(samples, config, dev):
    """Each sample of an H.264 track decoded twice, by the plain versions on
    the CPU and by the kernels on ``dev``, compared after every kernel step
    (preproc/h264.py::picture_steps): [(picture index, kernel name)] of the
    steps that launched, and the launches counted."""
    from moda_tpu_torch.preproc import h264 as D

    parser = D.Parser(config)
    dpb_c = dpb_g = None
    ran = []
    D.reset_launches()
    for i, sample in enumerate(samples):
        pic = parser.parse(sample)
        if pic is None:
            continue
        g = parser.geometry
        if dpb_c is None:
            dpb_c = torch.zeros((g.slots, g.frame_bytes), dtype=torch.uint8)
            dpb_g = dpb_c.to(dev)
        wc, wg = D.to_device(pic, g, "cpu"), D.to_device(pic, g, dev)
        for (name, n, cpu_step), (_, _, card_step) in zip(D.picture_steps(wc, pic.slot, g),
                                                          D.picture_steps(wg, pic.slot, g)):
            cpu_step(dpb_c, plain=True)
            card_step(dpb_g)
            torch.cuda.synchronize()
            assert torch.equal(dpb_g[pic.slot].cpu(), dpb_c[pic.slot]), (i, name)
            if n:
                ran.append((i, name))
    return ran, dict(D.launches)


H264_CASES = ("intra_types", "p_partitions", "mv_outside", "refs_mmco_long_term",
              "slices_deblocking", "constrained_intra", "qp_0", "qp_51", "level_escapes",
              "chroma_qp_offset_minus", "cropped_176x144_frame_num_wrap")


@pytest.mark.parametrize("case", H264_CASES)
def test_h264_kernels_match_plain(cuda_device, case):
    """h264_inter, h264_intra and h264_deblock against their plain versions
    on the writer's seeded streams (tests/torch_h264.py, each case a tool
    mix), picture by picture and step by step: integer arithmetic
    throughout, so bit-equal; launches as the launch lists say (inter one a
    picture with P or skipped macroblocks, intra and deblock one a non-empty
    wavefront)."""
    H = _h264_writer()
    seq, samples = H.random_stream(seed=7, **H.CASES[case])
    ran, launches = _h264_stepwise([H.sample_bytes(s) for s in samples], H.avcc(seq), cuda_device)
    assert {name for _, name in ran} >= ({"h264_intra", "h264_deblock"} if case != "qp_0"
                                         else {"h264_intra"})
    assert launches["h264_inter"] == sum(name == "h264_inter" for _, name in ran)
    assert launches["h264_intra"] >= sum(name == "h264_intra" for _, name in ran)


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("case", ["intra_8x8", "p_partitions_8x8", "constrained_intra_8x8",
                                  "lists_pps_falls_back_to_sps", "lists_explicit_sps"])
def test_h264_kernels_match_plain_at_high_profile(cuda_device, case, entropy):
    """The three H.264 kernels against their plain versions on the writer's
    High-profile streams (the 8x8 transform in I and P macroblocks, Intra
    8x8, scaling lists), picture by picture and step by step: bit-equal."""
    H = _h264_writer()
    seq, samples = H.random_stream(seed=7, entropy=entropy, **H.high_case(case, 7))
    ran, launches = _h264_stepwise([H.sample_bytes(s) for s in samples], H.avcc(seq), cuda_device)
    assert {name for _, name in ran} >= {"h264_intra", "h264_deblock"}
    assert launches["h264_inter"] == sum(name == "h264_inter" for _, name in ran)


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("case", ["b_partitions", "b_temporal_direct", "b_pyramid_implicit",
                                  "b_explicit_weights", "b_no_direct_inference", "b_high_8x8",
                                  "p_weighted"])
def test_h264_kernels_match_plain_on_b_slices(cuda_device, case, entropy):
    """The three H.264 kernels against their plain versions on the writer's
    B-slice and weighted-prediction streams (bi-prediction under the
    default, explicit and implicit weights, direct prediction, explicit
    weights in P slices), picture by picture and step by step: bit-equal."""
    H = _h264_writer()
    seq, samples = H.random_stream(seed=7, entropy=entropy, **H.b_case(case))
    ran, launches = _h264_stepwise([H.sample_bytes(s) for s in samples], H.avcc(seq), cuda_device)
    assert {name for _, name in ran} >= {"h264_inter", "h264_intra", "h264_deblock"}
    assert launches["h264_inter"] == sum(name == "h264_inter" for _, name in ran)


@pytest.mark.parametrize("width,height,left,top,matrix", [(1920, 1080, 0, 0, 0),
                                                          (70, 38, 64, 2, 1), (30, 18, 0, 6, 0)])
def test_yuv420_to_bgr_with_a_crop_matches_plain(cuda_device, width, height, left, top, matrix):
    """yuv420_to_bgr with an H.264 crop's offsets and a colour matrix's
    coefficients (BT.601, BT.709) against yuv420_to_bgr_plain: bit-equal."""
    from moda_tpu_torch.preproc import h264 as D
    from moda_tpu_torch.preproc import m4v as M

    mb_w, mb_h = -(-(width + left) // 16), -(-(height + top) // 16)
    g = M.Geometry(width, height, mb_w, mb_h)
    gen = torch.Generator().manual_seed(width)
    frame = torch.randint(0, 256, (g.frame_bytes,), generator=gen, dtype=torch.uint8)
    got = M.yuv420_to_bgr(frame.to(cuda_device), g, left, top, D.COEFFS[matrix])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), M.yuv420_to_bgr_plain(frame, g, left, top, D.COEFFS[matrix]))


@pytest.mark.parametrize("name", ["clip_h264_small.mp4", "clip_h264_cabac_small.mp4",
                                  "clip_h264_high_small.mp4", "clip_h264_1080p_high.mp4",
                                  "clip_h264_b_small.mp4", "clip_h264_b_cabac_small.mp4"])
def test_h264_decoder_matches_cv2_on_the_goldens(cuda_device, name):
    """H264Decoder on the card over every sample of a committed clip: each
    picture's SHA-256 equals cv2.VideoCapture's recorded one
    (tests/goldens/video_readings.json)."""
    import hashlib
    import json
    import os

    from moda_tpu_torch.preproc import h264 as D
    from moda_tpu_torch.preproc.video import open_video

    goldens = os.path.join(os.path.dirname(__file__), "goldens")
    with open(os.path.join(goldens, "video_readings.json")) as f:
        want = json.load(f)[name]["all_pixels_sha256"]
    clip = open_video(os.path.join(goldens, name))
    dec = D.H264Decoder(clip, cuda_device)
    frames = [f for f in map(dec.decode, map(clip.sample, range(len(clip)))) if f is not None]
    got = [hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest() for f in frames + dec.flush()]
    assert got == want
