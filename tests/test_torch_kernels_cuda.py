"""The hand-written CUDA kernels (K1 forward, K2 backward of the fused
NeRF MLP) against their plain PyTorch version on the card. They have no
CPU or interpret mode, so these tests need a CUDA card: they carry the
``cuda`` marker and skip without one. Run on a card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.

Tolerance: relative L2 error against the plain version in bf16 mode, 1e-2
on outputs and 2e-2 on gradients (both round the same operands and
cotangents to bf16; only fp32 summation order differs).
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
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    specs, ct, cd = SITE_NETS[S]
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
