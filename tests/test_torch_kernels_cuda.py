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
