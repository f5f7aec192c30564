"""The port's DIS optical flow (moda_tpu_torch/preproc/dis_flow.py) against
cv2's and the JAX package's on the CPU, stage by stage and as a whole.

cv2 is the oracle: the JAX package's pipeline.dis_flow is
``cv2.DISOpticalFlow_create(PRESET_MEDIUM).calc``. Gates:
- grey, the INTER_AREA pyramid, the Sobel gradients and both float
  INTER_LINEAR resizes: bit-equal to cv2;
- the variational refinement alone: within 1e-3 px of
  cv2.VariationalRefinement everywhere, given the same frames and flow;
- whole DIS, three scenes (a translation, a smooth non-rigid warp, two
  layers with an occlusion) in three settings (propagation and refinement
  off; propagation on; PRESET_MEDIUM): endpoint difference from cv2's flow
  with median <= 1e-3 px and p99 <= 0.05 px, and endpoint error against the
  known motion within 5% of cv2's. The JAX package's dis_flow is held to the
  same gates.
The patch search runs here in its plain version (``patch_search_plain``);
the kernel is held against it on the card (tests/test_torch_kernels_cuda.py).
"""
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.preproc import pipeline as JP
from moda_tpu_torch.preproc import dis_flow as D
from moda_tpu_torch.preproc import pipeline as TP

SETTINGS = {"plain": dict(use_spatial_propagation=False, var_refine_iter=0),
            "propagation": dict(var_refine_iter=0),
            "medium": {}}
SCENES = ("translation", "warp", "layers")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def texture(rng, h: int, w: int, sigma: float = 1.5) -> np.ndarray:
    return cv2.GaussianBlur((rng.random((h, w, 3)) * 255).astype(np.uint8), (0, 0), sigma)


def scene(kind: str, h: int = 96, w: int = 128, seed: int = 0):
    """(img0, img1, flow): two BGR frames and the motion img0 -> img1.
    translation: (2.6, -1.3) px everywhere; warp: a smooth sine field of up
    to 4 px; layers: a textured box moving (4, 2) px over a background
    moving 0.5 px, which it covers and uncovers."""
    rng = np.random.default_rng(seed)
    tex = texture(rng, h + 40, w + 40)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    box = None
    if kind == "translation":
        fx, fy = np.full((h, w), 2.6, np.float32), np.full((h, w), -1.3, np.float32)
    elif kind == "warp":
        fx = (3.0 * np.sin(2 * np.pi * ys / h) + 1.0).astype(np.float32)
        fy = (2.0 * np.cos(2 * np.pi * xs / w)).astype(np.float32)
    else:
        fx, fy = np.full((h, w), 0.5, np.float32), np.zeros((h, w), np.float32)
        box = (ys > h * 0.3) & (ys < h * 0.7) & (xs > w * 0.3) & (xs < w * 0.6)
        fx[box], fy[box] = 4.0, 2.0
    img0 = tex[20:20 + h, 20:20 + w].copy()
    img1 = cv2.remap(tex, xs + 20 - fx, ys + 20 - fy, cv2.INTER_LINEAR)
    if box is not None:
        fg = texture(np.random.default_rng(seed + 1), h, w, 1.0)
        img0[box] = fg[box]
        moved = np.roll(box, (2, 4), (0, 1))
        img1[moved] = np.roll(fg, (2, 4), (0, 1))[moved]
    return img0, img1, np.stack([fx, fy], -1)


def cv2_dis(g0, g1, setting: str) -> np.ndarray:
    d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    kw = SETTINGS[setting]
    if "use_spatial_propagation" in kw:
        d.setUseSpatialPropagation(kw["use_spatial_propagation"])
    if "var_refine_iter" in kw:
        d.setVariationalRefinementIterations(kw["var_refine_iter"])
    return d.calc(g0, g1, None)


def dis_gate(got, want, truth, tag):
    e = np.linalg.norm(got - want, axis=-1)
    assert np.median(e) <= 1e-3 and np.percentile(e, 99) <= 0.05, \
        f"{tag}: median {np.median(e):.2e}, p99 {np.percentile(e, 99):.2e}"
    epe = np.linalg.norm(got - truth, axis=-1).mean()
    ref = np.linalg.norm(want - truth, axis=-1).mean()
    assert epe <= 1.05 * ref, f"{tag}: endpoint error {epe:.4f} against cv2's {ref:.4f}"


def test_import_pulls_in_no_jax_cv2_or_jax_package():
    code = ("import sys, moda_tpu_torch.preproc.dis_flow, moda_tpu_torch.preproc.pipeline; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'cv2', 'moda_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_gray_is_cv2_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(D.bgr_to_gray(torch.from_numpy(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("src,dst", [((96, 128), (48, 64)), ((135, 240), (67, 120)),
                                     ((97, 131), (48, 65)), ((67, 120), (33, 60)),
                                     ((33, 60), (16, 30))])
def test_area_pyramid_and_gradients_are_cv2(src, dst):
    """INTER_AREA halvings (exact 2x, and cv2's float weights where a size
    is odd) and spatialGradient, bit-equal."""
    rng = np.random.default_rng(src[0])
    img = cv2.GaussianBlur((rng.random(src) * 255).astype(np.uint8), (3, 3), 0)
    got = D.resize_area_u8(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))
    gx, gy = D.spatial_gradient(torch.from_numpy(got))
    cx, cy = cv2.spatialGradient(got)
    np.testing.assert_array_equal(gx.numpy(), cx)
    np.testing.assert_array_equal(gy.numpy(), cy)


@pytest.mark.parametrize("src,dst", [((60, 80), (120, 160)), ((67, 120), (135, 240)),
                                     ((48, 65), (97, 131)), ((16, 30), (33, 60))])
def test_flow_upsampling_is_cv2(src, dst):
    """The scale-to-scale resize (cv2 on one plane) and the final one (cv2
    on the interleaved two-channel flow), bit-equal."""
    f = np.random.default_rng(src[1]).standard_normal((2,) + src).astype(np.float32)
    got = D.resize_linear(torch.from_numpy(f), dst).numpy()
    np.testing.assert_array_equal(got, np.stack([cv2.resize(p, dst[::-1]) for p in f]))
    got = D.resize_linear(torch.from_numpy(f), dst, planes=False).numpy()
    want = cv2.resize(np.ascontiguousarray(f.transpose(1, 2, 0)), dst[::-1])
    np.testing.assert_array_equal(got, want.transpose(2, 0, 1))


@pytest.mark.parametrize("h,w", [(96, 128), (100, 333), (480, 640), (1080, 1920), (37, 53)])
def test_coarsest_scale_is_cv2s_rule(h, w):
    """cv2 with coarsest scale -1 gives what it gives with the rule's level,
    and a coarser cap changes nothing; one level less changes the flow."""
    rng = np.random.default_rng(h)
    small = cv2.GaussianBlur((rng.random((h, w)) * 255).astype(np.uint8), (7, 7), 2)
    g1 = np.roll(small, (1, 2), (0, 1))
    k = D.coarsest_scale(h, w)

    def flow(scale):
        d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
        d.setVariationalRefinementIterations(0)
        d.setCoarsestScale(scale)
        return d.calc(small, g1, None)

    auto = flow(-1)
    assert np.array_equal(flow(k), auto) and np.array_equal(flow(k + 1), auto)
    if k > D.FINEST_SCALE:
        assert not np.array_equal(flow(k - 1), auto)


@pytest.mark.parametrize("fixed,sor", [(1, 1), (5, 5)])
def test_variational_refinement_matches_cv2(fixed, sor):
    img0, img1, _ = scene("warp", 60, 80, seed=3)
    g0, g1 = cv2.cvtColor(img0, cv2.COLOR_BGR2GRAY), cv2.cvtColor(img1, cv2.COLOR_BGR2GRAY)
    rng = np.random.default_rng(4)
    u = cv2.GaussianBlur((1.5 + 0.3 * rng.standard_normal((60, 80))).astype(np.float32), (5, 5), 2)
    v = cv2.GaussianBlur((0.8 + 0.3 * rng.standard_normal((60, 80))).astype(np.float32), (5, 5), 2)
    vr = cv2.VariationalRefinement_create()
    vr.setFixedPointIterations(fixed)
    vr.setSorIterations(sor)
    cu, cv = vr.calcUV(g0, g1, u.copy(), v.copy())
    got = D.variational_refinement(torch.from_numpy(g0), torch.from_numpy(g1),
                                   torch.from_numpy(np.stack([u, v])),
                                   fixed_point_iter=fixed, sor_iter=sor).numpy()
    assert np.abs(cu - u).max() > 0.05  # the refinement moved the flow
    assert np.abs(got[0] - cu).max() <= 1e-3 and np.abs(got[1] - cv).max() <= 1e-3


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("kind", SCENES)
def test_dis_matches_cv2(kind, setting):
    img0, img1, truth = scene(kind)
    g0, g1 = cv2.cvtColor(img0, cv2.COLOR_BGR2GRAY), cv2.cvtColor(img1, cv2.COLOR_BGR2GRAY)
    got = D.calc(torch.from_numpy(g0), torch.from_numpy(g1), D.DISParams(**SETTINGS[setting]))
    assert got.dtype == torch.float32 and got.shape == (96, 128, 2)
    dis_gate(got.numpy(), cv2_dis(g0, g1, setting), truth, f"{kind}/{setting}")


@pytest.mark.parametrize("kind,h,w", [("translation", 120, 160), ("layers", 240, 320)])
def test_pipeline_dis_flow_matches_the_jax_packages(kind, h, w):
    """pipeline.dis_flow on BGR frames in both packages (PRESET_MEDIUM),
    three pyramid levels at 240 x 320."""
    img0, img1, truth = scene(kind, h, w, seed=1)
    got = TP.dis_flow(img0, img1, device="cpu")
    assert got.dtype == np.float32 and got.shape == (h, w, 2)
    dis_gate(got, JP.dis_flow(img0, img1), truth, kind)


def test_dis_flow_translation():
    """DIS flow recovers a synthetic integer shift (the port's counterpart
    of tests/test_preproc.py::test_dis_flow_translation)."""
    rng = np.random.default_rng(0)
    img0 = cv2.GaussianBlur((rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8), (5, 5), 1.5)
    img1 = np.roll(img0, 3, axis=1)
    flow = TP.dis_flow(img0, img1, device="cpu")
    inner = flow[16:48, 16:48]
    assert abs(np.median(inner[..., 0]) - 3) < 1.0 and abs(np.median(inner[..., 1])) < 1.0
    np.testing.assert_allclose(flow, JP.dis_flow(img0, img1), rtol=0, atol=1e-3)


def test_plain_search_is_the_wrapper_on_the_cpu_and_counts_no_launch():
    img0, img1, _ = scene("warp", 48, 64)
    g0 = torch.from_numpy(cv2.cvtColor(img0, cv2.COLOR_BGR2GRAY))
    g1 = torch.from_numpy(cv2.cvtColor(img1, cv2.COLOR_BGR2GRAY))
    gx, gy = D.spatial_gradient(g0)
    st = D.structure_tensor(gx, gy)
    ext = torch.nn.functional.pad(g1[None, None].float(), (D.BORDER,) * 4,
                                  mode="replicate")[0, 0].to(torch.uint8)
    U = torch.zeros(2, 48, 64)
    before = D.launches["patch_search"]
    S = D.patch_search(g0, ext, gx, gy, U, st)
    assert D.launches["patch_search"] == before
    assert torch.equal(S, D.patch_search_plain(g0, ext, gx, gy, U, st))
    assert S.shape == (2, 14, 19) and torch.isfinite(S).all()


def test_a_tensor_off_the_cpu_goes_to_the_kernel_or_raises(monkeypatch):
    """No fallback: a tensor that is not on the CPU takes the kernel's route,
    which raises here (no nvcc, no card) instead of running the plain
    version."""
    def no_build():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(D, "build_library", no_build)
    g = torch.zeros(48, 64, dtype=torch.uint8, device="meta")
    gx = torch.zeros(48, 64, dtype=torch.int16, device="meta")
    ext = torch.zeros(80, 96, dtype=torch.uint8, device="meta")
    U = torch.zeros(2, 48, 64, device="meta")
    st = torch.zeros(5, 14, 19, device="meta")
    with pytest.raises(RuntimeError, match="no nvcc"):
        D.patch_search(g, ext, gx, gx, U, st)
    with pytest.raises(ValueError, match="int16"):
        D.patch_search(g, ext, gx.to(torch.int32), gx, U, st)


# (h, w) of one scale's patch search: 1920 x 1080's six scales, 3840 x 2160's
# finest and a portrait 1080p frame's (stripes of 45 and 40 patch rows: some
# warps take two rows), the CUDA test's 120 x 160 and a scale of one patch row
GEOMETRY_HW = [(1080 >> s, 1920 >> s) for s in range(D.FINEST_SCALE, D.coarsest_scale(1080, 1920)
                                                     + 1)] + [(1080, 1920), (960, 540), (120, 160),
                                                              (8, 23)]


@pytest.mark.parametrize("prop", [True, False])
@pytest.mark.parametrize("h,w", GEOMETRY_HW)
def test_search_geometry_gives_every_patch_to_one_warp(h, w, prop):
    """dis_patch_search's launch shape (``search_geometry``): with spatial
    propagation one CTA a non-empty stripe of cv2's cut (stripe_sz =
    ceil(hs / 8)), and every patch row of a stripe searched by exactly one of
    its warps, as the kernel loops over them (rows w, w + warps, ...);
    without it one warp a patch. Never more than 32 warps a CTA."""
    hs, ws = D.patch_grid(h, w)
    assert (hs, ws) == (1 + (h - 8) // 3, 1 + (w - 8) // 3)
    g = D.search_geometry(hs, ws, prop)
    assert 1 <= g.warps <= 32 and g.ctas >= 1
    if not prop:
        assert g.stripe == 0
        assert (g.ctas - 1) * g.warps < hs * ws <= g.ctas * g.warps
        return
    sz = -(-hs // 8)
    cut = [(min(s * sz, hs), min((s + 1) * sz, hs)) for s in range(8)]
    cut = [(a, b) for a, b in cut if a < b]
    assert g.ctas == len(cut)
    owner = {}
    for c in range(g.ctas):
        a, b = c * g.stripe, min((c + 1) * g.stripe, hs)
        assert (a, b) == cut[c]
        for wp in range(g.warps):
            for r in range(a + wp, b, g.warps):
                assert r not in owner, f"patch row {r} searched by two warps"
                owner[r] = (c, wp)
    assert sorted(owner) == list(range(hs))
    assert g.warps == min(32, sz)


def test_ptxas_usage_reads_registers_and_spills():
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__f2b1f58e_6_dis_cu_42ba6a73"
        "18dis_search_patchesENS_5ScaleEPKfS2_i' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN38_GLOBAL__N__f2b1f58e_6_dis_cu_42ba6a73"
        "18dis_search_patchesENS_5ScaleEPKfS2_i",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__f2b1f58e_6_dis_cu_42ba6a73"
        "18dis_search_stripesENS_5ScaleEPKfS2_iii' for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers"])
    assert D.ptxas_usage(report) == {
        "patches": {"registers": 40, "spill_stores": 0, "spill_loads": 0},
        "stripes": {"registers": 64, "spill_stores": 12, "spill_loads": 16}}
