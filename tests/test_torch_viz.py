"""The port's viz tools (moda_tpu_torch/viz, cli/nvs_app.py, cli/match_app.py)
against moda_tpu's on the CPU, from the same seeded numpy inputs and
bridged weights (one JAX init per configuration, tests/torch_parity.py).

Tolerances:
- turntable cameras, bone meshes, vertex normals: bit-equal (the same numpy
  code); mesh views and turntables: 1e-6 absolute (the same native
  rasterizer on the same float32 vertices);
- render_nvs and render_nvs_ctraj: every image within 1e-5 relative L2
  (both fp32 with the same ray chunking; summation order moves a
  silhouette by up to 7e-6 relative, 1e-5 absolute at 0.3);
- match_frames: canonical points 1e-5 absolute and pixels 5e-3 absolute,
  with use_pallas off (both fp32; read 5.5e-7 and 9.0e-4) and on (the
  Sinkhorn reads its kernel matrix rounded to bf16 on both sides, the
  MLPs stay fp32 on the CPU; read 1.5e-6 and 8.6e-4). The pixels move
  more than the points because some points lie close to the camera
  (depth 0.014 at focal 8);
- the line drawer and draw_matches: bit-equal to cv2.line / the JAX
  package's cv2 canvas;
- save_gif: PIL reads back exactly the writer's quantized frames, with
  the frame count and the 1/fps delay.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from moda_tpu.extract.mesh import Mesh as JMesh
from moda_tpu.viz import match as JM
from moda_tpu.viz import nvs as JN
from moda_tpu.viz import render_vis as JRV
from moda_tpu_torch.extract.mesh import Mesh
from moda_tpu_torch.viz import match as TM
from moda_tpu_torch.viz import nvs as TN
from moda_tpu_torch.viz import render_vis as RV
from tests.torch_parity import both_models

NVS_TOL = 1e-5  # relative L2 of each rendered image


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _base_rtk():
    """tests/test_viz_goldens.py's camera."""
    base = np.zeros((4, 4), np.float32)
    base[:3, :3] = np.eye(3)
    base[:3, 3] = [0, 0, 0.3]
    base[3] = [8.0, 8.0, 4.0, 4.0]
    return base


def _color_sphere(seed=0):
    v, f = RV.unit_sphere(2)
    rng = np.random.default_rng(seed)
    v = (v * np.asarray([0.4, 0.3, 0.35], np.float32) + [0.05, -0.02, 0.0]).astype(np.float32)
    return v, f, rng.uniform(0, 1, v.shape).astype(np.float32)


# ------------------------------------------------------------ host drawing
@pytest.mark.parametrize("axis", ["y", "x"])
def test_turntable_cams_match_jax(axis):
    base = _base_rtk()
    base[:3, :3] = cv2.Rodrigues(np.asarray([0.3, -0.2, 0.1]))[0]
    np.testing.assert_array_equal(TN.turntable_cams(base, 5, axis),
                                  JN.turntable_cams(base, 5, axis))


def test_bone_meshes_and_normals_match_jax():
    rng = np.random.default_rng(1)
    bones = rng.normal(size=(4, 10)).astype(np.float32)
    t, j = RV.bones_to_mesh(bones), JRV.bones_to_mesh(bones)
    for a, b in ((t.vertices, j.vertices), (t.faces, j.faces), (t.colors, j.colors)):
        np.testing.assert_array_equal(a, b)
    v, f, c = _color_sphere()
    np.testing.assert_array_equal(RV.vertex_normals(Mesh(v, f, c)),
                                  JRV.vertex_normals(JMesh(v, f, c)))


@pytest.mark.parametrize("shade", [True, False])
def test_mesh_views_and_turntable_match_jax(shade):
    v, f, c = _color_sphere()
    rtk = _base_rtk()
    rtk[:3, 3] = [0.02, 0.01, 1.2]
    rtk[3] = [30.0, 28.0, 12.0, 11.0]
    np.testing.assert_allclose(RV.render_mesh_view(Mesh(v, f, c), rtk, 24, shade=shade),
                               JRV.render_mesh_view(JMesh(v, f, c), rtk, 24, shade=shade),
                               atol=1e-6)
    mesh_c = (v, f, c) if shade else (v, f, None)
    tt, jt = RV.render_turntable(Mesh(*mesh_c), 3, 20), JRV.render_turntable(JMesh(*mesh_c), 3,
                                                                              20)
    assert len(tt) == len(jt) == 3
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a, b, atol=1e-6)
    # an empty mesh: white views
    assert (RV.render_turntable(Mesh(), 2, 8)[1] == 1).all()


@pytest.mark.parametrize("kind", ["few_colours", "many_colours"])
def test_save_gif_reads_back_with_pil(tmp_path, kind):
    rng = np.random.default_rng(2)
    if kind == "few_colours":
        frames = [np.floor(rng.uniform(size=(13, 17, 3)) * 5) / 4 for _ in range(3)]
        fps = 4
    else:
        y, x = np.mgrid[0:40, 0:50] / 40.0
        frames = [np.clip(np.stack([x, y, (x * y + 0.1 * i) % 1], -1)
                          + rng.normal(0, 0.05, (40, 50, 3)), 0, 1) for i in range(4)]
        fps = 10
    path = str(tmp_path / "a.gif")
    RV.save_gif(path, frames, fps=fps)
    palette, idx = RV.quantize(frames)
    assert idx.shape == (len(frames),) + frames[0].shape[:2]
    quant = palette[idx]
    u8 = np.stack([RV.to_uint8(f) for f in frames])
    if kind == "few_colours":
        np.testing.assert_array_equal(quant, u8)  # <= 256 colours: lossless
    else:
        assert len(np.unique(u8.reshape(-1, 3), axis=0)) > 256
        # the median cut beats a fixed 3-3-2-bit palette of 256 colours
        step = np.asarray([32, 32, 64])
        fixed = u8 // step * step + step // 2
        assert np.abs(quant.astype(int) - u8).mean() < np.abs(fixed - u8.astype(int)).mean()
    with Image.open(path) as im:
        assert im.n_frames == len(frames) and im.size == frames[0].shape[1::-1]
        for i in range(im.n_frames):
            im.seek(i)
            assert im.info["duration"] == 1000 / fps
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), quant[i])
    info = RV.gif_info(path)
    assert (info["frames"], info["height"], info["width"]) == (len(frames),) + frames[0].shape[:2]
    assert info["delays"] == [100 // fps] * len(frames)
    # the same frames give the same bytes
    RV.save_gif(str(tmp_path / "b.gif"), frames, fps=fps)
    assert open(path, "rb").read() == open(tmp_path / "b.gif", "rb").read()


def test_line_drawer_is_bit_equal_to_cv2():
    rng = np.random.default_rng(3)
    n_cross = 0
    for i in range(300):
        h, w = (int(s) for s in rng.integers(1, 48, 2))
        span = 10_000 if i % 10 == 0 else 80
        p0, p1 = (tuple(int(c) for c in rng.integers(-span, span, 2)) for _ in range(2))
        if i % 3 == 0:  # one end inside: the segment crosses the border
            p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        color = rng.integers(0, 256, 3).astype(np.uint8)
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.line(want, p0, p1, tuple(int(c) for c in color), 1)
        TM.draw_line(got, p0, p1, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {p0} {p1}")
        inside = [0 <= p[0] < w and 0 <= p[1] < h for p in (p0, p1)]
        n_cross += inside[0] != inside[1]
    assert n_cross >= 60


def test_draw_matches_matches_jax():
    rng = np.random.default_rng(4)
    img0, img1 = rng.uniform(size=(20, 16, 3)), rng.uniform(size=(18, 24, 3))
    xys0 = rng.uniform(-5, 22, (30, 2)).astype(np.float32)
    xys1 = rng.uniform(-8, 30, (30, 2)).astype(np.float32)
    np.testing.assert_array_equal(TM.draw_matches(img0, img1, xys0, xys1),
                                  JM.draw_matches(img0, img1, xys0, xys1))


# ------------------------------------------------------------ model renders
@pytest.fixture(scope="module")
def tiny():
    """tests/test_render_pipeline.py::tiny_setup's configuration in both
    packages."""
    return both_models(use_unc=True)


def test_render_nvs_matches_jax(tiny):
    """tests/test_viz_goldens.py::_compute's NVS inputs."""
    cfg, model, params, mvars, tmodel = tiny
    cams = JN.turntable_cams(_base_rtk(), num_views=2)
    want = JN.render_nvs(model, params, mvars, cams, [0, 1], render_size=8, ndepth=cfg.ndepth,
                         chunk=64)
    got = TN.render_nvs(tmodel, cams, [0, 1], render_size=8, ndepth=cfg.ndepth, chunk=64)
    for g, w in zip(got, want):
        for k in ("img_coarse", "sil_coarse", "vis_pred"):
            assert g[k].shape == w[k].shape
            assert _rel(g[k], w[k]) <= NVS_TOL, (k, _rel(g[k], w[k]))
    assert got[0]["sil_coarse"].max() > 0.01  # the frames show the object


@pytest.mark.parametrize("use_pallas", [False, True])
def test_match_frames_matches_jax(use_pallas):
    """tests/test_viz_goldens.py::_compute's match inputs."""
    cfg, model, params, mvars, tmodel = both_models(use_unc=True, use_pallas=use_pallas)
    rng = np.random.default_rng(11)
    feats0 = rng.normal(size=(8, 16)).astype(np.float32)
    feats0 /= np.linalg.norm(feats0, axis=-1, keepdims=True)
    xys0 = rng.uniform(2, 14, size=(8, 2)).astype(np.float32)
    kaug = np.asarray([1.0, 1.0, 0.0, 0.0], np.float32)
    args = (feats0, xys0, _base_rtk(), _base_rtk(), kaug, 0, 1)
    jp, jx = JM.match_frames(model, params, mvars, *args, grid_size=cfg.feat_ndepth_grid)
    tp, tx = TM.match_frames(tmodel, *args, grid_size=cfg.feat_ndepth_grid)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tx, np.asarray(jx), atol=5e-3)


def _write_ctraj(prefix, rtks, sils):
    for i, (rtk, sil) in enumerate(zip(rtks, sils)):
        np.savetxt(f"{prefix}ctrajs-{i:05d}.txt", rtk)
        RV.save_png(f"{prefix}refsil-{i:05d}.png", sil)


def _ctraj_inputs(shape, n=3):
    """n cameras orbiting the tiny model with intrinsics at a w x h
    silhouette's scale, and elliptic silhouettes at 128."""
    h, w = shape
    rtks = TN.turntable_cams(_base_rtk(), n)
    rtks[:, 3] = [2.0 * max(h, w), 2.0 * max(h, w), w / 2.0, h / 2.0]
    y, x = np.mgrid[0:h, 0:w]
    sils = [(((x - w / 2) / (0.35 * w)) ** 2 + ((y - h / 2 - i) / (0.4 * h)) ** 2 < 1)
            .astype(np.uint8) * 128 for i in range(n)]
    return rtks, sils


@pytest.mark.parametrize("shape", [(30, 22), (22, 30)], ids=["vert", "hori"])
def test_render_nvs_ctraj_matches_jax(tiny, tmp_path, shape):
    """A tiny ctraj/refsil set written to disk, read back by both packages'
    load_root/load_sils, and rendered composited at scale 0.5."""
    cfg, model, params, mvars, tmodel = tiny
    prefix = str(tmp_path / "s-")
    _write_ctraj(prefix, *_ctraj_inputs(shape))
    rtks = TN.load_root(prefix + "ctrajs-")
    np.testing.assert_array_equal(rtks, JN.load_root(prefix + "ctrajs-"))
    sils = TN.load_sils(prefix + "refsil-")
    for a, b in zip(sils, JN.load_sils(prefix + "refsil-")):
        np.testing.assert_array_equal(a, b)
    b = np.asarray(mvars.obj_bound)
    verts = np.random.default_rng(5).uniform(-0.5, 0.5, (40, 3)).astype(np.float32) * b
    kw = dict(scale=0.5, chunk=64, mesh_rest_verts=verts)
    want = JN.render_nvs_ctraj(model, params, mvars, rtks, sils, [0, 2, 4], cfg.ndepth, **kw)
    got = TN.render_nvs_ctraj(tmodel, rtks, sils, [0, 2, 4], cfg.ndepth, **kw)
    short = int(min(shape) * 15 / max(shape))
    for g, w in zip(got, want):
        for k in ("rgb", "sil", "vis"):
            assert g[k].shape[:2] == ((15, short) if shape[0] > shape[1] else (short, 15))
            assert _rel(g[k], w[k]) <= NVS_TOL, (k, _rel(g[k], w[k]))
    # the composite shows rendered pixels inside the silhouette
    assert any((g["sil"] < 1).any() for g in got)


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def scene_ckpt(tmp_path_factory):
    """A 4-frame 32 px MeshScene in the DAVIS layout and a checkpoint of an
    untrained tiny model with the scene's cameras: (flags, log dir)."""
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data.synth_mesh import MeshScene
    from moda_tpu_torch.data.synthetic import write_frame_dataset
    from moda_tpu_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("viz_apps")
    db, cfgd, log = str(root / "db"), str(root / "cfg"), str(root / "log")
    write_frame_dataset(db, cfgd, "flap", MeshScene(img_size=32, num_frames=4))
    flags = ["--seqname", "flap", "--config_dir", cfgd, "--logname", "v", "--checkpoint_dir",
             log, "--ndepth", "8", "--img_size", "32", "--num_bones", "3", "--render_size", "8",
             "--chunk", "40", "--feat_ndepth_grid", "4"]
    seq = load_seq_config("flap", cfgd)[0]
    tr = Trainer(parse_config(flags), DataInfo(offset=(0, 4), intrinsics=(tuple(seq.ks),)),
                 device="cpu")
    rtks = np.stack([np.loadtxt(os.path.join(db, "Cameras", "Full-Resolution", "flap",
                                             "%05d.txt" % i)) for i in range(4)])
    rtks[:, :3, 3] /= tr.model.obj_scale
    tr.set_cameras_from_rtk_files(rtks.astype(np.float32))
    tr.save("latest")
    return flags + ["--model_path", os.path.join(log, "v", "latest")], log


def test_nvs_app_runs_on_the_cpu(scene_ckpt, tmp_path):
    """Both routes of nvs_app: the replay and bullet-time GIFs, then the
    ctraj route on a written ctraj/refsil set (the frames a --maxframe
    sample of it)."""
    from moda_tpu_torch.cli import nvs_app

    flags, log = scene_ckpt
    tr = nvs_app.main(flags + ["--test_frames", "3"], device="cpu")
    assert tr.model.device.type == "cpu"
    for name in ("replay", "bullet"):
        info = RV.gif_info(os.path.join(log, "v-nvs", f"{name}.gif"))
        assert (info["frames"], info["height"], info["width"]) == (3, 8, 8), name

    prefix = str(tmp_path / "flap-")
    rtks, sils = _ctraj_inputs((24, 20), n=4)
    rtks[:, :3] = tr.latest_vars["rtk"][:, :3]
    _write_ctraj(prefix, rtks, sils)
    out = str(tmp_path / "nvs" / "o")
    nvs_app.main(flags + ["--rootdir", prefix + "ctrajs-", "--nvs_outpath", out, "--scale",
                          "0.5", "--maxframe", "2", "--sample_grid3d", "8"], device="cpu")
    short = int(20 * 12 / 24)
    for i in range(2):
        with Image.open(f"{out}-rgb_{i:05d}.png") as im:
            assert im.mode == "RGB" and im.size == (short, 12)
        for kind in ("sil", "vis"):
            with Image.open(f"{out}-{kind}_{i:05d}.png") as im:
                assert im.mode == "L" and im.size == (short, 12)
    assert not os.path.exists(f"{out}-rgb_00002.png")
    assert RV.gif_info(f"{out}-rgb.gif")["frames"] == 2


def test_chip_smoke_nvs_gate_renders_the_fixed_model_through_nvs_app(scene_ckpt, monkeypatch):
    """chip_smoke.py phase 10's card-against-CPU NVS gate runs nvs_app on
    the checkpoint nvs_fixed_checkpoint writes: the same digest on every
    call, and on the CPU the app's replay frame is nvs_fixed_model's own
    render, bit-equal."""
    import chip_smoke
    from moda_tpu_torch.cli import nvs_app
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.train import ckpt as CK

    flags, log = scene_ckpt
    cfg = parse_config(flags)
    seq = load_seq_config("flap", cfg.config_dir)[0]
    info = DataInfo(offset=(0, 4), intrinsics=(tuple(seq.ks),))
    rtks = CK.load_checkpoint(cfg.model_path)[1]["rtk"]
    path = os.path.join(log, "fixed", "fixed")
    digest = chip_smoke.nvs_fixed_checkpoint(cfg, info, rtks, path)
    assert chip_smoke.nvs_fixed_checkpoint(cfg, info, rtks, path) == digest
    seen, render = [], nvs_app.render_nvs
    monkeypatch.setattr(nvs_app, "render_nvs", lambda *a, **k: seen.append(render(*a, **k)) or
                        seen[-1])
    nvs_app.main(flags + ["--model_path", path, "--logname", "fixed", "--test_frames", "1"],
                 device="cpu")
    want = TN.render_nvs(chip_smoke.nvs_fixed_model(cfg, info, rtks), rtks[:1], [0],
                         cfg.render_size, cfg.ndepth, chunk=cfg.chunk)[0]
    assert seen[0][0].keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(seen[0][0][k], want[k])


def test_match_app_runs_on_the_cpu(scene_ckpt, monkeypatch):
    """match_app on frames 0 and 2: 64 mask pixels matched and drawn; the
    canvas is what draw_matches gives for match_frames' pixels."""
    from moda_tpu_torch.cli import match_app

    flags, log = scene_ckpt
    seen = {}
    match = match_app.match_frames

    def spy(model, feats0, xys0, *a, **kw):
        seen["xys0"], seen["out"] = xys0, match(model, feats0, xys0, *a, **kw)
        return seen["out"]

    monkeypatch.setattr(match_app, "match_frames", spy)
    match_app.main(flags + ["--match_frames", "0 2"], device="cpu")
    path = os.path.join(log, "v-match-0-2.png")
    assert seen["xys0"].shape == (64, 2) and np.isfinite(seen["out"][1]).all()
    with Image.open(path) as im:
        canvas = np.asarray(im.convert("RGB"))
    assert canvas.shape == (32, 64, 3)
    # the lines are drawn over the two frames: the canvas differs from them
    from moda_tpu_torch.data.dataset import build_datasets
    reader = build_datasets("flap", 32, flags[flags.index("--config_dir") + 1])[0].reader
    frames = [reader.read_raw(i, flowfw=True, dframe=1)["img"] for i in (0, 2)]
    np.testing.assert_array_equal(
        canvas, TM.draw_matches(frames[0], frames[1], seen["xys0"], seen["out"][1]))
    assert (canvas != TM.draw_matches(frames[0], frames[1], seen["xys0"][:0],
                                      seen["out"][1][:0])).any()


def test_viz_modules_import_no_jax():
    code = ("import sys\n"
            "import moda_tpu_torch.viz.nvs, moda_tpu_torch.viz.match\n"
            "import moda_tpu_torch.cli.nvs_app, moda_tpu_torch.cli.match_app\n"
            "import moda_tpu_torch.preproc.posenet, moda_tpu_torch.fields.resnet_fpn\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'moda_tpu', 'cv2', 'imageio', 'PIL')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
