"""The port's extraction outputs and scores against moda_tpu's, and its
extraction and scoring entry points on the CPU:

- the native rasterizer and mesh_silhouette: bit-equal images, depths and
  masks;
- chamfer_distance and fscore, icp_align, align_sim3, umeyama_alignment,
  eval_pair and eval_sequence on seeded point clouds and meshes:
  distances, rotations and statistics within 1e-5 relative, F-scores
  within 2e-4 absolute at 10,000 samples (one sample may fall on the other
  side of a threshold; 2 / n at n samples); an empty predicted mesh scores
  NaN / 0 in both;
- the PNG writer: zlib-decoding the file gives back the bytes written;
- extract_app, evals.ama.main and eval_root_app on a tiny line-shard
  scene: the export layout and finite scores (the port alone: the JAX
  extract_app reads frames through the frame-decoding route, which the
  line-shard scene does not have).
"""
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.evals import ama as JA
from moda_tpu.evals import sim3 as JS
from moda_tpu.evals.icp import icp_align as j_icp
from moda_tpu.extract.mesh import Mesh as JMesh
from moda_tpu.native import rasterize as j_rasterize
from moda_tpu.ops.chamfer import chamfer_distance as j_chamfer, fscore as j_fscore
from moda_tpu.viz.render_vis import mesh_silhouette as j_silhouette
from moda_tpu_torch.evals import ama as TA
from moda_tpu_torch.evals import sim3 as TS
from moda_tpu_torch.evals.icp import icp_align as t_icp
from moda_tpu_torch.extract.mesh import Mesh
from moda_tpu_torch.native import marching_cubes, rasterize as t_rasterize
from moda_tpu_torch.ops.chamfer import chamfer_distance as t_chamfer, fscore as t_fscore
from moda_tpu_torch.viz import render_vis as RV


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _ellipsoid(axes=(0.3, 0.2, 0.25), n=24, bump=0.0, seed=0, limbs=False) -> Mesh:
    """Marching-tetrahedra ellipsoid (object units), optionally bumpy and
    with three ball limbs at non-collinear places (a shape ICP locks onto)."""
    x = np.linspace(-1, 1, n, dtype=np.float32)
    p = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1)
    r = np.linalg.norm(p / (np.asarray(axes) / 0.35), axis=-1)
    phase = np.random.default_rng(seed).uniform(0, 6.28)
    vol = 0.35 + bump * np.sin(5 * p[..., 0] + phase) * np.cos(4 * p[..., 1]) - r
    if limbs:
        for c, rad in (((0.45, 0.1, 0.0), 0.22), ((-0.2, 0.45, 0.1), 0.18),
                       ((0.0, -0.2, 0.5), 0.15)):
            vol = np.maximum(vol, rad - np.linalg.norm(p - np.asarray(c), axis=-1))
    v, f = marching_cubes(vol.astype(np.float32), 0.0)
    return Mesh((v - n / 2.0) / n * 2.0, f)


def _cam(a=0.4, size=(48, 40)) -> np.ndarray:
    rtk = np.zeros((4, 4), np.float32)
    rtk[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    rtk[:3, 3] = [0.02, -0.01, 1.0]
    rtk[3] = [60.0, 55.0, size[1] / 2, size[0] / 2]
    return rtk


def test_rasterize_and_silhouette_are_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    verts = np.concatenate([rng.uniform(-4, 36, size=(60, 2)), rng.uniform(0.5, 3, size=(60, 1))],
                           -1).astype(np.float32)
    verts[3, 2] = -1.0  # a face behind the camera is skipped
    faces = rng.integers(0, 60, size=(80, 3)).astype(np.int32)
    attrs = rng.normal(size=(60, 5)).astype(np.float32)
    got = t_rasterize(verts, faces, attrs, 30, 34)
    want = j_rasterize(verts, faces, attrs, 30, 34)
    assert got[2].sum() > 50
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    mesh = _ellipsoid()
    for a in (0.0, 0.7):
        sil = RV.mesh_silhouette(mesh, _cam(a), 48, 40)
        np.testing.assert_array_equal(sil, j_silhouette(JMesh(mesh.vertices, mesh.faces),
                                                        _cam(a), 48, 40))
        assert 0.05 < sil.mean() < 0.9
    assert RV.mesh_silhouette(Mesh(), _cam(), 8, 8).sum() == 0


def test_chamfer_and_fscore_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5000, 3)).astype(np.float32)
    y = (rng.normal(size=(4200, 3)) * 1.1 + 0.05).astype(np.float32)
    jd = [np.asarray(a) for a in j_chamfer(jnp.asarray(x), jnp.asarray(y), tile=1024)]
    td = [a.numpy() for a in t_chamfer(torch.as_tensor(x), torch.as_tensor(y), tile=1024)]
    for k in (0, 1):
        assert _rel(td[k], jd[k]) <= 1e-5
    # nearest neighbours: equal but at near-ties
    assert (td[2] == jd[2]).mean() > 0.999 and (td[3] == jd[3]).mean() > 0.999
    for thr in (0.01, 0.05, 0.2):
        jf = [float(a) for a in j_fscore(jnp.asarray(jd[0]), jnp.asarray(jd[1]), thr)]
        tf = [float(a) for a in t_fscore(torch.as_tensor(td[0]), torch.as_tensor(td[1]), thr)]
        np.testing.assert_allclose(tf, jf, atol=2e-4)


@pytest.mark.parametrize("angle,iters", [(0.15, 20), (0.3, 5)])
def test_icp_matches_jax(angle, iters):
    """A rotation ICP resolves within its 20 iterations, and the first 5
    iterations of a larger one. Mid-way through the larger one the two
    trajectories part where a point is as near to two neighbours (at 0.3
    rad: 5e-7 apart through iteration 5, 3.6e-4 at 10, 4e-6 again once
    both converge at 60, on an x86 CPU), as two runs of one package would
    under a reordered sum."""
    rng = np.random.default_rng(2)
    dst = rng.normal(size=(3000, 3)).astype(np.float32) * np.asarray([1.0, 0.6, 0.3], np.float32)
    c, s = np.cos(angle), np.sin(angle)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = (dst[rng.permutation(3000)[:2500]] @ R.T + np.asarray([0.1, -0.05, 0.02], np.float32)
           + rng.normal(size=(2500, 3)).astype(np.float32) * 0.01)
    Rj, tj = [np.asarray(v) for v in j_icp(jnp.asarray(src), jnp.asarray(dst), iters=iters)]
    Rt, tt = [v.numpy() for v in t_icp(torch.as_tensor(src), torch.as_tensor(dst), iters=iters)]
    assert _rel(Rt, Rj) <= 1e-5 and _rel(tt, tj) <= 1e-5
    if iters == 20:  # it undoes the rotation
        assert np.abs(Rt @ R - np.eye(3)).max() < 0.02


def test_sim3_and_umeyama_match_jax():
    rng = np.random.default_rng(3)
    from scipy.spatial.transform import Rotation
    n = 12
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = Rotation.random(n, random_state=4).as_matrix()
    gt[:, :3, 3] = rng.normal(size=(n, 3))
    pred = gt.copy()
    noise = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.1).as_matrix()
    pred[:, :3, :3] = gt[:, :3, :3] @ noise @ Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    pred[:, :3, 3] *= 0.5
    inl = rng.uniform(size=n) > 0.3
    for kw in ({}, {"is_inlier": inl}):
        j, t = JS.align_sim3(gt, pred, **kw), TS.align_sim3(gt, pred, **kw)
        for k in j:
            assert _rel(t[k], j[k]) <= 1e-5, k
    np.testing.assert_allclose(TS.mean_rotation(noise), JS.mean_rotation(noise), rtol=1e-5,
                               atol=1e-7)
    x = rng.normal(size=(3, 40))
    y = 1.7 * gt[0, :3, :3] @ x + rng.normal(size=(3, 1))
    for ws in (False, True):
        for a, b in zip(TS.umeyama_alignment(x, y, ws), JS.umeyama_alignment(x, y, ws)):
            assert _rel(a, b) <= 1e-5



def _meshes():
    """Predicted frames and their ground truth: the same limbed bumpy
    surfaces, the truth marched on a finer grid, turned by 0.1 rad, in
    other units and another place (as an export's frames against a
    dataset's meshes). The limbs lock ICP: on smooth ellipsoids it slides
    for 40 iterations and more, and there the two packages' trajectories
    part where a point is as near to two neighbours, as in
    test_icp_matches_jax (6e-4 apart after 20 iterations, 4e-3 after 40;
    on an x86 CPU)."""
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    preds, gts = [], []
    for seed in range(2):
        preds.append(_ellipsoid(bump=0.03, seed=seed, limbs=True))
        g = _ellipsoid(n=30, bump=0.03, seed=seed, limbs=True)
        g.vertices = g.vertices @ R.T * 1.5 + np.asarray([0.2, -0.3, 0.1], np.float32)
        gts.append(g)
    return preds, gts


def _assert_scores(t, j, n_sample):
    """Distances within 1e-5 relative; an F-score within 2 / n_sample, the
    most one sample on the other side of a threshold can move it (2e-4 at
    10,000 samples)."""
    assert sorted(t) == sorted(j)
    for k in j:
        if k.startswith("f@"):
            assert abs(t[k] - j[k]) <= 2.0 / n_sample and 0 <= t[k] <= 1, k
        else:
            assert abs(t[k] - j[k]) <= 1e-5 * abs(j[k]), k


def test_eval_pair_and_sequence_match_jax():
    """eval_pair at the default 10,000 samples without ICP, and with ICP
    (alone and in eval_sequence) at 3,000: ICP's 20 nearest-neighbour
    passes over 10,000^2 pairs take ~11 s a pair on an 8-core x86 CPU in
    either package."""
    preds, gts = _meshes()
    jp = [JMesh(m.vertices, m.faces) for m in preds]
    jg = [JMesh(m.vertices, m.faces) for m in gts]
    for n, use_icp in ((10000, False), (3000, True)):
        t = TA.eval_pair(preds[0], gts[0], n_sample=n, use_icp=use_icp, device="cpu")
        _assert_scores(t, JA.eval_pair(jp[0], jg[0], n_sample=n, use_icp=use_icp), n)
    t = TA.eval_sequence(preds, gts, n_sample=3000, device="cpu")
    _assert_scores(t, JA.eval_sequence(jp, jg, n_sample=3000), 3000)
    assert t["f@5%_ave"] > 0.5
    # an empty prediction (a collapsed shape): NaN chamfer, zero F-scores
    with np.errstate(all="ignore"):
        t = TA.eval_pair(Mesh(), gts[0], n_sample=500, device="cpu")
        j = JA.eval_pair(JMesh(), jg[0], n_sample=500)
    assert np.isnan(t["chamfer"]) and np.isnan(j["chamfer"])
    assert all(t[k] == j[k] == 0.0 for k in j if k.startswith("f@"))


def _png_rows(path):
    """IHDR fields and the unfiltered rows of a PNG, decoded with zlib."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()  # filter type none
    return (h, w, depth, color), raw[:, 1:]


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3)])
def test_png_writer_round_trip(tmp_path, shape):
    img = np.random.default_rng(5).integers(0, 256, size=shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    RV.save_png(path, img)
    (h, w, depth, color), rows = _png_rows(path)
    assert (h, w, depth, color) == (shape[0], shape[1], 8, 0 if len(shape) == 2 else 2)
    np.testing.assert_array_equal(rows.reshape(shape), img)
    assert RV.png_size(path) == shape[:2]
    # an independent decoder reads the same image
    dec = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(dec if len(shape) == 2 else dec[..., ::-1], img)
    with pytest.raises(ValueError):
        RV.save_png(path, img.astype(np.float32))


def test_parse_test_frames_matches_jax():
    from moda_tpu.cli.extract_app import parse_test_frames as j_parse
    from moda_tpu_torch.cli.extract_app import parse_test_frames as t_parse
    offsets = (0, 6, 10, 17)
    for spec in ("{0}", "{1,2}", "{0,2}", "5", "40", "1"):
        assert [int(i) for i in t_parse(spec, offsets)] == [int(i) for i in j_parse(spec, offsets)]
    # every frame of a video but its last: not only the last of all videos
    assert t_parse("{0,1}", offsets) == [0, 1, 2, 3, 4, 6, 7, 8]


def test_extract_app_ama_and_eval_root_run_on_the_cpu(tmp_path, monkeypatch):
    """A checkpoint of a tiny model on a 6-frame line-shard scene, then the
    scripts/eval_synth.sh chain through the port: extract_app
    (--test_frames '{0}'), evals.ama.main against the scene's Meshes/ and
    eval_root_app against its Cameras/. The threshold is set to the median
    of the model's grid so that the untrained model has a surface to warp,
    silhouette and score; video 0's mask PNG is 20 x 24, which sets the
    refsil size."""
    from moda_tpu_torch.cli import eval_root_app, extract_app
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.extract.mesh import make_grid_query
    from moda_tpu_torch.train.trainer import Trainer

    db, cfgd, log = str(tmp_path / "db"), str(tmp_path / "cfg"), str(tmp_path / "log")
    write_line_dataset(db, cfgd, "syn", SynthScene(img_size=16, num_frames=6))
    gt_meshes = sorted(os.listdir(os.path.join(db, "Meshes", "Full-Resolution", "syn")))
    assert gt_meshes == ["mesh-%05d.obj" % i for i in range(6)]
    ann = os.path.join(db, "Annotations", "Full-Resolution", "syn")
    os.makedirs(ann)
    RV.save_png(os.path.join(ann, "00000.png"), np.zeros((20, 24), np.uint8))

    flags = ["--seqname", "syn", "--config_dir", cfgd, "--logname", "v", "--checkpoint_dir", log,
             "--lineload", "--ndepth", "8", "--img_size", "16", "--num_bones", "3",
             "--render_size", "8", "--chunk", "40"]
    from moda_tpu_torch.cli.flags import parse_config
    cfg = parse_config(flags)
    seq = load_seq_config("syn", cfgd)[0]
    tr = Trainer(cfg, DataInfo(offset=(0, 6), intrinsics=(tuple(seq.ks),)), device="cpu")
    rtks = np.stack([np.loadtxt(os.path.join(db, "Cameras", "Full-Resolution", "syn",
                                             "%05d.txt" % i)) for i in range(6)])
    rtks[:, :3, 3] /= tr.model.obj_scale
    tr.set_cameras_from_rtk_files(rtks.astype(np.float32))
    tr.save("latest")
    b = tr.latest_vars["obj_bound"]
    axes = [np.linspace(-b[i], b[i], 12, dtype=np.float32) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    thr = float(np.median(make_grid_query(tr.model)(torch.as_tensor(grid))[0].numpy()))

    ex = extract_app.main(flags + ["--model_path", os.path.join(log, "v", "latest"),
                                   "--test_frames", "{0}", "--sample_grid3d", "12",
                                   "--mc_threshold", str(thr), "--full_mesh"], device="cpu")
    out = os.path.join(log, "v-export")
    files = os.listdir(out)
    for kind, ext in (("mesh", "obj"), ("cam", "txt"), ("ctrajs", "txt"), ("refsil", "png")):
        assert sorted(f for f in files if f.startswith(f"syn-{kind}-0")) == \
            [f"syn-{kind}-{i:05d}.{ext}" for i in range(5)], kind
    assert {"syn-mesh-rest.obj", "syn-mesh-skin.obj", "syn-rgb.gif", "syn-sil.gif"} <= set(files)
    rest = TA.load_obj(os.path.join(out, "syn-mesh-rest.obj"))
    assert len(rest.vertices) > 20
    for i in range(5):
        m = TA.load_obj(os.path.join(out, f"syn-mesh-{i:05d}.obj"))
        assert m.vertices.shape == rest.vertices.shape and np.isfinite(m.vertices).all()
        np.testing.assert_array_equal(m.faces, rest.faces)
        assert RV.png_size(os.path.join(out, f"syn-refsil-{i:05d}.png")) == (20, 24)
        cam = np.loadtxt(os.path.join(out, f"syn-cam-{i:05d}.txt"))
        np.testing.assert_allclose(cam, np.loadtxt(os.path.join(
            db, "Cameras", "Full-Resolution", "syn", "%05d.txt" % i)), rtol=1e-5, atol=1e-6)
    for kind in ("rgb", "sil"):
        gif = RV.gif_info(os.path.join(out, f"syn-{kind}.gif"))
        assert (gif["frames"], gif["height"], gif["width"]) == (5, 8, 8), kind
    assert ex.model.device.type == "cpu"

    # 1,000 samples a mesh instead of 10,000: ICP over 10,000^2 pairs takes
    # ~10 s a frame on the CPU (the parity test above holds eval_pair at
    # 3,000 and 10,000)
    pair = TA.eval_pair
    monkeypatch.setattr(TA, "eval_pair", lambda p, g, n_sample, **kw: pair(p, g, 1000, **kw))
    scores = TA.main([out, os.path.join(db, "Meshes", "Full-Resolution", "syn")], device="cpu")
    assert all(np.isfinite(v) for v in scores.values())
    assert all(0 <= v <= 1 for k, v in scores.items() if k.startswith("f@"))
    root = eval_root_app.main([os.path.join(out, "syn-cam"),
                               os.path.join(db, "Cameras", "Full-Resolution", "syn"), "5"])
    # the exported cameras are the dataset's: no error after alignment
    assert root["so3_err_max"] < 0.2
