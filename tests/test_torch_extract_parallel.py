"""Multi-device extraction over processes (the JAX package shards the grid
points and the frames over its device mesh: moda_tpu/extract/mesh.py:106-211,
tests/test_extract_parallel.py): gloo ranks on the CPU, spawned with a
timeout (tests/torch_dist.py), against the port's one-process run from the
same seeds and checkpoint, and against the JAX package's run on a mesh of
CPU devices.

- ``dist.share`` splits n units into contiguous, disjoint shares that cover
  them, in rank order;
- ``extract_mesh`` with a comm: each rank queries its share of the grid's
  chunks and no more, and every rank's mesh (vertices, faces, colours,
  occupied share) is the one-process mesh bit for bit (each chunk is the
  one-process call, and the all-reduce adds zeros);
- ``extract_app`` as 2 and 3 ranks under a torchrun-like environment: the
  export directory holds the one-process run's files byte for byte (the
  meshes, cameras, trajectories, silhouettes and both animations); each
  rank queried its share of the grid and wrote the meshes of its share of
  the frames, no frame twice; every rank holds rank 0's checkpoint, and
  only rank 0 reports being main;
- 2 and 3 ranks against the JAX package's extract_mesh(mesh=) and
  make_warp_fw_frames(mesh=) on 2 and 3 devices (the volume, the marching
  of a shared volume, the warped frames), and extract_app as 2 ranks
  against the JAX package's extract_app on its 8 devices (every file).
"""
import os

import numpy as np
import pytest
import torch

from moda_tpu_torch.parallel import dist
from tests import torch_dist as TD


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,world", [(10, 2), (10, 3), (2, 3), (0, 2), (7, 7), (1, 4)])
def test_share_splits_the_work(n, world):
    shares = [dist.share(n, r, world) for r in range(world)]
    assert [i for s in shares for i in s] == list(range(n))
    assert max(map(len, shares)) - min(map(len, shares)) <= 1


def _threshold(grid: int, chunk: int, seed: int) -> float:
    """The median of the model's volume, so that the seeded (untrained)
    model has a surface to march."""
    from moda_tpu_torch.config import MoDAConfig
    from moda_tpu_torch.extract.mesh import make_grid_query
    from moda_tpu_torch.fields.model import MoDAModel

    model = MoDAModel(MoDAConfig(**TD.BASE), TD.INFO, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    axes = [np.linspace(-b, b, grid, dtype=np.float32) for b in TD.MESH_BOUND]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return float(np.median(make_grid_query(model, chunk)(torch.as_tensor(pts))[0].numpy()))


@pytest.mark.parametrize("world", [2, 3])
def test_extract_mesh_over_ranks_is_the_one_process_mesh(tmp_path, world):
    """A 13^3 grid in chunks of 100 points (22 chunks: shares of 11 / 7-8)."""
    grid, chunk, seed = 13, 100, 4
    args = (grid, _threshold(grid, chunk, seed), chunk, seed)
    one = TD.run_mesh(args)
    assert len(one["vertices"]) > 20 and 0 < one["frac"] < 1 and one["points"] == grid ** 3
    ranks = TD.spawn(world, str(tmp_path), "mesh", args)
    chunks = -(-grid ** 3 // chunk)
    for r, got in enumerate(ranks):
        mine = dist.share(chunks, r, world)
        assert got["points"] == min(mine.stop * chunk, grid ** 3) - mine.start * chunk
        np.testing.assert_array_equal(got["vertices"], one["vertices"])
        np.testing.assert_array_equal(got["faces"], one["faces"])
        np.testing.assert_array_equal(got["colors"], one["colors"])
        assert got["frac"] == one["frac"]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_match_the_jax_packages_device_mesh(tmp_path, world):
    """The JAX package's multi-device extraction on a mesh of ``world`` CPU
    devices (extract_mesh(mesh=), make_warp_fw_frames(mesh=)) against the
    port's ``world`` gloo ranks, on tests/torch_parity.py's weights (the
    JAX init copied into the port): a 12^3 grid in chunks of 100 points,
    frames 0-5 in groups of 4. At test_torch_extract.py's gates: each
    rank's volume within 1e-5 (relative L2) of the JAX package's sharded
    one; the JAX package's extract_mesh on the ranks' volume gives every
    rank's mesh bit for bit; each rank's warped frames within 1e-5 of the
    JAX package's frame-sharded warp of that mesh, every frame warped by
    one rank. Beside it, each rank's volume, mesh and warps are the
    one-process run's bit for bit."""
    import jax.numpy as jnp
    from moda_tpu.extract import mesh as JM
    from moda_tpu.parallel.mesh import make_mesh
    from moda_tpu_torch.extract import mesh as TM
    from tests.torch_parity import both_models

    _, jmodel, params, _, tmodel = both_models()
    grid, chunk, frames = 12, 100, list(range(6))
    raw, _ = TM.grid_volume(tmodel, TD.MESH_BOUND, grid, TM.make_grid_query(tmodel, chunk))
    path = str(tmp_path / "model.pt")
    torch.save(tmodel, path)
    args = (path, grid, float(np.median(raw.numpy())), chunk, frames)
    one = TD.run_saved_extract(args)
    assert len(one["vertices"]) > 20 and 0 < one["frac"] < 1
    os.makedirs(tmp_path / "ranks")
    ranks = TD.spawn(world, str(tmp_path / "ranks"), "saved_extract", args)

    dev, seen = make_mesh(world), []
    query = JM.make_grid_query(jmodel)

    def sharded_query(p, pts, symm=False):
        seen.append({s.data.shape for s in pts.addressable_shards})
        return query(p, pts, symm=symm)

    JM.extract_mesh(jmodel, params, TD.MESH_BOUND, grid, args[2], query=sharded_query, mesh=dev)
    assert seen == [{(grid ** 3 // world, 3)}]  # the grid's points split over the devices
    jraw, jvis = query(params, jnp.asarray(_grid_points(grid)), symm=jmodel.cfg.symm_shape)
    jmesh = JM.extract_mesh(jmodel, params, TD.MESH_BOUND, grid, args[2],
                            query=lambda p, x, symm=False: (jnp.asarray(one["raw"]),
                                                            jnp.asarray(one["vis"])))
    jwarp, _ = JM.make_warp_fw_frames(jmodel, mesh=dev)(params, jnp.asarray(one["vertices"]),
                                                        jnp.asarray(frames, jnp.int32))
    assert {s.data.shape for s in jwarp.addressable_shards} == \
        {(len(frames) // world,) + one["vertices"].shape}
    jwarp = np.asarray(jwarp)
    for r in ranks:
        assert _rel(r["raw"], jraw) <= 1e-5 and _rel(r["vis"], jvis) <= 1e-5
        assert r["frac"] == jmesh.frac_occupied
        for k in ("vertices", "faces", "colors"):
            np.testing.assert_array_equal(r[k], getattr(jmesh, k), err_msg=k)
        for fi, v in r["warped"].items():
            assert _rel(v, jwarp[fi]) <= 1e-5, fi
            np.testing.assert_array_equal(v, one["warped"][fi])
        for k in ("raw", "vis", "vertices", "faces", "colors"):
            np.testing.assert_array_equal(r[k], one[k], err_msg=k)
    assert sorted(fi for r in ranks for fi in r["warped"]) == frames
    assert _rel(one["warped"][3], one["vertices"]) > 1e-3  # the warp moves the mesh


def _grid_points(grid: int) -> np.ndarray:
    axes = [np.linspace(-b, b, grid, dtype=np.float32) for b in TD.MESH_BOUND]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _scene(tmp_path):
    """A checkpoint of a tiny untrained model on a 6-frame line-shard scene
    and extract_app's flags for it (tests/test_torch_eval.py's setting:
    the threshold at the grid's median, video 0's mask 20 x 24)."""
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.extract.mesh import make_grid_query
    from moda_tpu_torch.train.trainer import Trainer
    from moda_tpu_torch.viz.render_vis import save_png

    db, cfgd, log = str(tmp_path / "db"), str(tmp_path / "cfg"), str(tmp_path / "log")
    write_line_dataset(db, cfgd, "syn", SynthScene(img_size=16, num_frames=6))
    ann = os.path.join(db, "Annotations", "Full-Resolution", "syn")
    os.makedirs(ann)
    save_png(os.path.join(ann, "00000.png"), np.zeros((20, 24), np.uint8))
    flags = ["--seqname", "syn", "--config_dir", cfgd, "--checkpoint_dir", log, "--lineload",
             "--ndepth", "8", "--img_size", "16", "--num_bones", "3", "--render_size", "8",
             "--chunk", "40"]
    cfg = parse_config(flags + ["--logname", "v"])
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
    return flags + ["--model_path", os.path.join(log, "v", "latest"), "--test_frames", "{0}",
                    "--sample_grid3d", "12", "--mc_threshold", str(thr), "--full_mesh"], log


def _files(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_extract_app_over_ranks_writes_the_one_process_files(tmp_path, world):
    """5 frames in groups of 4: with 2 ranks rank 0 takes frames 0-3 and
    rank 1 frame 4; with 3 ranks rank 0 takes none (it still writes the
    rest and skin meshes and the animations)."""
    from moda_tpu_torch.cli import extract_app

    flags, log = _scene(tmp_path)
    one = extract_app.main(flags + ["--logname", "one"], device="cpu")
    os.makedirs(tmp_path / "ranks")
    ranks = TD.spawn(world, str(tmp_path / "ranks"), "extract", flags + ["--logname", "many"])
    want, got = _files(os.path.join(log, "one-export")), _files(os.path.join(log, "many-export"))
    assert sorted(got) == sorted(want)
    assert len([f for f in want if f.startswith("syn-mesh-0")]) == 5
    assert {"syn-mesh-rest.obj", "syn-mesh-skin.obj", "syn-rgb.gif", "syn-sil.gif"} <= set(want)
    for name in want:
        assert got[name] == want[name], name
    assert [r["is_main"] for r in ranks] == [True] + [False] * (world - 1)
    assert sum(r["points"] for r in ranks) == 12 ** 3 and max(r["points"] for r in ranks) < 12 ** 3
    frames = [sorted(f for f in r["written"] if f.startswith("syn-mesh-0")) for r in ranks]
    assert sorted(f for fs in frames for f in fs) == [f"syn-mesh-{i:05d}.obj" for i in range(5)]
    assert frames[0] == ([] if world == 3 else [f"syn-mesh-{i:05d}.obj" for i in range(4)])
    assert [f for r in ranks[1:] for f in r["written"] if not f.startswith("syn-mesh-0")] == []
    params = dict(one.model.named_parameters())
    for r in ranks:
        for n, p in r["params"].items():
            assert torch.equal(p, params[n]), n


def test_extract_app_over_ranks_matches_the_jax_packages(tmp_path):
    """The whole app: the port's extract_app as 2 gloo ranks against the
    JAX package's extract_app on its mesh of 8 CPU devices (grid points
    and frames sharded), on the same checkpoint (written by the port; both
    read it). The same files; cameras and trajectories byte for byte; the
    rest and skin meshes' faces equal and vertices within 1e-5 (relative
    L2, test_torch_extract.py's gate); each frame's mesh the same faces and
    vertices within 5e-5: at this checkpoint the JAX package's warp against
    itself, its parameters moved by 1e-7 relative noise, reads up to 2.4e-5
    (the warp moves the mesh by more than its size); the reference
    silhouettes pixel for pixel; both animations 5 frames of 8 x 8. Their
    pixels are not compared: each package's renderer draws its samples
    from its own stream (the renderer is held to the JAX package's under
    its draws in tests/test_torch_evalrender.py)."""
    from moda_tpu.cli import extract_app as JA
    from moda_tpu_torch.data.imageio import imread
    from moda_tpu_torch.evals.ama import load_obj
    from moda_tpu_torch.viz.render_vis import gif_info

    flags, log = _scene(tmp_path)
    JA.main(flags + ["--logname", "jax"])
    os.makedirs(tmp_path / "ranks")
    TD.spawn(2, str(tmp_path / "ranks"), "extract", flags + ["--logname", "many"])
    jdir, tdir = os.path.join(log, "jax-export"), os.path.join(log, "many-export")
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want)
    for name in want:
        path_j, path_t = os.path.join(jdir, name), os.path.join(tdir, name)
        if name.endswith(".txt"):
            assert got[name] == want[name], name
        elif name.endswith(".obj"):
            mj, mt = load_obj(path_j), load_obj(path_t)
            assert len(mt.vertices) > 20, name
            np.testing.assert_array_equal(mt.faces, mj.faces, err_msg=name)
            tol = 5e-5 if name.startswith("syn-mesh-0") else 1e-5
            assert _rel(mt.vertices, mj.vertices) <= tol, name
        elif name.endswith(".png"):
            np.testing.assert_array_equal(imread(path_t, gray=True), imread(path_j, gray=True),
                                          err_msg=name)
        else:
            assert gif_info(path_t) == gif_info(path_j), name
            assert gif_info(path_t)["frames"] == 5 and gif_info(path_t)["height"] == 8, name
    assert {n.split("-")[1].split(".")[0] for n in want} == {"cam", "ctrajs", "mesh", "refsil", "rgb", "sil"}
