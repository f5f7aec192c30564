"""The port's rest-mesh extraction and k-means against moda_tpu's:

- the grid SDF/visibility query on a 24^3 grid (relative L2 <= 1e-5);
- the native marching tetrahedra and largest_component on one volume
  (bit-equal vertices and faces);
- extract_mesh end to end on one volume;
- k-means from the same initial centres (within 1e-5);
- the warps (make_warp_fw, make_warp_fw_frames, make_warp_bw) and the
  vertex colours (skin_colors, radiance_colors) on one mesh, with NeuDBS
  and with LBS (within 1e-5 relative L2), launching no kernel and building
  no graph.
"""
import pytest
import jax
import jax.numpy as jnp
import numpy as np
import torch

from moda_tpu.extract import mesh as JM
from moda_tpu.native import marching_cubes as j_marching
from moda_tpu.ops.kmeans import kmeans as j_kmeans
from moda_tpu_torch.extract import mesh as TM
from moda_tpu_torch.native import marching_cubes as t_marching
from moda_tpu_torch.ops.kmeans import kmeans as t_kmeans
from tests.torch_parity import both_models


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(b) + 1e-12))


def _grid(G, bound):
    axes = [np.linspace(-b, b, G, dtype=np.float32) for b in bound]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def test_grid_query_matches_jax():
    _, jmodel, params, _, tmodel = both_models()
    pts = _grid(24, (0.3, 0.25, 0.2))
    for symm in (False, True):
        jraw, jvis = JM.make_grid_query(jmodel)(params, jnp.asarray(pts), symm=symm)
        traw, tvis = TM.make_grid_query(tmodel, chunk=4096)(torch.as_tensor(pts), symm=symm)
        assert not traw.requires_grad and not tvis.requires_grad
        assert _rel(traw.numpy(), jraw) <= 1e-5 and _rel(tvis.numpy(), jvis) <= 1e-5


def _two_blobs(G=20):
    """An SDF-like volume (positive inside) of two disjoint spheres of
    different size, so the largest component drops one."""
    x = np.linspace(-1, 1, G, dtype=np.float32)
    p = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1)
    a = 0.45 - np.linalg.norm(p - np.asarray([-0.4, 0, 0]), axis=-1)
    b = 0.25 - np.linalg.norm(p - np.asarray([0.55, 0.1, 0]), axis=-1)
    return np.maximum(a, b).astype(np.float32)


def test_marching_and_largest_component_match_jax():
    vol = _two_blobs()
    vj, fj = j_marching(vol, 0.0)
    vt, ft = t_marching(vol, 0.0)
    assert len(vt) > 100 and vt.dtype == vj.dtype and ft.dtype == fj.dtype
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    mj = JM.largest_component(JM.Mesh(vertices=vj, faces=fj))
    mt = TM.largest_component(TM.Mesh(vertices=vt, faces=ft))
    assert 0 < len(mt.vertices) < len(vt)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)


def test_extract_mesh_matches_jax_on_one_volume(tmp_path):
    """Both extract_mesh functions on the same query output (the volume of
    two blobs), so any difference is in the host path: marching, the
    component filter, the voxel->object map and the colours."""
    _, jmodel, params, _, tmodel = both_models()
    vol = _two_blobs(16).reshape(-1)
    vis = np.ones_like(vol)
    bound = np.asarray([0.3, 0.2, 0.25], np.float32)
    mj = JM.extract_mesh(jmodel, params, bound, 16, 0.0,
                         query=lambda p, x, symm=False: (jnp.asarray(vol), jnp.asarray(vis)))
    mt = TM.extract_mesh(tmodel, bound, 16, 0.0,
                         query=lambda x, symm=False: (torch.as_tensor(vol), torch.as_tensor(vis)))
    assert len(mt.vertices) > 0 and mt.frac_occupied == mj.frac_occupied
    for k in ("vertices", "faces", "colors"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k), err_msg=k)
    mt.export_obj(str(tmp_path / "m.obj"))
    mj.export_obj(str(tmp_path / "j.obj"))
    assert (tmp_path / "m.obj").read_text() == (tmp_path / "j.obj").read_text()


def test_kmeans_matches_jax():
    pts = np.random.default_rng(3).normal(size=(400, 3)).astype(np.float32)
    k = 6
    key = jax.random.key(0)
    idx = np.asarray(jax.random.choice(key, len(pts), (k,), replace=False))
    cj = np.asarray(j_kmeans(key, jnp.asarray(pts), k))
    ct = t_kmeans(torch.as_tensor(pts), k, init_idx=torch.as_tensor(idx)).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-5)
    # from the trainer's generator: k distinct points to start from
    cg = t_kmeans(torch.as_tensor(pts), k, generator=torch.Generator().manual_seed(1))
    assert cg.shape == (k, 3) and torch.isfinite(cg).all()


def _mesh_and_frames():
    m = TM.largest_component(TM.Mesh(*t_marching(_two_blobs(14), 0.0)))
    # object units: the blobs at ~0.1, as the trainer's rest meshes
    return TM.Mesh(m.vertices * 0.012 - 0.08, m.faces), [0, 3, 5, 2]


@pytest.mark.parametrize("skinning", ["neudbs", "lbs"])
def test_warps_match_jax(skinning):
    kw = {} if skinning == "neudbs" else dict(neudbs=False, lbs=True)
    _, jmodel, params, _, tmodel = both_models(**kw)
    mesh, fids = _mesh_and_frames()
    v = jnp.asarray(mesh.vertices)
    jv, jb = JM.make_warp_fw(jmodel)(params, v, jnp.asarray(fids[1]))
    tv, tb = TM.make_warp_fw(tmodel)(mesh.vertices, fids[1])
    assert not tv.requires_grad
    assert _rel(tv.numpy(), jv) <= 1e-5 and _rel(tb.numpy(), jb) <= 1e-5
    assert _rel(tv.numpy(), mesh.vertices) > 1e-3  # the warp moves the mesh
    jv, jb = JM.make_warp_fw_frames(jmodel)(params, v, jnp.asarray(fids))
    tv, tb = TM.make_warp_fw_frames(tmodel)(mesh.vertices, fids)
    assert tv.shape == (len(fids),) + mesh.vertices.shape and tb.shape == jb.shape
    assert _rel(tv.numpy(), jv) <= 1e-5 and _rel(tb.numpy(), jb) <= 1e-5
    # frame 3 of the batch is the single-frame warp's
    assert _rel(tv[1].numpy(), TM.make_warp_fw(tmodel)(mesh.vertices, fids[1])[0].numpy()) <= 1e-6
    pts = np.asarray(jv[2])
    jc = JM.make_warp_bw(jmodel)(params, jnp.asarray(pts), jnp.asarray(fids[2]))
    tc = TM.make_warp_bw(tmodel)(pts, fids[2])
    assert _rel(tc.numpy(), jc) <= 1e-5


def test_vertex_colours_match_jax():
    _, jmodel, params, _, tmodel = both_models()
    mesh, _ = _mesh_and_frames()
    jmesh = JM.Mesh(mesh.vertices, mesh.faces)
    tc = TM.skin_colors(tmodel, mesh)
    assert tc.shape == mesh.vertices.shape and tc.dtype == np.float32
    assert _rel(tc, JM.skin_colors(jmodel, params, jmesh)) <= 1e-5
    view_dir = np.random.default_rng(4).normal(size=mesh.vertices.shape).astype(np.float32)
    for fid, env_fid in ((2, None), (1, 4)):
        tr = TM.radiance_colors(tmodel, mesh, fid, view_dir, env_frameid=env_fid)
        jr = JM.radiance_colors(jmodel, params, jmesh, fid, view_dir, env_frameid=env_fid)
        assert tr.shape == mesh.vertices.shape and _rel(tr, jr) <= 1e-5
