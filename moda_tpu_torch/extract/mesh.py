"""Mesh extraction: a dense grid SDF query on the device -> host marching
cubes -> largest connected component, and the forward/backward warps of
meshes through the deformation model. Counterpart of
moda_tpu/extract/mesh.py (train_utils.extract_mesh, train_utils.py:1364-1476;
warp_bw/warp_fw, geom_utils.py:974-1073).

Everything here runs the plain fp32 path (``MoDAModel.precise()``, the JAX
package's ``model.precise()``) under ``torch.no_grad()``, so it launches no
kernel and builds no graph.

Multi-device extraction (the JAX package shards the grid's point axis over
its device mesh): with a ``comm`` (parallel/dist.py), ``grid_volume`` (and
so ``extract_mesh``) queries each rank's share of the grid's chunks and
all-reduces the volume, so every rank holds the one-process volume bit for
bit and marches the same mesh; cli/extract_app.py shares the frames.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from moda_tpu_torch.core import skinning as SK
from moda_tpu_torch.native import marching_cubes
from moda_tpu_torch.parallel.dist import Shard, share
from moda_tpu_torch.render.rays import compute_bone_rts

# grid points a query call on the card: the unit of work ranks share, so each
# rank's calls are the one-process run's calls and give the same bits. 64^3
# is one call; at 128^3 eight calls take 3% longer than one on an H100 and
# hold 0.9 GiB instead of 7 (scripts/grid_query_time.py)
GRID_CHUNK = 1 << 18


@dataclass
class Mesh:
    """Minimal host-side triangle mesh."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    faces: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    colors: Optional[np.ndarray] = None  # [V,3] float 0..1
    # density-grid diagnostic: share of grid cells above the threshold
    # (train_utils.py:1435-1440)
    frac_occupied: float = 0.0

    def export_obj(self, path: str):
        with open(path, "w") as f:
            if self.colors is not None:
                rows = np.concatenate([self.vertices, self.colors.astype(np.float32)], 1)
            else:
                rows = self.vertices
            np.savetxt(f, rows, fmt="v" + " %.6g" * rows.shape[1])
            if len(self.faces):
                np.savetxt(f, np.asarray(self.faces) + 1, fmt="f %d %d %d")

    @property
    def bounds(self) -> np.ndarray:
        if len(self.vertices) == 0:
            return np.zeros((2, 3), np.float32)
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy(),
                    None if self.colors is None else self.colors.copy())


def largest_component(mesh: Mesh) -> Mesh:
    """Keep the largest connected component (use_cc, train_utils.py:1447-1451)."""
    if len(mesh.faces) == 0:
        return mesh
    V = len(mesh.vertices)
    e = np.concatenate([mesh.faces[:, [0, 1]], mesh.faces[:, [1, 2]], mesh.faces[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
    n_comp, labels = csgraph.connected_components(adj, directed=False)
    if n_comp <= 1:
        return mesh
    keep = np.argmax(np.bincount(labels, minlength=n_comp))
    vmask = labels == keep
    remap = -np.ones(V, np.int64)
    remap[vmask] = np.arange(vmask.sum())
    fmask = vmask[mesh.faces].all(-1)
    return Mesh(
        vertices=mesh.vertices[vmask],
        faces=remap[mesh.faces[fmask]].astype(np.int32),
        colors=None if mesh.colors is None else mesh.colors[vmask],
    )


def make_grid_query(model, chunk: Optional[int] = None):
    """Dense SDF (and visibility) evaluation over [N,3] points on the
    model's device: ``query(pts, symm=False) -> (raw [N], vis [N])``.
    chunk: points per call (``query.chunk``); None gives GRID_CHUNK on the
    card and cfg.chunk on the CPU."""
    view = model.precise()
    if chunk is None:
        chunk = GRID_CHUNK if model.device.type == "cuda" else model.cfg.chunk

    @torch.no_grad()
    def query_chunk(pts, symm):
        pts_in = torch.cat([torch.abs(pts[..., :1]), pts[..., 1:]], -1) if symm else pts
        raw = view.apply_coarse(view.embed_xyz(pts_in), sigma_only=True)[..., 0]
        if view.cfg.nerf_vis:
            vis = torch.sigmoid(view.apply_vis(view.embed_xyz(pts), need_dx=False)[..., 0])
        else:
            vis = torch.ones_like(raw)
        return raw, vis

    def query(pts: torch.Tensor, symm: bool = False):
        outs = [query_chunk(pts[i:i + chunk], symm) for i in range(0, pts.shape[0], chunk)]
        if not outs:
            return pts.new_zeros(0), pts.new_zeros(0)
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    query.chunk = chunk
    return query


def grid_volume(model, obj_bound: np.ndarray, grid_size: int, query=None, comm=None):
    """The grid query's (raw, vis), each [G^3] on the model's device, over
    the G^3 grid spanning +-obj_bound. comm: the ranks' group; each rank
    queries its share of the grid's chunks of ``query.chunk`` points (the
    one-process calls; a query without ``chunk`` is one call), and every
    rank gets the whole volume."""
    if query is None:
        query = make_grid_query(model)
    b = np.asarray(obj_bound, np.float32)
    axes = [np.linspace(-b[i], b[i], grid_size, dtype=np.float32) for i in range(3)]
    pts = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3),
                          device=model.device)
    rank, world = (comm.rank, comm.world) if comm is not None else (0, 1)
    step = getattr(query, "chunk", 0) or len(pts)
    mine = share(-(-len(pts) // step), rank, world)
    lo, hi = mine.start * step, min(mine.stop * step, len(pts))
    raw, vis = query(pts[lo:hi], symm=model.cfg.symm_shape)
    if comm is not None:
        rows = torch.arange(lo, hi, device=model.device)
        raw, vis = Shard(comm, rows, len(pts)).reduce([raw, vis], scatter=True)
    return raw, vis


def extract_mesh(model, obj_bound: np.ndarray, grid_size: int, threshold: float,
                 use_vis: bool = True, query=None, comm=None) -> Mesh:
    """Canonical-shape extraction (train_utils.py:1364-1465) from the
    model's current parameters; over the ranks of ``comm`` each queries its
    share of the grid (``grid_volume``) and every rank marches the whole
    volume."""
    b = np.asarray(obj_bound, np.float32)
    raw, vis = grid_volume(model, b, grid_size, query, comm)
    vol = raw.cpu().numpy().reshape(grid_size, grid_size, grid_size)
    if use_vis and model.cfg.nerf_vis:
        visv = vis.cpu().numpy().reshape(vol.shape)
        vol = np.where(visv < 0.5, -1.0, vol)

    frac = float((vol > threshold).mean())
    verts, tris = marching_cubes(vol.astype(np.float32), float(threshold))
    if len(verts) == 0:
        return Mesh(frac_occupied=frac)
    # voxel -> object coords (matching (v - G/2)/G * 2 * bound)
    verts = (verts - grid_size / 2.0) / grid_size * 2.0 * b[None, :]
    mesh = Mesh(vertices=verts.astype(np.float32), faces=tris, frac_occupied=frac)
    if model.cfg.use_cc:
        mesh = largest_component(mesh)
        mesh.frac_occupied = frac
    # canonical-location colors (train_utils.py:1453-1465)
    if len(mesh.vertices) > 0:
        vmin = mesh.vertices.min(0, keepdims=True)
        vlen = np.maximum(mesh.vertices.max(0, keepdims=True) - vmin, 1e-9)
        mesh.colors = (mesh.vertices - vmin) / vlen
    return mesh


def _skin(view, pts: torch.Tensor, bones: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Skinning weights [bs, N, B] of points pts [bs, N, 3] against bones
    [bs, B, 10], the delta-skin MLP reading the per-point code (the layout
    of the JAX package's warp helpers: [xyz_embed | code] per point)."""
    dskin = None
    if view.cfg.nerf_skin:
        c = code[:, None, :].expand(pts.shape[:-1] + (code.shape[-1],))
        dskin = view.apply_skin(torch.cat([view.embed_xyz(pts), c], -1))
    return SK.skinning_weights(bones, pts, dskin, view.skin_aux[0])


def _blend(view, bones, rts, skin, pts, backward: bool):
    if view.cfg.neudbs:
        return SK.neu_dbs(bones, rts, skin, pts, backward=backward)
    return SK.lbs(bones, rts, skin, pts, backward=backward)


def _rest_code(view) -> torch.Tensor:
    return view.apply_rest_pose_code(torch.zeros(1, dtype=torch.long, device=view.device))


def _points(view, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=view.device)


def _frames(view, fid) -> torch.Tensor:
    return torch.as_tensor(fid, device=view.device).long().reshape(-1)


def make_warp_fw(model):
    """Canonical -> frame vertex warp (warp_fw, geom_utils.py:1029-1073):
    ``warp(verts [V,3], frameid) -> (verts_dfm [V,3], bones_dfm [B,10])``,
    tensors on the model's device."""
    view = model.precise()

    @torch.no_grad()
    def warp(verts, frameid):
        bones_rst, bone_rts = compute_bone_rts(view, _frames(view, frameid))
        pts = _points(view, verts)[None]
        skin = _skin(view, pts, bones_rst[None], _rest_code(view))
        out, bones_dfm = _blend(view, bones_rst[None], bone_rts, skin, pts, backward=False)
        return out[0], bones_dfm[0]

    return warp


def make_warp_fw_frames(model):
    """The rest mesh warped to F frames in one call:
    ``warp(verts [V,3], frameids [F]) -> (verts_dfm [F,V,3], bones_dfm
    [F,B,10])``. The skinning weights read only the rest pose and the
    rest-pose code, so they are computed once for all frames. (The JAX
    package shards the frame axis over its device mesh; cli/extract_app.py
    gives each rank its share of the frames.)"""
    view = model.precise()

    @torch.no_grad()
    def warp(verts, frameids):
        fids = _frames(view, frameids)
        bones_rst, bone_rts = compute_bone_rts(view, fids)
        F = fids.shape[0]
        pts = _points(view, verts)[None]
        skin = _skin(view, pts, bones_rst[None], _rest_code(view))
        return _blend(view, bones_rst[None].expand((F,) + bones_rst.shape), bone_rts,
                      skin.expand((F,) + skin.shape[1:]),
                      pts.expand((F,) + pts.shape[1:]), backward=False)

    return warp


def make_warp_bw(model):
    """Frame -> canonical point warp (warp_bw, geom_utils.py:974-1027):
    ``warp(pts_frame [N,3], frameid) -> pts_canonical [N,3]``."""
    view = model.precise()

    @torch.no_grad()
    def warp(pts_frame, frameid):
        fid = _frames(view, frameid)
        bones_rst, bone_rts = compute_bone_rts(view, fid)
        if view.cfg.neudbs:
            bones_dfm = SK.bone_transform_dq(bones_rst, bone_rts)
        else:
            bones_dfm = SK.bone_transform_rts(bones_rst, bone_rts)
        pts = _points(view, pts_frame)[None]
        skin = _skin(view, pts, bones_dfm, view.apply_pose_code(fid))
        out, _ = _blend(view, bones_rst[None], bone_rts, skin, pts, backward=True)
        return out[0]

    return warp


@torch.no_grad()
def skin_colors(model, mesh: Mesh) -> np.ndarray:
    """Rest-mesh vertex colours [V,3] by skinning weight, each bone a fixed
    random colour (train_utils.py:567-591)."""
    view = model.precise()
    bones_rst, _ = compute_bone_rts(view, torch.zeros(1, dtype=torch.long,
                                                      device=view.device))
    pts = _points(view, mesh.vertices)[None]
    skin = _skin(view, pts, bones_rst[None], _rest_code(view))[0].cpu().numpy()
    rng = np.random.default_rng(0)
    cmap = rng.uniform(0.1, 1.0, size=(skin.shape[-1], 3))
    return (skin @ cmap).astype(np.float32)


@torch.no_grad()
def radiance_colors(model, mesh: Mesh, frameid: int, view_dir: np.ndarray,
                    env_frameid: Optional[int] = None) -> np.ndarray:
    """Vertex colours [V,3] from the radiance field (the ce_color=False path,
    train_utils.py:538-546 + get_vertex_colors): the coarse MLP's rgb
    branch at the canonical vertices with the frame's env code and the
    given viewing directions view_dir [V,3] (any length)."""
    view = model.precise()
    v = _points(view, mesh.vertices)
    d = _points(view, view_dir)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    feats = [view.embed_xyz(v), view.embed_dir(d)]
    if view.cfg.env_code:
        env = view.apply_env_code(_frames(view, env_frameid or frameid))
        feats.append(env.expand(v.shape[0], env.shape[-1]))
    if view.cfg.appearance_code:
        app = view.apply_appearance_code(_frames(view, frameid))
        feats.append(app.expand(v.shape[0], app.shape[-1]))
    return view.apply_coarse(torch.cat(feats, -1))[..., :3].cpu().numpy()
