"""Rest-mesh extraction: a dense grid SDF query on the device -> host
marching cubes -> largest connected component. Counterpart of the
extraction half of moda_tpu/extract/mesh.py (train_utils.py:1364-1476).

The query runs the plain fp32 path (the JAX package's ``model.precise()``):
a view of the model with ``use_pallas=False``, under ``torch.no_grad()``,
so it launches no kernel and builds no graph. The warp helpers wait for
the extraction slice.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from moda_tpu_torch.native import marching_cubes


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
    chunk: points per call; None runs one call on the card and chunks of
    cfg.chunk on the CPU."""
    view = copy.copy(model)  # shares the parameters; only cfg differs
    view.cfg = model.cfg.replace(use_pallas=False)
    if chunk is None:
        chunk = 0 if model.device.type == "cuda" else model.cfg.chunk

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
        step = chunk or pts.shape[0]
        outs = [query_chunk(pts[i:i + step], symm) for i in range(0, pts.shape[0], step)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    return query


def extract_mesh(model, obj_bound: np.ndarray, grid_size: int, threshold: float,
                 use_vis: bool = True, query=None) -> Mesh:
    """Canonical-shape extraction (train_utils.py:1364-1465) from the
    model's current parameters."""
    if query is None:
        query = make_grid_query(model)
    b = np.asarray(obj_bound, np.float32)
    axes = [np.linspace(-b[i], b[i], grid_size, dtype=np.float32) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    raw, vis = query(torch.as_tensor(pts, device=model.device), symm=model.cfg.symm_shape)
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
