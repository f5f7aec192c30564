"""AMA mesh-accuracy evaluation: ICP-aligned chamfer distance and F-scores.
Counterpart of moda_tpu/evals/ama.py (the protocol of
scripts/visualize/render_vis.py:382-425 and 513-525): per frame, fit the
predicted mesh's scale to the ground truth's (both centred), ICP-align it,
then report the bidirectional chamfer distance and the F-score at 1%, 2%
and 5% of the ground truth's largest bounding-box edge.

    python -m moda_tpu_torch.evals.ama <pred_dir> <gt_dir>

scores the ``*mesh-0*.obj`` files of an extraction's export directory
against the ground-truth OBJs of <gt_dir> (both sorted by name, as many as
both have) and prints the sequence summary as JSON, as
scripts/eval_ama.sh does for the JAX package. The nearest-neighbour and
ICP work runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from moda_tpu_torch.evals.icp import icp_align
from moda_tpu_torch.extract.mesh import Mesh
from moda_tpu_torch.ops.chamfer import chamfer_distance, fscore
from moda_tpu_torch.runtime import Device, resolve_device
from moda_tpu_torch.train.trainer import sample_mesh_points


def sample_surface(mesh: Mesh, n: int, seed: int = 0) -> np.ndarray:
    return sample_mesh_points(mesh, n, np.random.default_rng(seed))


def eval_pair(pred: Mesh, gt: Mesh, n_sample: int = 10000, use_icp: bool = True,
              device: Device = None) -> Dict[str, float]:
    """Single-frame mesh accuracy (render_vis.py:382-416)."""
    dev = resolve_device(device)
    p = sample_surface(pred, n_sample, 0)
    g = sample_surface(gt, n_sample, 1)
    # centre, and fit the scale by the median radius (render_vis.py:371-388
    # fits the median camera depth; on centred meshes the median radius
    # removes the canonical-unit against world-unit mismatch the same way)
    p = p - pred.vertices.mean(0)
    g = g - gt.vertices.mean(0)
    fitted_scale = (np.median(np.linalg.norm(g, axis=-1))
                    / max(np.median(np.linalg.norm(p, axis=-1)), 1e-12))
    p = p * fitted_scale
    max_edge = float((gt.vertices.max(0) - gt.vertices.min(0)).max())

    pt = torch.as_tensor(p, device=dev)
    gt_pts = torch.as_tensor(g, device=dev)
    if use_icp:
        R, t = icp_align(pt, gt_pts, iters=20)
        pt = pt @ R.T + t
    d1, d2, _, _ = chamfer_distance(pt, gt_pts)
    # raw (not squared) distances averaged both ways, in input units
    cd = float(np.sqrt(d1.cpu().numpy()).mean() + np.sqrt(d2.cpu().numpy()).mean()) / 2.0
    out = {"chamfer": cd, "max_edge": max_edge}
    for pct in (1, 2, 5):
        f, _, _ = fscore(d1, d2, (max_edge * pct / 100.0) ** 2)
        out[f"f@{pct}%"] = float(f)
    return out


def eval_sequence(preds: List[Mesh], gts: List[Mesh], n_sample: int = 10000,
                  device: Device = None) -> Dict[str, float]:
    """Sequence summary: mean/max chamfer, mean/min F-scores
    (render_vis.py:513-525)."""
    rows = [eval_pair(p, g, n_sample, device=device) for p, g in zip(preds, gts)]
    cds = np.asarray([r["chamfer"] for r in rows])
    out = {"chamfer_ave": float(cds.mean()), "chamfer_max": float(cds.max())}
    for pct in (1, 2, 5):
        fs = np.asarray([r[f"f@{pct}%"] for r in rows])
        out[f"f@{pct}%_ave"] = float(fs.mean())
        out[f"f@{pct}%_min"] = float(fs.min())
    return out


def load_obj(path: str) -> Mesh:
    """Vertices and triangles of an OBJ file (vertex colours dropped)."""
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append(line.split()[1:4])
            elif line.startswith("f "):
                fs.append([t.split("/")[0] for t in line.split()[1:4]])
    # numpy parses the number strings (a Python float() each is ~3x slower)
    return Mesh(np.asarray(vs, np.float32).reshape(-1, 3),
                np.asarray(fs, np.int64).reshape(-1, 3).astype(np.int32) - 1)


def main(argv=None, device: Device = None) -> Dict[str, float]:
    """``main([pred_dir, gt_dir])``: print and return eval_sequence's JSON."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m moda_tpu_torch.evals.ama <pred_dir> <gt_dir>")
    preds = sorted(glob.glob(os.path.join(argv[0], "*mesh-0*.obj")))
    gts = sorted(glob.glob(os.path.join(argv[1], "*.obj")))
    n = min(len(preds), len(gts))
    if n == 0:
        raise SystemExit(f"no meshes to compare: {len(preds)} in {argv[0]}, "
                         f"{len(gts)} in {argv[1]}")
    out = eval_sequence([load_obj(p) for p in preds[:n]], [load_obj(g) for g in gts[:n]],
                        device=device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
