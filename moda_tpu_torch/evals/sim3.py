"""Root-pose trajectory alignment + SO(3) error (numpy, eval-only): the
port's copy of moda_tpu/evals/sim3.py.

Replaces geom_utils.py:1463-1514 (align_sim3) and
scripts/eval/eval_root.py (umeyama): align a predicted camera trajectory
to ground truth with a global rotation + scale, then report rotation
error statistics in degrees.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation as R


def mean_rotation(mats: np.ndarray) -> np.ndarray:
    """Chordal-mean rotation of [N,3,3]."""
    return R.from_matrix(mats).mean().as_matrix()


def align_sim3(root_a: np.ndarray, root_b: np.ndarray,
               is_inlier: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Align root_b ([N,4,4] object-to-cam) onto root_a and report SO3 error.

    Mutates nothing; returns stats + the aligned copy."""
    root_b = root_b.copy()
    dso3 = np.matmul(np.transpose(root_b[:, :3, :3], (0, 2, 1)), root_a[:, :3, :3])
    dscale = np.linalg.norm(root_a[:, :3, 3], axis=-1) / np.maximum(
        np.linalg.norm(root_b[:, :3, 3], axis=-1), 1e-12)
    if is_inlier is not None and is_inlier.sum() > 0:
        dso3 = dso3[is_inlier]
        dscale = dscale[is_inlier]
    dso3_m = mean_rotation(dso3)
    root_b[:, :3, :3] = root_b[:, :3, :3] @ dso3_m[None]
    root_b[:, :3, 3] *= dscale.mean()

    err_mat = root_a[:, :3, :3] @ np.transpose(root_b[:, :3, :3], (0, 2, 1))
    cos = np.clip((np.trace(err_mat, axis1=1, axis2=2) - 1) / 2, -1 + 1e-6, 1 - 1e-6)
    deg = np.degrees(np.arccos(cos))
    return {
        "so3_err_max": float(deg.max()),
        "so3_err_med": float(np.median(deg)),
        "so3_err_mean": float(deg.mean()),
        "so3_err_std": float(deg.std()),
        "aligned": root_b,
    }


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform y ~ c R x + t (Umeyama 1991).

    x, y: [3, N]. Returns (R, t, c)."""
    mx = x.mean(1, keepdims=True)
    my = y.mean(1, keepdims=True)
    xc = x - mx
    yc = y - my
    n = x.shape[1]
    cov = yc @ xc.T / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    Rm = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / n
        c = np.trace(np.diag(D) @ S) / var_x
    else:
        c = 1.0
    t = my[:, 0] - c * Rm @ mx[:, 0]
    return Rm, t, c
