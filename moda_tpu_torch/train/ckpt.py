"""Checkpoint save/load with the reference's size-mismatch surgery:
counterpart of moda_tpu/train/ckpt.py, in the same files, so a checkpoint
crosses between the packages both ways.

- ``<path>.params.npz``: the parameter tree flattened to "/"-joined keys
  (``bridge.flatten``; the port's "." names with "/");
- ``<path>.vars.npz``: the trainer's host-side ``latest_vars``;
- ``<path>.mvars.npz``: the model's non-optimized state;
- ``<path>.meta.json``: frame and bone counts, steps.

On load into a model with a different number of frames/videos, all
video-specific entries are dropped (train_utils.py:330-359); a bone-count
mismatch drops bones/skin/body heads (train_utils.py:361-366).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np

from moda_tpu_torch.bridge import flatten, unflatten

VIDEO_SPECIFIC = (
    "pose_code", "env_code", "appearance_code", "vid_code",
    "nerf_root_rts", "root_code", "ks_param",
)
BONE_SPECIFIC = ("bones", "nerf_body_rts", "nerf_skin", "nerf_dis")
SUFFIXES = (".params.npz", ".vars.npz", ".mvars.npz", ".meta.json")


def save_checkpoint(path: str, params: Mapping[str, Any], latest_vars: Dict[str, Any],
                    mvars_dict: Dict[str, np.ndarray], meta: Optional[Dict] = None):
    """params: a nested tree (or "/"-flattened dict) of numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".params.npz", **flatten(params))
    lv = {k: np.asarray(v) for k, v in latest_vars.items()
          if isinstance(v, np.ndarray) or np.isscalar(v)}
    np.savez(path + ".vars.npz", **lv)
    np.savez(path + ".mvars.npz", **mvars_dict)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def copy_checkpoint(src: str, dst: str):
    """Duplicate a just-written checkpoint under another tag (the epoch loop
    saves 'latest' and str(epoch+1) with identical contents)."""
    for suffix in SUFFIXES:
        if os.path.exists(src + suffix):
            shutil.copyfile(src + suffix, dst + suffix)


def load_checkpoint(path: str):
    """-> (params nested numpy tree, latest_vars, mvars dict, meta or None)."""
    with np.load(path + ".params.npz") as z:
        params = unflatten(dict(z))
    with np.load(path + ".vars.npz") as z:
        latest_vars = dict(z)
    with np.load(path + ".mvars.npz") as z:
        mvars_dict = dict(z)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, latest_vars, mvars_dict, meta


def merge_params(init_params: Mapping[str, Any], loaded_params: Mapping[str, Any],
                 num_fr_match: bool, num_bones_match: bool) -> Dict[str, Any]:
    """Graft loaded top-level groups onto freshly-initialized ones, dropping
    groups that cannot transfer (the reference's del_key surgery): another
    frame or bone count, or another set of leaves or leaf shapes."""
    out = dict(init_params)
    for k, v in loaded_params.items():
        if k not in out:
            continue
        if not num_fr_match and k in VIDEO_SPECIFIC:
            continue
        if not num_bones_match and k in BONE_SPECIFIC:
            continue
        init_flat = flatten({k: out[k]})
        load_flat = flatten({k: v})
        if set(init_flat) != set(load_flat):
            continue
        if any(init_flat[n].shape != load_flat[n].shape for n in init_flat):
            continue
        out[k] = v
    return out
