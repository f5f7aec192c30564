"""Converted-checkpoint npz IO and the predictor loaders of preprocessing:
counterpart of moda_tpu/preproc/checkpoints.py.

Format (the JAX package's, so a file written by either package loads in
the other): one flat .npz whose keys are '/'-joined paths into the nested
parameter dict (vcn_rob.npz: {params, mean}; pointrend.npz: the parameter
tree; cse.npz: {backbone, head[, vertex_embeddings]}), as
tools/convert_all_checkpoints.py writes them.

The loaders build the VCN+ flow, PointRend and DensePose-CSE predictors
on ``device`` (the card unless ``device="cpu"``); a missing key raises.
"""
from __future__ import annotations

import numpy as np

from moda_tpu_torch.bridge import flatten, unflatten, vcn_from_jax
from moda_tpu_torch.preproc.cse_infer import CSEPredictor
from moda_tpu_torch.preproc.pointrend_infer import PointRendPredictor
from moda_tpu_torch.preproc.vcn_flow import VCNFlowPredictor
from moda_tpu_torch.runtime import resolve_device


flatten_tree = flatten


def unflatten_tree(flat: dict) -> dict:
    return unflatten({k: np.asarray(v) for k, v in flat.items()})


def save_pytree_npz(path: str, tree) -> None:
    np.savez(path, **flatten_tree(tree))


def load_pytree_npz(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def load_vcn_predictor(npz_path: str, device=None, **kw):
    """The VCN+ flow predictor of a converted ``vcn_rob.npz``, on ``device``
    (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    t = load_pytree_npz(npz_path)
    return VCNFlowPredictor(vcn_from_jax(t["params"], dev), mean=t["mean"], **kw)


def load_pointrend_predictor(npz_path: str, device=None, **kw) -> PointRendPredictor:
    """The PointRend predictor of a converted ``pointrend.npz`` on
    ``device``; ``kw`` as PointRendPredictor takes them (keep_classes,
    score_thresh, input_size, ...)."""
    return PointRendPredictor(load_pytree_npz(npz_path), device=device, **kw)


def load_cse_predictor(npz_path: str, device=None, **kw) -> CSEPredictor:
    """The DensePose-CSE predictor of a converted ``cse.npz`` ({backbone,
    head[, vertex_embeddings]}) on ``device``."""
    t = load_pytree_npz(npz_path)
    return CSEPredictor(t["backbone"], t["head"], vertex_embeddings=t.get("vertex_embeddings"),
                        device=device, **kw)
