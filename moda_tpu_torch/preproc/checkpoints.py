"""Converted-checkpoint npz IO and the predictor loaders of preprocessing:
counterpart of moda_tpu/preproc/checkpoints.py.

Format (the JAX package's, so a file written by either package loads in
the other): one flat .npz whose keys are '/'-joined paths into the nested
parameter dict (vcn_rob.npz: {params, mean}; pointrend.npz: the parameter
tree; cse.npz: {backbone, head[, vertex_embeddings]}), as
tools/convert_all_checkpoints.py writes them.

The VCN+ flow predictor loads here. The PointRend and DensePose-CSE graphs
are ported in the next slice (ROADMAP.md §1 item 4); their loaders raise
until then, so that preproc_app never writes zero features or skips
segmentation where their weights were given.
"""
from __future__ import annotations

import numpy as np

from moda_tpu_torch.bridge import flatten, unflatten, vcn_from_jax
from moda_tpu_torch.preproc.vcn_flow import VCNFlowPredictor
from moda_tpu_torch.runtime import resolve_device

NEXT_SLICE = ("is ported in a later slice, with the ResNet-50 + FPN backbone "
              "(ROADMAP.md §1 item 4)")


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


def load_pointrend_predictor(npz_path: str, **kw):
    raise NotImplementedError(f"the PointRend graph ({npz_path}) {NEXT_SLICE}; pass "
                              "--mask_dir, or keep the Annotations, and no pointrend*.npz")


def load_cse_predictor(npz_path: str, **kw):
    raise NotImplementedError(f"the DensePose-CSE graph ({npz_path}) {NEXT_SLICE}; without "
                              "a cse*.npz the stage writes zero features (--nouse_embed)")
