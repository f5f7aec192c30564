"""Conversion of the reference's released preprocessing checkpoints into
the npz files that preproc_app reads, with no JAX: counterpart of
tools/convert_all_checkpoints.py, whose files it writes bit for bit.

  python -m moda_tpu_torch.cli.convert_app --weights_dir /path/to/weights \\
      [--out_dir weights_converted] [--golden_dir /path/to/golden]

Files found under --weights_dir (the first match of each is converted):
  vcn_rob.pth, vcn*.pth                 VCN+ flow (third_party/vcnplus)
  pointrend*.pkl|.pth, model_final*pointrend*
                                        detectron2 PointRend R50-FPN
  cse*.pkl|.pth, densepose*.pkl|.pth    detectron2 DensePose-CSE
They become ``vcn_rob.npz``, ``pointrend.npz`` and ``cse.npz`` in the
shared layout (preproc/checkpoints.py), and ``manifest.json`` lists them.

--golden_dir holds one frame and the reference pipeline's outputs for it:
``frame.jpg`` (and ``frame2.jpg`` for flow), ``mask.png`` (PointRend's
mask), ``flo.pfm`` (VCN+'s forward flow), ``feat.pfm`` (CSE features, 16 *
112 x 112). The converted models run on them, on the card unless
``main(argv, device="cpu")``, and are scored as the JAX tool scores them:
mask IoU >= 0.90, flow EPE <= 1.0 px, CSE cosine >= 0.95. The report goes
to ``<out_dir>/acceptance.json``; main returns 1 if a check fails, 2 if
nothing was found to convert or to score.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional

import numpy as np

from moda_tpu_torch.preproc.checkpoints import save_pytree_npz

PATTERNS = {
    "vcn": ["vcn_rob.pth", "vcn*.pth"],
    "pointrend": ["pointrend*.pkl", "pointrend*.pth", "model_final*pointrend*"],
    "cse": ["cse*.pkl", "cse*.pth", "densepose*.pkl", "densepose*.pth"],
}
OUT_NAMES = {"vcn": "vcn_rob.npz", "pointrend": "pointrend.npz", "cse": "cse.npz"}
MASK_IOU_MIN, FLOW_EPE_MAX, CSE_COSINE_MIN = 0.90, 1.0, 0.95


def _find(weights_dir: str, patterns) -> Optional[str]:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(weights_dir, pat)))
        if hits:
            return hits[0]
    return None


def convert_tree(kind: str, path: str) -> dict:
    """The npz tree of one checkpoint file."""
    from moda_tpu_torch.preproc import cse_infer, pointrend_infer, vcn_flow

    if kind == "vcn":
        params, mean = vcn_flow.load_vcn_checkpoint(path)
        return {"params": params, "mean": mean}
    sd = cse_infer.load_detectron2_state_dict(path)
    if kind == "pointrend":
        return pointrend_infer.convert_pointrend_checkpoint(sd)
    return cse_infer.convert_cse_checkpoint(sd)


# ------------------------------------------------------------ acceptance
def _gray_mask(path: str) -> np.ndarray:
    from moda_tpu_torch.data import imageio as IO

    m = IO.imread(path, gray=True)
    if m is None:
        raise ValueError(f"{path}: not an image")
    return m > 0


def run_acceptance(golden_dir: str, converted: dict, device=None) -> dict:
    """Score the converted npz files on the golden frame (tools/
    convert_all_checkpoints.py::run_acceptance, read through the port's
    image and PFM readers; frames reach the models as BGR)."""
    from moda_tpu_torch.data import imageio as IO
    from moda_tpu_torch.data.pfm import read_pfm
    from moda_tpu_torch.preproc import checkpoints

    report: dict = {}
    frame_p = os.path.join(golden_dir, "frame.jpg")
    img = IO.imread(frame_p)
    if img is None:
        raise FileNotFoundError(f"{frame_p} missing or unreadable")
    img = np.ascontiguousarray(img[..., ::-1])

    mask_p = os.path.join(golden_dir, "mask.png")
    if "pointrend" in converted and os.path.exists(mask_p):
        gt = _gray_mask(mask_p)
        pred = checkpoints.load_pointrend_predictor(converted["pointrend"], device=device)
        got = pred.as_mask_fn()(img) > 0
        iou = float(np.logical_and(gt, got).sum()) / max(float(np.logical_or(gt, got).sum()), 1.0)
        report["mask_iou"] = {"value": iou, "pass": bool(iou >= MASK_IOU_MIN)}

    flo_p, frame2_p = os.path.join(golden_dir, "flo.pfm"), os.path.join(golden_dir, "frame2.jpg")
    if "vcn" in converted and os.path.exists(flo_p) and os.path.exists(frame2_p):
        gt_flow = read_pfm(flo_p)[0][..., :2]
        img2 = IO.imread(frame2_p)
        if img2 is None:
            raise FileNotFoundError(f"{frame2_p} unreadable")
        flow_fn = checkpoints.load_vcn_predictor(converted["vcn"], device=device).as_flow_fn()
        flow = flow_fn(img, np.ascontiguousarray(img2[..., ::-1]))
        epe = float(np.linalg.norm(flow - gt_flow, axis=-1).mean())
        report["flow_epe_px"] = {"value": epe, "pass": bool(epe <= FLOW_EPE_MAX)}

    feat_p = os.path.join(golden_dir, "feat.pfm")
    if "cse" in converted and os.path.exists(feat_p):
        gt_feat = read_pfm(feat_p)[0].reshape(16, 112, 112)
        mask = (_gray_mask(mask_p).astype(np.uint8) if os.path.exists(mask_p)
                else np.ones(img.shape[:2], np.uint8))
        feat, _, _ = checkpoints.load_cse_predictor(converted["cse"], device=device)(img, mask)
        a, b = gt_feat.reshape(16, -1).T, feat.reshape(16, -1).T
        den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-8
        cos = float(((a * b).sum(-1) / den).mean())
        report["cse_cosine"] = {"value": cos, "pass": bool(cos >= CSE_COSINE_MIN)}
    return report


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights_dir", required=True)
    ap.add_argument("--out_dir", default="weights_converted")
    ap.add_argument("--golden_dir", default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    converted = {}
    for kind, patterns in PATTERNS.items():
        src = _find(args.weights_dir, patterns)
        if src:
            converted[kind] = os.path.join(args.out_dir, OUT_NAMES[kind])
            save_pytree_npz(converted[kind], convert_tree(kind, src))
            print(f"converted {src} -> {converted[kind]}")
    if not converted:
        print(f"no recognized checkpoints under {args.weights_dir} "
              "(expected vcn_rob.pth / pointrend*.pkl / cse*.pkl)")
        return 2
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump({k: os.path.abspath(v) for k, v in converted.items()}, f, indent=1)

    if args.golden_dir:
        report = run_acceptance(args.golden_dir, converted, device=device)
        with open(os.path.join(args.out_dir, "acceptance.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report, indent=1))
        if not report:
            print("golden_dir given but no scorable artifacts found")
            return 2
        if not all(v["pass"] for v in report.values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
