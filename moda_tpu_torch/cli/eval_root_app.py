"""Root-pose accuracy evaluation: counterpart of
moda_tpu/cli/eval_root_app.py (scripts/eval/eval_root.py role).

    python -m moda_tpu_torch.cli.eval_root_app <pred_cam_prefix> <gt_cam_prefix> <num_frames>

Camera files are per-frame 4x4 rtk text files as extract_app writes them
(``<prefix>-%05d.txt``) or a directory of ``%05d.txt`` files (the Cameras/
ground-truth layout). Prints the SO(3) error statistics in degrees after a
global rotation and scale alignment (``evals/sim3.py::align_sim3``). Host
numpy only.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from moda_tpu_torch.evals.sim3 import align_sim3


def load_cams(prefix: str, n: int) -> np.ndarray:
    """[n, 4, 4] cameras from ``<prefix>-%05d.txt`` or ``<prefix>/%05d.txt``."""
    out = []
    for i in range(n):
        p = f"{prefix}-{i:05d}.txt"
        if not os.path.exists(p):
            p = os.path.join(prefix, f"{i:05d}.txt")
        out.append(np.loadtxt(p))
    return np.stack(out)


def main(argv=None) -> dict:
    """Print and return the statistics as JSON."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit("usage: python -m moda_tpu_torch.cli.eval_root_app "
                         "<pred_cam_prefix> <gt_cam_prefix> <num_frames>")
    pred_prefix, gt_prefix, n = argv[0], argv[1], int(argv[2])
    stats = align_sim3(load_cams(gt_prefix, n), load_cams(pred_prefix, n))
    out = {k: v for k, v in stats.items() if k != "aligned"}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
