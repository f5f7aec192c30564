"""Two-frame feature-match visualization entry point: counterpart of
moda_tpu/cli/match_app.py (the reference's scripts/visualize/match.py).

  python -m moda_tpu_torch.cli.match_app --seqname <seq> --logname <name> \\
      --model_path logdir/<name>/latest --match_frames "0 5"

matches 64 seeded pixels of frame f0's object mask into the canonical
feature volume, projects them into frame f1 and writes the side-by-side
canvas with the motion lines to
``<checkpoint_dir>/<logname>-match-<f0>-<f1>.png`` (RGB). The frames are
read with ``FrameReader.read_raw`` of video 0 at ``--img_size``.

It runs on the CUDA card (the feature grid's MLP is one fused-MLP K1 launch
under ``--use_pallas``); ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from moda_tpu_torch.cli.flags import parse_config
from moda_tpu_torch.config import DataInfo, load_seq_config
from moda_tpu_torch.data.dataset import build_datasets, data_offsets
from moda_tpu_torch.train.trainer import Trainer
from moda_tpu_torch.viz.match import draw_matches, match_frames
from moda_tpu_torch.viz.render_vis import save_png

NUM_PIXELS = 64  # mask pixels matched, drawn from default_rng(0)


def main(argv=None, device=None) -> Trainer:
    """Match from the flags in ``argv`` (plus ``--match_frames "f0 f1"``,
    default "0 1"); returns the Trainer holding the loaded checkpoint."""
    argv = list(argv if argv is not None else sys.argv[1:])
    pair = "0 1"
    if "--match_frames" in argv:
        i = argv.index("--match_frames")
        pair = argv[i + 1]
        del argv[i:i + 2]
    f0, f1 = [int(x) for x in pair.split()]

    cfg = parse_config(argv)
    datasets = build_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                              rtk_base=cfg.rtk_path or None)
    seqs = load_seq_config(cfg.seqname, cfg.config_dir)
    info = DataInfo(offset=data_offsets(datasets), intrinsics=tuple(tuple(s.ks) for s in seqs))
    trainer = Trainer(cfg, info, loader=None, device=device)

    reader = datasets[0].reader
    d0 = reader.read_raw(f0, flowfw=True, dframe=1)
    d1 = reader.read_raw(f1, flowfw=True, dframe=1)
    S = cfg.img_size
    # pixels on the object mask
    ys, xs = np.where(d0["mask"] > 0)
    sel = np.random.default_rng(0).choice(len(xs), size=min(NUM_PIXELS, len(xs)),
                                          replace=False)
    xys0 = np.stack([xs[sel], ys[sel]], -1).astype(np.float32)
    feats0 = d0["dp_feat_rsmp"].reshape(16, -1)[:, ys[sel] * S + xs[sel]].T

    rtk = trainer.latest_vars["rtk"]
    _, xys1 = match_frames(trainer.model, feats0, xys0, rtk[f0], rtk[f1], d0["kaug"], f0, f1)
    canvas = draw_matches(d0["img"], d1["img"], xys0, xys1)
    out = os.path.join(cfg.checkpoint_dir, cfg.logname + f"-match-{f0}-{f1}.png")
    save_png(out, canvas)
    print(f"wrote {out}")
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
