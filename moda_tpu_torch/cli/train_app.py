"""Training entry point: counterpart of moda_tpu/cli/train_app.py (the
reference's main.py) for the line-shard route.

  python -m moda_tpu_torch.cli.train_app --seqname <seq> --logname <name> \\
      --num_epochs 120 --lineload --batch_size 256 --warmup_shape_ep 5 \\
      --warmup_rootmlp --eikonal_wt 0.001 --nsample 4 --noppr_eikonal \\
      --render_size 0

(stage 1 of scripts/template.sh, with ``--render_size 0``). It trains on
the CUDA card; ``main(argv, device="cpu")`` runs the plain path on the CPU.
Refused, each naming the later slice that ports it: a dataset without
``Pixels/`` line shards (the frame-decoding route), more than one
process, and the trainer's and the step's unported flags
(``train/trainer.py::check_ported``).
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _num_processes() -> int:
    """The process count that torch's launchers (torchrun) set."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def main(argv=None, device=None):
    """Train from the flags in ``argv``; returns the Trainer."""
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data.dataset import PairLoader, build_line_datasets, data_offsets
    from moda_tpu_torch.train.trainer import Trainer, check_ported

    if _num_processes() > 1:
        raise NotImplementedError("training in more than one process is ported in a later "
                                  "slice of moda_tpu_torch (the multi-GPU slice)")
    cfg = parse_config(argv)
    check_ported(cfg)
    seqs = load_seq_config(cfg.seqname, cfg.config_dir)
    pixels = seqs[0].image_list()[0].replace("JPEGImages", "Pixels").rsplit("/", 1)[0]
    if not (cfg.lineload and os.path.isdir(pixels)):
        raise NotImplementedError("training without --lineload and Pixels/ line shards (the "
                                  "frame-decoding route) is ported in a later slice of "
                                  "moda_tpu_torch (the data slice)")
    datasets = build_line_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                                   rtk_base=cfg.rtk_path or None)
    info = DataInfo(offset=data_offsets(datasets), intrinsics=tuple(tuple(s.ks) for s in seqs))
    # host-side pixel sampling: nsample uniform slots + the 4x active
    # candidate pool per entry
    loader = PairLoader(datasets, cfg.batch_size, seed=cfg.seed,
                        num_threads=cfg.n_data_workers,
                        num_prefetch=max(4, cfg.n_data_workers), npix=5 * cfg.nsample)
    try:
        trainer = Trainer(cfg, info, loader=loader, seed=cfg.seed, device=device)
        # canonical template prior (moda.py:405-445)
        if cfg.prior_mesh_path:
            trainer.load_prior_mesh(cfg.prior_mesh_path)
        # camera initialization from rtk files on disk
        if cfg.use_rtk_file or cfg.rtk_path:
            rtks = []
            for d in datasets:
                for i in range(d.num_frames):
                    try:
                        rtk = np.loadtxt(d.rtklist[i])
                    except OSError:
                        break
                    rtk[:3, 3] /= trainer.model.obj_scale
                    rtks.append(rtk)
            if len(rtks) == info.num_fr:
                trainer.set_cameras_from_rtk_files(np.stack(rtks).astype(np.float32))
        trainer.train()
    finally:
        loader.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
