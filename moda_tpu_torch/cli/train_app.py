"""Training entry point: counterpart of moda_tpu/cli/train_app.py (the
reference's main.py).

  python -m moda_tpu_torch.cli.train_app --seqname <seq> --logname <name> \\
      --num_epochs 120 --lineload --batch_size 256 --warmup_shape_ep 5 \\
      --warmup_rootmlp --eikonal_wt 0.001 --nsample 4 --noppr_eikonal

(stage 1 of scripts/template.sh). It trains on the CUDA card;
``main(argv, device="cpu")`` runs the plain path on the CPU. With
``--lineload`` and ``Pixels/`` line shards it trains from the shards;
otherwise it decodes the frames (``data/dataset.py::build_datasets``, the
frame-decoding route). Either way the eval grid reads its observed columns
through frame datasets at ``--render_size`` (``eval_datasets``), as the JAX
package does; a video without frames, or ``--render_size 0``, leaves the
grid without them (logged where frames are missing).
With ``--warmup_pose_ep`` > 0 and a template prior, the trainer's cold start
trains the pose CNN and takes the cameras from it. With ``--ft_cse`` the
batches carry full crops (the trainable CSE net reads them; batch mode).
Refused, naming the later slice that ports it: more than one process and
``--steps_chunk`` > 1 (``train/trainer.py::check_ported``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from moda_tpu_torch.data.dataset import (PairLoader, build_datasets, build_line_datasets,
                                         data_offsets)


def _num_processes() -> int:
    """The process count that torch's launchers (torchrun) set."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def _eval_datasets(cfg):
    """Frame datasets at render_size for the eval grid's observed columns
    (train_utils.py:140), or None where the grid is off (render_size 0) or a
    video has no frames. None lets the cold start read the loader's frame
    datasets at img_size instead."""
    if cfg.render_size <= 0:
        return None
    try:
        return build_datasets(cfg.seqname, cfg.render_size, cfg.config_dir,
                              rtk_base=cfg.rtk_path or None)
    except FileNotFoundError as e:
        print(f"train_app: the eval grid has no observed columns ({e})")
        return None


def main(argv=None, device=None):
    """Train from the flags in ``argv``; returns the Trainer."""
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.train.trainer import Trainer, check_ported

    if _num_processes() > 1:
        raise NotImplementedError("training in more than one process is ported in a later "
                                  "slice of moda_tpu_torch (the multi-GPU slice)")
    cfg = parse_config(argv)
    check_ported(cfg)
    seqs = load_seq_config(cfg.seqname, cfg.config_dir)
    imgs = seqs[0].image_list()
    if not imgs:
        raise FileNotFoundError(f"no frames under {seqs[0].datapath}")
    pixels = imgs[0].replace("JPEGImages", "Pixels").rsplit("/", 1)[0]
    # lineload: the reference's pre-sharded pixel rows when present
    if cfg.lineload and os.path.isdir(pixels):
        datasets = build_line_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                                       rtk_base=cfg.rtk_path or None)
    else:
        datasets = build_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                                  rtk_base=cfg.rtk_path or None)
    info = DataInfo(offset=data_offsets(datasets), intrinsics=tuple(tuple(s.ks) for s in seqs))
    # host-side pixel sampling: nsample uniform slots + the 4x active
    # candidate pool per entry; ft_cse's CSE net needs the full crops
    loader = PairLoader(datasets, cfg.batch_size, seed=cfg.seed,
                        num_threads=cfg.n_data_workers,
                        num_prefetch=max(4, cfg.n_data_workers),
                        npix=None if cfg.ft_cse else 5 * cfg.nsample)
    try:
        trainer = Trainer(cfg, info, loader=loader, seed=cfg.seed, device=device,
                          eval_datasets=_eval_datasets(cfg))
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
