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
``--steps_chunk K`` makes K optimizer steps a call (rounded down to divide
50 and the epoch; ``Trainer.steps_chunk``).

Data parallelism, one process per card:

  torchrun --nproc_per_node N -m moda_tpu_torch.cli.train_app <flags>

Each rank trains on cuda:LOCAL_RANK (``parallel/dist.py``; NCCL), draws
``--batch_size / N`` pairs a step from its own loader stream
(``process_index``), and the step makes the update one process makes on the
global batch of ``--batch_size`` pairs; rank 0 alone writes. A batch that N
(times ``--accu_steps``) does not divide raises: the JAX package replicates
it instead. ``main(argv, device="cpu")`` runs the ranks on the CPU (gloo).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from moda_tpu_torch.data.dataset import (PairLoader, build_datasets, build_line_datasets,
                                         data_offsets)
from moda_tpu_torch.parallel import dist


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


def main(argv=None, device=None, backend=None):
    """Train from the flags in ``argv``; returns the Trainer. Under torchrun
    (WORLD_SIZE > 1) this process joins the data-parallel group first, on
    ``device`` (cuda:LOCAL_RANK by default) with ``backend`` (NCCL on a
    card, gloo on the CPU by default; ranks that share one card need
    gloo)."""
    from moda_tpu_torch.cli.flags import parse_config

    cfg = parse_config(argv)
    world = dist.world_size()
    if world > 1 and cfg.batch_size % (world * cfg.accu_steps):
        raise ValueError(f"--batch_size {cfg.batch_size} does not divide into {world} ranks x "
                         f"--accu_steps {cfg.accu_steps}")
    comm = dist.init_from_env(device=device, backend=backend) if world > 1 else None
    try:
        return _train(cfg, comm, device if comm is None else comm.device)
    finally:
        if comm is not None:
            comm.close()


def _train(cfg, comm, device):
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.train.trainer import Trainer

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
    world = 1 if comm is None else comm.world
    loader = PairLoader(datasets, cfg.batch_size // world, seed=cfg.seed,
                        process_index=0 if comm is None else comm.rank,
                        num_threads=cfg.n_data_workers,
                        num_prefetch=max(4, cfg.n_data_workers),
                        npix=None if cfg.ft_cse else 5 * cfg.nsample)
    try:
        trainer = Trainer(cfg, info, loader=loader, seed=cfg.seed, device=device,
                          eval_datasets=_eval_datasets(cfg), comm=comm)
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
