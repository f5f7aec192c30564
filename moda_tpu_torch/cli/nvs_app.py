"""Novel-view-synthesis entry point: counterpart of moda_tpu/cli/nvs_app.py
(the reference's scripts/visualize/nvs.py).

  python -m moda_tpu_torch.cli.nvs_app --seqname <seq> --logname <name> \\
      --model_path logdir/<name>/latest --test_frames 9

renders (a) an input-view replay and (b) a bullet-time turntable around the
middle frame, written as ``replay.gif`` and ``bullet.gif`` under
``<checkpoint_dir>/<logname>-nvs/``. With ``--rootdir <export>/<seq>-ctrajs-``
it renders along extract_app's saved camera trajectories instead,
composited with its ``-refsil-`` silhouettes, and writes
``<nvs_outpath>-{rgb,sil,vis}_%05d.png`` and ``<nvs_outpath>-rgb.gif``.
The PNGs are written as RGB (the JAX package writes the same file through
cv2's BGR order).

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
The renders run on the model's plain fp32 view: no kernel launch.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from moda_tpu_torch.cli.flags import parse_config
from moda_tpu_torch.config import DataInfo, load_seq_config
from moda_tpu_torch.data.dataset import build_datasets, data_offsets
from moda_tpu_torch.extract.mesh import extract_mesh
from moda_tpu_torch.train.trainer import Trainer
from moda_tpu_torch.viz.nvs import (load_root, load_sils, render_nvs, render_nvs_ctraj,
                                    turntable_cams)
from moda_tpu_torch.viz.render_vis import save_gif, save_png, to_uint8


def main(argv=None, device=None) -> Trainer:
    """Render from the flags in ``argv``; returns the Trainer holding the
    loaded checkpoint."""
    cfg = parse_config(argv)
    if not cfg.model_path:
        raise SystemExit("--model_path is required for novel-view synthesis")
    datasets = build_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                              rtk_base=cfg.rtk_path or None)
    offsets = data_offsets(datasets)
    seqs = load_seq_config(cfg.seqname, cfg.config_dir)
    info = DataInfo(offset=offsets, intrinsics=tuple(tuple(s.ks) for s in seqs))
    trainer = Trainer(cfg, info, loader=None, device=device)
    model, lv = trainer.model, trainer.latest_vars

    if cfg.rootdir:
        # ctraj-file-driven NVS with reference-sil compositing
        # (scripts/visualize/nvs.py:41-199)
        rtks = load_root(cfg.rootdir)
        sils = load_sils(cfg.rootdir.replace("ctrajs", "refsil"))
        if cfg.maxframe > 0:
            sample_idx = np.linspace(0, len(rtks) - 1, cfg.maxframe).astype(int)
        else:
            sample_idx = np.arange(len(rtks))
        rtks = rtks[sample_idx]
        sils = [sils[i] for i in sample_idx]
        embedids = sample_idx + offsets[cfg.vidid]
        if cfg.bullet_time > -1:
            embedids = np.full_like(embedids, cfg.bullet_time + offsets[cfg.vidid])
        mesh_rest = extract_mesh(model, lv["obj_bound"], cfg.sample_grid3d, cfg.mc_threshold)
        frames = render_nvs_ctraj(model, rtks, sils, embedids, cfg.ndepth, scale=cfg.scale,
                                  chunk=cfg.chunk, mesh_rest_verts=mesh_rest.vertices)
        os.makedirs(os.path.dirname(cfg.nvs_outpath) or ".", exist_ok=True)
        for i, f in enumerate(frames):
            for kind in ("rgb", "sil", "vis"):
                save_png(f"{cfg.nvs_outpath}-{kind}_{i:05d}.png", to_uint8(f[kind]))
        save_gif(f"{cfg.nvs_outpath}-rgb.gif", [f["rgb"] for f in frames])
        print(f"wrote {len(frames)} NVS frames to {cfg.nvs_outpath}-*")
        return trainer

    out_dir = os.path.join(cfg.checkpoint_dir, cfg.logname + "-nvs")
    os.makedirs(out_dir, exist_ok=True)
    num_fr = info.num_fr
    n = min(9 if cfg.test_frames.startswith("{") else int(cfg.test_frames), num_fr)
    ids = np.linspace(0, num_fr - 1, n, dtype=int)

    # input-view replay
    frames = render_nvs(model, lv["rtk"][ids], ids, cfg.render_size, cfg.ndepth,
                        chunk=cfg.chunk)
    save_gif(os.path.join(out_dir, "replay.gif"), [f["img_coarse"] for f in frames])

    # bullet time around the middle frame
    mid = int(ids[len(ids) // 2])
    orbit = turntable_cams(lv["rtk"][mid], num_views=n)
    frames = render_nvs(model, orbit, [mid] * n, cfg.render_size, cfg.ndepth, chunk=cfg.chunk)
    save_gif(os.path.join(out_dir, "bullet.gif"), [f["img_coarse"] for f in frames])
    print(f"wrote {out_dir}/replay.gif and bullet.gif")
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
