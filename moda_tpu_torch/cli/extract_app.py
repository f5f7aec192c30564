"""Mesh and camera extraction entry point: counterpart of
moda_tpu/cli/extract_app.py (the reference's extract.py).

  python -m moda_tpu_torch.cli.extract_app --seqname <seq> --logname <name> \\
      --model_path logdir/<name>/latest --lineload --test_frames '{0}' \\
      --sample_grid3d 128

(the flags of scripts/eval_synth.sh). It loads a checkpoint (either
package's), extracts the canonical mesh, warps it to each requested frame
(the queryfw route, train_utils.py:1467-1473), renders the frames the
checkpoint has cameras for, and writes the JAX package's export layout to
``<checkpoint_dir>/<logname>-export/`` (extract.py:24-136's save_output):
``<seq>-mesh-rest.obj``, ``<seq>-mesh-skin.obj`` and per frame
``<seq>-mesh-%05d.obj``, ``-cam-%05d.txt``, ``-ctrajs-%05d.txt`` and
``-refsil-%05d.png``, and the rgb and silhouette animations
``<seq>-rgb.gif`` / ``<seq>-sil.gif`` (the port's own GIF writer,
``viz/render_vis.save_gif``). The refsil size is the first mask's
((render_size, render_size) where there is none), decoded by
``data/imageio.py`` as the JAX package decodes it with cv2.

It runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
The videos' frame counts come from the frame datasets, as in the JAX
package; building them reads no file, so a dataset with or without
``Pixels/`` line shards takes the same route.

Multi-device extraction (the JAX package's device mesh over the grid
points and the frames): under torchrun (WORLD_SIZE > 1) each process joins
a group (parallel/dist.py), rank 0 reads the checkpoint and broadcasts it,
each rank queries its share of the grid's chunks (``extract_mesh``'s comm:
every rank then holds the whole volume and marches the same rest mesh) and
takes its share of the frames in groups of WARP_GROUP: their warps, meshes,
cameras, silhouettes and renders; rank 0 writes the rest and skin meshes,
gathers the renders and writes the animations. The files are those of one
process, byte for byte.

  torchrun --nproc_per_node 2 -m moda_tpu_torch.cli.extract_app <flags>
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from moda_tpu_torch.cli.flags import parse_config
from moda_tpu_torch.config import DataInfo, load_seq_config
from moda_tpu_torch.data.dataset import build_datasets, data_offsets
from moda_tpu_torch.data.imageio import imread
from moda_tpu_torch.extract.mesh import Mesh, extract_mesh, make_warp_fw_frames, skin_colors
from moda_tpu_torch.parallel import dist
from moda_tpu_torch.render.evalrender import make_frame_renderer
from moda_tpu_torch.train.trainer import Trainer
from moda_tpu_torch.viz.render_vis import mesh_silhouette, save_gif, save_png

WARP_GROUP = 4  # frames per warp call (the JAX package's group on one device)


def parse_test_frames(spec: str, offsets) -> list:
    """test_frames syntax (utils/io.py str_to_frame): '{0,1}' = every frame
    but the last of videos 0 and 1; 'N' = N frames evenly spaced."""
    total = offsets[-1]
    if spec.startswith("{"):
        idx = []
        for v in spec[1:-1].split(","):
            v = int(v)
            idx += list(range(offsets[v], offsets[v + 1] - 1))
        return idx
    n = int(spec)
    return list(np.linspace(0, total - 1, min(n, total), dtype=int))


def _mask_size(seq, rs: int):
    """(H, W) of a video's first mask (Annotations/ PNG), or (rs, rs) where
    it is missing or not an image."""
    first = seq.image_list()[0]
    mask = imread(first.replace("JPEGImages", "Annotations").rsplit(".", 1)[0] + ".png",
                  gray=True)
    return mask.shape if mask is not None else (rs, rs)


def main(argv=None, device=None, backend=None) -> Trainer:
    """Extract from the flags in ``argv``; returns the Trainer holding the
    loaded checkpoint. Under torchrun (WORLD_SIZE > 1) this process joins
    the group first, on ``device`` (cuda:LOCAL_RANK by default) with
    ``backend`` (NCCL on a card, gloo on the CPU by default; ranks that
    share one card need gloo)."""
    cfg = parse_config(argv)
    if not cfg.model_path:
        raise SystemExit("--model_path is required for extraction")
    comm = dist.init_from_env(device=device, backend=backend) if dist.world_size() > 1 \
        else None
    try:
        return _extract(cfg, comm, device if comm is None else comm.device)
    finally:
        if comm is not None:
            comm.close()


def _extract(cfg, comm, device) -> Trainer:
    seqs = load_seq_config(cfg.seqname, cfg.config_dir)
    datasets = build_datasets(cfg.seqname, cfg.img_size, cfg.config_dir,
                              rtk_base=cfg.rtk_path or None)
    offsets = data_offsets(datasets)
    info = DataInfo(offset=offsets, intrinsics=tuple(tuple(s.ks) for s in seqs))
    trainer = Trainer(cfg, info, loader=None, device=device, comm=comm)
    model, lv, main_rank = trainer.model, trainer.latest_vars, trainer.is_main

    out_dir = os.path.join(cfg.checkpoint_dir, cfg.logname + "-export")
    os.makedirs(out_dir, exist_ok=True)

    def out(kind: str) -> str:
        return os.path.join(out_dir, f"{cfg.seqname}-{kind}")

    mesh_rest = extract_mesh(model, lv["obj_bound"], cfg.sample_grid3d, cfg.mc_threshold,
                             use_vis=not cfg.full_mesh, comm=comm)
    if main_rank:
        mesh_rest.export_obj(out("mesh-rest.obj"))
        if len(mesh_rest.vertices) > 0:
            skin_mesh = mesh_rest.copy()
            skin_mesh.colors = skin_colors(model, mesh_rest)
            skin_mesh.export_obj(out("mesh-skin.obj"))

    idx_render = parse_test_frames(cfg.test_frames, offsets)
    rank, world = (comm.rank, comm.world) if comm is not None else (0, 1)
    groups = frame_groups(idx_render, rank, world)
    mine = [fi for group in groups for fi in group]
    rs = cfg.render_size
    warped = warp_groups(model, mesh_rest.vertices, groups) \
        if cfg.queryfw and len(mesh_rest.vertices) > 0 else {}

    renderer = make_frame_renderer(model, rs, cfg.ndepth, chunk=cfg.chunk)
    renders = {}  # frame -> rgb and silhouette, [rs, rs, 6]
    mask_sizes = {}
    for fi in mine:
        mesh_i = Mesh(warped[fi], mesh_rest.faces, mesh_rest.colors) if fi in warped \
            else mesh_rest
        mesh_i.export_obj(out(f"mesh-{fi:05d}.obj"))
        rtk = lv["rtk"][fi].copy()
        rtk[:3, 3] *= model.obj_scale
        np.savetxt(out(f"cam-{fi:05d}.txt"), rtk)
        # camera trajectory and reference silhouette for the NVS tool
        # (render_vis.py:501-535: ctraj = [R|T; scaled K], refsil = mesh mask)
        if len(mesh_i.vertices) > 0:
            di = int(np.searchsorted(np.asarray(offsets), fi, side="right")) - 1
            if di not in mask_sizes:
                mask_sizes[di] = _mask_size(seqs[di], rs)
            H0, W0 = mask_sizes[di]
            sc = min(1.0, 512.0 / max(H0, W0))
            H1, W1 = max(int(H0 * sc), 1), max(int(W0 * sc), 1)
            # model-unit camera (as the exported meshes); row 3 = the raw
            # intrinsics rescaled to the silhouette's size
            ctraj = lv["rtk"][fi].copy()
            ctraj[3] = ctraj[3] * sc
            sil = mesh_silhouette(mesh_i, ctraj, H1, W1)
            np.savetxt(out(f"ctrajs-{fi:05d}.txt"), ctraj)
            save_png(out(f"refsil-{fi:05d}.png"), (sil * 128).astype(np.uint8))
        # per-frame renders (extract.py save_output's rgb and sil images)
        if lv["idk"][fi] > 0:
            rtk_d = lv["rtk"][fi][None]
            px, py = float(rtk_d[0, 3, 2]), float(rtk_d[0, 3, 3])
            kaug = np.asarray([[max(2 * px / rs, 1e-6), max(2 * py / rs, 1e-6), 0.0, 0.0]],
                              np.float32)
            # one fixed stream per frame, as the JAX renderer's fixed key
            gen = torch.Generator(device=model.device).manual_seed(0)
            o = renderer(rtk_d, kaug, [fi], [0], generator=gen)
            renders[fi] = np.concatenate([np.clip(o["img_coarse"], 0, 1),
                                          np.repeat(np.clip(o["sil_coarse"], 0, 1), 3, -1)], -1)
    if comm is not None:
        renders = _gather_renders(comm, renders, idx_render, mine, rs)
    if main_rank:
        frames = [renders[fi] for fi in idx_render if fi in renders]
        if frames:
            save_gif(out("rgb.gif"), [f[..., :3] for f in frames])
            save_gif(out("sil.gif"), [f[..., 3:] for f in frames])
        print(f"exported {len(idx_render)} frames to {out_dir}"
              + (f" ({comm.world} ranks)" if comm is not None else ""))
    return trainer


def frame_groups(idx_render: list, rank: int = 0, world: int = 1) -> list:
    """``rank``'s share of the frames, in groups of WARP_GROUP (one warp call
    a group)."""
    groups = [list(idx_render[g0:g0 + WARP_GROUP]) for g0 in range(0, len(idx_render),
                                                                    WARP_GROUP)]
    return [groups[g] for g in dist.share(len(groups), rank, world)]


def warp_groups(model, vertices: np.ndarray, groups: list) -> dict:
    """The rest mesh's vertices warped to every frame of ``groups``, one
    call a group (the last padded by repeating its last frame): {frame:
    [V, 3]}."""
    warp, warped = make_warp_fw_frames(model), {}
    for group in groups:
        verts_dfm, _ = warp(vertices, group + [group[-1]] * (WARP_GROUP - len(group)))
        verts_np = verts_dfm.cpu().numpy()
        for j, fi in enumerate(group):
            warped[fi] = verts_np[j]
    return warped


def _gather_renders(comm, renders: dict, idx_render: list, mine: list, rs: int) -> dict:
    """Every rank's renders on every rank: one all-reduce of [frames, rs,
    rs, 6] images, each rank's frames at their rows of a zero buffer, and
    of the rendered flags."""
    pos = {fi: k for k, fi in enumerate(idx_render)}
    imgs = torch.zeros((len(mine), rs, rs, 6), dtype=torch.float32, device=comm.device)
    flags = torch.zeros(len(mine), dtype=torch.int32, device=comm.device)
    for k, fi in enumerate(mine):
        if fi in renders:
            imgs[k] = torch.from_numpy(renders[fi])
            flags[k] = 1
    rows = torch.as_tensor([pos[fi] for fi in mine], dtype=torch.long, device=comm.device)
    imgs, flags = dist.Shard(comm, rows, len(idx_render)).reduce([imgs, flags], scatter=True)
    imgs, flags = imgs.cpu().numpy(), flags.cpu().numpy()
    return {fi: imgs[k] for k, fi in enumerate(idx_render) if flags[k]}


if __name__ == "__main__":
    main(sys.argv[1:])
