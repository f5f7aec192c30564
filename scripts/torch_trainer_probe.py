"""Two probes of the port's stage-1 trainer at the flags of chip_smoke.py's
trainer phase (full widths, batch 256, 16 synthetic frames at 128 px).

``warmup``: the shape warmup (one epoch of 200 steps) and the rest-mesh
extraction at the trainer's 64^3 grid, with the warmup's points drawn from
a seeded CPU generator so that every host and device sees the same draws.
It separates the initializer from the warmup's trajectory: ``--save-init``
writes the initial parameters as a checkpoint (the path is its prefix, as
for ``train/ckpt.py``), ``--init`` starts from such a checkpoint instead
of the port's own initializer, and the line printed carries a checksum of
the parameters the warmup starts from. To compare two hosts, run it on
both with ``--save-init``, then on each from the other's checkpoint:

    python scripts/torch_trainer_probe.py warmup --device cpu --save-init hostA
    python scripts/torch_trainer_probe.py warmup --device cuda --init hostA

``loader``: the dense line-shard route's cost: the preload, one batch of
256 pairs assembled on one thread (the mean of 20), and its upload to the
card through pinned memory.

    python scripts/torch_trainer_probe.py loader
"""
import argparse
import hashlib
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from moda_tpu_torch import bridge  # noqa: E402
from moda_tpu_torch.config import DataInfo, MoDAConfig  # noqa: E402
from moda_tpu_torch.train import ckpt as CK  # noqa: E402
from moda_tpu_torch.train.trainer import Trainer  # noqa: E402

IMG, FRAMES, BATCH, NPIX = 128, 16, 256, 20  # chip_smoke.py's trainer phase (npix = 5 nsample)
DRAW_SEED, GRID = 5, 64


class CpuDraws:
    """The warmup's point draws from one seeded CPU generator."""

    def __init__(self, seed: int):
        self.g = torch.Generator().manual_seed(seed)

    def __call__(self, kind, **info):
        if kind != "shape_pts":
            raise KeyError(kind)
        return torch.rand(info["n"], 3, generator=self.g) * 2.0 - 1.0


def checksum(model) -> str:
    h = hashlib.sha1()
    for n, p in sorted(model.named_parameters()):
        h.update(n.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def make_trainer(device: str, log_dir: str, draws=None) -> Trainer:
    cfg = MoDAConfig(img_size=IMG, lineload=True, batch_size=BATCH, nsample=NPIX // 5,
                     warmup_shape_ep=1, warmup_rootmlp=True, eikonal_wt=0.001, num_epochs=1,
                     dskin_steps=1.0, render_size=0, checkpoint_dir=log_dir)
    info = DataInfo(offset=(0, FRAMES), intrinsics=((float(IMG), float(IMG), IMG / 2, IMG / 2),))
    return Trainer(cfg, info, device=device, draws=draws)


def warmup(args):
    from moda_tpu_torch.extract.mesh import extract_mesh

    with tempfile.TemporaryDirectory() as log_dir:
        tr = make_trainer(args.device, log_dir, CpuDraws(DRAW_SEED))
        if args.init:
            bridge.load_params(tr.model, CK.load_checkpoint(args.init)[0])
        if args.save_init:
            CK.save_checkpoint(args.save_init, bridge.export_params(tr.model), {}, {})
        start = checksum(tr.model)
        t0 = time.time()
        loss = tr.warmup_shape(tr.cfg.warmup_shape_ep)
        t_warm = time.time() - t0
        tr.reset_nf()
        mesh = extract_mesh(tr.model, tr.latest_vars["obj_bound"], GRID, tr.cfg.mc_threshold,
                            query=tr.grid_query)
    print(f"[warmup probe] torch {torch.__version__} device {args.device} "
          f"init {args.init or 'own'} start {start}: loss {loss:.6e} in {t_warm:.2f} s; "
          f"mesh {len(mesh.vertices)} vertices, occupied share {mesh.frac_occupied:.5f}",
          flush=True)


def loader(args):
    from moda_tpu_torch.data.dataset import PairLoader, build_line_datasets
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    with tempfile.TemporaryDirectory() as root:
        cfg_dir = os.path.join(root, "cfg")
        write_line_dataset(os.path.join(root, "db"), cfg_dir, "probe",
                           SynthScene(img_size=IMG, num_frames=FRAMES))
        t0 = time.perf_counter()
        ds = build_line_datasets("probe", IMG, cfg_dir)
        lo = PairLoader(ds, BATCH, num_threads=1, num_prefetch=1, npix=NPIX)
        t_pre = time.perf_counter() - t0
        lo.close()
        t0 = time.perf_counter()
        batches = [lo._sample_batch() for _ in range(20)]
        t_batch = (time.perf_counter() - t0) / 20
    nbytes = sum(v.nbytes for v in batches[0].values())
    line = (f"[loader probe] torch {torch.__version__}: preload {t_pre:.3f} s; one batch of "
            f"{BATCH} pairs on one thread {t_batch * 1e3:.3f} ms, {nbytes / 1e6:.3f} MB")
    if args.device == "cuda":
        with tempfile.TemporaryDirectory() as log_dir:
            tr = make_trainer("cuda", log_dir)
        for b in batches[:3]:
            tr._upload_batch(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            tr._upload_batch(b)
        torch.cuda.synchronize()
        line += f"; upload {(time.perf_counter() - t0) / len(batches) * 1e3:.3f} ms"
    print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("warmup", "loader"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--init", default="",
                    help="warmup: checkpoint of initial parameters (--save-init)")
    ap.add_argument("--save-init", default="",
                    help="warmup: write the initial parameters as this checkpoint")
    args = ap.parse_args(argv)
    (warmup if args.probe == "warmup" else loader)(args)


if __name__ == "__main__":
    main()
