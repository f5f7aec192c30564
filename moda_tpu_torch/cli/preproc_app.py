"""One-command offline preprocessing: a video or a directory of frames ->
training-ready database. Counterpart of moda_tpu/cli/preproc_app.py (the
role of preprocess/preprocess.sh in the reference), with no image library.

Chains the pipeline stages over one sequence:
  frames -> masks -> densepose features -> optical flow -> config -> lines

  python -m moda_tpu_torch.cli.preproc_app --seqname myvid \\
      --input clip.mov|frames/ --mask_dir masks/ --weights_dir weights_converted/ \\
      [--database database/DAVIS] [--config_dir configs] [--img_size 512] \\
      [--no-lines]

The flags and stages are the JAX package's. The converted weights under
--weights_dir (the layout of tools/convert_all_checkpoints.py, or of the
port's own ``python -m moda_tpu_torch.cli.convert_app``) run on the CUDA
card; ``main(argv, device="cpu")`` runs them on the CPU:
- masks: PointRend from a ``pointrend*.npz`` (the person class with
  --use_human, else the animal classes 14-23), else --mask_dir, else the
  existing Annotations;
- DensePose: CSE features from a ``cse*.npz``, else zero features (train
  with --nouse_embed);
- flow: VCN+ from a ``vcn*.npz``, else OpenCV's DIS (preproc/dis_flow.py,
  its patch search in the CUDA kernel dis_patch_search) on the same device.
Frames: .jpg inputs are copied byte for byte; other images are stored as
8-bit RGB PNGs under the DAVIS .jpg names (the JAX package re-encodes them
as JPEG; the frame reader, like cv2.imread, goes by the first bytes).
A video --input (preproc/video.py: AVI, MOV or MP4) keeps every
round(rate / --fps)-th frame, as the JAX package's cv2.VideoCapture route
does: Motion JPEG stores each kept frame's own JPEG sample (a clip with a
display rotation: the turned frame as PNG); MPEG-4 Part 2 (mp4v, XVID,
DIVX, FMP4, DX50, ...; preproc/m4v.py) is decoded on the same device and
stored as PNG.
What the JAX package does and the port does not, raising with the reason
instead of falling back: video in any other codec (H.264/avc1, HEVC,
MS-MPEG-4 DIV3/MP42/MP43, MPEG-2, Motion-JPEG format B mjpb, ...), the
MPEG-4 Part 2 tools FFmpeg's encoder does not use at its defaults (B-VOPs,
four vectors a macroblock, interlace, GMC, quarter-pel, MPEG quantisation,
resync markers, data partitioning) and XviD or DivX streams, interlaced
Motion JPEG, fragmented MP4 and edit lists other than the identity.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import time

import numpy as np

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.viz.render_vis import save_png


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seqname", required=True)
    ap.add_argument("--input", required=True,
                    help="video file or directory of frames")
    ap.add_argument("--database", default="database/DAVIS")
    ap.add_argument("--config_dir", default="configs")
    ap.add_argument("--weights_dir", default="",
                    help="dir of converted npz checkpoints "
                         "(python -m moda_tpu_torch.cli.convert_app)")
    ap.add_argument("--img_size", type=int, default=512,
                    help="line-shard crop size (img2lines img_size)")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--mask_dir", default="",
                    help="directory of existing %%05d.png masks (used when "
                         "no PointRend weights are available)")
    ap.add_argument("--use_human", action="store_true",
                    help="segment the person class instead of animals "
                         "(mask.py:50-126 class split)")
    ap.add_argument("--lines", action=argparse.BooleanOptionalAction,
                    default=True, help="write Pixels/ line shards")
    return ap


def _weights(args, pattern: str) -> list:
    return sorted(glob.glob(os.path.join(args.weights_dir, pattern))) if args.weights_dir else []


def stage_frames(args, device=None) -> str:
    from moda_tpu_torch.preproc.ama import store_frame
    from moda_tpu_torch.preproc.pipeline import extract_frames

    seq_dir = os.path.join(args.database, "JPEGImages", "Full-Resolution", args.seqname)
    if not os.path.isdir(args.input):
        paths = extract_frames(args.input, seq_dir, fps=args.fps, device=device)
        print(f"[frames] extracted {len(paths)} frames @ {args.fps}fps -> {seq_dir}")
        return seq_dir
    os.makedirs(seq_dir, exist_ok=True)
    srcs = sorted(glob.glob(os.path.join(args.input, "*.jpg"))
                  + glob.glob(os.path.join(args.input, "*.png")))
    if not srcs:
        sys.exit(f"no frames (*.jpg|*.png) in {args.input}")
    for i, p in enumerate(srcs):
        dst = os.path.join(seq_dir, "%05d.jpg" % i)
        if p.endswith(".jpg"):
            shutil.copyfile(p, dst)
        else:
            store_frame(p, dst)
    print(f"[frames] copied {len(srcs)} frames -> {seq_dir}")
    return seq_dir


def stage_masks(args, seq_dir: str, device=None) -> None:
    from moda_tpu_torch.preproc import checkpoints
    from moda_tpu_torch.preproc.pipeline import write_masks

    w = _weights(args, "pointrend*.npz")
    if w:
        # person class 0 vs animal classes 14-23 (preprocess/mask.py:50-126)
        keep = (0,) if args.use_human else tuple(range(14, 24))
        pred = checkpoints.load_pointrend_predictor(w[0], device=device, keep_classes=keep)
        write_masks(seq_dir, args.database, args.seqname, pred.as_mask_fn())
        print(f"[masks] PointRend ({os.path.basename(w[0])}) on {pred.device}")
        return
    out_dir = os.path.join(args.database, "Annotations", "Full-Resolution", args.seqname)
    if args.mask_dir:
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for i, p in enumerate(sorted(glob.glob(os.path.join(args.mask_dir, "*.png")))):
            m = IO.imread(p, gray=True)
            if m is None:
                raise ValueError(f"{p}: not an image")
            save_png(os.path.join(out_dir, "%05d.png" % i), (m > 0).astype(np.uint8) * 128)
            n += 1
        print(f"[masks] copied {n} user masks from {args.mask_dir}")
        return
    if os.path.isdir(out_dir) and glob.glob(os.path.join(out_dir, "*.png")):
        print(f"[masks] keeping existing masks in {out_dir}")
        return
    sys.exit("[masks] no PointRend weights, no --mask_dir, and no existing "
             f"Annotations for {args.seqname}: segmentation is required "
             "(reference preprocess/mask.py)")


def stage_densepose(args, seq_dir: str, device=None) -> bool:
    """CSE features from a cse*.npz, else zero features; returns whether CSE
    ran."""
    from moda_tpu_torch.preproc import checkpoints
    from moda_tpu_torch.preproc.pipeline import write_dp_features

    w = _weights(args, "cse*.npz")
    cse_fn = None
    if w:
        cse_fn = checkpoints.load_cse_predictor(w[0], device=device)
        print(f"[densepose] CSE ({os.path.basename(w[0])}) on {cse_fn.device}")
    else:
        print("[densepose] no CSE weights: writing zero features "
              "(train with --nouse_embed, or distill via train/cse_distill.py)")
    write_dp_features(seq_dir, args.database, args.seqname, cse_fn=cse_fn)
    return cse_fn is not None


def stage_flow(args, seq_dir: str, device=None) -> int:
    """Flow for every pair of pipeline.compute_flows, by VCN+ from a
    vcn*.npz or else by DIS; returns the number of flow calls (two a
    pair)."""
    from moda_tpu_torch.preproc import checkpoints
    from moda_tpu_torch.preproc.pipeline import compute_flows, dis_flow

    w = _weights(args, "vcn*.npz")
    if w:
        pred = checkpoints.load_vcn_predictor(w[0], device=device)
        print(f"[flow] VCN+ ({os.path.basename(w[0])}) on {pred.device}")
        compute_flows(seq_dir, args.database, args.seqname, flow_fn=pred.as_flow_fn())
        return pred.calls
    print(f"[flow] no VCN weights: OpenCV DIS + fb-confidence on {device}")
    calls = [0]

    def dis(a, b):
        calls[0] += 1
        return dis_flow(a, b, device=device)

    compute_flows(seq_dir, args.database, args.seqname, flow_fn=dis)
    return calls[0]


def main(argv=None, device=None) -> dict:
    """Run every stage; returns each stage's seconds (``times``), the flow
    calls run (``flow_calls``, VCN+ or DIS, two a pair), whether CSE features were written
    (``have_cse``), the config's path and the frame directory."""
    from moda_tpu_torch.runtime import resolve_device

    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    times = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        times[name] = time.perf_counter() - t0
        return out

    seq_dir = timed("frames", stage_frames, args, device=dev)
    timed("masks", stage_masks, args, seq_dir, device=dev)
    have_cse = timed("densepose", stage_densepose, args, seq_dir, device=dev)
    flow_calls = timed("flow", stage_flow, args, seq_dir, device=dev)

    from moda_tpu_torch.preproc.pipeline import write_config

    img0 = IO.imread(sorted(glob.glob(os.path.join(seq_dir, "*.jpg")))[0])
    cfg_path = timed("config", write_config, args.config_dir, args.seqname, seq_dir,
                     img0.shape[:2])
    print(f"[config] {cfg_path}")

    if args.lines:
        from moda_tpu_torch.data.dataset import build_datasets
        from moda_tpu_torch.preproc.pipeline import write_lines

        def lines():
            ds = build_datasets(args.seqname, img_size=args.img_size,
                                config_dir=args.config_dir)
            write_lines(args.database, args.seqname, args.img_size, ds)

        timed("lines", lines)
        print(f"[lines] Pixels shards @ {args.img_size}")

    extra = "" if have_cse else " --nouse_embed"
    print(f"done. train with: python -m moda_tpu_torch.cli.train_app "
          f"--seqname {args.seqname} --lineload{extra} ...")
    return {"times": times, "flow_calls": flow_calls, "have_cse": have_cse, "config": cfg_path,
            "seq_dir": seq_dir}


if __name__ == "__main__":
    main()
