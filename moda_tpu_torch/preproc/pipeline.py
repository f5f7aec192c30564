"""Offline preprocessing: frames -> the DAVIS-layout database. Counterpart of
moda_tpu/preproc/pipeline.py, with no image library.

Writes the on-disk contract the datasets read (vidbase.py:68-174):

  database/DAVIS/JPEGImages/Full-Resolution/<seq>/%05d.jpg
  database/DAVIS/Annotations/Full-Resolution/<seq>/%05d.png
  database/DAVIS/FlowFW_<d>/Full-Resolution/<seq>/flo-%05d.pfm (+occ-)
  database/DAVIS/Densepose/Full-Resolution/<seq>/{%05d.pfm,feat-,bbox-}
  database/DAVIS/Pixels/Full-Resolution/<seq>/1_%05d/%04d.npy (line shards)
  configs/<seq>.config

Model-backed stages take callbacks, as in the JAX package: a segmentation
``mask_fn`` (frame -> mask), a CSE ``cse_fn`` (zero features without one)
and a flow ``flow_fn`` (``VCNFlowPredictor.as_flow_fn()``). The callbacks
see frames in BGR order, as cv2.imread gives them to the JAX package's;
the port's ``imread`` decodes RGB, so the frames are flipped first.

What needs cv2 and has no counterpart here raises, naming what to pass
instead: video input (``extract_frames``: pass a directory of frames) and
OpenCV's DIS flow (``dis_flow``, the JAX package's flow without VCN
weights: pass a ``vcn*.npz``).
"""
from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional

import numpy as np

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.pfm import write_pfm
from moda_tpu_torch.viz.render_vis import save_png

DFRAMES = (1, 2, 4, 8, 16, 32)


def extract_frames(video_path: str, out_dir: str, fps: int = 10) -> List[str]:
    raise NotImplementedError(
        f"video input ({video_path}) needs a video decoder, which the port does not have "
        "(the JAX package uses cv2.VideoCapture); pass a directory of frames "
        "(*.jpg or *.png) as --input")


def dis_flow(img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
    raise NotImplementedError(
        "optical flow without VCN+ weights is OpenCV's DIS in the JAX package, which the "
        "port does not have; put a converted vcn*.npz (tools/convert_all_checkpoints.py) "
        "under --weights_dir")


def read_bgr(path: str) -> np.ndarray:
    """uint8 [H, W, 3] in BGR order (cv2.imread's), or ValueError where the
    file is missing or not an image."""
    img = IO.imread(path)
    if img is None:
        raise ValueError(f"{path}: missing, empty or not an image")
    return np.ascontiguousarray(img[..., ::-1])


def fb_confidence(flow_fw: np.ndarray, flow_bw: np.ndarray) -> np.ndarray:
    """Forward-backward consistency -> [0,1] confidence (the occ-*.pfm
    convention consumed by vidbase.flow_process). The backward flow is
    sampled as cv2.remap samples 2-channel float images."""
    h, w = flow_fw.shape[:2]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    mx = xs + flow_fw[..., 0]
    my = ys + flow_fw[..., 1]
    bw_at = IO.remap(flow_bw, mx, my, IO.INTER_LINEAR)
    err = np.linalg.norm(flow_fw + bw_at, axis=-1)
    conf = np.exp(-0.1 * err)
    return conf.astype(np.float32)


def compute_flows(seq_dir: str, database_root: str, seqname: str,
                  flow_fn: Optional[Callable] = None,
                  dframes=DFRAMES) -> None:
    """Write FlowFW_<d>/FlowBW_<d> flo-/occ- PFM pairs for a sequence: the
    pairs (i, i + d) with d | i, each through ``flow_fn`` both ways."""
    if flow_fn is None:
        dis_flow(None, None)  # raises: the JAX package's default
    imgs = sorted(glob.glob(os.path.join(seq_dir, "*.jpg")))
    frames = [read_bgr(p) for p in imgs]
    n = len(frames)
    for d in dframes:
        fw_dir = os.path.join(database_root, f"FlowFW_{d}", "Full-Resolution", seqname)
        bw_dir = os.path.join(database_root, f"FlowBW_{d}", "Full-Resolution", seqname)
        os.makedirs(fw_dir, exist_ok=True)
        os.makedirs(bw_dir, exist_ok=True)
        for i in range(0, n - d):
            if i % d != 0:
                continue
            fw = flow_fn(frames[i], frames[i + d])
            bw = flow_fn(frames[i + d], frames[i])
            occ_fw = fb_confidence(fw, bw)
            occ_bw = fb_confidence(bw, fw)
            f3 = np.concatenate([fw, np.zeros_like(fw[..., :1])], -1)
            b3 = np.concatenate([bw, np.zeros_like(bw[..., :1])], -1)
            write_pfm(os.path.join(fw_dir, "flo-%05d.pfm" % i), f3)
            write_pfm(os.path.join(fw_dir, "occ-%05d.pfm" % i), occ_fw)
            write_pfm(os.path.join(bw_dir, "flo-%05d.pfm" % (i + d)), b3)
            write_pfm(os.path.join(bw_dir, "occ-%05d.pfm" % (i + d)), occ_bw)


def write_masks(seq_dir: str, database_root: str, seqname: str,
                mask_fn: Callable[[np.ndarray], np.ndarray]) -> None:
    """Run a segmentation callable over the (BGR) frames -> Annotations PNGs
    (preprocess/mask.py role), the largest component at 128."""
    out_dir = os.path.join(database_root, "Annotations", "Full-Resolution", seqname)
    os.makedirs(out_dir, exist_ok=True)
    for p in sorted(glob.glob(os.path.join(seq_dir, "*.jpg"))):
        mask = mask_fn(read_bgr(p))
        mask = largest_cc((mask > 0).astype(np.uint8))
        name = os.path.basename(p).rsplit(".", 1)[0] + ".png"
        save_png(os.path.join(out_dir, name), mask.astype(np.uint8) * 128)


def largest_cc(mask: np.ndarray) -> np.ndarray:
    """Keep the largest connected component (mask.py:50-126 behavior):
    8-connected components numbered in raster order of their first pixel,
    as cv2.connectedComponents numbers them; of equal sizes the first
    wins. A mask without foreground comes back as it was."""
    from scipy import ndimage

    labels, n = ndimage.label(mask.astype(np.uint8), structure=np.ones((3, 3), np.int32))
    if n == 0:
        return mask
    counts = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    return (labels == int(np.argmax(counts)) + 1).astype(np.uint8)


def write_dp_features(seq_dir: str, database_root: str, seqname: str,
                      cse_fn: Optional[Callable] = None) -> None:
    """Write Densepose artifacts: per-frame vertex map (%05d.pfm, stored
    /50 as in compute_dp.py:97), 16x112x112 feature pfm, bbox txt.
    Without a CSE backend, zero features are emitted (training then runs
    with --nouse_embed). ``cse_fn(img_bgr, mask) -> (feat [16,112,112],
    vert_map [H,W], bbox [4])``; the mask comes from the write_masks stage
    (zeros if absent)."""
    out_dir = os.path.join(database_root, "Densepose", "Full-Resolution", seqname)
    mask_dir = os.path.join(database_root, "Annotations", "Full-Resolution", seqname)
    os.makedirs(out_dir, exist_ok=True)
    for idx, p in enumerate(sorted(glob.glob(os.path.join(seq_dir, "*.jpg")))):
        img = read_bgr(p)
        h, w = img.shape[:2]
        mask_p = os.path.join(mask_dir, "%05d.png" % idx)
        if os.path.exists(mask_p):
            mask = IO.imread(mask_p, gray=True)
            if mask is None:
                raise ValueError(f"{mask_p}: not an image")
            mask = (mask > 0).astype(np.uint8)
        else:
            mask = np.zeros((h, w), np.uint8)
        if cse_fn is not None:
            feat, vert_map, bbox = cse_fn(img, mask)
        else:
            feat = np.zeros((16, 112, 112), np.float32)
            vert_map = np.zeros((h, w), np.float32)
            bbox = np.asarray([0, 0, w, h], np.float32)
        write_pfm(os.path.join(out_dir, "%05d.pfm" % idx), vert_map / 50.0)
        write_pfm(os.path.join(out_dir, "feat-%05d.pfm" % idx),
                  feat.reshape(16 * 112, 112))
        np.savetxt(os.path.join(out_dir, "bbox-%05d.txt" % idx), bbox)


def write_config(config_dir: str, seqname: str, datapath: str,
                 img_hw: tuple, dframe: str = "1") -> str:
    """Emit configs/<seq>.config (preprocess/write_config.py format)."""
    os.makedirs(config_dir, exist_ok=True)
    h, w = img_hw
    fl = max(h, w)
    path = os.path.join(config_dir, f"{seqname}.config")
    with open(path, "w") as f:
        f.write("[data]\n")
        f.write(f"dframe = {dframe}\ninit_frame = 0\nend_frame = -1\ncan_frame = -1\n\n")
        f.write("[data_0]\n")
        f.write(f"ks = {fl} {fl} {w/2} {h/2}\n")
        f.write(f"datapath = {datapath}\n")
    return path


def write_lines(database_root: str, seqname: str, img_size: int, datasets) -> None:
    """Line shards (preprocess/img2lines.py:33-107) cut from frame datasets
    (data/dataset.py::VideoDataset): ``Pixels/Full-Resolution/<seq>/1_%05d/
    %04d.npy`` per row of the pair (i, i+1) read through the frame reader
    at dframe 1, reference key names, pair-stacked [1, 2, C, W], plus
    ``rtk.npy`` {'rtk', 'kaug'}. The JAX package's write_lines stores
    ``sample_pair(rng(i), idx=i)`` there, a pair of random direction and
    dframe under the dframe-1 name; this one stores the pair its name says."""
    out_base = os.path.join(database_root, "Pixels", "Full-Resolution", seqname)
    for ds in datasets:
        reader = ds.reader
        for i in range(ds.num_frames - 1):
            d0 = reader.read_raw(i, flowfw=True, dframe=1)
            d1 = reader.read_raw(i + 1, flowfw=False, dframe=1)
            flow, flown, occ, occn = reader.flow_process(d0, d1)
            rows = {}
            for k, (a, b) in {"img": (d0["img"], d1["img"]), "flow": (flow, flown),
                              "mask": ((d0["mask"] * d0["vis2d"] > 0),
                                       (d1["mask"] * d1["vis2d"] > 0)),
                              "vis2d": (d0["vis2d"], d1["vis2d"]), "occ": (occ, occn),
                              "dp_feat_rsmp": (d0["dp_feat_rsmp"].transpose(1, 2, 0),
                                               d1["dp_feat_rsmp"].transpose(1, 2, 0)),
                              "dp": (d0["dp"], d1["dp"])}.items():
                # [S, S(, C)] -> [S rows, 2, C, S]
                pair = np.stack([np.asarray(a, np.float32), np.asarray(b, np.float32)], 1)
                rows[k] = pair.reshape(img_size, 2, img_size, -1).transpose(0, 1, 3, 2)
            dirname = os.path.join(out_base, f"1_{i:05d}")
            os.makedirs(dirname, exist_ok=True)
            np.save(os.path.join(dirname, "rtk.npy"),
                    {"rtk": np.stack([d0["rtk"], d1["rtk"]]).astype(np.float32)[None],
                     "kaug": np.stack([d0["kaug"], d1["kaug"]])[None]})
            for row in range(img_size):
                np.save(os.path.join(dirname, "%04d.npy" % row),
                        {k: v[row][None] for k, v in rows.items()})


def compute_flow_cse(cse_a: np.ndarray, cse_b: np.ndarray) -> np.ndarray:
    """Dense flow a->b by CSE feature matching (geom_utils.py:1230-1247).

    cse_{a,b}: [16, h, w] unit feature images. Returns flo [2, h, w] in
    [-2, 2] normalized units (matching the reference's dp-flow convention)."""
    C, h, w = cse_a.shape
    fa = cse_a.reshape(C, -1)
    fb = cse_b.reshape(C, -1)
    cost = fa.T @ fb  # [hw, hw]
    match = cost.argmax(1)
    tx, ty = match % w, match // w
    xs, ys = np.meshgrid(range(w), range(h))
    flo = np.stack([tx.reshape(h, w) - xs, ty.reshape(h, w) - ys], 0)
    return flo.astype(np.float32) / w * 2.0
