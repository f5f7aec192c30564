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

Without a ``flow_fn`` the flow is OpenCV's DIS (PRESET_MEDIUM), as in the
JAX package: ``dis_flow`` runs preproc/dis_flow.py, its patch search in the
CUDA kernel dis_patch_search, on the card unless ``device`` says otherwise.

Video input (``extract_frames``, cv2.VideoCapture in the JAX package) reads
AVI, MOV and MP4 clips through preproc/video.py: Motion JPEG (the clip's
own JPEG samples are stored), MPEG-4 Part 2 and H.264 I/P streams with
CAVLC or CABAC (the Baseline profile's tools, and the Main profile's
without B slices or weighted prediction; decoded on the card by
preproc/m4v.py and preproc/h264.py, stored as PNG); other codecs and tools
raise.
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


def extract_frames(video_path: str, out_dir: str, fps: int = 10, device=None) -> List[str]:
    """Video -> frames at a fixed rate (preprocess.sh:42 ffmpeg), as the JAX
    package's: every max(round(src_fps / fps), 1)-th decoded frame, src_fps
    the clip's rate as cv2 reports it or 30.0, stored as %05d.jpg; returns
    the paths. Motion JPEG, MPEG-4 Part 2 and H.264 (preproc/video.py;
    ValueError naming any other codec, or a tool preproc/h264.py refuses).
    A kept Motion-JPEG sample is stored as its own JPEG bytes (Annex K.3's
    tables added where it has none); in a clip with a display rotation, and
    for MPEG-4 Part 2 and H.264 (decoded by preproc/m4v.py and
    preproc/h264.py on ``device``, the card unless the caller asks for the
    CPU, every sample in order: P pictures need their predecessors; a VOP
    with vop_coded 0 is no frame, as cv2 reads none), as an 8-bit RGB PNG of
    the turned frame under the .jpg name (preproc/ama.py::store_frame's
    rule: the port has no JPEG encoder). Every kept Motion-JPEG sample's
    header, every MPEG-4 sample whole and every H.264 sample's headers are
    parsed before anything is written."""
    from moda_tpu_torch.preproc.video import open_video, require_supported

    clip = open_video(video_path)
    require_supported(clip)
    step = max(int(round((clip.fps or 30.0) / fps)), 1)
    if clip.kind == "mpeg4":
        return _extract_mpeg4(clip, out_dir, step, device)
    if clip.kind == "h264":
        return _extract_h264(clip, out_dir, step, device)
    kept = range(0, len(clip), step)
    for i in kept:
        clip.jpeg(i)  # raises with the sample's index
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for out_i, i in enumerate(kept):
        p = os.path.join(out_dir, "%05d.jpg" % out_i)
        if clip.rotation:
            save_png(p, clip.frame(i))
        else:
            with open(p, "wb") as f:
                f.write(clip.jpeg(i))
        paths.append(p)
    return paths


def _extract_mpeg4(clip, out_dir: str, step: int, device) -> List[str]:
    """extract_frames for an MPEG-4 Part 2 track: every sample parsed whole
    (a refusal raises here; the syntax arrays, a few MB a 1080p VOP, are not
    kept), then parsed again and reconstructed in order, and every step-th
    picture converted and stored."""
    from moda_tpu_torch.preproc.m4v import VOP_I, VOP_NOT_CODED, Mpeg4Decoder
    from moda_tpu_torch.preproc.video import ROT90_K

    dec = Mpeg4Decoder(clip, device)
    codings = [clip.vop(dec.parser, i).coding for i in range(len(clip))]
    coded = [i for i, c in enumerate(codings) if c != VOP_NOT_CODED]
    if coded and codings[coded[0]] != VOP_I:
        raise ValueError(f"{clip.path}: sample {coded[0]}: a P-VOP without a preceding I-VOP")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for n, i in enumerate(coded):
        dec.advance(clip.vop(dec.parser, i))
        if n % step == 0:
            p = os.path.join(out_dir, "%05d.jpg" % len(paths))
            rgb = dec.picture().cpu().numpy()[..., ::-1]
            save_png(p, np.ascontiguousarray(np.rot90(rgb, ROT90_K[clip.rotation])))
            paths.append(p)
    return paths


def _extract_h264(clip, out_dir: str, step: int, device) -> List[str]:
    """extract_frames for an H.264 track: every sample's parameter sets and
    slice headers read first by a parser of their own (every refusal raises
    there), then each sample parsed whole and decoded in order, the pictures
    taken in FFmpeg's output order (what cv2.VideoCapture reads, the rest
    flushed at the end of the track), and every step-th of them converted
    and stored. A sample without a picture is no frame."""
    from moda_tpu_torch.preproc.h264 import H264Decoder, Parser
    from moda_tpu_torch.preproc.video import ROT90_K

    dec = H264Decoder(clip, device)
    try:
        scan = Parser(clip.config)
    except ValueError as e:
        raise ValueError(f"{clip.path}: {e}") from None
    coded = [i for i in range(len(clip)) if clip.h264(scan, i, headers_only=True) is not None]
    os.makedirs(out_dir, exist_ok=True)
    paths, shown = [], [0]

    def show(slot: int) -> None:
        # the picture leaves the reorder buffer now: its slot may take the
        # next picture, so it is converted before that one is decoded
        if shown[0] % step == 0:
            p = os.path.join(out_dir, "%05d.jpg" % len(paths))
            rgb = dec.picture(slot).cpu().numpy()[..., ::-1]
            save_png(p, np.ascontiguousarray(np.rot90(rgb, ROT90_K[clip.rotation])))
            paths.append(p)
        shown[0] += 1

    for i in coded:
        pic = clip.h264(dec.parser, i)
        dec.advance(pic)
        if pic.out >= 0:
            show(pic.out)
    for slot in dec.parser.flush():
        show(slot)
    return paths


def dis_flow(img0: np.ndarray, img1: np.ndarray, device=None) -> np.ndarray:
    """Dense flow img0 -> img1 of two BGR uint8 frames by OpenCV's DIS
    (PRESET_MEDIUM): float32 [H, W, 2], as cv2's calc gives it (VCN+
    stand-in). Runs on the CUDA card unless ``device`` says otherwise."""
    from moda_tpu_torch.preproc import dis_flow as D

    return D.dis_flow(img0, img1, device=device)


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
                  dframes=DFRAMES, device=None) -> None:
    """Write FlowFW_<d>/FlowBW_<d> flo-/occ- PFM pairs for a sequence: the
    pairs (i, i + d) with d | i, each through ``flow_fn`` both ways (DIS on
    ``device``, the card by default, without one)."""
    if flow_fn is None:
        from moda_tpu_torch.runtime import resolve_device

        dev = resolve_device(device)
        flow_fn = lambda a, b: dis_flow(a, b, device=dev)
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
