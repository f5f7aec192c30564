"""AMA dataset conversion: multi-camera AMA captures -> DAVIS layout.
Counterpart of moda_tpu/preproc/ama.py, with no image library.

Role of scripts/ama-process/{ama2davis.py,read_cam.py}: copy per-camera
images + silhouettes into JPEGImages/Annotations and parse the
Camera%d.Pmat.cal projection matrices used as eval ground truth
(run_eval.sh:5-9). The JAX package re-encodes each image as JPEG; the port
has no JPEG encoder, so a JPEG source is copied byte for byte and any other
image is stored as an 8-bit RGB PNG under the .jpg name (the frame reader,
like cv2.imread, tells formats apart by their first bytes). Either way the
stored file decodes to the source's pixels.
"""
from __future__ import annotations

import glob
import os
import shutil

import numpy as np

from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.viz.render_vis import save_png


def read_pmat(path: str) -> np.ndarray:
    """Parse a Camera*.Pmat.cal 3x4 projection matrix."""
    vals = np.loadtxt(path)
    return vals.reshape(3, 4)


def pmat_to_rtk(pmat: np.ndarray) -> np.ndarray:
    """Decompose P = K [R|t] into the rtk 4x4 layout (RQ decomposition)."""
    import scipy.linalg

    M = pmat[:, :3]
    K, R = scipy.linalg.rq(M)
    # positive diagonal
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R
        K = -K
    t = np.linalg.solve(K, pmat[:, 3])
    K = K / K[2, 2]
    rtk = np.zeros((4, 4))
    rtk[:3, :3] = R
    rtk[:3, 3] = t
    rtk[3] = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    return rtk


def store_frame(src: str, dst: str) -> np.ndarray:
    """Store the image ``src`` at ``dst`` (a DAVIS .jpg name): its bytes
    where it is a JPEG, else an 8-bit RGB PNG of its pixels. Returns the
    decoded RGB pixels; ValueError where ``src`` is not an image."""
    img = IO.imread(src)
    if img is None:
        raise ValueError(f"{src}: missing, empty or not an image")
    with open(src, "rb") as f:
        is_jpeg = f.read(3) == b"\xff\xd8\xff"
    if is_jpeg:
        shutil.copyfile(src, dst)
    else:
        save_png(dst, img)
    return img


def ama_to_davis(ama_seq_dir: str, database_root: str, seqname: str,
                 camera: int = 0) -> int:
    """Copy images/<cam> + silhouettes/<cam> into the DAVIS layout.

    AMA layout: <seq>/images/Image%d-%04d.png, <seq>/silhouettes/
    silhouette%d-%04d.pbm (ama2davis.py)."""
    img_dir = os.path.join(database_root, "JPEGImages", "Full-Resolution", seqname)
    ann_dir = os.path.join(database_root, "Annotations", "Full-Resolution", seqname)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    imgs = sorted(glob.glob(os.path.join(ama_seq_dir, "images", f"Image{camera}-*.png")))
    n = 0
    for i, p in enumerate(imgs):
        img = store_frame(p, os.path.join(img_dir, "%05d.jpg" % i))
        sil_p = os.path.join(ama_seq_dir, "silhouettes",
                             f"silhouette{camera}-" + p.split("-")[-1].replace(".png", ".pbm"))
        sil = IO.imread(sil_p, gray=True)
        if sil is None:
            sil = np.zeros(img.shape[:2], np.uint8)
        save_png(os.path.join(ann_dir, "%05d.png" % i), (sil > 0).astype(np.uint8) * 128)
        n += 1
    return n
