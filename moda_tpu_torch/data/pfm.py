"""PFM image read/write (host-side IO); the port's copy of moda_tpu/data/pfm.py.

Re-implementation of the Portable-Float-Map codec the reference vendors in
third_party/ext_utils/util_flow.py (readPFM/save_pfm). The on-disk format
is the contract: preprocessing artifacts (flow ``flo-*.pfm``, occlusion
``occ-*.pfm``, CSE features ``feat-*.pfm``, vertex maps ``*.pfm``) must
interoperate byte-for-byte with the reference's database layout.
"""
from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")

        dims = f.readline()
        while dims.startswith(b"#"):  # skip comments
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.frombuffer(f.read(), endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        # PFM stores rows bottom-to-top
        return np.flipud(data).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("PFM supports HxW or HxWx3 float images")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)
