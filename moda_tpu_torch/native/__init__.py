"""Host-side native components, built with g++ on first use into
``moda_tpu_torch/_build/`` and loaded through ctypes: the marching
tetrahedra isosurface of the rest-mesh extraction (the reference's
PyMCubes, train_utils.py:19,1441), the z-buffer rasterizer of the
silhouette export and the pose-CNN warmup, and the image codec of the
frame reader (``imgcodec.cpp``: JPEG decoding, PNG unfiltering, cv2's
resize and remap; ``data/imageio.py`` wraps it) and the bitstream parser of
the MPEG-4 Part 2 decoder (``m4v.cpp``; ``preproc/m4v.py`` wraps it) and
of the H.264 decoder (``h264.cpp``; ``preproc/h264.py`` wraps it).
Counterpart of moda_tpu/native/__init__.py."""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build"
_LOCK = threading.Lock()
_LIBS = {}
# the JAX package's flags, so both packages give bit-equal meshes on one host
_FLAGS = ["-O3", "-shared", "-fPIC", "-march=native"]


def _host_isa() -> bytes:
    """The host CPU's feature flags: -march=native builds for them, so a
    library built on another host is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return platform.machine().encode()


def _compile(name: str) -> Path:
    src = _HERE / f"{name}.cpp"
    tag = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode() +
                         _host_isa()).hexdigest()[:16]
    so = _BUILD / f"lib{name}_{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # another process may build the same library at the same time
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.check_call(["g++", *_FLAGS, "-o", str(tmp), str(src)])
        os.replace(tmp, so)
    return so


def _declare(name: str, lib):
    if name == "marching":
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_free.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32)]
    elif name == "imgcodec":
        u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_size.restype = ctypes.c_int
        lib.jpeg_size.argtypes = [u8p, ctypes.c_int64, ip, ip, ip, ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p]
        lib.resize_f32.restype = None
        lib.resize_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.resize_u8.restype = None
        lib.resize_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
                                  ctypes.c_int, ctypes.c_int]
        lib.remap_f32.restype = None
        lib.remap_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  f32p, f32p, ctypes.c_int64, f32p, ctypes.c_int, ctypes.c_int]
    elif name == "m4v":
        vp, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
        lib.m4v_open.restype = vp
        lib.m4v_open.argtypes = [ctypes.c_char_p]
        lib.m4v_close.restype = None
        lib.m4v_close.argtypes = [vp]
        lib.m4v_config.restype = ctypes.c_int
        lib.m4v_config.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.m4v_info.restype = ctypes.c_int
        lib.m4v_info.argtypes = [vp, i32p]
        lib.m4v_parse.restype = ctypes.c_int64
        lib.m4v_parse.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
                                  ctypes.c_int64, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_int]
    elif name == "h264":
        vp, i32p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
        lib.h264_open.restype = vp
        lib.h264_open.argtypes = []
        lib.h264_close.restype = None
        lib.h264_close.argtypes = [vp]
        lib.h264_config.restype = ctypes.c_int
        lib.h264_config.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_int]
        lib.h264_info.restype = ctypes.c_int
        lib.h264_info.argtypes = [vp, i32p]
        lib.h264_peek.restype = ctypes.c_int
        lib.h264_peek.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.h264_parse.restype = ctypes.c_int64
        lib.h264_parse.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, i32p, i32p,
                                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_int]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.h264_cabac_tables.restype = None
        lib.h264_cabac_tables.argtypes = [ctypes.POINTER(ctypes.c_int8), u8p, u8p]
        lib.h264_scales.restype = None
        lib.h264_scales.argtypes = [vp, i32p]
        lib.h264_weights.restype = ctypes.c_int
        lib.h264_weights.argtypes = [vp, i32p]
        lib.h264_set_delay.restype = None
        lib.h264_set_delay.argtypes = [vp, ctypes.c_int]
        lib.h264_flush.restype = ctypes.c_int
        lib.h264_flush.argtypes = [vp, i32p, ctypes.c_int]
        lib.h264_high_tables.restype = None
        lib.h264_high_tables.argtypes = [u8p] * 6
    else:
        lib.rasterize.restype = None
        lib.rasterize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]


def _load(name: str):
    """The library built from ``<name>.cpp`` ("marching", "raster",
    "imgcodec", "m4v" or "h264")."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_compile(name)))
            _declare(name, lib)
            _LIBS[name] = lib
        return _LIBS[name]


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """Isosurface of grid [nx,ny,nz] (float32) at level iso.

    Returns (verts [V,3] in voxel coords (x,y,z), tris [T,3] int32).
    Triangles wind around the >iso region.
    """
    lib = _load("marching")
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.marching_tets(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        ctypes.c_float(iso), ctypes.byref(vp), ctypes.byref(tp),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("marching_tets allocation failed")
    try:
        verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy() if nt.value
                else np.zeros((0, 3), np.int32))
    finally:
        lib.mt_free(vp, tp)
    return verts, tris


def rasterize(verts: np.ndarray, faces: np.ndarray, attrs: np.ndarray,
              height: int, width: int):
    """Hard z-buffer rasterization with perspective-correct vertex-attribute
    interpolation. verts [V,3] = (x_px, y_px, depth); faces [F,3] int;
    attrs [V,C]. Faces with an index outside the vertices are skipped.
    Returns (attr [H,W,C], depth [H,W] (inf where empty), mask [H,W]), float32."""
    lib = _load("raster")
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    attrs = np.ascontiguousarray(attrs, np.float32)
    # the shapes the native loop reads past otherwise
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3 \
            or attrs.ndim != 2 or len(attrs) != len(verts):
        raise ValueError(f"rasterize: verts {verts.shape}, faces {faces.shape}, "
                         f"attrs {attrs.shape}")
    C = attrs.shape[1]
    out_attr = np.zeros((height, width, C), np.float32)
    out_depth = np.zeros((height, width), np.float32)
    out_mask = np.zeros((height, width), np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.rasterize(
        verts.ctypes.data_as(fptr), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        attrs.ctypes.data_as(fptr), C, height, width,
        out_attr.ctypes.data_as(fptr), out_depth.ctypes.data_as(fptr),
        out_mask.ctypes.data_as(fptr))
    return out_attr, out_depth, out_mask
