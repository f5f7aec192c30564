"""Host-side native components, built with g++ on first use into
``moda_tpu_torch/_build/`` and loaded through ctypes: the marching
tetrahedra isosurface of the rest-mesh extraction (the reference's
PyMCubes, train_utils.py:19,1441). Counterpart of the marching half of
moda_tpu/native/__init__.py."""
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


def _load_marching():
    with _LOCK:
        if "marching" not in _LIBS:
            lib = ctypes.CDLL(str(_compile("marching")))
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
            _LIBS["marching"] = lib
        return _LIBS["marching"]


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """Isosurface of grid [nx,ny,nz] (float32) at level iso.

    Returns (verts [V,3] in voxel coords (x,y,z), tris [T,3] int32).
    Triangles wind around the >iso region.
    """
    lib = _load_marching()
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
