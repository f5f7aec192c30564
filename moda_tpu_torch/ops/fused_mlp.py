"""Fused NeRF-MLP stack: the CUDA kernels K1/K2, their plain version, and
the autograd wrapper.

Counterpart of moda_tpu/ops/fused_mlp.py (Pallas ``_fwd_kernel`` and
``_bwd_kernel``). Several nets that read the same per-point input run in
one launch; the positional embed of raw xyz, the per-ray code broadcast
and every layer stay on chip. Architecture per net (nets.NeRFMLP):

  t   = concat(x_e, code_trunk per-ray)
  h = t; for i < D: h = relu(W_i @ (concat(t, h) if i in skips else h))
  sigma = W_sigma @ h
  hd  = relu(W_dir @ concat(W_final @ h, code_dir per-ray))
  out = concat(W_out @ hd [sigmoid], sigma)   # sigma dropped for raw_feat

Routes:
- ``fused_mlp`` is the wrapper: a CUDA tensor goes through the kernels of
  csrc/fused_mlp.cu (bf16 products, fp32 accumulation) or raises; a CPU
  tensor goes through ``fused_mlp_plain``.
- ``fused_mlp_plain`` is the same function in plain PyTorch, in fp32 or in
  a bf16 mode that rounds every product operand to bf16 and multiplies in
  fp32, like the kernel. A stash changes no value, so it is also the plain
  version of K1s/K2s.

Modes: rematerialization is the default, as in the JAX package. With
MODA_PALLAS_STASH=1 (the variable the JAX package's ``_stash`` reads) a
forward under grad launches K1s, which keeps every layer's bf16 input
activation for the backward, and the backward launches K2s, which reads them
instead of recomputing the forward.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# kernel launches made through the wrappers since the last reset, in all
# (K1, K2, K1s, K2s, and the dW GEMM, which K2 and K2s launch and dw_gemm
# launches alone) and by call site and nets ("bwd:skin_bw:D5W64o25c128",
# "dw:skin_bw:D5W64o25c128")
launches = {"fwd": 0, "bwd": 0, "fwd_stash": 0, "bwd_stash": 0, "dw": 0}
launches_by_call = collections.Counter()
# (shared-memory bytes, resident CTAs per SM) of the block kernel (or the
# dW GEMM) of each key of launches_by_call, taken at its first launch
footprints = {}


def reset_launches():
    for k in launches:
        launches[k] = 0
    launches_by_call.clear()


def _count(kind: str, site: Optional[str], nets: str, lib, desc):
    launches[kind] += 1
    key = f"{kind}:{site}:{nets}" if site else f"{kind}:{nets}"
    launches_by_call[key] += 1
    if key not in footprints:
        bwd = kind.startswith("bwd")
        per_sm = lib.moda_fmlp_bwd_blocks_per_sm if bwd else lib.moda_fmlp_fwd_blocks_per_sm
        ref = ctypes.byref(desc)
        footprints[key] = (lib.moda_fmlp_smem_bytes(ref, int(bwd)), per_sm(ref))


def _count_dw(key: str, lib, dw):
    launches["dw"] += 1
    launches_by_call[key] += 1
    if key not in footprints:
        ref = ctypes.byref(dw)
        footprints[key] = (lib.moda_fmlp_dw_smem_bytes(ref), lib.moda_fmlp_dw_blocks_per_sm(ref))


def stash_enabled() -> bool:
    """MODA_PALLAS_STASH=1 switches both packages to the activation stash
    (moda_tpu/ops/fused_mlp.py::_stash reads the same variable)."""
    return os.environ.get("MODA_PALLAS_STASH") == "1"

BM_F, BM_B = 64, 32  # rows per block of the forward / backward kernels (built in)
MAXNETS, MAXLAYERS = 2, 12


@dataclasses.dataclass(frozen=True)
class Arch:
    """Static per-net configuration (the JAX Arch). A launch takes a tuple
    of Arch; S / emb / need_dx are launch-level and read from the first."""

    D: int
    in_x: int
    ct: int
    cd: int
    skips: Tuple[int, ...]
    S: int
    need_dx: bool = True
    sigmoid: bool = False
    emb: Optional[Tuple[int, int, bool]] = None  # (C, F, logscale): x arrives raw [N, C]
    drop_sigma: bool = False

    @property
    def nw(self):
        return 2 * (self.D + 4)


def _split_ws(ws, archs):
    out, i = [], 0
    for a in archs:
        out.append(list(ws[i:i + a.nw]))
        i += a.nw
    return out


def _out_dim(a: Arch, ws) -> int:
    return ws[-2].shape[1] + (0 if a.drop_sigma else 1)


# ------------------------------------------------------------ plain version
def _round(x: torch.Tensor, cdt) -> torch.Tensor:
    """Round to cdt in the forward, pass the fp32 gradient straight through."""
    if cdt == torch.float32:
        return x
    return x + (x.to(cdt).float() - x).detach()


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient to bf16, as the
    kernel (and the TPU kernel) rounds each pre-activation gradient before
    it enters a product. The bias gradient, added after this node, keeps
    the unrounded fp32 sum."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _mm(a, b, cdt):
    out = _round(a, cdt) @ _round(b, cdt)
    return out if cdt == torch.float32 else _RoundGrad.apply(out)


def _embed(x: torch.Tensor, win: torch.Tensor, emb) -> torch.Tensor:
    C, F, _ = emb
    freqs = 2.0 ** torch.arange(F, dtype=x.dtype, device=x.device)
    xf = (x[:, None, :] * freqs[:, None]).reshape(-1, F, 1, C).expand(-1, F, 2, C)
    xf = xf.reshape(x.shape[0], F * 2 * C)
    col = torch.arange(F * 2 * C, device=x.device)
    trig = torch.where(((col // C) % 2) == 0, torch.sin(xf), torch.cos(xf))
    return torch.cat([x, trig * win.reshape(1, -1)], -1)


def _bcast(code, S):
    return code.repeat_interleave(S, 0)


def fused_mlp_plain(x, ct_code, cd_code, win, weights, archs: Sequence[Arch],
                    compute_dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the fused launch. x [N, C] raw (emb) or
    [N, in_x]; codes [R, c] per ray with N = R*S; win [1, 2FC] (ones when
    unwindowed); weights flat (k, b) pairs of every net in order.
    Returns one [N, out(+1)] tensor per net."""
    a0 = archs[0]
    S = a0.S
    xe = _embed(x, win, a0.emb) if a0.emb else x
    outs = []
    for a, ws in zip(archs, _split_ws(weights, archs)):
        t = torch.cat([xe, _bcast(ct_code, S)], -1) if a.ct else xe
        h = t
        for i in range(a.D):
            if i in a.skips:
                h = torch.cat([t, h], -1)
            h = torch.relu(_mm(h, ws[2 * i], compute_dtype) + ws[2 * i + 1])
        D = a.D
        h_final = _mm(h, ws[2 * D + 2], compute_dtype) + ws[2 * D + 3]
        hd_in = torch.cat([h_final, _bcast(cd_code, S)], -1) if a.cd else h_final
        hd = torch.relu(_mm(hd_in, ws[2 * D + 4], compute_dtype) + ws[2 * D + 5])
        rgb = _mm(hd, ws[2 * D + 6], compute_dtype) + ws[2 * D + 7]
        if a.drop_sigma:
            outs.append(rgb)
            continue
        if a.sigmoid:
            rgb = torch.sigmoid(rgb)
        sigma = _mm(h, ws[2 * D], compute_dtype) + ws[2 * D + 1]
        outs.append(torch.cat([rgb, sigma], -1))
    return tuple(outs)


# ------------------------------------------------------------------ build
_lib = None
_lib_lock = threading.Lock()
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu"
_BUILD = Path(__file__).resolve().parent.parent / "_build"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    return "nvcc"


# the block sizes reach the kernels as macros, so they are set here alone
_DEFINES = [f"-DBM_F={BM_F}", f"-DBM_B={BM_B}"]


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_DEFINES).encode()).hexdigest()[:16]
    return _BUILD / f"libmoda_fmlp_{tag}.so"


def ptxas_report() -> str:
    """What ptxas said of each kernel (registers, shared memory, spills)
    when the current source was built."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_library() -> ctypes.CDLL:
    """Compile csrc/fused_mlp.cu for sm_90a into a shared library (once per
    source content) and load it."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _BUILD.mkdir(parents=True, exist_ok=True)
        so = _lib_path()
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", *_DEFINES,
                   "-o", str(tmp), str(_SRC)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
            so.with_suffix(".log").write_text(res.stderr)
        lib = ctypes.CDLL(str(so))
        lib.moda_fmlp_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.moda_fmlp_forward.restype = ctypes.c_int
        lib.moda_fmlp_backward.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.moda_fmlp_backward.restype = ctypes.c_int
        lib.moda_fmlp_dw.argtypes = [ctypes.c_void_p] * 3
        lib.moda_fmlp_dw.restype = ctypes.c_int
        for fn in (lib.moda_fmlp_dw_smem_bytes, lib.moda_fmlp_dw_blocks_per_sm):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.moda_fmlp_registers.argtypes = [ctypes.c_int]
        lib.moda_fmlp_registers.restype = ctypes.c_int
        for fn in (lib.moda_fmlp_fwd_blocks_per_sm, lib.moda_fmlp_bwd_blocks_per_sm):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.moda_fmlp_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.moda_fmlp_smem_bytes.restype = ctypes.c_int
        lib.moda_fmlp_num_sms.argtypes = []
        lib.moda_fmlp_num_sms.restype = ctypes.c_int
        lib.moda_fmlp_error_string.argtypes = [ctypes.c_int]
        lib.moda_fmlp_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


class _LayerDesc(ctypes.Structure):
    _fields_ = [("kin", ctypes.c_int), ("nout", ctypes.c_int), ("bias_off", ctypes.c_int),
                ("dw_off", ctypes.c_int), ("w", ctypes.c_void_p), ("wt", ctypes.c_void_p),
                ("a", ctypes.c_void_p),
                ("d", ctypes.c_void_p)]


class _NetDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "D", "skips", "W", "out_ch", "out_pad", "sigmoid", "drop_sigma", "uses_ct",
        "uses_cd", "tin")] + [("out", ctypes.c_void_p), ("g", ctypes.c_void_p),
                              ("layers", _LayerDesc * MAXLAYERS)]


class _FusedDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n", "s", "c", "f", "in_x", "xp", "ct", "ctp", "cd", "cdp", "nnets",
        "need_dx", "need_dt", "need_dwin", "stashed", "hw", "outw", "dsw",
        "total_bias", "total_w", "npad", "nblocks", "grid", "rows_slot", "spb")] + [
        (n, ctypes.c_void_p) for n in (
            "x", "ct_code", "cd_code", "win", "bias", "dx", "part_b", "part_win",
            "part_ct", "part_cd")] + [("nets", _NetDesc * MAXNETS)]


class _GemmTask(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("kin", "nout", "dw_off")] + [
        ("a", ctypes.c_void_p), ("d", ctypes.c_void_p)]


class _DwDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "ntasks", "ntiles", "nitems", "npad", "ba", "bd", "nstages")] + [
        ("plan", ctypes.c_void_p), ("part_w", ctypes.c_void_p),
        ("t", _GemmTask * (MAXNETS * MAXLAYERS))]


def _check(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib.moda_fmlp_error_string(rc).decode()}")


# ---------------------------------------------------------- kernel layout
def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


class _Layout:
    """Padded bf16 kernels, concatenated padded biases and the per-layer
    geometry of one launch. Every segment of a layer input (embedded x,
    trunk code, hidden, final, dir code) is padded to a multiple of 16
    columns; the kernel rows follow the same segments."""

    def __init__(self, weights, archs: Sequence[Arch]):
        a0 = archs[0]
        self.in_x = a0.in_x
        self.xp = _pad16(a0.in_x)
        self.ct = max(a.ct for a in archs)
        self.cd = max(a.cd for a in archs)
        self.ctp, self.cdp = _pad16(self.ct), _pad16(self.cd)
        self.nets = []
        biases, bias_off, dw_off = [], 0, 0
        for a, ws in zip(archs, _split_ws(weights, archs)):
            W = ws[0].shape[1]
            if W % 32 or a.D + 4 > MAXLAYERS:
                raise NotImplementedError(f"fused kernel: width {W}, depth {a.D}")
            tin_segs = [(a.in_x, self.xp)] + ([(a.ct, self.ctp)] if a.ct else [])
            seg_list = []
            for i in range(a.D):
                s = tin_segs if i == 0 else []
                if i in a.skips and i > 0:
                    s = tin_segs + [(W, W)]
                elif i > 0:
                    s = [(W, W)]
                seg_list.append(s)
            seg_list += [[(W, W)], [(W, W)],
                         [(W, W)] + ([(a.cd, self.cdp)] if a.cd else []), [(W // 2, W // 2)]]
            layers = []
            for li, segs in enumerate(seg_list):
                k, b = ws[2 * li], ws[2 * li + 1]
                nout_t = k.shape[1]
                nout = _pad16(nout_t)
                kin = sum(p for _, p in segs)
                rows = torch.cat([torch.arange(t, device=k.device) + off for (t, _), off in
                                  zip(segs, _offsets([p for _, p in segs]))])
                if rows.numel() != k.shape[0]:
                    raise ValueError(f"layer {li}: kernel rows {k.shape[0]} != {rows.numel()}")
                kp = torch.zeros(kin, nout, dtype=torch.bfloat16, device=k.device)
                kp[rows, :nout_t] = k.detach().to(torch.bfloat16)
                bp = torch.zeros(nout, dtype=torch.float32, device=k.device)
                bp[:nout_t] = b.detach().reshape(-1)
                biases.append(bp)
                layers.append(dict(kin=kin, nout=nout, nout_t=nout_t, rows=rows, w=kp,
                                   wt=kp.t().contiguous(),
                                   bias_off=bias_off, dw_off=dw_off))
                bias_off += nout
                dw_off += kin * nout
            self.nets.append(dict(arch=a, W=W, out_ch=ws[-2].shape[1], layers=layers,
                                  tin=sum(p for _, p in tin_segs)))
        self.bias = torch.cat(biases).contiguous()
        self.total_bias, self.total_w = bias_off, dw_off
        Ws = [n["W"] for n in self.nets]
        outs = [n["layers"][-1]["nout"] for n in self.nets]
        self.hw = max(Ws)
        self.outw = max(outs)
        self.dsw = max(l["nout"] for n in self.nets for l in n["layers"])

    def fill(self, desc: _FusedDesc, archs, n, S):
        a0 = archs[0]
        C, F = (a0.emb[0], a0.emb[1]) if a0.emb else (a0.in_x, 0)
        for name, v in (("n", n), ("s", S), ("c", C), ("f", F), ("in_x", self.in_x),
                        ("xp", self.xp), ("ct", self.ct), ("ctp", self.ctp), ("cd", self.cd),
                        ("cdp", self.cdp), ("nnets", len(archs)), ("hw", self.hw),
                        ("outw", self.outw), ("dsw", self.dsw), ("total_bias", self.total_bias),
                        ("total_w", self.total_w)):
            setattr(desc, name, int(v))
        desc.bias = self.bias.data_ptr()
        for i, net in enumerate(self.nets):
            a, nd = net["arch"], desc.nets[i]
            nd.D, nd.W, nd.out_ch = a.D, net["W"], net["out_ch"]
            nd.skips = sum(1 << s for s in a.skips if s < a.D)
            nd.out_pad = net["layers"][-1]["nout"]
            nd.sigmoid, nd.drop_sigma = int(a.sigmoid), int(a.drop_sigma)
            nd.uses_ct, nd.uses_cd, nd.tin = int(bool(a.ct)), int(bool(a.cd)), net["tin"]
            for li, L in enumerate(net["layers"]):
                ld = nd.layers[li]
                ld.kin, ld.nout, ld.bias_off, ld.dw_off = L["kin"], L["nout"], L["bias_off"], L["dw_off"]
                ld.w, ld.wt = L["w"].data_ptr(), L["wt"].data_ptr()


def _offsets(widths):
    out, o = [], 0
    for w in widths:
        out.append(o)
        o += w
    return out


def _nets_key(lay: "_Layout") -> str:
    """Depth, width, output width and trunk-code width of each net of a
    launch ("D5W64o25c128" is the skin MLP, "D5W64o1" the visibility MLP)."""
    return "+".join(f"D{n['arch'].D}W{n['W']}o{n['out_ch']}" +
                    (f"c{n['arch'].ct}" if n["arch"].ct else "") for n in lay.nets)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _alloc_stacks(lay: _Layout, rows: int, which: str, dev):
    """One bf16 buffer for the per-layer scratch stacks of a launch: with "a"
    in ``which`` every layer's input activation [rows, kin] (the sigma head
    reads the final layer's), with "d" every layer's pre-activation gradient
    [rows, nout]; 256-byte aligned. Returns (buffer, per net and layer the
    (A, D) addresses, None where not allocated)."""
    size, plan = 0, []
    for net in lay.nets:
        D, offs = net["arch"].D, []
        for li, L in enumerate(net["layers"]):
            a_off = d_off = None
            if "a" in which and li != D:
                a_off = size
                size += (rows * L["kin"] + 127) // 128 * 128
            if "d" in which:
                d_off = size
                size += (rows * L["nout"] + 127) // 128 * 128
            offs.append([a_off, d_off])
        if "a" in which:
            offs[D][0] = offs[D + 1][0]
        plan.append(offs)
    buf = torch.empty(size, dtype=torch.bfloat16, device=dev)
    base = buf.data_ptr()
    return buf, [[tuple(None if o is None else base + 2 * o for o in od) for od in offs]
                 for offs in plan]


class BwdGeometry(NamedTuple):
    nblocks: int    # blocks of bm points
    npad: int       # rows of the scratch stacks: nblocks * bm
    rows_slot: int  # points per code-gradient slot: min(S, bm)
    spb: int        # code-gradient slots per block: bm // rows_slot
    nslots: int     # code-gradient slots, each inside one block and one ray: nblocks * spb
    bpr: int        # consecutive slots per ray, summed by the reduction


def bwd_geometry(n: int, S: int, bm: int = BM_B) -> BwdGeometry:
    """How K2 groups n points (rays of S consecutive points) into blocks of
    bm rows and per-ray code-gradient slots. Point p lies in block p // bm
    and slot (p // bm) * spb + (p % bm) // rows_slot, and ray r sums slots
    [r * bpr, (r + 1) * bpr). Needs S | bm or bm | S. The kernel reads
    rows_slot and spb from the descriptor."""
    if S % bm and bm % S:
        raise NotImplementedError(f"fused kernel backward needs S | {bm} or {bm} | S, got {S}")
    nblocks = -(-n // bm)
    rows_slot = min(S, bm)
    spb = bm // rows_slot
    return BwdGeometry(nblocks, nblocks * bm, rows_slot, spb, nblocks * spb, max(S // bm, 1))


# ------------------------------------------------- block kernels' footprint
# Row padding of the bf16 and fp32 tiles and the warps of a CTA
# (csrc/fused_mlp.cu PADH, PADF, NWARPS). The H100's shared memory: a
# multiprocessor's, the reserve a CTA (cudaDevAttrReservedSharedMemoryPerBlock),
# a CTA's opt-in maximum. REG_CTAS: the CTAs of 256 threads that a
# multiprocessor's 65,536 registers hold at 86-128 registers a thread (K1 and
# K2 are kept at or under 128).
PADH, PADF, NWARPS = 8, 4, 8
SM_SMEM, CTA_RESERVED, BLOCK_SMEM_MAX, REG_CTAS = 233472, 1024, 232448, 2


def block_smem_bytes(lay: "_Layout", bwd: bool) -> int:
    """Shared-memory bytes of K1's (or K2's) block kernel at a launch of
    ``lay``, as csrc/fused_mlp.cu::smem_layout lays them out."""
    bm = BM_B if bwd else BM_F
    a0 = lay.nets[0]["arch"]
    fc = a0.emb[0] * a0.emb[1] if a0.emb else 0
    h = max(lay.hw, lay.dsw) if bwd else lay.hw
    # xe, ct, cd, h0, h1, the warps' fp32 staging tiles, outs
    regions = [bm * (lay.xp + PADH) * 2, bm * (lay.ctp + PADH) * 2, bm * (lay.cdp + PADH) * 2,
               bm * (h + PADH) * 2, bm * (h + PADH) * 2, NWARPS * 16 * (16 + PADF) * 4,
               bm * lay.outw * 4]
    if bwd:  # ds2, dt, dcd, bacc, wacc
        regions += [bm * (16 + PADH) * 2, bm * (lay.xp + lay.ctp) * 4, bm * lay.cdp * 4,
                    lay.total_bias * 4, 2 * fc * 4 + 4]
    return sum((b + 127) // 128 * 128 for b in regions)


def ctas_per_sm(smem: int) -> int:
    """Resident CTAs per multiprocessor of K1 or K2 at ``smem`` bytes a CTA."""
    return min(REG_CTAS, SM_SMEM // (smem + CTA_RESERVED))


# ------------------------------------------------------------- dW GEMM plan
# output tile (rows of kin x columns of nout), points per ring stage,
# columns of a TMA box, consumer warps of a CTA: csrc/fused_mlp.cu DW_TM,
# DW_TN, DW_KC, DW_BOX and DW_WARPS. A warp owns a 64 x 32 block of a tile.
DW_TM, DW_TN, DW_KC, DW_BOX, DW_WARPS = 128, 128, 128, 64, 8
DW_MIN_POINTS = 512  # least points of an item: four ring stages, and enough that
                     # its fp32 partial is at most 1/8 of the operand bytes it reads
DW_WAVES = 4         # items per resident CTA, so the block scheduler can even them out
DW_MAX_ITEMS = 768   # an item's partials are at most 64 KB (8 warps' 64 x 32 fp32
                     # blocks), so this keeps them under ~52 MB


class DwTile(NamedTuple):
    task: int      # index into the launch's tasks
    m0: int        # first row of kin
    n0: int        # first column of nout
    mw: int        # rows (a multiple of 16, at most DW_TM)
    nw: int        # columns (a multiple of 16, at most DW_TN)
    nsplit: int    # point ranges
    part_off: int  # offset of its partials [nsplit * kslices][mw][nw] (floats)
    kslices: int   # warps per 64 x 32 block, each summing every kslices-th 16-point step


class DwItem(NamedTuple):
    tile: int
    split: int
    p0: int  # a multiple of DW_KC
    p1: int  # a multiple of BM_B, at most npad


class DwPlan(NamedTuple):
    tiles: Tuple[DwTile, ...]
    items: Tuple[DwItem, ...]  # one CTA each, in launch order
    part_floats: int


def dw_tasks(lay: _Layout) -> list:
    """The dW GEMM's tasks of a launch, in K2's order: (net, layer, the
    layer whose A stack it reads) of every layer with a D stack, that is all
    but a dropped sigma head. The sigma head reads the final layer's A."""
    return [(i, li, net["arch"].D + 1 if li == net["arch"].D else li)
            for i, net in enumerate(lay.nets) for li in range(len(net["layers"]))
            if not (li == net["arch"].D and net["arch"].drop_sigma)]


def dw_task_shapes(nets, in_x: int, ct: int = 0, cd: int = 0, S: int = 1,
                   emb: Optional[Tuple[int, int, bool]] = None) -> list:
    """(kin, nout, a) of each task of the dW GEMM that K2 runs for a launch
    of nets [(NeRFMLP, use_ct, use_cd)] (arguments as ``launch_archs``), in
    the padded widths of _Layout; a is the first task that reads the same A
    stack."""
    lay = launch_layout(nets, in_x, ct, cd, S, emb=emb)
    first = {}
    return [(lay.nets[i]["layers"][li]["kin"], lay.nets[i]["layers"][li]["nout"],
             first.setdefault((i, a), j)) for j, (i, li, a) in enumerate(dw_tasks(lay))]


def dw_boxes(shapes: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """DW_BOX-column TMA boxes a ring stage holds of A and of D: enough for
    the launch's widest tile."""
    return (-(-min(DW_TM, max(k for k, _ in shapes)) // DW_BOX),
            -(-min(DW_TN, max(n for _, n in shapes)) // DW_BOX))


def dw_stages(ba: int, bd: int) -> int:
    """Ring stages of the dW GEMM: as many as fit in a block's shared memory
    (csrc/fused_mlp.cu::dw_smem_bytes), at most 8."""
    stage = (ba + bd) * DW_KC * DW_BOX * 2
    return min(8, (BLOCK_SMEM_MAX - 1024) // (stage + 16))


def dw_kslices(mw: int, nw: int) -> int:
    """Warps that share each 64 x 32 block of an mw x nw tile: the largest
    power of two that leaves no block without a warp."""
    blocks, ks = -(-mw // 64) * -(-nw // 32), 1
    while 2 * ks * blocks <= DW_WARPS:
        ks *= 2
    return ks


def _dw_cost(mw: int, nw: int) -> float:
    # per point: the bytes of the TMA boxes a stage copies (zero-filled
    # columns included), and the products at ~64 per byte
    return 2 * DW_BOX * (-(-mw // DW_BOX) - (-nw // DW_BOX)) + mw * nw / 64


def _dw_min_points(mw: int, nw: int) -> int:
    # an item reads 2 (mw + nw) bytes a point and writes 4 mw nw once
    return max(DW_MIN_POINTS, 16 * mw * nw // (mw + nw))


def dw_plan(shapes: Sequence[Tuple[int, int]], npad: int, slots: int) -> DwPlan:
    """The dW GEMM's work for tasks of shapes (kin, nout) over npad points,
    with ``slots`` CTAs resident at once: every task cut into output tiles
    of at most DW_TM x DW_TN, every tile's points into ranges (items) of
    about equal cost, about min(DW_WAVES * slots, DW_MAX_ITEMS) items in
    all, no item under _dw_min_points unless the tile has fewer. Items are
    ordered by cost in tenths of the target, the costliest first (no long
    item left for the end of the grid), then by task, first point and
    tile, so items that read the same rows of a task's stacks run side by
    side. A pure function of its arguments."""
    if npad <= 0 or npad % BM_B:
        raise ValueError(f"dW GEMM: npad {npad} must be a positive multiple of {BM_B}")
    for k, n in shapes:
        if k <= 0 or n <= 0 or k % 16 or n % 16:
            raise ValueError(f"dW GEMM: task shape ({k}, {n}) must be multiples of 16")
    geo = [(ti, m0, n0, min(DW_TM, k - m0), min(DW_TN, n - n0))
           for ti, (k, n) in enumerate(shapes)
           for m0 in range(0, k, DW_TM) for n0 in range(0, n, DW_TN)]
    per_item = sum(_dw_cost(mw, nw) for *_, mw, nw in geo) * npad / min(
        DW_WAVES * max(slots, 1), DW_MAX_ITEMS)
    tiles, items, off = [], [], 0
    for t, m0, n0, mw, nw in geo:
        max_split = max(1, npad // _dw_min_points(mw, nw))
        want = min(max_split, max(1, round(_dw_cost(mw, nw) * npad / per_item)))
        step = -(-npad // (want * DW_KC)) * DW_KC
        nsplit = -(-npad // step)
        ks = dw_kslices(mw, nw)
        tiles.append(DwTile(t, m0, n0, mw, nw, nsplit, off, ks))
        items += [DwItem(len(tiles) - 1, s, s * step, min(npad, (s + 1) * step))
                  for s in range(nsplit)]
        off += nsplit * ks * mw * nw
    if off >= 2 ** 31:
        raise ValueError("dW GEMM: partials exceed 2^31 floats")
    def rank(it):
        t = tiles[it.tile]
        return (-round(10 * _dw_cost(t.mw, t.nw) * (it.p1 - it.p0) / per_item), t.task, it.p0,
                it.tile)

    items.sort(key=rank)
    return DwPlan(tuple(tiles), tuple(items), off)


_dw_tables = collections.OrderedDict()  # (shapes, npad, slots, device) -> (plan, int32 table)
_dw_slots = {}  # (ba, bd, nstages, device) -> dW GEMM CTAs resident at once


def _dw_table(shapes, npad: int, slots: int, dev) -> Tuple[DwPlan, torch.Tensor]:
    """The plan and its device table (8 ints a tile, then 4 an item), kept
    for the last 64 launch geometries so a step copies none of them again."""
    key = (tuple(shapes), npad, slots, str(dev))
    hit = _dw_tables.get(key)
    if hit is None:
        plan = dw_plan(shapes, npad, slots)
        rows = [list(t) for t in plan.tiles] + [list(it) for it in plan.items]
        table = torch.tensor([v for r in rows for v in r], dtype=torch.int32).to(dev)
        hit = _dw_tables[key] = (plan, table)
        while len(_dw_tables) > 64:
            _dw_tables.popitem(last=False)
    return hit


def _dw_desc(lib, tasks, npad: int, dev) -> Tuple[_DwDesc, torch.Tensor, torch.Tensor]:
    """The dW GEMM's descriptor for tasks (kin, nout, dw_off, A address, D
    address). Returns it with the buffers it points at (the partials and the
    plan table), which must live until the launch is queued."""
    if len(tasks) > MAXNETS * MAXLAYERS:
        raise NotImplementedError(f"dW GEMM: at most {MAXNETS * MAXLAYERS} tasks")
    shapes = [(k, n) for k, n, *_ in tasks]
    dw = _DwDesc()
    dw.ntasks = len(tasks)
    dw.npad = npad
    dw.ba, dw.bd = dw_boxes(shapes)
    dw.nstages = dw_stages(dw.ba, dw.bd)
    for j, (kin, nout, off, a, d) in enumerate(tasks):
        if a % 16 or d % 16:
            raise ValueError("dW GEMM: stacks must be 16-byte aligned")
        t = dw.t[j]
        t.kin, t.nout, t.dw_off, t.a, t.d = kin, nout, off, a, d
    # the shared memory, and so the residency, depends on the ring alone
    skey = (dw.ba, dw.bd, dw.nstages, str(dev))
    slots = _dw_slots.get(skey)
    if slots is None:
        slots = _dw_slots[skey] = (lib.moda_fmlp_num_sms() *
                                   lib.moda_fmlp_dw_blocks_per_sm(ctypes.byref(dw)))
    plan, table = _dw_table(shapes, npad, slots, dev)
    part = torch.empty(max(plan.part_floats, 1), device=dev, dtype=torch.float32)
    dw.ntiles, dw.nitems = len(plan.tiles), len(plan.items)
    dw.plan, dw.part_w = table.data_ptr(), part.data_ptr()
    return dw, part, table


def dw_gemm_plain(a: Sequence[torch.Tensor], d: Sequence[torch.Tensor],
                  npad: Optional[int] = None) -> list:
    """Plain version of the dW GEMM: per task, A[:npad]^T D in fp32 (npad
    defaults to D's rows)."""
    return [ai[:di.shape[0] if npad is None else npad].float().t() @ di.float()
            for ai, di in zip(a, d)]


def dw_gemm(a: Sequence[torch.Tensor], d: Sequence[torch.Tensor], npad: Optional[int] = None,
            site: Optional[str] = None) -> list:
    """The dW GEMM alone, as K2's backward runs it: per task, A[:npad]^T D
    with bf16 A [>= npad, kin] and D [npad, nout] and fp32 sums, returned as
    fp32 [kin, nout]. CUDA tensors launch fmlp_dw_kernel (csrc/fused_mlp.cu)
    or raise; CPU tensors take ``dw_gemm_plain``. Passing one tensor twice
    in ``a`` (the sigma head reads the final layer's A) is allowed."""
    if len(a) != len(d) or not a:
        raise ValueError("dw_gemm: one A and one D stack per task")
    if not d[0].is_cuda:
        return dw_gemm_plain(a, d, npad)
    npad = d[0].shape[0] if npad is None else npad
    for ai, di in zip(a, d):
        if not (ai.is_cuda and di.is_cuda and ai.dtype == di.dtype == torch.bfloat16
                and ai.dim() == di.dim() == 2 and ai.is_contiguous() and di.is_contiguous()):
            raise ValueError("dw_gemm: stacks must be contiguous 2-D bf16 CUDA tensors")
        if di.shape[0] != npad or ai.shape[0] < npad:
            raise ValueError(f"dw_gemm: D needs {npad} rows and A at least as many")
    lib = build_library()
    dev = d[0].device
    offs = _offsets([ai.shape[1] * di.shape[1] for ai, di in zip(a, d)])
    tasks = [(ai.shape[1], di.shape[1], off, ai.data_ptr(), di.data_ptr())
             for ai, di, off in zip(a, d, offs)]
    dw, part, table = _dw_desc(lib, tasks, npad, dev)
    out = torch.empty(offs[-1] + a[-1].shape[1] * d[-1].shape[1], device=dev,
                      dtype=torch.float32)
    _check(lib, lib.moda_fmlp_dw(ctypes.byref(dw), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream), "dW GEMM")
    _count_dw(f"dw:{site}" if site else "dw", lib, dw)
    del part, table  # their last use is queued on this stream
    return [out[o:o + k * n].view(k, n) for (k, n, o, _, _) in tasks]


def _check_inputs(x, ct_code, cd_code, win, archs):
    a0 = archs[0]
    if len(archs) > MAXNETS:
        raise NotImplementedError(f"fused kernel takes at most {MAXNETS} nets per launch")
    if a0.emb and not a0.emb[2]:
        raise NotImplementedError("fused kernel: only log-scale embedding frequencies")
    bwd_geometry(x.shape[0], a0.S)
    for t in (x, ct_code, cd_code, win):
        if t is not None and (t.device.type != "cuda" or t.dtype != torch.float32):
            raise ValueError("fused kernel: inputs must be float32 CUDA tensors")
    if x.shape[0] % a0.S:
        raise ValueError("fused kernel: x rows must be R * S")


class _FusedMLP(torch.autograd.Function):
    """K1 (K1s when ``stash``) forward; K2 (K2s when the forward stashed)
    backward. ``site`` names the call site in the launch counters."""

    @staticmethod
    def forward(ctx, x, ct_code, cd_code, win, archs, stash, site, *weights):
        _check_inputs(x, ct_code, cd_code, win, archs)
        lib = build_library()
        x = x.contiguous()
        ct_code = None if ct_code is None else ct_code.contiguous()
        cd_code = None if cd_code is None else cd_code.contiguous()
        win = None if win is None else win.reshape(-1).contiguous()
        lay = _Layout(weights, archs)
        n = x.shape[0]
        outs = [torch.empty(n, _out_dim(a, ws), device=x.device, dtype=torch.float32)
                for a, ws in zip(archs, _split_ws(weights, archs))]
        desc = _FusedDesc()
        lay.fill(desc, archs, n, archs[0].S)
        desc.x, desc.ct_code, desc.cd_code, desc.win = (
            x.data_ptr(), _ptr(ct_code), _ptr(cd_code), _ptr(win))
        for i, o in enumerate(outs):
            desc.nets[i].out = o.data_ptr()
        # K1s: the A stacks, one row per point of every forward block (the
        # backward's BM_B-row blocks cover no more rows than that)
        acts = aptrs = None
        if stash and n:
            acts, ptrs = _alloc_stacks(lay, (n + BM_F - 1) // BM_F * BM_F, "a", x.device)
            aptrs = [[a for a, _ in net] for net in ptrs]
            for i, net in enumerate(aptrs):
                for li, a in enumerate(net):
                    desc.nets[i].layers[li].a = a
            desc.stashed = 1
        if n:
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _check(lib, lib.moda_fmlp_forward(ctypes.byref(desc), stream), "fused MLP forward")
            _count("fwd_stash" if acts is not None else "fwd", site, _nets_key(lay), lib, desc)
        ctx.archs, ctx.lay, ctx.site = archs, lay, site
        ctx.stashed, ctx.acts, ctx.aptrs = acts is not None, acts, aptrs
        ctx.save_for_backward(x, ct_code, cd_code, win)
        ctx.weight_shapes = [w.shape for w in weights]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x, ct_code, cd_code, win = ctx.saved_tensors
        archs, lay = ctx.archs, ctx.lay
        a0 = archs[0]
        lib = build_library()
        dev = x.device
        n, S = x.shape[0], a0.S
        R = n // S
        geo = bwd_geometry(n, S)
        need_dx = bool(a0.need_dx and ctx.needs_input_grad[0])
        need_dwin = bool(a0.emb and win is not None and ctx.needs_input_grad[3])
        gs = [torch.zeros(n, net["out_ch"] + (0 if net["arch"].drop_sigma else 1), device=dev)
              if g is None else g.contiguous().float() for net, g in zip(lay.nets, gs)]
        desc = _FusedDesc()
        lay.fill(desc, archs, n, S)
        # persistent CTAs: as many as stay resident at once
        grid = max(1, min(geo.nblocks, lib.moda_fmlp_num_sms() *
                          lib.moda_fmlp_bwd_blocks_per_sm(ctypes.byref(desc))))
        # scratch stacks: D always; A too unless K1s kept them (K2s)
        acts, ctx.acts = ctx.acts, None  # released once this backward is queued
        if ctx.stashed and acts is None:
            raise RuntimeError("the stashed activations were used by an earlier backward")
        scratch, ptrs = _alloc_stacks(lay, geo.npad, "d" if ctx.stashed else "ad", dev)
        for i, net in enumerate(lay.nets):
            nd = desc.nets[i]
            nd.g = gs[i].data_ptr()
            for li in range(len(net["layers"])):
                a, d = ptrs[i][li]
                nd.layers[li].a = ctx.aptrs[i][li] if ctx.stashed else a
                nd.layers[li].d = d
        desc.stashed = int(ctx.stashed)
        fc2 = 2 * a0.emb[0] * a0.emb[1] if a0.emb else 0
        f32 = dict(device=dev, dtype=torch.float32)
        dx = torch.empty(x.shape, **f32) if need_dx else None
        part_b = torch.empty(grid, lay.total_bias, **f32)
        part_win = torch.empty(grid, max(fc2, 1), **f32)
        part_ct = torch.empty(geo.nslots, max(lay.ctp, 1), **f32)
        part_cd = torch.empty(geo.nslots, max(lay.cdp, 1), **f32)
        tasks = []
        for i, li, _ in dw_tasks(lay):
            L, ld = lay.nets[i]["layers"][li], desc.nets[i].layers[li]
            tasks.append((L["kin"], L["nout"], L["dw_off"], ld.a, ld.d))
        dw, part_w, dw_table = _dw_desc(lib, tasks, geo.npad, dev)
        desc.need_dx, desc.need_dwin = int(need_dx), int(need_dwin)
        desc.need_dt = int(need_dx or need_dwin or lay.ct > 0)
        desc.npad, desc.nblocks, desc.grid = geo.npad, geo.nblocks, grid
        desc.rows_slot, desc.spb = geo.rows_slot, geo.spb
        desc.x, desc.ct_code, desc.cd_code, desc.win = (
            x.data_ptr(), _ptr(ct_code), _ptr(cd_code), _ptr(win))
        desc.dx = _ptr(dx)
        desc.part_b, desc.part_win = part_b.data_ptr(), part_win.data_ptr()
        desc.part_ct, desc.part_cd = part_ct.data_ptr(), part_cd.data_ptr()
        dw_all = torch.empty(lay.total_w, **f32)
        db_all = torch.empty(lay.total_bias, **f32)
        dwin = torch.empty(max(fc2, 1), **f32)
        dct = torch.empty(R, max(lay.ctp, 1), **f32)
        dcd = torch.empty(R, max(lay.cdp, 1), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.moda_fmlp_backward(
            ctypes.byref(desc), ctypes.byref(dw), dw_all.data_ptr(), db_all.data_ptr(),
            dwin.data_ptr(), dct.data_ptr(), dcd.data_ptr(), R, geo.bpr, stream),
            "fused MLP backward")
        nets = _nets_key(lay)
        _count("bwd_stash" if ctx.stashed else "bwd", ctx.site, nets, lib, desc)
        _count_dw(f"dw:{ctx.site}:{nets}" if ctx.site else f"dw:{nets}", lib, dw)
        del acts, scratch, part_w, dw_table  # their last use is queued on this stream
        dws = []
        for net in lay.nets:
            a = net["arch"]
            for li, L in enumerate(net["layers"]):
                kshape = ctx.weight_shapes[len(dws)]
                if li == a.D and a.drop_sigma:
                    dws += [torch.zeros(kshape, **f32),
                            torch.zeros(ctx.weight_shapes[len(dws) + 1], **f32)]
                    continue
                dk = dw_all[L["dw_off"]:L["dw_off"] + L["kin"] * L["nout"]].view(L["kin"], L["nout"])
                dws.append(dk[L["rows"], :L["nout_t"]])
                db = db_all[L["bias_off"]:L["bias_off"] + L["nout_t"]]
                dws.append(db.reshape(ctx.weight_shapes[len(dws)]))
        g_ct = dct[:, :lay.ct] if ct_code is not None else None
        g_cd = dcd[:, :lay.cd] if cd_code is not None else None
        g_win = dwin[:fc2].reshape(1, -1) if need_dwin else None
        g_x = dx if need_dx else (torch.zeros_like(x) if ctx.needs_input_grad[0] else None)
        return (g_x, g_ct, g_cd, g_win, None, None, None, *dws)


def fused_mlp(x, ct_code, cd_code, win, weights, archs: Sequence[Arch],
              compute_dtype=torch.bfloat16, site: Optional[str] = None
              ) -> Tuple[torch.Tensor, ...]:
    """The wrapper: CUDA tensors launch K1 (and K2 in the backward), or K1s
    and K2s under MODA_PALLAS_STASH=1 when a gradient will be taken; CPU
    tensors take ``fused_mlp_plain``."""
    if not x.is_cuda:
        return fused_mlp_plain(x, ct_code, cd_code, win, weights, archs, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError("the fused CUDA kernel computes in bf16 only")
    if win is not None:
        win = win.reshape(1, -1)
    stash = stash_enabled() and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, ct_code, cd_code, win, *weights))
    return _FusedMLP.apply(x, ct_code, cd_code, win, tuple(archs), stash, site, *weights)


def launch_archs(nets, in_x: int, ct: int, cd: int, S: int, need_dx: bool = True,
                 emb: Optional[Tuple[int, int, bool]] = None) -> Tuple[tuple, list]:
    """The Arch of each of nets [(NeRFMLP, use_ct, use_cd)] in one launch
    and their weights, flat: per-point inputs of in_x columns (after the
    embed ``emb``), per-ray trunk / dir codes of ct / cd columns, S points a
    ray."""
    archs, weights = [], []
    for mod, use_ct, use_cd in nets:
        ct_i = ct if use_ct else 0
        cd_i = cd if use_cd else 0
        if in_x + ct_i != mod.in_channels_xyz or cd_i != mod.in_channels_dir:
            raise ValueError(f"input widths {in_x}+{ct_i}/{cd_i} do not match "
                             f"{mod.in_channels_xyz}/{mod.in_channels_dir}")
        archs.append(Arch(mod.D, in_x, ct_i, cd_i, tuple(mod.skips), S, need_dx=need_dx,
                          sigmoid=not mod.raw_feat, emb=emb, drop_sigma=mod.raw_feat))
        weights += mod.flat_weights()
    return tuple(archs), weights


def launch_layout(nets, in_x: int, ct: int = 0, cd: int = 0, S: int = 1,
                  emb: Optional[Tuple[int, int, bool]] = None) -> _Layout:
    """The padded weights and geometry of a launch of nets [(NeRFMLP,
    use_ct, use_cd)] (arguments as ``launch_archs``), as the wrapper lays
    them out; ``block_smem_bytes`` and ``dw_task_shapes`` read it."""
    archs, weights = launch_archs(nets, in_x, ct, cd, S, emb=emb)
    return _Layout(weights, archs)


def nerf_mlp_fused(nets, x: torch.Tensor, *, code_trunk=None, code_dir=None,
                   samples_per_ray: int = 1, need_dx: bool = True, embed_freqs: int = 0,
                   embed_window=None, compute_dtype=torch.float32, kernel: bool = False,
                   site: Optional[str] = None):
    """Evaluate one or more NeRFMLPs on the same per-point input in one
    fused launch (nerf_mlp_pallas_multi of the JAX package).

    nets: list of (NeRFMLP module, use_ct, use_cd). x [..., C]: raw points
    when embed_freqs > 0 (embedded in the launch), else embedded inputs.
    code_trunk / code_dir [R, c]: per-ray codes, rows of x = R * S. One net
    with a dir branch and no code_dir takes the legacy layout of
    nerf_mlp_pallas: its dir input rides in x's last columns, per point.
    kernel=True routes through ``fused_mlp`` (the CUDA kernels for CUDA
    tensors); otherwise ``fused_mlp_plain`` in compute_dtype. ``site``
    names the call site in the launch counters."""
    lead = x.shape[:-1]
    n = 1
    for s in lead:
        n *= s
    x2 = x.reshape(n, x.shape[-1])
    S = samples_per_ray
    ct = code_trunk.shape[-1] if code_trunk is not None else 0
    cd = code_dir.shape[-1] if code_dir is not None else 0
    if code_trunk is not None:
        code_trunk = code_trunk.reshape(-1, ct)
    if code_dir is not None:
        code_dir = code_dir.reshape(-1, cd)
    elif len(nets) == 1 and nets[0][0].in_channels_dir > 0:
        # legacy layout (fused_mlp.py:780-785): dir columns per point in x
        mod = nets[0][0]
        if code_trunk is not None or S != 1:
            raise ValueError("a per-point dir input needs S = 1 and no trunk code")
        code_dir = x2[:, mod.in_channels_xyz:mod.in_channels_xyz + mod.in_channels_dir]
        x2 = x2[:, :mod.in_channels_xyz]
        cd = mod.in_channels_dir
        nets = [(mod, nets[0][1], True)]
    emb, win, in_x = None, None, x2.shape[-1]
    if embed_freqs > 0:
        C = x2.shape[-1]
        in_x = C * (2 * embed_freqs + 1)
        emb = (C, embed_freqs, True)
        win = (torch.ones(1, embed_freqs * 2 * C, device=x.device) if embed_window is None
               else embed_window.reshape(1, -1).float())
    archs, weights = launch_archs(nets, in_x, ct, cd, S, need_dx, emb)
    if kernel:
        outs = fused_mlp(x2, code_trunk, code_dir, win, weights, archs, compute_dtype,
                         site=site)
    else:
        outs = fused_mlp_plain(x2, code_trunk, code_dir, win, weights, archs, compute_dtype)
    return [o.reshape(lead + (o.shape[-1],)) for o in outs]
