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

# kernel launches made through the wrapper since the last reset, in all
# (K1, K2, K1s, K2s) and by call site and nets ("bwd:skin_bw:D5W64o25c128")
launches = {"fwd": 0, "bwd": 0, "fwd_stash": 0, "bwd_stash": 0}
launches_by_call = collections.Counter()
# (shared-memory bytes, resident CTAs per SM) of the block kernel of each
# key of launches_by_call, taken at its first launch
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
        "total_bias", "total_w", "npad", "nblocks", "grid", "nsplit", "chunk", "rows_slot",
        "spb")] + [
        (n, ctypes.c_void_p) for n in (
            "x", "ct_code", "cd_code", "win", "bias", "dx", "part_b", "part_win",
            "part_ct", "part_cd", "part_w")] + [("nets", _NetDesc * MAXNETS)]


class _GemmTask(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "kin", "nout", "dw_off", "tiles_n", "tile_start")] + [
        ("a", ctypes.c_void_p), ("d", ctypes.c_void_p)]


class _DwDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "ntasks", "total_tiles", "npad", "chunk", "total_w")] + [
        ("part_w", ctypes.c_void_p), ("t", _GemmTask * (MAXNETS * MAXLAYERS))]


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
        # dW GEMM tasks: every layer with a D stack (not the dropped sigma)
        dw = _DwDesc()
        tasks, tile = [], 0
        for i, net in enumerate(lay.nets):
            D = net["arch"].D
            for li, L in enumerate(net["layers"]):
                if li == D and net["arch"].drop_sigma:
                    continue
                t = dw.t[len(tasks)]
                t.kin, t.nout, t.dw_off = L["kin"], L["nout"], L["dw_off"]
                t.tiles_n = (L["nout"] + 63) // 64
                t.tile_start = tile
                t.a = desc.nets[i].layers[li].a
                t.d = desc.nets[i].layers[li].d
                tile += ((L["kin"] + 63) // 64) * t.tiles_n
                tasks.append(t)
        # about 8 resident dW CTAs per SM; chunks of whole 32-point steps
        nsplit_target = max(1, -(-8 * lib.moda_fmlp_num_sms() // tile))
        chunk = -(-geo.npad // nsplit_target)
        chunk = (chunk + 31) // 32 * 32
        nsplit = -(-geo.npad // chunk)
        part_w = torch.empty(nsplit, lay.total_w, **f32)
        dw.ntasks, dw.total_tiles, dw.npad, dw.chunk, dw.total_w = (
            len(tasks), tile, geo.npad, chunk, lay.total_w)
        dw.part_w = part_w.data_ptr()
        desc.need_dx, desc.need_dwin = int(need_dx), int(need_dwin)
        desc.need_dt = int(need_dx or need_dwin or lay.ct > 0)
        desc.npad, desc.nblocks, desc.grid, desc.nsplit, desc.chunk = (
            geo.npad, geo.nblocks, grid, nsplit, chunk)
        desc.rows_slot, desc.spb = geo.rows_slot, geo.spb
        desc.x, desc.ct_code, desc.cd_code, desc.win = (
            x.data_ptr(), _ptr(ct_code), _ptr(cd_code), _ptr(win))
        desc.dx = _ptr(dx)
        desc.part_b, desc.part_win, desc.part_w = part_b.data_ptr(), part_win.data_ptr(), part_w.data_ptr()
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
        _count("bwd_stash" if ctx.stashed else "bwd", ctx.site, _nets_key(lay), lib, desc)
        del acts, scratch  # their last use is queued on this stream
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
    if kernel:
        outs = fused_mlp(x2, code_trunk, code_dir, win, weights, tuple(archs), compute_dtype,
                         site=site)
    else:
        outs = fused_mlp_plain(x2, code_trunk, code_dir, win, weights, tuple(archs),
                               compute_dtype)
    return [o.reshape(lead + (o.shape[-1],)) for o in outs]
