"""OpenCV's DIS optical flow on tensors: the counterpart of
moda_tpu/preproc/pipeline.py::dis_flow (``cv2.DISOpticalFlow_create(
PRESET_MEDIUM).calc`` on the two frames' grey images), with no image library.

It follows OpenCV 5.0.0's dis_flow.cpp and variational_refinement.cpp step by
step and in their float32 arithmetic order, so that it lands within
rounding of cv2's flow:

1. grey: cv2's fixed-point BGR2GRAY, (3735 B + 19235 G + 9798 R + 2^14) >> 15;
2. the pyramid: INTER_AREA halvings (the 2x2 mean rounded half up where
   both sizes halve exactly, cv2's generic area weights in float otherwise),
   Sobel gradients to int16 with reflected borders (cv2.spatialGradient),
   I1 with a replicated 16-pixel border, and the per-patch sums of the
   gradient products (the structure tensor) as running float sums;
3. the coarsest scale: min(round(log2(max(H, W) / (4 * patch))),
   floor(log2(min(H, W) / patch))), cv2's rule for coarsest_scale -1;
4. the patch inverse search (``patch_search``): per scale, every patch
   starts from the coarser flow at its centre; with spatial propagation the
   patch rows are cut into 8 stripes, and a forward pass (top-left to
   bottom-right, trying the left and the upper neighbour's flow) and a
   backward pass (trying the right and the lower one) each pick the
   candidate of least mean-normalized SSD and then run floor(25 / 2)
   inverse-compositional gradient-descent steps; the sums over a patch are
   taken as cv2's 4-lane SSE code takes them;
5. densification: each pixel's flow is the mean of the flows of the patches
   that cover it, weighted by 1 / max(1, |photometric error|);
6. variational refinement (``variational_refinement``, cv2's
   VariationalRefinement): fixed-point iterations of red-black SOR on the
   colour- and gradient-constancy and smoothness terms, I1 warped by
   bilinear sampling with replicated borders;
7. up-sampling: cv2's float INTER_LINEAR resize to the next scale and at the
   end to full size, the values scaled by the same factor.

Step 4 is the one whose work is sequential: each patch of a pass starts from
its left and upper neighbours' results. On a CUDA tensor it runs in the
hand-written kernel ``dis_patch_search`` of csrc/dis.cu (one warp a patch,
one CTA a stripe walking the stripe's anti-diagonals); on a CPU tensor in
``patch_search_plain``, the same function in PyTorch, vectorized over one
anti-diagonal of every stripe. Every other step is plain PyTorch on the
tensors' device. There is no fallback: a CUDA tensor goes through the kernel
or raises.

Against the cv2 5.0.0 that the JAX package runs on, steps 1-3 and 7 are
bit-equal, and so is the whole flow with the refinement off; with it on,
the flow is a median 6e-7 px and a p99 1.2e-4 px from cv2's (the
refinement's data term rounds otherwise than cv2's SSE code in the last
bit; tests/test_torch_dis.py). Where cv2's C++
rounds once, so does this code on either device: a Python number divided by
a tensor becomes a 0-dim tensor first (PyTorch would multiply by the
reciprocal), and float32 square roots go through float64 (PyTorch's CUDA
float32 sqrt is off by an ulp at times).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

EPS = 0.001  # dis_flow.cpp's EPS (determinant floor, densification clamp)
INF = 1e10
BORDER = 16  # border_size: the replicated border of I1 that patch reads may reach
NSTRIPES = 8  # stripes of a pass with spatial propagation, whatever the thread count
MAX_WARPS = 32  # warps a CTA of dis_patch_search at most (its __launch_bounds__)
PATCH_WARPS = 8  # warps a CTA without spatial propagation (one patch a warp)
ZETA = 0.1  # VariationalRefinement's zeta (normalization of the constancy terms)

# launches of dis_patch_search through ``patch_search`` since the last reset
launches = {"patch_search": 0}


def reset_launches():
    launches["patch_search"] = 0


# PRESET_MEDIUM (mean normalization on, the coarsest scale cv2's automatic one)
FINEST_SCALE = 1
PATCH = 8  # patch size, every cv2 preset's
STRIDE = 3
GD_ITER = 25  # gradient-descent iterations, split evenly over the passes
VR_EPSILON = 0.01  # DIS's refinement epsilon (VariationalRefinement's own default: 0.001)
# VariationalRefinement's weights of the smoothness, colour and gradient terms
# (DIS sets the same), its SOR relaxation and SOR iterations
VR_ALPHA, VR_DELTA, VR_GAMMA, VR_OMEGA, VR_SOR_ITER = 20.0, 5.0, 10.0, 1.6, 5


@dataclass(frozen=True)
class DISParams:
    """The two PRESET_MEDIUM settings that cv2's setters turn off and the
    tests do (setUseSpatialPropagation, setVariationalRefinementIterations);
    every other parameter is the preset's (the constants above)."""
    use_spatial_propagation: bool = True
    var_refine_iter: int = 5


PRESET_MEDIUM = DISParams()


# ------------------------------------------------------------- stages 1-3
def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] BGR -> uint8 [H, W], bit-equal to cv2.cvtColor(
    COLOR_BGR2GRAY) of OpenCV 5."""
    x = img.to(torch.int32)
    y = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
    return y.to(torch.uint8)


def _area_tab(ssize: int, dsize: int) -> List[List[Tuple[int, float]]]:
    """cv2's computeResizeAreaTab: the (source index, weight) terms of each
    destination index, in the order cv2 sums them."""
    scale = ssize / dsize
    tab = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        terms = []
        if s1 - f1 > 1e-3:
            terms.append((s1 - 1, float(np.float32((s1 - f1) / cell))))
        terms += [(s, float(np.float32(1.0 / cell))) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            terms.append((s2, float(np.float32(min(min(f2 - s2, 1.0), cell) / cell))))
        tab.append(terms)
    return tab


def _weighted_sum(x: torch.Tensor, tab, dim: int) -> torch.Tensor:
    """sum_k x[..., idx_k, ...] * w_k along ``dim``, the terms added in the
    table's order in float32 (missing terms skipped)."""
    k = max(len(t) for t in tab)
    idx = torch.tensor([[t[min(j, len(t) - 1)][0] for j in range(k)] for t in tab],
                       device=x.device)
    w = torch.tensor([[t[j][1] if j < len(t) else 0.0 for j in range(k)] for t in tab],
                     dtype=torch.float32, device=x.device)
    has = torch.tensor([[j < len(t) for j in range(k)] for t in tab], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = len(tab)
    acc = None
    for j in range(k):
        term = x.index_select(dim, idx[:, j]) * w[:, j].view(shape)
        acc = term if acc is None else torch.where(has[:, j].view(shape), acc + term, acc)
    return acc


def resize_area_u8(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """uint8 [h, w] -> uint8 [dh, dw] (size = (dh, dw), no larger than the
    input), bit-equal to cv2.resize(..., INTER_AREA) (the pyramid's
    halvings: an exact 2x, or cv2's float area weights)."""
    h, w = img.shape
    dh, dw = size
    if (dh, dw) == (h, w):
        return img.clone()
    if (h, w) == (2 * dh, 2 * dw):  # cv2's fast path: the 2x2 mean rounded half up
        s = img.to(torch.int32).view(dh, 2, dw, 2).sum((1, 3))
        return ((s + 2) >> 2).to(torch.uint8)
    x = _weighted_sum(img.to(torch.float32), _area_tab(w, dw), 1)
    x = _weighted_sum(x, _area_tab(h, dh), 0)
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def spatial_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [h, w] -> (dx, dy) int16 [h, w]: 3x3 Sobel with reflected
    (BORDER_REFLECT_101) borders, bit-equal to cv2.spatialGradient."""
    h, w = img.shape
    x = img.to(torch.int32)
    ri = torch.tensor([1] + list(range(h)) + [h - 2], device=img.device)
    ci = torch.tensor([1] + list(range(w)) + [w - 2], device=img.device)
    p = x.index_select(0, ri).index_select(1, ci)
    dx = p[:, 2:] - p[:, :-2]
    dy = p[2:, :] - p[:-2, :]
    gx = dx[:-2] + 2 * dx[1:-1] + dx[2:]
    gy = dy[:, :-2] + 2 * dy[:, 1:-1] + dy[:, 2:]
    return gx.to(torch.int16), gy.to(torch.int16)


def coarsest_scale(h: int, w: int) -> int:
    """The coarsest pyramid level cv2 uses for an h x w frame (its rule for
    coarsest scale -1)."""
    cs = min(int(math.log(max(w, h) / (4.0 * PATCH)) / math.log(2.0) + 0.5),
             int(math.log(min(w, h) / PATCH) / math.log(2.0)))
    if cs < FINEST_SCALE:
        # cv2 then picks another patch size and stride (autoSelectPatchSizeAndScales)
        raise ValueError(f"a {h} x {w} frame is too small for DIS at finest scale "
                         f"{FINEST_SCALE} and patch {PATCH}")
    return cs


def structure_tensor(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """[5, hs, ws] float32: the sums over each patch (rows and columns
    ``k * STRIDE .. + PATCH``) of gx*gx, gy*gy, gx*gy, gx and gy, as cv2's
    precomputeStructureTensor takes them: exact integer row sums, then a
    running float32 sum down the rows (add the entering row, subtract the
    leaving one)."""
    h, w = gx.shape
    psz, pstr = PATCH, STRIDE
    hs, ws = patch_grid(h, w)
    x, y = gx.to(torch.int64), gy.to(torch.int64)
    prods = torch.stack([x * x, y * y, x * y, x, y])  # [5, h, w]
    c = torch.nn.functional.pad(prods.cumsum(2), (1, 0))
    cols = torch.arange(ws, device=gx.device) * pstr
    aux = (c[:, :, cols + psz] - c[:, :, cols]).to(torch.float32)  # exact: < 2^24
    d = aux[:, psz:] - aux[:, :-psz]
    s = aux[:, 0]
    for i in range(1, psz):
        s = s + aux[:, i]
    rows = [s]
    for i in range(psz, h):
        s = s + d[:, i - psz]
        if (i - psz + 1) % pstr == 0:
            rows.append(s)
    return torch.stack(rows[:hs], 1)


# ----------------------------------------------------- stage 4: the search
def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """t [..., 8, 4]: each of the 4 lanes summed down the 8 rows in order,
    then the lanes as (l0 + l2) + (l1 + l3) (cv2's v_reduce_sum on SSE)."""
    a = t[..., 0, :]
    for r in range(1, t.shape[-2]):
        a = a + t[..., r, :]
    return (a[..., 0] + a[..., 2]) + (a[..., 1] + a[..., 3])


class _Search:
    """Plain patch inverse search over a set of patches at once: the
    arithmetic of dis_flow.cpp's processPatchMeanNorm/computeSSDMeanNorm and
    of one patch of PatchInverseSearch_ParBody, vectorized over patches."""

    def __init__(self, I0, I1e, gx, gy, st, hs: int, ws: int):
        self.h, self.w = I0.shape
        self.we = self.w + 2 * BORDER
        self.I0 = I0.to(torch.float32).reshape(-1)
        self.I1e = I1e.to(torch.float32).reshape(-1)
        self.gx = gx.to(torch.float32).reshape(-1)
        self.gy = gy.to(torch.float32).reshape(-1)
        self.st = st.reshape(5, -1)
        self.hs, self.ws = hs, ws
        dev = I0.device
        r = torch.arange(8, device=dev)
        self.off0 = (r[:, None] * self.w + r[None, :]).reshape(-1)
        r9 = torch.arange(9, device=dev)
        self.off1 = (r9[:, None] * self.we + r9[None, :]).reshape(-1)
        self.lo = float(BORDER - PATCH + 1)
        self.hi_i = float(BORDER + self.h - 1)
        self.hi_j = float(BORDER + self.w - 1)

    def patches(self, k: torch.Tensor):
        """Per-patch constants of patch indices k (is * ws + js)."""
        i = (k // self.ws) * STRIDE
        j = (k % self.ws) * STRIDE
        base = (i * self.w + j)[:, None] + self.off0
        xx, yy, xy, sx, sy = (self.st[c, k] for c in range(5))
        det = xx * yy - xy * xy
        det = torch.where(det.abs() < EPS, torch.full_like(det, EPS), det)
        return {"i": i.to(torch.float32), "j": j.to(torch.float32),
                "I0": self.I0[base].view(-1, 8, 8), "gx": self.gx[base].view(-1, 8, 8),
                "gy": self.gy[base].view(-1, 8, 8),
                "h11": yy / det, "h12": -xy / det, "h22": xx / det, "sx": sx, "sy": sy}

    def _diff(self, c, ux, uy):
        """I1 bilinearly sampled at the patch moved by (ux, uy), minus I0:
        [n, 8, 8] (INIT_BILINEAR_WEIGHTS and the 8x8 extraction)."""
        ii = torch.clamp((c["i"] + uy) + BORDER, min=self.lo).clamp(max=self.hi_i)
        jj = torch.clamp((c["j"] + ux) + BORDER, min=self.lo).clamp(max=self.hi_j)
        fi, fj = torch.floor(ii), torch.floor(jj)
        di, dj = ii - fi, jj - fj
        w11 = (di * dj)[:, None, None]
        w10 = (di * (1 - dj))[:, None, None]
        w01 = ((1 - di) * dj)[:, None, None]
        w00 = ((1 - di) * (1 - dj))[:, None, None]
        base = fi.to(torch.int64) * self.we + fj.to(torch.int64)
        P = self.I1e[base[:, None] + self.off1].view(-1, 9, 9)
        return (((w00 * P[:, :8, :8] + w01 * P[:, :8, 1:]) + w10 * P[:, 1:, :8])
                + w11 * P[:, 1:, 1:]) - c["I0"]

    def ssd(self, c, ux, uy):
        """computeSSDMeanNorm."""
        d = self._diff(c, ux, uy)
        l, r = d[..., :4], d[..., 4:]
        sq = _lane_sum(l * l + r * r)
        s = _lane_sum(l + r)
        return sq - (s * s) / 64.0

    def step(self, c, ux, uy):
        """processPatchMeanNorm: (SSD, dUx, dUy)."""
        d = self._diff(c, ux, uy)
        l, r = d[..., :4], d[..., 4:]
        gx, gy = c["gx"], c["gy"]
        sx = _lane_sum(l * gx[..., :4] + r * gx[..., 4:])
        sy = _lane_sum(l * gy[..., :4] + r * gy[..., 4:])
        sq = _lane_sum(l * l + r * r)
        s = _lane_sum(l + r)
        return (sq - (s * s) / 64.0, sx - (s * c["sx"]) / 64.0, sy - (s * c["sy"]) / 64.0)

    def descend(self, c, ux, uy, n_iter: int, stats: Optional[dict] = None):
        """The gradient-descent loop: stops a patch once its SSD stops
        falling, after that step's update."""
        active = torch.ones_like(ux, dtype=torch.bool)
        prev = torch.full_like(ux, INF)
        for _ in range(n_iter):
            if stats is not None:
                stats["grad"] = stats["grad"] + active.sum()
            ssd, dux, duy = self.step(c, ux, uy)
            dx = c["h11"] * dux + c["h12"] * duy
            dy = c["h12"] * dux + c["h22"] * duy
            ux = torch.where(active, ux - dx, ux)
            uy = torch.where(active, uy - dy, uy)
            active = active & (ssd < prev)
            prev = torch.where(active, ssd, prev)
            if not bool(active.any()):
                break
        return ux, uy


def _schedule(hs: int, ws: int, nstripes: int, backward: bool, dev):
    """The anti-diagonal steps of one pass over every stripe: for each step,
    the patch indices, and for each the index of its row neighbour and of its
    column neighbour already visited in this pass (-1: none)."""
    sz = -(-hs // nstripes)
    steps = {}
    for s in range(nstripes):
        a, b = min(s * sz, hs), min((s + 1) * sz, hs)
        for ist in range(a, b):
            for js in range(ws):
                r, c = (b - 1 - ist, ws - 1 - js) if backward else (ist - a, js)
                step = steps.setdefault(r + c, ([], [], []))
                dj, di = (1, 1) if backward else (-1, -1)
                step[0].append(ist * ws + js)
                step[1].append(ist * ws + js + dj if c > 0 else -1)
                step[2].append((ist + di) * ws + js if r > 0 else -1)
    return [tuple(torch.tensor(v, device=dev) for v in steps[d]) for d in sorted(steps)]


def patch_search_plain(I0: torch.Tensor, I1e: torch.Tensor, gx: torch.Tensor,
                       gy: torch.Tensor, U: torch.Tensor, st: torch.Tensor,
                       p: DISParams = PRESET_MEDIUM, stats: Optional[dict] = None) -> torch.Tensor:
    """The patch inverse search of one scale in PyTorch (what the kernel
    dis_patch_search computes, in the same arithmetic order).

    I0 uint8 [h, w]; I1e uint8 [h + 32, w + 32] (I1 with its replicated
    border); gx, gy int16 [h, w]; U float32 [2, h, w] (the coarser flow);
    st float32 [5, hs, ws] (``structure_tensor``). Returns the sparse flow
    float32 [2, hs, ws]. ``stats``, where given, gets the patch evaluations
    this input needs added to it (as 0-dim tensors, so that counting adds no
    sync): "ssd" (candidate tests) and "grad" (gradient-descent steps)."""
    psz, pstr = PATCH, STRIDE
    hs, ws = patch_grid(*I0.shape)
    se = _Search(I0, I1e, gx, gy, st, hs, ws)
    k = torch.arange(hs * ws, device=I0.device)
    ci = (k // ws) * pstr + psz // 2
    cj = (k % ws) * pstr + psz // 2
    Sx = U[0][ci, cj].clone()
    Sy = U[1][ci, cj].clone()
    prop = p.use_spatial_propagation
    npass = 2 if prop else 1
    n_inner = GD_ITER // npass
    for it in range(npass):
        steps = _schedule(hs, ws, NSTRIPES, it % 2 == 1, I0.device) if prop else [(k, None, None)]
        for idx, nb_row, nb_col in steps:
            c = se.patches(idx)
            ux, uy = Sx[idx], Sy[idx]
            if prop:
                if stats is not None:
                    tried = len(idx) + (nb_row >= 0).sum() + (nb_col >= 0).sum()
                    stats["ssd"] = stats["ssd"] + tried
                best = se.ssd(c, ux, uy)
                for nb in (nb_row, nb_col):
                    has = nb >= 0
                    nbi = nb.clamp(min=0)
                    cx, cy = Sx[nbi], Sy[nbi]
                    cur = se.ssd(c, cx, cy)
                    take = has & (cur < best)
                    best = torch.where(take, cur, best)
                    ux = torch.where(take, cx, ux)
                    uy = torch.where(take, cy, uy)
            nx, ny = se.descend(c, ux, uy, n_inner, stats)
            ex = (nx - ux).to(torch.float64)
            ey = (ny - uy).to(torch.float64)
            keep = torch.sqrt(ex * ex + ey * ey) <= psz
            Sx[idx] = torch.where(keep, nx, ux)
            Sy[idx] = torch.where(keep, ny, uy)
    return torch.stack([Sx, Sy]).view(2, hs, ws)


def patch_grid(h: int, w: int) -> Tuple[int, int]:
    """(hs, ws): the patches of an h x w scale, one every STRIDE px each way."""
    return 1 + (h - PATCH) // STRIDE, 1 + (w - PATCH) // STRIDE


@dataclass(frozen=True)
class SearchGeometry:
    """dis_patch_search's launch at one scale: ``ctas`` CTAs of ``warps``
    warps, one warp a patch. With spatial propagation CTA c walks cv2's
    stripe of patch rows [c * stripe, min((c + 1) * stripe, hs)), and its
    warp w takes the stripe's rows w, w + warps, ...; without it (stripe 0)
    warp w of CTA c searches patch c * warps + w."""
    ctas: int
    warps: int
    stripe: int


def search_geometry(hs: int, ws: int, prop: bool) -> SearchGeometry:
    """The launch shape of dis_patch_search for hs x ws patches."""
    if prop:
        stripe = -(-hs // NSTRIPES)  # cv2's stripe_sz; only non-empty stripes get a CTA
        return SearchGeometry(ctas=-(-hs // stripe), warps=min(MAX_WARPS, stripe), stripe=stripe)
    return SearchGeometry(ctas=-(-(hs * ws) // PATCH_WARPS), warps=PATCH_WARPS, stripe=0)


def patch_search(I0, I1e, gx, gy, U, st, p: DISParams = PRESET_MEDIUM) -> torch.Tensor:
    """The patch inverse search of one scale: the kernel dis_patch_search on
    a CUDA tensor, ``patch_search_plain`` on a CPU one."""
    if I0.device.type == "cpu":
        return patch_search_plain(I0, I1e, gx, gy, U, st, p)
    return _patch_search_cuda(I0, I1e, gx, gy, U, st, p)


# --------------------------------------------------------- stages 5 and 7
def _cover(n: int, psz: int, pstr: int) -> Tuple[List[int], List[int]]:
    """For each pixel row (or column) 0..n-1, the first and last patch index
    whose patch covers it, as Densification_ParBody steps them."""
    start, end, lo, hi = [], [], 0, -1
    for i in range(n):
        if i % pstr == 0 and i + psz <= n:
            hi += 1
        if i - psz >= 0 and (i - psz) % pstr == 0 and lo < hi:
            lo += 1
        start.append(lo)
        end.append(hi)
    return start, end


def densify(S: torch.Tensor, I0: torch.Tensor, I1: torch.Tensor) -> torch.Tensor:
    """Sparse flow [2, hs, ws] -> dense flow [2, h, w]: each pixel the mean
    of its covering patches' flows weighted by 1 / max(1, |I1(x + u) -
    I0(x)|), summed patch row by patch row, as cv2 sums them."""
    h, w = I0.shape
    hs, ws = S.shape[1:]
    dev = I0.device
    si, ei = (torch.tensor(v, device=dev) for v in _cover(h, PATCH, STRIDE))
    sj, ej = (torch.tensor(v, device=dev) for v in _cover(w, PATCH, STRIDE))
    ki = int((ei - si).max()) + 1
    kj = int((ej - sj).max()) + 1
    I0f = I0.to(torch.float32)
    I1f = I1.to(torch.float32).reshape(-1)
    fi = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    fj = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    jmax = np.float32(np.float32(w) - np.float32(1.0)) - np.float32(EPS)
    imax = np.float32(np.float32(h) - np.float32(1.0)) - np.float32(EPS)
    sum_u = torch.zeros(h, w, device=dev)
    sum_v = torch.zeros(h, w, device=dev)
    sum_c = torch.zeros(h, w, device=dev)
    for a in range(ki):
        isx = si + a
        vi = isx <= ei
        for b in range(kj):
            jsx = sj + b
            valid = vi[:, None] & (jsx <= ej)[None, :]
            k = isx.clamp(max=hs - 1)[:, None] * ws + jsx.clamp(max=ws - 1)[None, :]
            sx = S[0].reshape(-1)[k]
            sy = S[1].reshape(-1)[k]
            jm = torch.clamp(fj + sx, min=0.0).clamp(max=float(jmax))
            im = torch.clamp(fi + sy, min=0.0).clamp(max=float(imax))
            jl = jm.to(torch.int64)
            il = im.to(torch.int64)
            A = jm - jl.to(torch.float32)
            B = im - il.to(torch.float32)
            C = (jl + 1).to(torch.float32) - jm
            D = (il + 1).to(torch.float32) - im
            p00 = I1f[il * w + jl]
            p01 = I1f[il * w + jl + 1]
            p10 = I1f[(il + 1) * w + jl]
            p11 = I1f[(il + 1) * w + jl + 1]
            diff = ((((A * B) * p11 + (C * B) * p10) + (A * D) * p01) + (C * D) * p00) - I0f
            coef = _rdiv(1.0, torch.clamp(diff.abs(), min=1.0))
            sum_u = torch.where(valid, sum_u + coef * sx, sum_u)
            sum_v = torch.where(valid, sum_v + coef * sy, sum_v)
            sum_c = torch.where(valid, sum_c + coef, sum_c)
    return torch.stack([sum_u / sum_c, sum_v / sum_c])


def _linear_coefs(d: int, s: int, dev, exact: bool, clamp: bool = True):
    """cv2.resize INTER_LINEAR's source index and weight per destination
    index (half-pixel centres). ``exact``: the fraction taken in double
    (OpenCV 5's one-channel float path); else in float32. ``clamp``: an
    index past a border takes that border's pixel with weight 1 (columns;
    the multi-channel path keeps the rows' weights and clamps the rows)."""
    scale = 1.0 / (d / s)
    idx, a = [], []
    for i in range(d):
        fd = (i + 0.5) * scale - 0.5
        f = np.float32(fd)
        si = int(np.floor(fd if exact else f))
        f = np.float32(fd - si) if exact else np.float32(f - np.float32(si))
        if clamp and si < 0:
            f, si = np.float32(0), 0
        if clamp and si >= s - 1:
            f, si = np.float32(0), s - 1
        idx.append(si)
        a.append(f)
    i0 = torch.tensor(idx, device=dev)
    a1 = torch.tensor(np.asarray(a, np.float32), device=dev)
    return i0.clamp(0, s - 1), (i0 + 1).clamp(0, s - 1), 1.0 - a1, a1


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """fma(t, b - a, a) in float32: the product and sum rounded once."""
    return (a.double() + t.double() * (b - a).double()).float()


def resize_linear(x: torch.Tensor, size: Tuple[int, int], planes: bool = True) -> torch.Tensor:
    """float32 [C, h, w] -> [C, dh, dw], as cv2.resize INTER_LINEAR gives it
    in OpenCV 5: with ``planes``, what it gives each [h, w] plane alone
    (fractions in double, each pass a fused lerp); else what it gives the
    interleaved [h, w, C] image (fractions in float32, products and sums
    rounded one by one, rows first)."""
    C, h, w = x.shape
    dh, dw = size
    x0, x1, a0, a1 = _linear_coefs(dw, w, x.device, planes)
    y0, y1, b0, b1 = _linear_coefs(dh, h, x.device, planes, clamp=planes)
    if planes:
        r = _lerp(x[:, :, x0], x[:, :, x1], a1)
        return _lerp(r[:, y0, :], r[:, y1, :], b1[:, None])
    r = x[:, :, x0] * a0 + x[:, :, x1] * a1
    return r[:, y0, :] * b0[:, None] + r[:, y1, :] * b1[:, None]


# ----------------------------------------------- stage 6: the refinement
def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded once on every device (PyTorch's CUDA float32
    sqrt is off by an ulp at times; through float64 it is exact)."""
    return torch.sqrt(t.double()).float()


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t rounded once, as C++ divides (``num / t`` with a Python
    number is t's reciprocal times num in PyTorch: two roundings)."""
    return t.new_full((), num) / t


def _sample_replicate(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, mx, my, INTER_LINEAR, BORDER_REPLICATE) of a float32
    [h, w] image: bilinear weights from the exact fraction, each tap's
    coordinates clamped into the image."""
    h, w = img.shape
    fx, fy = torch.floor(mx), torch.floor(my)
    ax, ay = mx - fx, my - fy
    big = 1 << 30
    x0 = fx.clamp(-big, big).to(torch.int64)
    y0 = fy.clamp(-big, big).to(torch.int64)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    f = img.reshape(-1)
    w0 = (1 - ay) * (1 - ax)
    w1 = (1 - ay) * ax
    w2 = ay * (1 - ax)
    w3 = ay * ax
    return ((f[ya * w + xa] * w0 + f[ya * w + xb] * w1) + f[yb * w + xa] * w2) + f[yb * w + xb] * w3


def _ddx(x: torch.Tensor) -> torch.Tensor:
    """Sobel ksize 1 along x with replicated borders: x[j+1] - x[j-1]."""
    p = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    return p[:, 2:] - p[:, :-2]


def _ddy(x: torch.Tensor) -> torch.Tensor:
    p = torch.cat([x[:1], x, x[-1:]], 0)
    return p[2:] - p[:-2]


def variational_refinement(I0: torch.Tensor, I1: torch.Tensor, U: torch.Tensor, *,
                           fixed_point_iter: int = 5, sor_iter: int = VR_SOR_ITER,
                           epsilon: float = 0.001) -> torch.Tensor:
    """cv2.VariationalRefinement.calcUV: I0, I1 uint8 [h, w], U float32
    [2, h, w] -> the refined flow [2, h, w] (the defaults are cv2's; DIS
    passes its own epsilon and fixed-point iterations).

    Red-black SOR over the whole image: a pixel (i, j) is red where i + j is
    even. The smoothness weight of a pixel serves its edges to the right and
    down; an edge past the right or bottom border does not exist, and a
    neighbour past any border adds nothing to the SOR sums."""
    f32 = lambda v: float(np.float32(v))
    h, w = I0.shape
    dev = I0.device
    I0f = I0.to(torch.float32)
    I1f = I1.to(torch.float32)
    zeta2 = f32(np.float32(ZETA) * np.float32(ZETA))
    eps2 = f32(np.float32(epsilon) * np.float32(epsilon))
    alpha2, gamma2, delta2 = f32(VR_ALPHA / 2), f32(VR_GAMMA / 2), f32(VR_DELTA / 2)
    omega = f32(VR_OMEGA)
    Wu, Wv = U[0], U[1]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    warped = _sample_replicate(I1f, xs + Wu, ys + Wv)
    avg = I0f * 0.5 + warped * 0.5
    Iz = warped - I0f
    Ix, Iy = _ddx(avg), _ddy(avg)
    Ixx, Ixy, Iyy = _ddx(Ix), _ddy(Ix), _ddy(Iy)
    Ixz, Iyz = _ddx(Iz), _ddy(Iz)

    ii = torch.arange(h, device=dev)[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    red = (ii + jj) % 2 == 0
    not_right = (jj < w - 1).expand(h, w)
    not_bottom = (ii < h - 1).expand(h, w)

    def right(x):  # x at (i, j + 1), 0 past the border
        return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)

    def left(x):
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)

    def down(x):
        return torch.cat([x[1:], torch.zeros_like(x[:1])], 0)

    def up(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], 0)

    def rep_right(x):  # replicated border
        return torch.cat([x[:, 1:], x[:, -1:]], 1)

    def rep_down(x):
        return torch.cat([x[1:], x[-1:]], 0)

    du = torch.zeros_like(Wu)
    dv = torch.zeros_like(Wv)
    tu, tv = Wu, Wv
    for _ in range(fixed_point_iter):
        # data term (colour and gradient constancy)
        dn = (Ix * Ix + Iy * Iy) + zeta2
        ik = (Iz + Ix * du) + Iy * dv
        wt = _rdiv(delta2, _sqrt((ik * ik) / dn + eps2)) / dn
        a11 = wt * (Ix * Ix) + zeta2
        a12 = wt * (Ix * Iy)
        a22 = wt * (Iy * Iy) + zeta2
        b1 = -wt * (Iz * Ix)
        b2 = -wt * (Iz * Iy)
        dn1 = (Ixx * Ixx + Ixy * Ixy) + zeta2
        dn2 = (Iyy * Iyy + Ixy * Ixy) + zeta2
        ikx = (Ixz + Ixx * du) + Ixy * dv
        iky = (Iyz + Ixy * du) + Iyy * dv
        wt = _rdiv(gamma2, _sqrt(((ikx * ikx) / dn1 + (iky * iky) / dn2) + eps2))
        a11 = a11 + wt * ((Ixx * Ixx) / dn1 + (Ixy * Ixy) / dn2)
        a12 = a12 + wt * ((Ixx * Ixy) / dn1 + (Ixy * Iyy) / dn2)
        a22 = a22 + wt * ((Ixy * Ixy) / dn1 + (Iyy * Iyy) / dn2)
        b1 = b1 + -wt * ((Ixx * Ixz) / dn1 + (Ixy * Iyz) / dn2)
        b2 = b2 + -wt * ((Ixy * Ixz) / dn1 + (Iyy * Iyz) / dn2)
        # smoothness weights from the current flow, terms from the initial one
        ux = rep_right(tu) - tu
        vx = rep_right(tv) - tv
        uy = rep_down(tu) - tu
        vy = rep_down(tv) - tv
        sw = _rdiv(alpha2, _sqrt((((ux * ux + vx * vx) + uy * uy) + vy * vy) + eps2))
        hu = sw * (rep_right(Wu) - Wu)
        hv = sw * (rep_right(Wv) - Wv)
        vu = sw * (rep_down(Wu) - Wu)
        vv = sw * (rep_down(Wv) - Wv)
        sw_r = torch.where(not_right, sw, torch.zeros_like(sw))
        sw_d = torch.where(not_bottom, sw, torch.zeros_like(sw))
        hu, hv = torch.where(not_right, hu, 0 * hu), torch.where(not_right, hv, 0 * hv)
        vu, vv = torch.where(not_bottom, vu, 0 * vu), torch.where(not_bottom, vv, 0 * vv)
        # cv2 adds them pass by pass: horizontal red, horizontal black,
        # vertical red, vertical black; each pass adds an edge's weight to
        # both its ends
        for colour in (red, ~red):
            a11 = torch.where(colour & not_right, a11 + sw, a11)
            a22 = torch.where(colour & not_right, a22 + sw, a22)
            b1 = torch.where(colour & not_right, b1 + hu, b1)
            b2 = torch.where(colour & not_right, b2 + hv, b2)
            src = left(colour.to(torch.float32)) > 0  # the left neighbour has this colour
            a11 = torch.where(src, a11 + left(sw_r), a11)
            a22 = torch.where(src, a22 + left(sw_r), a22)
            b1 = torch.where(src, b1 - left(hu), b1)
            b2 = torch.where(src, b2 - left(hv), b2)
        for colour in (red, ~red):
            a11 = torch.where(colour & not_bottom, a11 + sw, a11)
            a22 = torch.where(colour & not_bottom, a22 + sw, a22)
            b1 = torch.where(colour & not_bottom, b1 + vu, b1)
            b2 = torch.where(colour & not_bottom, b2 + vv, b2)
            src = up(colour.to(torch.float32)) > 0
            a11 = torch.where(src, a11 + up(sw_d), a11)
            a22 = torch.where(src, a22 + up(sw_d), a22)
            b1 = torch.where(src, b1 - up(vu), b1)
            b2 = torch.where(src, b2 - up(vv), b2)
        wl, wu = left(sw), up(sw)
        for _ in range(sor_iter):
            for colour in (red, ~red):
                su = ((wl * left(du) + sw * right(du)) + wu * up(du)) + sw * down(du)
                sv = ((wl * left(dv) + sw * right(dv)) + wu * up(dv)) + sw * down(dv)
                nu = du + omega * (((su + b1) - dv * a12) / a11 - du)
                du = torch.where(colour, nu, du)
                nv = dv + omega * (((sv + b2) - du * a12) / a22 - dv)
                dv = torch.where(colour, nv, dv)
        tu, tv = Wu + du, Wv + dv
    return torch.stack([tu, tv])


# ------------------------------------------------------------ the whole
def calc(I0: torch.Tensor, I1: torch.Tensor, p: DISParams = PRESET_MEDIUM) -> torch.Tensor:
    """cv2.DISOpticalFlow.calc(I0, I1, None): grey uint8 [H, W] frames on
    one device -> flow float32 [H, W, 2] on that device."""
    H, W = I0.shape
    if I1.shape != I0.shape:
        raise ValueError(f"frames of shapes {tuple(I0.shape)} and {tuple(I1.shape)}")
    fs = FINEST_SCALE
    cs = coarsest_scale(H, W)
    I0s, I1s = {}, {}
    for i in range(fs, cs + 1):
        # the finest level straight from the frames, each coarser one from the last
        a, b = (I0, I1) if i == fs else (I0s[i - 1], I1s[i - 1])
        size = (H >> fs, W >> fs) if i == fs else (a.shape[0] // 2, a.shape[1] // 2)
        I0s[i], I1s[i] = resize_area_u8(a, size), resize_area_u8(b, size)
    U = torch.zeros((2,) + tuple(I0s[cs].shape), dtype=torch.float32, device=I0.device)
    for i in range(cs, fs - 1, -1):
        a, b = I0s[i], I1s[i]
        gx, gy = spatial_gradient(a)
        st = structure_tensor(gx, gy)
        ext = torch.nn.functional.pad(b[None, None].to(torch.float32), (BORDER,) * 4,
                                      mode="replicate")[0, 0].to(torch.uint8)
        S = patch_search(a, ext, gx, gy, U.contiguous(), st, p)
        U = densify(S, a, b)
        if p.var_refine_iter > 0:
            U = variational_refinement(a, b, U, fixed_point_iter=p.var_refine_iter,
                                       epsilon=VR_EPSILON)
        if i > fs:
            U = resize_linear(U, tuple(I0s[i - 1].shape)) * 2.0
    U = resize_linear(U, (H, W), planes=False) * float(1 << fs)
    return U.permute(1, 2, 0).contiguous()


def dis_flow(img0: np.ndarray, img1: np.ndarray, device=None) -> np.ndarray:
    """Dense flow img0 -> img1 of two BGR uint8 [H, W, 3] frames (or grey
    [H, W]): float32 [H, W, 2], what the JAX package's pipeline.dis_flow
    gives. Runs on the CUDA card unless ``device`` says otherwise."""
    from moda_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    g = []
    for img in (img0, img1):
        t = torch.from_numpy(np.ascontiguousarray(img, np.uint8)).to(dev)
        g.append(bgr_to_gray(t) if t.dim() == 3 else t)
    return calc(g[0], g[1]).cpu().numpy()


# ---------------------------------------------------------- the kernel
_lib = None
_lib_lock = threading.Lock()
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "dis.cu"
_BUILD = Path(__file__).resolve().parent.parent / "_build"


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libmoda_dis_{tag}.so"


def build_library() -> ctypes.CDLL:
    """Compile csrc/dis.cu for sm_90a into a shared library (once per
    source content) and load it. Products and sums are not fused into FMAs
    (-fmad=false), so the kernel rounds as the plain version does."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from moda_tpu_torch.ops.fused_mlp import _nvcc

        _BUILD.mkdir(parents=True, exist_ok=True)
        so = _lib_path()
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                   "-o", str(tmp), str(_SRC)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
            so.with_suffix(".log").write_text(res.stderr)
        lib = ctypes.CDLL(str(so))
        lib.moda_dis_patch_search.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        lib.moda_dis_patch_search.restype = ctypes.c_int
        lib.moda_dis_error_string.argtypes = [ctypes.c_int]
        lib.moda_dis_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_report() -> str:
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_usage(report: Optional[str] = None) -> dict:
    """Registers a thread and spilled bytes of each kernel of csrc/dis.cu as
    ptxas reported them (``report``, else the build's ``ptxas_report``):
    {"stripes": {"registers": n, "spill_stores": b, "spill_loads": b},
    "patches": {...}}."""
    out, cur = {}, None
    for line in (ptxas_report() if report is None else report).splitlines():
        m = re.search(r"Compiling entry function '\S*dis_search_([a-z]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def _patch_search_cuda(I0, I1e, gx, gy, U, st, p: DISParams) -> torch.Tensor:
    h, w = I0.shape
    hs, ws = patch_grid(h, w)
    want = {"I0": (I0, torch.uint8, (h, w)),
            "I1e": (I1e, torch.uint8, (h + 2 * BORDER, w + 2 * BORDER)),
            "gx": (gx, torch.int16, (h, w)), "gy": (gy, torch.int16, (h, w)),
            "U": (U, torch.float32, (2, h, w)), "st": (st, torch.float32, (5, hs, ws))}
    for name, (t, dt, shape) in want.items():
        if t.device != I0.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"dis_patch_search: {name} must be a contiguous {dt} {shape} "
                             f"on {I0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = build_library()
    S = torch.empty((2, hs, ws), dtype=torch.float32, device=I0.device)
    npass = 2 if p.use_spatial_propagation else 1
    g = search_geometry(hs, ws, p.use_spatial_propagation)
    stream = torch.cuda.current_stream(I0.device).cuda_stream
    rc = lib.moda_dis_patch_search(
        I0.data_ptr(), I1e.data_ptr(), gx.data_ptr(), gy.data_ptr(), U[0].data_ptr(),
        U[1].data_ptr(), st.data_ptr(), S[0].data_ptr(), S[1].data_ptr(), h, w, hs, ws, STRIDE,
        npass, GD_ITER // npass, g.ctas, g.warps, g.stripe, stream)
    if rc != 0:
        raise RuntimeError(f"dis_patch_search failed: {lib.moda_dis_error_string(rc).decode()}")
    launches["patch_search"] += 1
    return S
