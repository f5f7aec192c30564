"""Smoke run of the PyTorch/CUDA port on one H100.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile  # plus torch.profiler device-time tables

Phases:
1. print the card's name and power limit, torch and CUDA versions;
2. build the fused-MLP kernels from moda_tpu_torch/csrc;
3. hold K1 (forward) and K2 (backward) against the plain PyTorch version in
   bf16 mode at every call site of the init, ft1 and ft2 steps, at the
   shapes those steps give them, and K1s/K2s (the activation-stash mode)
   at the trunk and skin sites, against the plain version and K2s's
   gradients against K2's; print each launch's shared-memory bytes and
   resident CTAs per SM, and at the trunk site check that two backwards on
   the same inputs give bit-identical gradients; time the kernel, the plain
   version and a bf16 layer-by-layer F.linear chain (yardstick), and compute
   the bound;
4. for each of bench.py's init, ft1 and ft2 stages (full widths, random
   weights and data from a seed): one kernel-path step against one plain
   fp32 step from the same parameters and draws, then ten timed steps with
   the launch counters set to 0 before and read after, checked per call
   site; ft2 then runs with MODA_PALLAS_STASH=1 (K1s/K2s), its loss held
   against the rematerializing step's, the two timed in turns.
Prints the kernel JSON line, then {"ok": true, "device": {...}} last.
Exits non-zero without printing a result when there is no CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def cuda_time(fn, iters=5, warmup=2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_time_backward(forward, backward, iters=5, warmup=2) -> float:
    """Time of ``backward`` alone, on a graph that ``forward`` builds before
    each timed call (a difference of two forward-and-backward timings goes
    negative where host noise exceeds the backward's time)."""
    import torch
    total = 0.0
    for i in range(warmup + iters):
        graph = forward()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        backward(graph)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / iters


@contextlib.contextmanager
def stash_mode(on: bool):
    """MODA_PALLAS_STASH=1 inside the block (K1s/K2s), as the wrapper reads it."""
    old = os.environ.pop("MODA_PALLAS_STASH", None)
    if on:
        os.environ["MODA_PALLAS_STASH"] = "1"
    try:
        yield
    finally:
        os.environ.pop("MODA_PALLAS_STASH", None)
        if old is not None:
            os.environ["MODA_PALLAS_STASH"] = old


# --------------------------------------------------------------- kernels
def work(mods, N, ins, outs, need_dx, x):
    """Operations and bytes the fused launch must do: (flops, bytes) of K1,
    K2, K1s and K2s. Products only (the embed's trig is < 0.1%). K2
    recomputes the forward (its activations are not inputs), then dW for
    every layer and d(input) for every layer but the first, whose input
    gradient is needed only for dx or a trunk code. K1s does K1's work and
    writes the bf16 activation stack; K2s reads the stack instead of
    recomputing the forward, and a sigmoid head's output needs its last
    product again. Bytes: every input read once and every output written
    once, in fp32 (the stack in bf16)."""
    flops_f = flops_first = flops_head = 0
    n_stack = 0
    for m, use_ct, _ in mods:
        ks = m.flat_weights()[0::2]
        flops_f += sum(2 * N * w.numel() for w in ks)
        if need_dx or use_ct:
            flops_first += 2 * N * ks[0].shape[0] * ks[0].shape[1]
        if not m.raw_feat:
            flops_head += 2 * N * ks[-1].numel()
        # the stack holds each layer's input once (sigma shares the final's)
        n_stack += N * sum(k.shape[0] for i, k in enumerate(ks) if i != m.D)
    flops_b = 3 * flops_f - sum(2 * N * m.flat_weights()[0].numel() for m, _, _ in mods) + \
        flops_first
    n_in = sum(t.numel() for t in ins)
    n_w = sum(w.numel() for m, _, _ in mods for w in m.flat_weights())
    n_out = sum(o.numel() for o in outs)
    bytes_f = 4 * (n_in + n_w + n_out)
    # K2 reads the inputs, the weights and the cotangents; writes the weight
    # gradients, the code and window gradients, and dx when needed
    grads_in = n_in - (0 if need_dx else x.numel())
    bytes_b = 4 * (n_in + n_w + n_out + n_w + grads_in)
    return {"K1": (flops_f, bytes_f), "K2": (flops_b, bytes_b),
            "K1s": (flops_f, bytes_f + 2 * n_stack),
            "K2s": (flops_b - flops_f + flops_head, bytes_b + 2 * n_stack)}


TRUNK_FEAT = [(8, 256, 27 + 64, 3, False, False, True), (5, 128, 0, 16, True, False, False)]
FEAT = [(5, 128, 0, 16, True, False, False)]
VIS = [(5, 64, 0, 1, True, False, False)]
SKIN = [(5, 64, 0, 25, True, True, False)]
UNC = [(8, 256, 32, 1, True, False, True)]
P = "moda_tpu/render/pipeline.py"

# name: (nets [(D, W, in_dir, out, raw_feat, use_ct, use_cd)], N points, S, ct, cd,
#        need_dx, input, forward only, JAX call site, (stage, site) runs it serves)
# input: "raw" xyz embedded in the launch, "embedded" x with the dir code per
# point in its last columns (the legacy layout, no in-kernel embed)
KERNEL_CASES = {
    "trunk_feat_r2048": (TRUNK_FEAT, 262144, 128, 0, 91, True, "raw", False, f"{P}:156",
                         [("init", "trunk_feat"), ("ft2", "trunk_feat")]),
    "trunk_feat_r3072": (TRUNK_FEAT, 393216, 128, 0, 91, True, "raw", False, f"{P}:156",
                         [("ft1", "trunk_feat")]),
    "trunk_feat_coarse": (TRUNK_FEAT, 131072, 64, 0, 91, True, "raw", True, f"{P}:537",
                          [("ft2", "trunk_feat_coarse")]),
    "feat_grid": (FEAT, 8000, 1, 0, 0, False, "raw", False, f"{P}:215",
                  [("init", "feat_grid"), ("ft1", "feat_grid"), ("ft2", "feat_grid")]),
    "vis_r2048": (VIS, 524288, 1, 0, 0, False, "raw", False, f"{P}:502",
                  [("init", "vis"), ("ft2", "vis")]),
    "vis_r3072": (VIS, 786432, 1, 0, 0, False, "raw", False, f"{P}:502", [("ft1", "vis")]),
    "skin_r2048_s128": (SKIN, 262144, 128, 128, 0, True, "raw", False, f"{P}:83,112",
                        [("ft2", "skin_bw"), ("ft2", "skin_fw")]),
    "skin_r3072_s128": (SKIN, 393216, 128, 128, 0, True, "raw", False, f"{P}:83,112",
                        [("ft1", "skin_bw"), ("ft1", "skin_fw")]),
    "skin_coarse": (SKIN, 131072, 64, 128, 0, True, "raw", True, f"{P}:83 (via :537)",
                    [("ft2", "skin_bw_coarse")]),
    "skin_r2048_s1": (SKIN, 2048, 1, 128, 0, True, "raw", False, f"{P}:277",
                      [("ft2", "skin_reproj")]),
    "skin_r3072_s1": (SKIN, 3072, 1, 128, 0, True, "raw", False, f"{P}:277",
                      [("ft1", "skin_reproj")]),
    "unc_pred": (UNC, 2048, 1, 0, 32, True, "raw", False, f"{P}:436", [("ft2", "unc_pred")]),
    "unc_scores": (UNC, 4096, 1, 0, 32, False, "embedded", True, "moda_tpu/render/rays.py:91",
                   [("ft2", "unc_scores")]),
}
# K1s/K2s are checked and timed at these cases; they serve the ft2 stash run
STASH_CASES = {"trunk_feat_r2048": ["trunk_feat"], "skin_r2048_s128": ["skin_bw", "skin_fw"]}
# two backwards on the same inputs must give bit-identical gradients here
DETERMINISM_CASE = "trunk_feat_r2048"

# the nets of each call site, as the wrapper's launch counter names them
NETS = {"trunk_feat": "D8W256o3+D5W128o16", "feat_grid": "D5W128o16", "vis": "D5W64o1",
        "skin": "D5W64o25c128", "unc": "D8W256o1"}


# the wrapper's launch-counter kind of each kernel
KINDS = {"K1": "fwd", "K2": "bwd", "K1s": "fwd_stash", "K2s": "bwd_stash"}


def footprint(FM, kname: str, case: str):
    """(shared-memory bytes, resident CTAs per SM) of kernel ``kname``'s
    block kernel as the wrapper recorded them at the case's launch."""
    (fp,) = [v for k, v in FM.footprints.items() if k.startswith(f"{KINDS[kname]}:{case}:")]
    return fp


def nets_of(site: str) -> str:
    for k, v in NETS.items():
        if site.startswith(k):
            return v
    raise KeyError(site)


def check_kernels(results: list, profile: bool = False):
    """Each case's K1/K2 (and K1s/K2s where listed) against the plain
    version, timed; one JSON entry per kernel and case goes to ``results``
    (launches are filled in by the step phases)."""
    import torch
    from moda_tpu_torch.core.embedding import window_vec
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name, (specs, N, S, ct, cd, need_dx, layout, fwd_only, site, runs) in \
            KERNEL_CASES.items():
        R = N // S
        legacy = layout == "embedded"
        mods = []
        for D, W, in_dir, out, raw, use_ct, use_cd in specs:
            m = NeRFMLP(D=D, W=W, in_channels_xyz=63 + (ct if use_ct else 0),
                        in_channels_dir=in_dir, out_channels=out, raw_feat=raw)
            reset_denses(m, gen)
            mods.append((m.to(dev), use_ct, use_cd and not legacy))
        if legacy:
            x = torch.randn(N, 63 + cd, generator=gen).to(dev)
            ctc = cdc = win = None
        else:
            x = (torch.randn(N, 3, generator=gen) * 0.3).to(dev)
            ctc = torch.randn(R, ct, generator=gen).to(dev) if ct else None
            cdc = torch.randn(R, cd, generator=gen).to(dev) if cd else None
            win = window_vec(10, 3, 7.5, device=dev)
        weights = [w for m, _, _ in mods for w in m.flat_weights()]
        leaves = [x] + [t for t in (ctc, cdc, win) if t is not None] + weights
        names = ["x"] + [n for n, t in (("ct", ctc), ("cd", cdc), ("win", win))
                         if t is not None] + [f"w{i}" for i in range(len(weights))]

        def run(kernel: bool, cdt=torch.bfloat16, grad=True):
            for t in leaves:
                t.grad = None
            req = [t.requires_grad_(grad) for t in leaves]
            with torch.set_grad_enabled(grad):
                outs = FM.nerf_mlp_fused(mods, x, code_trunk=ctc, code_dir=cdc,
                                         samples_per_ray=S, need_dx=need_dx,
                                         embed_freqs=0 if legacy else 10, embed_window=win,
                                         compute_dtype=cdt, kernel=kernel, site=name)
            return outs, req

        def values(kernel, cdt=torch.bfloat16):
            outs, req = run(kernel, cdt, grad=not fwd_only)
            if fwd_only:
                return [o.detach() for o in outs], []
            grads = torch.autograd.grad(outs, req, gouts, allow_unused=True)
            return [o.detach() for o in outs], [None if g is None else g.detach() for g in grads]

        outs_f, _ = run(False, torch.float32, grad=False)
        gouts = [torch.randn(o.shape, generator=gen).to(dev) for o in outs_f]
        outs_f, grads_f = values(False, torch.float32)
        outs_p, grads_p = values(False)
        launches0 = dict(FM.launches)
        outs_k, grads_k = values(True)
        torch.cuda.synchronize()
        want = (launches0["fwd"] + 1, launches0["bwd"] + (0 if fwd_only else 1))
        if (FM.launches["fwd"], FM.launches["bwd"]) != want:
            raise SystemExit(f"{name}: the kernel route did not launch K1 (and K2) once each")

        def rel_l2(a, b):
            return float((a - b).norm() / (b.norm() + 1e-12))

        def nmax(a, b, ref):
            return float((a - b).abs().max() / (ref.abs().max() + 1e-12))

        # Tolerances. Both routes round the same operands and cotangents to
        # bf16 and accumulate in fp32; they differ in summation order, so a
        # pre-activation within one bf16 step of zero can flip a ReLU in one
        # route and not the other. Such a flip moves a single point's dx by up
        # to ~30% of the max (the embed's 2^9 factor amplifies it), so the
        # bulk is judged by the relative L2 error against the plain bf16
        # version, and the point-wise max by distance to the fp32 plain
        # version: the kernel must be no further from it than the plain bf16
        # version is (x1.5 + 1e-3).
        tol_out, tol_grad = 1e-2, 2e-2

        def compare(tag, outs_k, grads_k):
            worst, ok = (0.0, ""), True
            triples = [(f"out{i}", k, p, f, tol_out) for i, (k, p, f) in
                       enumerate(zip(outs_k, outs_p, outs_f))]
            triples += [(nm, k, p, f, tol_grad) for nm, k, p, f in
                        zip(names, grads_k, grads_p, grads_f)
                        if p is not None and k is not None and not (nm == "x" and not need_dx)]
            max_abs_out = max_abs_grad = 0.0
            for nm, k, p, f, tol in triples:
                e = rel_l2(k, p)
                worst = max(worst, (e, nm))
                far_k, far_p = nmax(k, f, f), nmax(p, f, f)
                if not (e <= tol and far_k <= 1.5 * far_p + 1e-3):
                    ok = False
                    print(f"[kernels] {tag} {name} {nm}: rel_l2 {e:.3e} (tol {tol}) max-vs-fp32 "
                          f"kernel {far_k:.3e} plain-bf16 {far_p:.3e}", flush=True)
                d = float((k - p).abs().max())
                if nm.startswith("out"):
                    max_abs_out = max(max_abs_out, d)
                else:
                    max_abs_grad = max(max_abs_grad, d)
            print(f"[kernels] {tag} {name}: N={N} S={S} worst rel_l2 {worst[0]:.3e} on "
                  f"{worst[1]} (tol out {tol_out}, grads {tol_grad}); max|kernel-plain| out "
                  f"{max_abs_out:.3e} grads {max_abs_grad:.3e}", flush=True)
            if not ok:
                raise SystemExit(f"kernel mismatch in {tag} {name}")
            return max_abs_out, max_abs_grad

        err_out, err_grad = compare("K1/K2", outs_k, grads_k)
        print(f"[kernels] {name}: shared memory " + ", ".join(
            "{} {} B ({} CTAs/SM)".format(k, *footprint(FM, k, name))
            for k in (("K1",) if fwd_only else ("K1", "K2"))) +
            f" at BM_F={FM.BM_F}, BM_B={FM.BM_B}", flush=True)
        if name == DETERMINISM_CASE:
            outs_k2, grads_k2 = values(True)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs_k + grads_k, outs_k2 + grads_k2)
                       if a is not None)
            print(f"[kernels] K1/K2 {name}: a second run on the same inputs is bit-identical: "
                  f"{same}", flush=True)
            if not same:
                raise SystemExit(f"{name}: the backward is not deterministic run to run")
        stash_errs = None
        if name in STASH_CASES:
            with stash_mode(True):
                l0 = dict(FM.launches)
                outs_s, grads_s = values(True)
                torch.cuda.synchronize()
            if (FM.launches["fwd_stash"], FM.launches["bwd_stash"]) != (
                    l0["fwd_stash"] + 1, l0["bwd_stash"] + 1):
                raise SystemExit(f"{name}: the stash route did not launch K1s and K2s once each")
            stash_errs = compare("K1s/K2s", outs_s, grads_s)
            same_out = all(torch.equal(a, b) for a, b in zip(outs_s, outs_k))
            dg = [rel_l2(a, b) for a, b in zip(grads_s, grads_k) if a is not None]
            same_grad = all(torch.equal(a, b) for a, b in zip(grads_s, grads_k)
                            if a is not None)
            print(f"[kernels] K1s/K2s {name}: outputs bit-identical to K1's: {same_out}; "
                  f"gradients bit-identical to K2's: {same_grad} (worst rel_l2 against K2 "
                  f"{max(dg):.3e})", flush=True)
            if not same_out or max(dg) > tol_grad:
                raise SystemExit(f"K1s/K2s disagree with K1/K2 in {name}")

        # ---- timing (forward, and forward + backward)
        def fwd(kernel):
            with torch.no_grad():
                run(kernel, grad=False)

        def fwd_graph(kernel):  # what K1s runs: a forward under grad
            run(kernel)

        def bwd(graph):
            outs, req = graph
            torch.autograd.grad(outs, req, gouts, allow_unused=True)

        def fwdbwd(kernel):
            bwd(run(kernel))

        xe_in = torch.randn(N, 63, device=dev, dtype=torch.bfloat16)
        cd_chain = x[:, 63:].contiguous() if legacy else cdc

        def chain(grad: bool):
            # yardstick: the same stacks as separate bf16 F.linear calls;
            # returns the summed outputs (backward: .backward() on them)
            ws = [(w.detach().to(torch.bfloat16).t().contiguous().requires_grad_(grad))
                  for w in weights]
            total = None
            with torch.set_grad_enabled(grad):
                for k, (m, use_ct, _) in enumerate(mods):
                    off = sum(2 * (mm.D + 4) for mm, _, _ in mods[:k])
                    t = xe_in
                    if use_ct:
                        t = torch.cat([t, ctc.to(torch.bfloat16).repeat_interleave(S, 0)], -1)
                    h = t
                    for i in range(m.D):
                        if i in m.skips:
                            h = torch.cat([t, h], -1)
                        h = torch.relu(torch.nn.functional.linear(h, ws[off + 2 * i]))
                    D = m.D
                    hf = torch.nn.functional.linear(h, ws[off + 2 * D + 2])
                    if m.in_channels_dir:
                        hf = torch.cat([hf, cd_chain.to(torch.bfloat16)
                                        .repeat_interleave(hf.shape[0] // cd_chain.shape[0], 0)],
                                       -1)
                    hd = torch.relu(torch.nn.functional.linear(hf, ws[off + 2 * D + 4]))
                    o = torch.nn.functional.linear(hd, ws[off + 2 * D + 6]).float().sum()
                    total = o if total is None else total + o
            return total

        n_launch = dict(FM.launches)
        timed = {}
        # the kernels' own device time, without the wrapper's host work
        target = (lambda: fwd(True)) if fwd_only else (lambda: fwdbwd(True))
        target()
        _, events, busy = profiled(target, 3)
        d_kf = device_ms(events, 3, ["fmlp_fwd"])
        d_kb = device_ms(events, 3, ["fmlp_bwd", "fmlp_dw", "fmlp_reduce"])
        if profile:
            print(f"[kernels] profile {name}: device busy {busy:.3f} ms per call", flush=True)
            print_table("kernels", events, 3, True, 8)
        t_kf = cuda_time(lambda: fwd(True))
        t_pf = cuda_time(lambda: fwd(False))
        t_cf = cuda_time(lambda: chain(False))
        timed["K1"] = (t_kf, d_kf, t_pf, t_cf)
        if not fwd_only:
            t_kb = cuda_time_backward(lambda: run(True), bwd)
            t_pb = cuda_time_backward(lambda: run(False), bwd)
            t_cb = cuda_time_backward(lambda: chain(True), lambda total: total.backward())
            timed["K2"] = (t_kb, d_kb, t_pb, t_cb)
        if name in STASH_CASES:
            with stash_mode(True):
                fwdbwd(True)
                _, ev_s, _ = profiled(lambda: fwdbwd(True), 3)
                t_sf = cuda_time(lambda: fwd_graph(True))
                t_sb = cuda_time_backward(lambda: run(True), bwd)
            # the plain version of K1s/K2s is fused_mlp_plain, as for K1/K2
            timed["K1s"] = (t_sf, device_ms(ev_s, 3, ["fmlp_fwd"]), t_pf, t_cf)
            timed["K2s"] = (t_sb, device_ms(ev_s, 3, ["fmlp_bwd", "fmlp_dw", "fmlp_reduce"]),
                            t_pb, t_cb)
        for k in FM.launches:  # timing launches are not main-path launches
            FM.launches[k] = n_launch[k]

        ins = [t for t in (x, ctc, cdc, win) if t is not None]
        bounds = work(mods, N, ins, outs_p, need_dx, x)
        for kname, (t_k, d_k, t_p, t_c) in timed.items():
            fl, by = bounds[kname]
            t_ops, t_bytes = fl / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
            err = stash_errs if kname.endswith("s") else (err_out, err_grad)
            stash = kname.endswith("s")
            results.append({
                "name": f"{kname}:{name}", "route": "cuda",
                "source": "moda_tpu_torch/csrc/fused_mlp.cu",
                "replaces": ("moda_tpu/ops/fused_mlp.py:341" if kname.startswith("K1")
                             else "moda_tpu/ops/fused_mlp.py:375"),
                "call_site": site, "launches": 0,
                "max_abs_err": err[0] if kname.startswith("K1") else err[1],
                "ms": t_k, "plain_ms": t_p, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "layer_chain_ms": t_c, "device_ms": d_k,
                "smem_bytes": footprint(FM, kname, name)[0],
                "ctas_per_sm": footprint(FM, kname, name)[1],
                "runs": ([["ft2_stash", s] for s in STASH_CASES[name]] if stash else
                         [list(r) for r in runs]),
            })
            print(f"[kernels] {kname} {name}: kernel {t_k:.3f} ms (device only {d_k:.3f})  "
                  f"plain {t_p:.3f} ms  F.linear chain {t_c:.3f} ms  bound "
                  f"{max(t_ops, t_bytes):.3f} ms ({'ops' if t_ops >= t_bytes else 'bytes'})",
                  flush=True)


# ------------------------------------------------------------ train step
# bench.py:58-75's stages: (config, uniform px, active px, fine pass, delta-skin)
STAGES = {
    "init": (dict(nsample=4, eikonal_wt=0.001), 4, 0, False, False),
    "ft1": (dict(nsample=6, freeze_proj=True), 6, 0, False, True),
    "ft2": (dict(nsample=4, use_unc=True, eikonal_wt=0.1), 2, 2, True, True),
}
# call sites each step launches: site -> (forward, backward) launches per step
SITES = {
    "init": {"trunk_feat": (1, 1), "feat_grid": (1, 1), "vis": (1, 1)},
    "ft1": {"skin_bw": (1, 1), "skin_fw": (1, 1), "trunk_feat": (1, 1), "feat_grid": (1, 1),
            "skin_reproj": (1, 1), "vis": (1, 1)},
    "ft2": {"unc_scores": (1, 0), "skin_bw_coarse": (1, 0), "trunk_feat_coarse": (1, 0),
            "skin_bw": (1, 1), "skin_fw": (1, 1), "trunk_feat": (1, 1), "feat_grid": (1, 1),
            "skin_reproj": (1, 1), "vis": (1, 1), "unc_pred": (1, 1)},
}


def make_stage(name: str, device: str, seed: int = 0):
    """bench.py's stage ``name``: 256 line pairs, 128 depth samples, 25
    bones, 20^3 feat-match grid, 64 frames, full widths; random weights and
    data from ``seed``."""
    import numpy as np
    import torch
    from moda_tpu_torch.config import DataInfo, MoDAConfig
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.train.step import StepExtras

    kw, ns, na, _, _ = STAGES[name]
    n_pairs, num_fr = 256, 64
    cfg = MoDAConfig(num_bones=25, img_size=512, ndepth=128, feat_ndepth_grid=20,
                     lineload=True, **kw)
    info = DataInfo(offset=(0, num_fr), intrinsics=((500.0, 500.0, 256.0, 256.0),))
    model = MoDAModel(cfg, info, device=device, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    P, bs2 = cfg.img_size, 2 * n_pairs

    def img(c):
        return torch.tensor(rng.uniform(size=(bs2, c, P)).astype(np.float32), device=device)

    fid = rng.integers(0, num_fr - 1, size=n_pairs)
    fid = torch.tensor(np.concatenate([fid, fid + 1]), device=device)
    batch = {
        "imgs": img(3), "masks": (img(1) > 0.4).float(), "vis2d": torch.ones(bs2, 1, P, device=device),
        "flow": img(2) * 0.1, "occ": img(1), "dp_feats": img(16),
        "kaug": torch.tensor([[1.0, 1.0, 0.0, 0.0]], device=device).repeat(bs2, 1),
        "frameid": fid, "frameid_sub": fid, "dataid": torch.zeros(bs2, dtype=torch.long, device=device),
        "lineid": torch.tensor(rng.integers(0, cfg.img_size, size=bs2), device=device),
    }
    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    extras = StepExtras(
        progress=t(0.5), loss_select=t(1), root_update=t(1.0), body_update=t(1.0),
        shape_update=t(0.0), cvf_update=t(0.0), sil_err_median=t(1e9),
        shape_samp=torch.tensor(rng.normal(size=(1000, 3)).astype(np.float32) * 0.1, device=device),
        shape_samp_valid=t(1.0), embed_alpha=t(10.0))
    return cfg, model, batch, extras, bs2 * (ns + na)


def _dev_us(e, self_only: bool) -> float:
    for name in (("self_device_time_total", "self_cuda_time_total") if self_only else
                 ("device_time_total", "cuda_time_total")):
        if hasattr(e, name):
            return getattr(e, name)
    return 0.0


def profiled(fn, n: int):
    """torch.profiler over n calls of fn. Returns the host ops and the
    device activities (kernels, copies, memsets) as key averages, and the
    device's busy time per call in ms (device activities only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    ops = [e for e in ka if e.device_type == DeviceType.CPU]
    dev = [e for e in ka if e.device_type != DeviceType.CPU]
    return ops, dev, sum(_dev_us(e, True) for e in dev) / n / 1e3


def device_ms(dev, n: int, prefixes) -> float:
    """Device time per call of the activities whose name starts with one of
    ``prefixes``."""
    return sum(_dev_us(e, True) for e in dev if e.key.startswith(tuple(prefixes))) / n / 1e3


def print_table(tag: str, events, n: int, self_only: bool, rows: int):
    print(f"[{tag}] top by {'self ' if self_only else ''}device time: ms per call, "
          f"count per call", flush=True)
    for e in sorted(events, key=lambda e: _dev_us(e, self_only), reverse=True)[:rows]:
        if _dev_us(e, self_only) > 0:
            print(f"[{tag}]   {_dev_us(e, self_only) / n / 1e3:9.3f}  {e.count / n:7.1f}  "
                  f"{e.key[:110]}", flush=True)


def profile_steps(tag, step, batch, extras, gen, step_s: float, n: int = 2):
    """Where the step's time goes on the device: torch.profiler over n
    kernel-path steps; prints device time by kernel and by PyTorch op and
    the device's idle share of the step."""
    ops, dev, busy = profiled(lambda: step(batch, extras, generator=gen), n)
    n_dev = sum(e.count for e in dev) / n
    print(f"[profile {tag}] device busy {busy:.2f} ms of {step_s * 1e3:.2f} ms/step "
          f"(idle share {1 - busy / (step_s * 1e3):.3f}); {n_dev:.0f} device activities "
          f"per step; fused-MLP kernels {device_ms(dev, n, ['fmlp_']):.2f} ms", flush=True)
    print_table(f"profile {tag}", dev, n, True, 25)
    print_table(f"profile {tag}", ops, n, False, 40)
    return busy


def stage_draws(name, cfg, model, plain, batch, extras, rays: int):
    """The draws of one step of ``name``, the same for the kernel and the
    plain path, including the active-sampling selection (the plain path's
    ranking); prints how many selections the two rankings share."""
    import torch
    from moda_tpu_torch.core import camera as cam
    from moda_tpu_torch.render.rays import active_sample_ids
    from moda_tpu_torch.train.step import batch_rtk

    _, ns, na, use_fine, _ = STAGES[name]
    g = torch.Generator(device="cuda").manual_seed(1)
    bs2, S, G = batch["frameid"].shape[0], cfg.ndepth, cfg.feat_ndepth_grid
    S0 = S // 2 if use_fine else S
    kw = dict(generator=g, device="cuda")
    draws = {"pix_ids": torch.randint(0, cfg.img_size, (bs2, ns), **kw),
             "z_u": torch.rand(rays, S0, **kw),
             "grid_noise": torch.randn(G ** 3, 3, **kw),
             "vis_neg": torch.rand(rays, S, 3, **kw) * 2 - 1,
             "eik_idx": torch.randint(0, rays * S, (1000,), **kw)}
    if use_fine:
        draws["pdf_u"] = torch.rand(rays, S0, **kw)
    if na:
        draws["cand_ids"] = torch.randint(0, cfg.img_size, (bs2, 4 * (ns + na)), **kw)
        picks = []
        with torch.no_grad():
            for m in (model, plain):
                Kinv = cam.prepare_ray_cams(batch_rtk(m, m.compute_rts(), batch),
                                            batch["kaug"])[2]
                picks.append(active_sample_ids(m, batch, Kinv, draws["cand_ids"], na,
                                               extras.embed_alpha))
        shared = len(set(picks[0].tolist()) & set(picks[1].tolist()))
        print(f"[{name}] active sampling: the kernel and plain unc rankings share {shared} of "
              f"{picks[1].numel()} selections; both steps take the plain one", flush=True)
        draws["active_idx"] = picks[1]
    return draws


def expected_calls(name: str, steps: int, stash: bool = False) -> dict:
    out = {}
    for site, (nf, nb) in SITES[name].items():
        for kind, n in (("fwd", nf), ("bwd", nb)):
            if n:
                k = f"{kind}_stash" if stash and nb else kind
                out[f"{k}:{site}:{nets_of(site)}"] = n * steps
    return out


def run_stage(name: str, results: list, card: str, profile: bool = False) -> dict:
    import copy
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import make_train_step

    _, ns, na, use_fine, use_dskin = STAGES[name]
    cfg, model, batch, extras, rays = make_stage(name, "cuda")
    start = copy.deepcopy(model)
    plain = copy.deepcopy(model)
    plain.cfg = cfg.replace(use_pallas=False)
    kw = dict(nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
              use_bones=True, nsample_active=na)
    step_k = make_train_step(model, MoDAOptimizer(cfg, total_steps=24000), **kw)
    step_p = make_train_step(plain, MoDAOptimizer(cfg, total_steps=24000), **kw)
    draws = stage_draws(name, cfg, model, plain, batch, extras, rays)
    aux_p, _ = step_p(batch, extras, draws=draws)
    aux_k, _ = step_k(batch, extras, draws=draws)
    torch.cuda.synchronize()
    lk, lp = float(aux_k["total_loss"]), float(aux_p["total_loss"])
    # bf16 kernel path against the fp32 plain path from the same parameters
    # and draws: the MLP outputs differ by bf16 rounding (~1e-3 relative)
    loss_tol = 2e-2
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    print(f"[{name}] one step, same inputs: kernel loss {lk:.6f}  plain loss {lp:.6f}  "
          f"rel diff {rel:.3e} (tol {loss_tol})", flush=True)
    for k in ("img_loss", "sil_loss", "flo_loss", "feat_loss", "feat_rnd_loss", "cyc_loss",
              "proj_loss", "visibility_loss", "ekl_loss", "bone_loc_loss", "unc_loss"):
        if k in aux_k:
            print(f"[{name}]   {k}: kernel {float(aux_k[k]):.6f} plain {float(aux_p[k]):.6f}",
                  flush=True)
    if not (rel <= loss_tol and math.isfinite(lk) and math.isfinite(lp)):
        raise SystemExit(f"{name}: kernel-path loss disagrees with the plain path")
    if float(aux_k["grad_finite"]) != 1.0:
        raise SystemExit(f"{name}: non-finite gradients on the kernel path")

    gen = torch.Generator(device="cuda").manual_seed(2)
    n_warm, n_timed = 2, 10
    for _ in range(n_warm):
        step_k(batch, extras, generator=gen)
    torch.cuda.synchronize()
    FM.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n_timed):
        aux, _ = step_k(batch, extras, generator=gen)
        losses.append(aux["total_loss"])
        finite = aux["grad_finite"]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    counts, calls = dict(FM.launches), dict(FM.launches_by_call)
    losses = [float(v) for v in losses]
    print(f"[{name}] kernel path: {dt * 1e3:.2f} ms/step, {rays / dt:.1f} rays/s over {n_timed} "
          f"steps ({card}); losses {[round(v, 5) for v in losses]}; launches {counts}",
          flush=True)
    print(f"[{name}] launches by call site: {calls}", flush=True)
    if not all(math.isfinite(v) for v in losses) or float(finite) != 1.0:
        raise SystemExit(f"{name}: non-finite loss or gradients on the kernel path")
    if calls != expected_calls(name, n_timed):
        raise SystemExit(f"{name}: launches by call site {calls} != "
                         f"{expected_calls(name, n_timed)}")
    for r in results:
        r["launches"] += sum(calls.get(f"{'fwd' if r['name'].startswith('K1') else 'bwd'}:"
                                       f"{site}:{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == name)
    busy = profile_steps(name, step_k, batch, extras, gen, dt) if profile else None
    step_p(batch, extras, generator=gen)
    torch.cuda.synchronize()
    n_plain = 3
    t0 = time.perf_counter()
    for _ in range(n_plain):
        step_p(batch, extras, generator=gen)
    torch.cuda.synchronize()
    dtp = (time.perf_counter() - t0) / n_plain
    print(f"[{name}] plain path: {dtp * 1e3:.2f} ms/step, {rays / dtp:.1f} rays/s ({card})",
          flush=True)
    out = {"ms_per_step": dt * 1e3, "rays_per_sec": rays / dt, "plain_ms_per_step": dtp * 1e3,
           "loss_kernel": lk, "loss_plain": lp, "device_busy_ms": busy, "card": card}
    if name == "ft2":
        out["stash"] = run_stash(start, cfg, kw, batch, extras, draws, rays, results, card)
    return out


def run_stash(start, cfg, kw, batch, extras, draws, rays, results, card) -> dict:
    """ft2 with MODA_PALLAS_STASH=1 against the rematerializing step: one
    step each from the same parameters and draws (the losses must agree;
    K1s's forward is K1's), then both timed in turns (remat, stash, stash,
    remat) with the stash turns' launches counted per call site."""
    import copy
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import make_train_step

    models = {m: copy.deepcopy(start) for m in ("remat", "stash")}
    steps = {m: make_train_step(models[m], MoDAOptimizer(cfg, total_steps=24000), **kw)
             for m in models}
    aux = {}
    for m in ("remat", "stash"):
        with stash_mode(m == "stash"):
            aux[m], _ = steps[m](batch, extras, draws=draws)
    torch.cuda.synchronize()
    lr, ls = float(aux["remat"]["total_loss"]), float(aux["stash"]["total_loss"])
    same = all(torch.equal(a, b) for a, b in zip(models["remat"].parameters(),
                                                 models["stash"].parameters()))
    rel = abs(ls - lr) / max(abs(lr), 1e-12)
    print(f"[ft2 stash] one step, same inputs: stash loss {ls:.6f}  remat loss {lr:.6f}  rel "
          f"diff {rel:.3e} (tol 2e-2); updated parameters bit-identical: {same}", flush=True)
    if not (rel <= 2e-2 and math.isfinite(ls)) or float(aux["stash"]["grad_finite"]) != 1.0:
        raise SystemExit("ft2: the stash step disagrees with the remat step")
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 4
    times = {"remat": [], "stash": []}
    calls = {}
    for turn in ("remat", "stash", "stash", "remat"):
        with stash_mode(turn == "stash"):
            steps[turn](batch, extras, generator=gen)
            torch.cuda.synchronize()
            if turn == "stash" and not times["stash"]:
                FM.reset_launches()
            t0 = time.perf_counter()
            for _ in range(n):
                steps[turn](batch, extras, generator=gen)
            torch.cuda.synchronize()
            times[turn].append((time.perf_counter() - t0) / n * 1e3)
            if turn == "stash" and len(times["stash"]) == 1:
                calls = dict(FM.launches_by_call)
    print(f"[ft2 stash] ms/step in turns remat/stash/stash/remat: {times['remat'][0]:.2f} / "
          f"{times['stash'][0]:.2f} / {times['stash'][1]:.2f} / {times['remat'][1]:.2f} "
          f"({card}); stash launches by call site {calls}", flush=True)
    if calls != expected_calls("ft2", n, stash=True):
        raise SystemExit(f"ft2 stash: launches by call site {calls} != "
                         f"{expected_calls('ft2', n, stash=True)}")
    for r in results:
        r["launches"] += sum(calls.get(f"{'fwd_stash' if r['name'].startswith('K1') else 'bwd_stash'}"
                                       f":{site}:{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == "ft2_stash")
    return {"loss_stash": ls, "loss_remat": lr, "params_bit_identical": same,
            "remat_ms_per_step": times["remat"], "stash_ms_per_step": times["stash"],
            "rays_per_sec_stash": rays / (sum(times["stash"]) / 2e3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile the kernels and each stage's kernel-path step")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        raise SystemExit(2)
    try:
        import moda_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: moda_tpu_torch not found next to this script", file=sys.stderr)
        raise SystemExit(2)
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.runtime import resolve_device

    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    t0 = time.time()
    FM.build_library()
    print(f"[build] fused_mlp.cu built and loaded in {time.time() - t0:.1f} s", flush=True)
    for line in FM.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)

    results: list = []
    check_kernels(results, profile=args.profile)
    print(f"[time] kernel phase done at {time.time() - t0:.1f} s", flush=True)
    steps = {}
    for name in STAGES:
        steps[name] = run_stage(name, results, card, profile=args.profile)
        print(f"[time] {name} done at {time.time() - t0:.1f} s", flush=True)
    for r in results:
        if r["launches"] == 0:
            raise SystemExit(f"{r['name']} was not launched on the main path")
        del r["runs"]
    print(json.dumps({"steps": steps}))
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
