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
   the bound; K2's device time is split into the block kernel, the dW GEMM
   and the reductions;
4. the dW GEMM alone (``fused_mlp.dw_gemm``) at every backward call site:
   seeded random bf16 A/D stacks of the site's task shapes and rows (as K2
   takes them: ``fused_mlp.dw_task_shapes``), against ``dw_gemm_plain`` (relative L2 error <= 1e-4 per
   task), run twice (bit-identical), timed beside its bound and one cuBLAS
   ``torch.matmul(A.t(), D)`` a task (the yardstick, ``library_ms``);
5. for each of bench.py's init, ft1 and ft2 stages (full widths, random
   weights and data from a seed): one kernel-path step against one plain
   fp32 step from the same parameters and draws, then ten timed steps with
   the launch counters set to 0 before and read after, checked per call
   site; ft2 then runs with MODA_PALLAS_STASH=1 (K1s/K2s), its loss held
   against the rematerializing step's, the two timed in turns;
6. the stage-1 trainer (``run_trainer``): ``moda_tpu_torch.cli.train_app.main``
   with the stage-1 flags of scripts/template.sh (the default render_size
   64, so the epoch ends with the eval grid) on a synthetic line-shard
   dataset, one 200-step epoch at full widths (batch 256), its logs,
   checkpoints, rest mesh, eval grid (``eval-000.png`` at the grid's size,
   no ``eval_render_error``) and K1/K2/dW launches per call site checked
   (the eval renders launch none);
7. extraction and scoring (``run_extract``) on the trainer's dataset and
   ``latest`` checkpoint, with the flags of scripts/eval_synth.sh:
   ``extract_app.main`` (``--lineload --test_frames {0} --sample_grid3d
   128``), then ``evals.ama.main`` against the dataset's ground-truth
   meshes and ``eval_root_app.main`` against its cameras. Checks: as many
   exported meshes, cameras and camera trajectories as video 0 has frames
   less one; every warped mesh finite with the rest mesh's vertex count;
   ``make_warp_fw_frames`` on the card within 1e-5 (relative L2) of a CPU
   copy of the model, and one 64 px frame of ``make_frame_renderer`` with
   flow within 1e-4; finite AMA and root-pose scores, F-scores in [0, 1];
   no kernel launch in the phase. It prints the time of each part.
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
import tempfile
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
KINDS = {"K1": "fwd", "K2": "bwd", "K1s": "fwd_stash", "K2s": "bwd_stash", "dW": "dw"}
# ptxas registers a thread: moda_fmlp_registers's argument of each kernel
REGISTERS = {"K1": 0, "K1s": 0, "K2": 1, "K2s": 1, "dW": 2}


def counter_kind(entry: str, stash: bool) -> str:
    """The launch-counter kind that counts kernel entry ``entry``'s launches
    in a run with or without MODA_PALLAS_STASH=1 (K2 and K2s both launch the
    dW GEMM)."""
    k = entry.split(":")[0]
    if k == "dW":
        return "dw"
    return ("fwd" if k.startswith("K1") else "bwd") + ("_stash" if stash else "")


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


def case_nets(name: str) -> list:
    """Case ``name``'s nets [(NeRFMLP, use_ct, use_cd)] on the CPU, as
    ``nerf_mlp_fused`` takes them."""
    from moda_tpu_torch.fields.nets import NeRFMLP

    specs, _, _, ct, _, _, layout = KERNEL_CASES[name][:7]
    return [(NeRFMLP(D=D, W=W, in_channels_xyz=63 + (ct if use_ct else 0),
                     in_channels_dir=in_dir, out_channels=out, raw_feat=raw),
             use_ct, use_cd and layout != "embedded")
            for D, W, in_dir, out, raw, use_ct, use_cd in specs]


def build_case(name: str, gen, dev):
    """Case ``name``'s nets (random weights) and inputs from ``gen``:
    (mods [(module, use_ct, use_cd)], x, ct code, cd code, window, legacy)."""
    import torch
    from moda_tpu_torch.core.embedding import window_vec
    from moda_tpu_torch.fields.nets import reset_denses

    _, N, S, ct, cd, _, layout = KERNEL_CASES[name][:7]
    R = N // S
    legacy = layout == "embedded"
    mods = []
    for m, use_ct, use_cd in case_nets(name):
        reset_denses(m, gen)
        mods.append((m.to(dev), use_ct, use_cd))
    if legacy:
        x = torch.randn(N, 63 + cd, generator=gen).to(dev)
        ctc = cdc = win = None
    else:
        x = (torch.randn(N, 3, generator=gen) * 0.3).to(dev)
        ctc = torch.randn(R, ct, generator=gen).to(dev) if ct else None
        cdc = torch.randn(R, cd, generator=gen).to(dev) if cd else None
        win = window_vec(10, 3, 7.5, device=dev)
    return mods, x, ctc, cdc, win, legacy


def check_kernels(results: list, profile: bool = False):
    """Each case's K1/K2 (and K1s/K2s where listed) against the plain
    version, timed; one JSON entry per kernel and case goes to ``results``
    (launches are filled in by the step phases)."""
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name, (_, N, S, _, _, need_dx, _, fwd_only, site, runs) in KERNEL_CASES.items():
        mods, x, ctc, cdc, win, legacy = build_case(name, gen, dev)
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
        splits = {"K2": k2_split(events)}
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
            splits["K2s"] = k2_split(ev_s)
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
                "registers": FM.build_library().moda_fmlp_registers(REGISTERS[kname]),
                "runs": ([["ft2_stash", s] for s in STASH_CASES[name]] if stash else
                         [list(r) for r in runs]),
                **splits.get(kname, {}),
            })
            split = " ".join(f"{k} {v:.3f}" for k, v in splits.get(kname, {}).items())
            print(f"[kernels] {kname} {name}: kernel {t_k:.3f} ms (device only {d_k:.3f}"
                  f"{'; ' + split if split else ''})  plain {t_p:.3f} ms  F.linear chain "
                  f"{t_c:.3f} ms  bound {max(t_ops, t_bytes):.3f} ms "
                  f"({'ops' if t_ops >= t_bytes else 'bytes'})", flush=True)


def k2_split(events) -> dict:
    """K2's device ms per call, by kernel: the block kernel, the dW GEMM and
    the reductions (the dW partials' and the others')."""
    return {"block_ms": device_ms(events, 3, ["fmlp_bwd"]),
            "dw_ms": device_ms(events, 3, ["fmlp_dw"]),
            "reduce_ms": device_ms(events, 3, ["fmlp_reduce"])}


def check_dw(results: list):
    """The dW GEMM alone at every backward call site of KERNEL_CASES, at the
    task shapes and rows K2 takes there (``fused_mlp.dw_task_shapes`` and
    ``bwd_geometry``): seeded random bf16 stacks (the sigma head reads the final layer's A, as
    in K2), ``dw_gemm`` against ``dw_gemm_plain`` per task (relative L2
    error <= 1e-4: both sum the same bf16 products in fp32, in another
    order), twice (bit-identical), timed beside the bound and one cuBLAS
    ``torch.matmul(A.t(), D)`` a task (``library_ms``). One JSON entry per
    site goes to ``results``."""
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(7)
    tol = 1e-4
    for name, (_, N, S, ct, cd, _, _, fwd_only, site, runs) in KERNEL_CASES.items():
        if fwd_only:
            continue
        tasks = FM.dw_task_shapes(case_nets(name), 63, ct, cd, S, emb=(3, 10, True))
        npad = FM.bwd_geometry(N, S).npad

        def randn(rows, cols):
            return torch.randn(rows, cols, generator=gen, device="cuda").to(torch.bfloat16)

        a_of = {j: randn(npad, kin) for j, (kin, _, first) in enumerate(tasks) if first == j}
        a = [a_of[first] for _, _, first in tasks]
        d = [randn(npad, nout) for _, nout, _ in tasks]
        n_launch = dict(FM.launches)
        out = FM.dw_gemm(a, d, npad, site=name)
        out2 = FM.dw_gemm(a, d, npad, site=name)
        ref = FM.dw_gemm_plain(a, d, npad)
        torch.cuda.synchronize()
        errs = [float((o - r).norm() / (r.norm() + 1e-12)) for o, r in zip(out, ref)]
        same = all(torch.equal(x, y) for x, y in zip(out, out2))
        max_abs = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        print(f"[dW] {name}: {len(tasks)} tasks, npad {npad}: worst rel_l2 {max(errs):.3e} "
              f"(tol {tol}), max|kernel-plain| {max_abs:.3e}; a second run bit-identical: "
              f"{same}", flush=True)
        if max(errs) > tol or not same:
            raise SystemExit(f"dW GEMM mismatch or not deterministic at {name}")

        def kernel():
            FM.dw_gemm(a, d, npad, site=name)

        t_k = cuda_time(kernel)
        _, events, _ = profiled(kernel, 3)
        d_k, d_r = device_ms(events, 3, ["fmlp_dw"]), device_ms(events, 3, ["fmlp_reduce_dw"])
        t_p = cuda_time(lambda: FM.dw_gemm_plain(a, d, npad))
        t_l = cuda_time(lambda: [torch.matmul(x.t(), y) for x, y in zip(a, d)])
        for k in FM.launches:  # timing launches are not main-path launches
            FM.launches[k] = n_launch[k]
        flops = sum(2 * npad * kin * nout for kin, nout, _ in tasks)
        nbytes = 2 * npad * (sum(kin for j, (kin, _, first) in enumerate(tasks) if first == j)
                             + sum(nout for _, nout, _ in tasks)) + \
            4 * sum(kin * nout for kin, nout, _ in tasks)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        smem, ctas = FM.footprints[f"dw:{name}"]
        regs = FM.build_library().moda_fmlp_registers(REGISTERS["dW"])
        results.append({
            "name": f"dW:{name}", "route": "cuda", "source": "moda_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "moda_tpu/ops/fused_mlp.py:245", "call_site": site, "launches": 0,
            "max_abs_err": max_abs, "rel_l2": max(errs), "ms": t_k, "plain_ms": t_p,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": t_l,
            "device_ms": d_k, "reduce_ms": d_r, "smem_bytes": smem, "ctas_per_sm": ctas,
            "registers": regs, "points": N, "npad": npad,
            "runs": [list(r) for r in runs] + [["ft2_stash", s] for s in
                                               STASH_CASES.get(name, [])],
        })
        print(f"[dW] {name}: kernel {t_k:.3f} ms (device {d_k:.3f} + reduce {d_r:.3f})  plain "
              f"{t_p:.3f} ms  cuBLAS {t_l:.3f} ms  bound {max(t_ops, t_bytes):.3f} ms "
              f"({'ops' if t_ops >= t_bytes else 'bytes'}); {smem} B, {ctas} CTAs/SM, "
              f"{regs} registers", flush=True)


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
        for kind, n in (("fwd", nf), ("bwd", nb), ("dw", nb)):
            if n:
                k = f"{kind}_stash" if stash and nb and kind != "dw" else kind
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
        r["launches"] += sum(calls.get(f"{counter_kind(r['name'], False)}:{site}:"
                                       f"{nets_of(site)}", 0)
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
        r["launches"] += sum(calls.get(f"{counter_kind(r['name'], True)}:{site}:"
                                       f"{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == "ft2_stash")
    return {"loss_stash": ls, "loss_remat": lr, "params_bit_identical": same,
            "remat_ms_per_step": times["remat"], "stash_ms_per_step": times["stash"],
            "rays_per_sec_stash": rays / (sum(times["stash"]) / 2e3)}


# ---------------------------------------------------------------- trainer
# stage 1 of scripts/template.sh:20-24, with the cuts listed in run_trainer
TRAINER_FLAGS = ["--lineload", "--batch_size", "256", "--nsample", "4", "--warmup_shape_ep", "1",
                 "--warmup_rootmlp", "--eikonal_wt", "0.001", "--noppr_eikonal", "--use_rtk_file",
                 "--num_epochs", "1", "--dskin_steps", "1"]
# the eval grid: 9 frames in 3 x 3 tiles, each of rgb, silhouette and flow
# columns (no observed columns: the line-shard datasets have no frame reader)
GRID_TILES, GRID_COLUMNS = 3, 3
TRAINER_FRAMES, TRAINER_IMG = 16, 128
# Below 100 vertices the trainer treats the rest mesh as absent (random bone
# centres, no surface samples). Read on the H100 with torch 2.11: 358 vertices
# after this phase's warmup; scripts/torch_trainer_probe.py warmup gives 372
# from the same initial parameters and CPU-drawn points on that machine's CPU
# and on the card, and 19,416-19,468 from the initializer of torch 2.13.
MIN_MESH_VERTS = 100


class _ProfiledLoader:
    """Wraps the trainer's loader: torch.profiler runs from the ``start``-th
    batch to the ``stop``-th (the device has finished every step before it
    then), so the window holds stop - start whole steps of the epoch."""

    def __init__(self, loader, start: int, stop: int):
        self.loader, self.start, self.stop, self.n = loader, start, stop, 0
        self.prof = self.t0 = self.wall = None
        self.overhead = 0.0  # s spent starting and stopping, inside the trainer's t_load

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __next__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        if self.n == self.start:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.n == self.stop:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
        if self.n in (self.start, self.stop):
            self.overhead += time.perf_counter() - t0
        self.n += 1
        return next(self.loader)


def check_grid_query(model, G: int = 32) -> float:
    """Relative L2 distance of the rest-mesh grid query (SDF and
    visibility) on the card from the same query on a CPU copy of the model,
    on a G^3 grid over the model's object bound: the CPU's plain fp32 path
    is the one the tests hold against the JAX package."""
    import numpy as np
    import torch
    from moda_tpu_torch.extract.mesh import make_grid_query

    b = model.mvars.obj_bound.cpu().numpy()
    axes = [np.linspace(-b[i], b[i], G, dtype=np.float32) for i in range(3)]
    pts = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3))
    got = torch.cat(make_grid_query(model)(pts.cuda())).cpu()
    want = torch.cat(make_grid_query(cpu_copy(model))(pts))
    return rel_l2(got, want)


def cpu_copy(model):
    """A copy of the model and its state on the CPU."""
    import copy
    cpu = copy.deepcopy(model).to("cpu")
    cpu.mvars = cpu.mvars.to("cpu")
    return cpu


def rel_l2(got, want) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def run_trainer(results: list, card: str, tmp: str, profile: bool = False) -> dict:
    """Stage 1 of the recipe through the port's CLI entry point, on a
    synthetic line-shard dataset written to ``tmp`` (a temporary directory
    under logdir/; the port's SynthScene in the layout of
    moda_tpu/preproc/pipeline.py::write_lines: Pixels/ rows, Cameras/,
    ground-truth Meshes/, placeholder JPEGImages/ names and the .config), at
    full widths and defaults (ndepth 128, 25 bones, D8 W256 trunk, 64^3
    extraction grid, 64 px eval grid).

    Cuts against a real stage 1 (template.sh:20-24):
    - warmup_shape_ep 1 instead of 5 (200 shape steps);
    - num_epochs 1 (200 steps) instead of 120;
    - --dskin_steps 1: at one epoch the default 0.8 gives int(1 * 0.8) = 0
      and would switch the delta-skin MLP on from the first step; a
      120-epoch stage 1 switches it on at epoch 96. With it every step has
      the init stage's signature (no fine pass, delta-skin or active
      sampling);
    - 16 synthetic frames at 128 px (~50 MB of rows) instead of a video.

    Checks (any failure exits non-zero): every logged step line (steps 0,
    50, 100, 150) has a finite total_loss and grad_finite == 1; the shape
    warmup's loss is finite; the epoch line carries mesh_verts, t_mesh and
    t_save, and the rest mesh after the shape warmup has more than
    MIN_MESH_VERTS vertices; the trained model's grid query on the card is
    within 1e-5 (relative L2) of the same query on the CPU;
    latest.* and the 1.* copy exist, and latest loads back through the
    port's ckpt bit-equal to the live parameters; eval-000.png exists with
    the grid's size in its header, and no eval_render_error is logged;
    K1/K2/dW launches over the run equal expected_calls("init", 200) at
    each call site (the shape warmup, the eikonal term, the extraction and
    the eval renders run the plain path). The dataset and the checkpoints
    stay in ``tmp`` for run_extract.
    --profile: device idle share over steps 100-109 of the epoch."""
    import numpy as np
    import torch
    from moda_tpu_torch import bridge
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train import ckpt as CK
    from moda_tpu_torch.train import trainer as TT
    from moda_tpu_torch.viz.render_vis import png_size

    steps = TT.ITERS_PER_EPOCH
    window = {}
    loader_cls = D.PairLoader
    if profile:
        def profiled_loader(*a, **k):
            window["loader"] = _ProfiledLoader(loader_cls(*a, **k), 100, 110)
            return window["loader"]
        D.PairLoader = profiled_loader
    try:
        t0 = time.time()
        write_line_dataset(os.path.join(tmp, "db"), os.path.join(tmp, "cfg"), "syn-smoke",
                           SynthScene(img_size=TRAINER_IMG, num_frames=TRAINER_FRAMES))
        t_data = time.time() - t0
        argv = ["--seqname", "syn-smoke", "--config_dir", os.path.join(tmp, "cfg"),
                "--logname", "smoke", "--checkpoint_dir", os.path.join(tmp, "log"),
                "--img_size", str(TRAINER_IMG)] + TRAINER_FLAGS
        print(f"[trainer] dataset of {TRAINER_FRAMES} frames at {TRAINER_IMG} px written in "
              f"{t_data:.1f} s; train_app flags {' '.join(argv[8:])}", flush=True)
        FM.reset_launches()
        t0 = time.time()
        tr = train_app.main(argv)
        torch.cuda.synchronize()
        t_run = time.time() - t0
        calls = dict(FM.launches_by_call)
        grid_err = check_grid_query(tr.model)
        rows = [json.loads(line) for line in open(tr.log_path)]
        saved = CK.load_checkpoint(os.path.join(tr.save_dir, "latest"))[0]
        same_ckpt = all(np.array_equal(bridge.flatten(saved)[n.replace(".", "/")],
                                       p.detach().cpu().numpy())
                        for n, p in tr.model.named_parameters())
        files = {t: all(os.path.exists(os.path.join(tr.save_dir, t + sfx))
                        for sfx in CK.SUFFIXES) for t in ("latest", "1")}
        grid_png = os.path.join(tr.save_dir, "eval-000.png")
        grid_size = png_size(grid_png) if os.path.exists(grid_png) else None
        rs = tr.cfg.render_size
    finally:
        D.PairLoader = loader_cls

    step_rows = [r for r in rows if "total_loss" in r]
    warm = [r for r in rows if "warmup_shape_time" in r]
    epoch = [r for r in rows if "epoch_time" in r]
    for r in step_rows:
        print(f"[trainer] step {r['step'] - 1}: total_loss {r['total_loss']:.6f} img "
              f"{r['img_loss']:.6f} sil {r['sil_loss']:.6f} flo {r['flo_loss']:.6f} grad_finite "
              f"{r['grad_finite']}", flush=True)
    fail = []
    if [r["step"] - 1 for r in step_rows] != list(range(0, steps, 50)):
        fail.append(f"logged steps {[r['step'] - 1 for r in step_rows]}")
    if not all(math.isfinite(r["total_loss"]) and r["grad_finite"] == 1.0 for r in step_rows):
        fail.append("a logged step has a non-finite loss or gradient")
    if len(warm) != 1 or not math.isfinite(warm[0]["shape_init_loss"]):
        fail.append("shape warmup loss missing or not finite")
    ep = epoch[0] if len(epoch) == 1 else {}
    if not all(k in ep for k in ("mesh_verts", "t_mesh", "t_save")):
        fail.append(f"epoch line {ep}")
    elif ep["mesh_verts"] <= MIN_MESH_VERTS:
        fail.append(f"the rest mesh after the shape warmup has {ep['mesh_verts']} vertices")
    if not grid_err <= 1e-5:
        fail.append(f"the grid query on the card is {grid_err:.2e} from the CPU's")
    if not all(files.values()) or not same_ckpt:
        fail.append(f"checkpoints {files}, latest bit-equal to the live parameters {same_ckpt}")
    want_grid = (GRID_TILES * rs, GRID_TILES * rs * GRID_COLUMNS)
    if grid_size != want_grid:
        fail.append(f"eval-000.png of size {grid_size}, not {want_grid}")
    errors = [r["eval_render_error"] for r in rows if "eval_render_error" in r]
    if errors:
        fail.append(f"eval_render_error {errors}")
    want = expected_calls("init", steps)
    print(f"[trainer] launches by call site over the run: {calls}", flush=True)
    if calls != want:
        fail.append(f"launches by call site {calls} != {want}")
    if fail:
        raise SystemExit("trainer: " + "; ".join(fail))
    for r in results:
        n = sum(calls.get(f"{counter_kind(r['name'], False)}:{site}:{nets_of(site)}", 0)
                for stage, site in r["runs"] if stage == "init")
        r["launches"] += n
        r["trainer_launches"] = n
    out = {"run_s": t_run, "data_s": t_data, "warmup_shape_s": warm[0]["warmup_shape_time"],
           "shape_init_loss": warm[0]["shape_init_loss"], "epoch_s": ep["epoch_time"],
           "steps_s": ep["t_steps"], "steps_per_s": ep["steps_per_s"],
           "ms_per_step": ep["t_steps"] / steps * 1e3, "mesh_verts": ep["mesh_verts"],
           "frac_occupied": ep["frac_occupied"], "grid_query_rel_l2_vs_cpu": grid_err,
           "losses": [r["total_loss"] for r in step_rows], "card": card,
           "eval_grid_size": list(grid_size), "render_size": rs,
           **{k: ep[k] for k in ("t_mesh", "t_save", "t_eval", "t_load", "t_upload",
                                 "t_dispatch", "t_fetch")}}
    print(f"[trainer] shape warmup {out['warmup_shape_s']:.2f} s (loss "
          f"{out['shape_init_loss']:.3e}); epoch {out['epoch_s']:.2f} s: {steps} steps in "
          f"{out['steps_s']:.2f} s ({out['steps_per_s']:.3f} steps/s, {out['ms_per_step']:.1f} "
          f"ms/step), t_load {ep['t_load']} t_upload {ep['t_upload']} t_dispatch "
          f"{ep['t_dispatch']} t_fetch {ep['t_fetch']} t_mesh {ep['t_mesh']} t_save "
          f"{ep['t_save']} t_eval {ep['t_eval']} s (eval grid {grid_size[0]} x {grid_size[1]} "
          f"px at render_size {rs}); rest mesh {ep['mesh_verts']} vertices (occupied share "
          f"{ep['frac_occupied']}); grid query rel L2 {grid_err:.2e} from the CPU's; whole "
          f"train_app.main {t_run:.2f} s ({card})", flush=True)
    lo = window.get("loader")
    if lo is not None and lo.wall:
        ka = lo.prof.key_averages()
        from torch.autograd import DeviceType
        dev = [e for e in ka if e.device_type != DeviceType.CPU]
        n = lo.stop - lo.start
        busy = sum(_dev_us(e, True) for e in dev) / 1e3
        out.update(window_steps=n, window_ms_per_step=lo.wall / n * 1e3,
                   profiler_start_stop_s=lo.overhead,
                   window_device_busy_ms_per_step=busy / n, window_idle_share=1 - busy / (
                       lo.wall * 1e3))
        print(f"[profile trainer] steps {lo.start}-{lo.stop - 1} under the profiler: "
              f"{lo.wall / n * 1e3:.2f} ms/step, device busy {busy / n:.2f} ms/step, idle share "
              f"{out['window_idle_share']:.3f}; starting and stopping it took {lo.overhead:.2f} s "
              f"of the epoch's t_load", flush=True)
        print_table("profile trainer", dev, n, True, 15)
    return out


# ------------------------------------------------------- extraction + eval
# scripts/eval_synth.sh:40-42's extract_app flags
EXTRACT_FLAGS = ["--lineload", "--nouse_human", "--nosymm_shape", "--test_frames", "{0}",
                 "--sample_grid3d", "128"]
# the card-against-CPU render: one 64 px frame with flow (4096 rays) in
# chunks of this many rays, the second padded, on both devices
CHECK_CHUNK = 3072


class _Timers(dict):
    """Seconds spent in wrapped calls, each call ended by a device sync."""

    def wrap(self, name, fn):
        import torch

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self[name] = self.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def wrap_factory(self, name, factory):
        """Time the calls of the functions that ``factory`` makes."""
        return lambda *a, **k: self.wrap(name, factory(*a, **k))


@contextlib.contextmanager
def _patched(patches):
    """Set (object, attribute, value) triples for the block."""
    old = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for o, n, v in patches:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def run_extract(card: str, tmp: str) -> dict:
    """Extraction and scoring, as scripts/eval_synth.sh runs them after
    training, on run_trainer's dataset and ``latest`` checkpoint in ``tmp``
    at full widths: ``extract_app.main`` with EXTRACT_FLAGS (128^3 grid,
    every frame of video 0 but its last, 64 px renders with ndepth 128 in
    chunks of 32,768 rays), ``evals.ama.main`` against the dataset's
    Meshes/ (10,000 samples a mesh, 20 ICP iterations) and
    ``eval_root_app.main`` against its Cameras/. Cuts against a real run:
    the checkpoint has one epoch of training behind it; 16 frames at
    128 px. Checks are listed in the module docstring; any failure exits
    non-zero. The launch counters are set to 0 before the phase and must
    read 0 after it: extraction, eval renders and scoring run the plain
    fp32 path."""
    import numpy as np
    import torch
    from moda_tpu_torch.cli import eval_root_app, extract_app
    from moda_tpu_torch.evals import ama
    from moda_tpu_torch.extract import mesh as EM
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.render.evalrender import make_frame_renderer

    seq, log = "syn-smoke", os.path.join(tmp, "log")
    export = os.path.join(log, "smoke-export")
    argv = ["--seqname", seq, "--config_dir", os.path.join(tmp, "cfg"), "--logname", "smoke",
            "--checkpoint_dir", log, "--model_path", os.path.join(log, "smoke", "latest"),
            "--img_size", str(TRAINER_IMG)] + EXTRACT_FLAGS
    print(f"[extract] extract_app flags {' '.join(argv[8:])}", flush=True)
    timers = _Timers()
    FM.reset_launches()
    t_phase = time.perf_counter()
    gt_dir = os.path.join(tmp, "db", "Meshes", "Full-Resolution", seq)
    cam_dir = os.path.join(tmp, "db", "Cameras", "Full-Resolution", seq)
    with _patched([(extract_app, "Trainer", timers.wrap("trainer_and_checkpoint",
                                                        extract_app.Trainer)),
                   (extract_app, "extract_mesh", timers.wrap("extract_mesh",
                                                             extract_app.extract_mesh)),
                   (EM, "make_grid_query", timers.wrap_factory("grid_query", EM.make_grid_query)),
                   (EM, "marching_cubes", timers.wrap("marching", EM.marching_cubes)),
                   (extract_app, "skin_colors", timers.wrap("skin_colors",
                                                            extract_app.skin_colors)),
                   (extract_app, "make_warp_fw_frames",
                    timers.wrap_factory("warps", extract_app.make_warp_fw_frames)),
                   (extract_app, "make_frame_renderer",
                    timers.wrap_factory("renders", extract_app.make_frame_renderer)),
                   (extract_app, "mesh_silhouette",
                    timers.wrap("silhouettes", extract_app.mesh_silhouette)),
                   (EM.Mesh, "export_obj", timers.wrap("obj_writes", EM.Mesh.export_obj)),
                   (ama, "load_obj", timers.wrap("ama_obj_reads", ama.load_obj))]):
        t0 = time.perf_counter()
        ex = extract_app.main(argv)
        t_app = time.perf_counter() - t0
        t0 = time.perf_counter()
        scores = ama.main([export, gt_dir])
        torch.cuda.synchronize()
        t_ama = time.perf_counter() - t0
    t0 = time.perf_counter()
    root = eval_root_app.main([os.path.join(export, f"{seq}-cam"), cam_dir,
                               str(len(os.listdir(cam_dir)) - 1)])
    t_root = time.perf_counter() - t0
    t_phase = time.perf_counter() - t_phase
    calls, counts = dict(FM.launches_by_call), dict(FM.launches)

    # the exports
    n_fr = ex.data_info.offset[1] - 1  # --test_frames {0}: video 0 but its last frame
    files = os.listdir(export)
    exported = {k: len([f for f in files if f.startswith(f"{seq}-{k}-0")])
                for k in ("mesh", "cam", "ctrajs", "refsil")}
    rest = ama.load_obj(os.path.join(export, f"{seq}-mesh-rest.obj"))
    warped = [ama.load_obj(os.path.join(export, f"{seq}-mesh-{i:05d}.obj")) for i in range(n_fr)]
    bad = [i for i, m in enumerate(warped)
           if m.vertices.shape != rest.vertices.shape or not np.isfinite(m.vertices).all()]
    rgb = np.load(os.path.join(export, f"{seq}-rgb.npy"))

    # the card against a CPU copy of the model, on the same inputs
    model, cpu, lv = ex.model, cpu_copy(ex.model), ex.latest_vars
    fids = list(range(n_fr))
    t0 = time.perf_counter()
    warp_card = EM.make_warp_fw_frames(model)(rest.vertices, fids)[0].cpu()
    t_warp_all = time.perf_counter() - t0
    warp_err = rel_l2(warp_card, EM.make_warp_fw_frames(cpu)(rest.vertices, fids)[0])
    rs, S, fi = ex.cfg.render_size, ex.cfg.ndepth, n_fr // 2
    px, py = float(lv["rtk"][fi][3, 2]), float(lv["rtk"][fi][3, 3])
    kaug = np.asarray([[max(2 * px / rs, 1e-6), max(2 * py / rs, 1e-6), 0.0, 0.0]], np.float32)
    g = torch.Generator().manual_seed(5)
    draws = {"vis_neg": torch.rand(CHECK_CHUNK, S, 3, generator=g) * 2 - 1,
             "symm_u": torch.rand(CHECK_CHUNK, S, 1, generator=g),
             "sigma_noise": torch.randn(CHECK_CHUNK, S, generator=g)}
    args = (lv["rtk"][fi][None], kaug, [fi], [0])
    kw = dict(rtk_target=lv["rtk"][fi + 1][None], frameid_target=[fi + 1], draws=draws)
    renders = {}
    for dev, m in (("card", model), ("cpu", cpu)):
        t0 = time.perf_counter()
        render = make_frame_renderer(m, rs, S, chunk=CHECK_CHUNK, with_flow=True)
        renders[dev] = render(*args, **kw)
        renders[dev + "_s"] = time.perf_counter() - t0
    render_err = {k: rel_l2(renders["card"][k], renders["cpu"][k]) for k in renders["cpu"]}

    fail = []
    if any(v != n_fr for v in exported.values()):
        fail.append(f"exported {exported}, not {n_fr} each")
    if bad or len(rest.vertices) == 0:
        fail.append(f"warped meshes {bad} not finite or not of the rest mesh's "
                    f"{len(rest.vertices)} vertices")
    n_rendered = int((lv["idk"][:n_fr] > 0).sum())  # frames the checkpoint has cameras for
    if rgb.shape != (n_rendered, rs, rs, 3):
        fail.append(f"rgb frames {rgb.shape}, not {n_rendered} at {rs} px")
    if not warp_err <= 1e-5:
        fail.append(f"make_warp_fw_frames on the card is {warp_err:.2e} from the CPU's")
    if not max(render_err.values()) <= 1e-4:
        fail.append(f"the frame render on the card is {render_err} from the CPU's")
    if not all(math.isfinite(v) for v in list(scores.values()) + list(root.values())) or \
            not all(0.0 <= v <= 1.0 for k, v in scores.items() if k.startswith("f@")):
        fail.append(f"scores {scores} {root}")
    if calls or any(counts.values()):
        fail.append(f"kernel launches in the phase: {calls}")
    out = {"extract_app_s": t_app, **{f"{k}_s": v for k, v in timers.items()},
           "ama_s": t_ama, "root_eval_s": t_root, "phase_s": t_phase,
           "warp_all_frames_one_call_s": t_warp_all, "rest_verts": len(rest.vertices),
           "rest_faces": len(rest.faces), "frames": n_fr, "exported": exported,
           "warp_rel_l2_vs_cpu": warp_err, "render_rel_l2_vs_cpu": render_err,
           "check_render_card_s": renders["card_s"], "check_render_cpu_s": renders["cpu_s"],
           "ama": scores, "root": root, "card": card}
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in timers.items())
    print(f"[extract] rest mesh {len(rest.vertices)} vertices at {ex.cfg.sample_grid3d}^3; "
          f"{n_fr} frames exported {exported}, {len(rgb)} rendered at {rs} px; extract_app.main "
          f"{t_app:.2f} s, AMA {t_ama:.2f} s, root eval {t_root:.3f} s, phase {t_phase:.2f} s; "
          f"parts (extract_mesh holds grid_query and marching; the OBJ reads are AMA's): "
          f"{parts} ({card})", flush=True)
    print(f"[extract] card against CPU: warps of {n_fr} frames rel L2 {warp_err:.2e} (tol "
          f"1e-5); one {rs} px frame with flow in chunks of {CHECK_CHUNK}: {render_err} (tol "
          f"1e-4), card {renders['card_s']:.2f} s, CPU {renders['cpu_s']:.2f} s", flush=True)
    print(f"[extract] AMA {json.dumps(scores)}; root {json.dumps(root)}; launches {calls}",
          flush=True)
    if fail:
        raise SystemExit("extract: " + "; ".join(fail))
    return out


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
    check_dw(results)
    print(f"[time] dW phase done at {time.time() - t0:.1f} s", flush=True)
    steps = {}
    for name in STAGES:
        steps[name] = run_stage(name, results, card, profile=args.profile)
        print(f"[time] {name} done at {time.time() - t0:.1f} s", flush=True)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logdir")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_", dir=base) as tmp:
        steps["trainer"] = run_trainer(results, card, tmp, profile=args.profile)
        print(f"[time] trainer done at {time.time() - t0:.1f} s", flush=True)
        steps["extract"] = run_extract(card, tmp)
        print(f"[time] extraction and eval done at {time.time() - t0:.1f} s", flush=True)
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
