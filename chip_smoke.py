"""Smoke run of the PyTorch/CUDA port on one H100.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile  # plus torch.profiler device-time tables
    python3 chip_smoke.py --plant gather  # phase 13 (b) alone, with a planted
                                          # fault (PLANTS); exits 0 iff caught

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
   flow within 1e-4; the rgb and silhouette GIFs with a frame per rendered
   frame; finite AMA and root-pose scores, F-scores in [0, 1];
   no kernel launch in the phase. It prints the time of each part;
8. the cold start and the frame-decoding route (``run_coldstart``): a
   16-frame 256 px articulated scene in the DAVIS layout, trained by
   train_app from the pose CNN's cameras (pose warmup, extract_cams_cnn,
   root preset, one 200-step epoch, the eval grid with observed columns),
   then 3 steps of the frame-decoding route at batch 256; read_raw timed at
   img_size 512 and the tests' JPEG fixture decoded (checks in its
   docstring);
9. the step's branches (``run_branches``): the ft2 stage with the
   displacement field nerf_dis (K1/K2/dW at its dis_bw and dis_fw sites, K1
   at dis_bw_coarse; the loss less the eikonal term gated at 2e-2, that
   term at EKL_DIS_TOL), one step each of flowbw without bones, S3IM,
   freeze_coarse (frozen gradients exactly zero) and accu_steps 2 against
   the plain fp32 step, ft_cse through train_app on phase 8's dataset (the
   frame route, 2 steps at batch 256) and CSEDistiller's loss falling;
10. the viz tools and the pretrained posenet (``run_viz``) on the artifacts
   of phases 6-8: ``nvs_app.main`` replay and bullet time on phase 6's
   checkpoint and its ctraj route on phase 7's exports (GIFs and PNGs, one
   frame against a CPU copy, no kernel launch), ``match_app.main`` on
   phase 8's scene (one K1 launch at feat_grid, points and pixels against
   a CPU copy), and the ``--pose_cnn_path`` route with a reference-layout
   posenet .pth (checks in its docstring);
11. preprocessing (``run_preproc``): VCN+ at its published widths with seeded
   weights, one pair on the card against a CPU copy and pairs timed at the
   ~2 MP protocol, then ``preproc_app.main`` on phase 8's scene (frames,
   masks, zero CSE features, VCN flow, config, line shards; no fused-MLP
   launch) and its refusals (checks in its docstring);
12. the detectron2 preprocessing graphs (``run_preproc_graphs``): PointRend
   and DensePose-CSE on the ResNet-50 + FPN backbone at their published
   widths with seeded weights, each on one frame on the card against a CPU
   copy and timed over phase 8's 16 frames, then ``preproc_app.main`` with
   their npz files and no --mask_dir: PointRend's masks, CSE features, VCN
   flow, line shards, no fused-MLP launch (checks in its docstring);
13. K optimizer steps a call and data parallelism (``run_parallel``): the
   chunked init step against K calls, two ranks on the one card (gloo)
   against the one-process step and a one-rank NCCL world, and
   ``train_app.main`` as two ranks with --steps_chunk 10 on phase 6's
   dataset (checks and cuts in its docstring).
The main-path launch counts of phases 5, 6, 8, 9, 10 and 13 go into the
kernel JSON's ``launches``; the dis cases of phases 3 and 4 are phase 9's.
Prints the kernel JSON line, then {"ok": true, "device": {...}} last.
Exits non-zero without printing a result when there is no CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores: the preprocessing graphs (TF32 off)
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
DIS = [(5, 128, 0, 3, True, True, False)]
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
                  [("init", "feat_grid"), ("ft1", "feat_grid"), ("ft2", "feat_grid"),
                   ("match", "feat_grid")]),
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
    # the displacement field nerf_dis (the branches phase's ft2 stage): both
    # warps, and the backward warp of the fine sampling's no-grad coarse pass
    "dis_r2048_s128": (DIS, 262144, 128, 128, 0, True, "raw", False, f"{P}:87-90,115-118",
                       [("ft2_dis", "dis_bw"), ("ft2_dis", "dis_fw")]),
    "dis_coarse": (DIS, 131072, 64, 128, 0, True, "raw", True, f"{P}:87-90 (via :537)",
                   [("ft2_dis", "dis_bw_coarse")]),
}
# K1s/K2s are checked and timed at these cases; they serve the ft2 stash run
STASH_CASES = {"trunk_feat_r2048": ["trunk_feat"], "skin_r2048_s128": ["skin_bw", "skin_fw"]}
# two backwards on the same inputs must give bit-identical gradients here
DETERMINISM_CASE = "trunk_feat_r2048"

# the nets of each call site, as the wrapper's launch counter names them
NETS = {"trunk_feat": "D8W256o3+D5W128o16", "feat_grid": "D5W128o16", "vis": "D5W64o1",
        "skin": "D5W64o25c128", "unc": "D8W256o1", "dis": "D5W128o3c128"}


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
    # the branches phase (run_branches): ft2 with the displacement field, and
    # one step each of init's shapes with a branch of the step
    "ft2_dis": (dict(nsample=4, use_unc=True, eikonal_wt=0.1, nerf_dis=True), 2, 2, True, True),
    "flowbw": (dict(nsample=4, eikonal_wt=0.001, flowbw=True, lbs=False, neudbs=False), 4, 0,
               False, False),
    "s3im": (dict(nsample=4, eikonal_wt=0.001, s3im_loss=True), 4, 0, False, False),
    "freeze_coarse": (dict(nsample=4, eikonal_wt=0.001, freeze_coarse=True), 4, 0, False, False),
    "accu2": (dict(nsample=4, eikonal_wt=0.001, accu_steps=2), 4, 0, False, False),
}
# the ft2 stage with nerf_dis: its eikonal term's tolerance (run_stage)
EKL_DIS_TOL = 1e-1
# the stage phases' stages (phase 5); the others run in the branches phase
RECIPE_STAGES = ("init", "ft1", "ft2")
BRANCH_STEPS = ("flowbw", "s3im", "freeze_coarse", "accu2")
# call sites each step launches: site -> (forward, backward) launches per step
SITES = {
    "init": {"trunk_feat": (1, 1), "feat_grid": (1, 1), "vis": (1, 1)},
    "ft1": {"skin_bw": (1, 1), "skin_fw": (1, 1), "trunk_feat": (1, 1), "feat_grid": (1, 1),
            "skin_reproj": (1, 1), "vis": (1, 1)},
    "ft2": {"unc_scores": (1, 0), "skin_bw_coarse": (1, 0), "trunk_feat_coarse": (1, 0),
            "skin_bw": (1, 1), "skin_fw": (1, 1), "trunk_feat": (1, 1), "feat_grid": (1, 1),
            "skin_reproj": (1, 1), "vis": (1, 1), "unc_pred": (1, 1)},
    "ft2_dis": {"unc_scores": (1, 0), "skin_bw_coarse": (1, 0), "dis_bw_coarse": (1, 0),
                "trunk_feat_coarse": (1, 0), "skin_bw": (1, 1), "dis_bw": (1, 1),
                "skin_fw": (1, 1), "dis_fw": (1, 1), "trunk_feat": (1, 1), "feat_grid": (1, 1),
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


def one_step(step, batch, extras, generator=None, draws=None):
    """One optimizer step through a step of chunk_steps=1: the batch stacked
    [1, ...] in, the outputs' slice 0 out."""
    auxs, hosts = step({k: v[None] for k, v in batch.items()}, extras, generator=generator,
                       draws=None if draws is None else [draws])
    return {k: v[0] for k, v in auxs.items()}, {k: v[0] for k, v in hosts.items()}


def profile_steps(tag, step, batch, extras, gen, step_s: float, n: int = 2):
    """Where the step's time goes on the device: torch.profiler over n
    kernel-path steps; prints device time by kernel and by PyTorch op and
    the device's idle share of the step."""
    ops, dev, busy = profiled(lambda: one_step(step, batch, extras, generator=gen), n)
    n_dev = sum(e.count for e in dev) / n
    print(f"[profile {tag}] device busy {busy:.2f} ms of {step_s * 1e3:.2f} ms/step "
          f"(idle share {1 - busy / (step_s * 1e3):.3f}); {n_dev:.0f} device activities "
          f"per step; fused-MLP kernels {device_ms(dev, n, ['fmlp_']):.2f} ms", flush=True)
    print_table(f"profile {tag}", dev, n, True, 25)
    print_table(f"profile {tag}", ops, n, False, 40)
    return busy


def stage_draws(name, cfg, model, plain, batch, extras, rays: int, seed: int = 1):
    """The draws of one step of ``name``, the same for the kernel and the
    plain path, including the active-sampling selection (the plain path's
    ranking); prints how many selections the two rankings share."""
    import torch
    from moda_tpu_torch.core import camera as cam
    from moda_tpu_torch.render.rays import active_sample_ids
    from moda_tpu_torch.train.step import batch_rtk

    _, ns, na, use_fine, _ = STAGES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
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
    if cfg.s3im_loss:
        draws["s3im_perm"] = torch.stack([torch.randperm(1024, **kw) for _ in range(9)])
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
    aux_p, _ = one_step(step_p, batch, extras, draws=draws)
    aux_k, _ = one_step(step_k, batch, extras, draws=draws)
    torch.cuda.synchronize()
    lk, lp = float(aux_k["total_loss"]), float(aux_p["total_loss"])
    # bf16 kernel path against the fp32 plain path from the same parameters
    # and draws: the MLP outputs differ by bf16 rounding (~1e-3 relative)
    loss_tol = 2e-2
    if cfg.nerf_dis:
        # The displacement field moves every canonical point by its bf16
        # output (~4e-3 from the fp32 one at random weights), and the eikonal
        # term (weight 0.1, ~80% of ft2's loss) differentiates 2^9-frequency
        # features there: it read 3.9% apart in this phase's first run while
        # the rest of the loss read 0.8% (NVIDIA H100 80GB HBM3, 700 W). The
        # loss less that term is gated at loss_tol, the term at EKL_DIS_TOL.
        ek, ep = float(aux_k["ekl_loss"]), float(aux_p["ekl_loss"])
        rel_ekl = abs(ek - ep) / max(abs(ep), 1e-12)
        print(f"[{name}] eikonal term: kernel {ek:.6f} plain {ep:.6f} rel diff {rel_ekl:.3e} "
              f"(tol {EKL_DIS_TOL})", flush=True)
        if not rel_ekl <= EKL_DIS_TOL:
            raise SystemExit(f"{name}: the kernel path's eikonal term disagrees with the plain "
                             "path's")
        lk, lp = lk - ek, lp - ep
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    print(f"[{name}] one step, same inputs: kernel loss {lk:.6f}  plain loss {lp:.6f}"
          f"{' (less the eikonal term)' if cfg.nerf_dis else ''}  rel diff {rel:.3e} "
          f"(tol {loss_tol})", flush=True)
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
        one_step(step_k, batch, extras, generator=gen)
    torch.cuda.synchronize()
    FM.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n_timed):
        aux, _ = one_step(step_k, batch, extras, generator=gen)
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
    one_step(step_p, batch, extras, generator=gen)
    torch.cuda.synchronize()
    n_plain = 3
    t0 = time.perf_counter()
    for _ in range(n_plain):
        one_step(step_p, batch, extras, generator=gen)
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
            aux[m], _ = one_step(steps[m], batch, extras, draws=draws)
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
            one_step(steps[turn], batch, extras, generator=gen)
            torch.cuda.synchronize()
            if turn == "stash" and not times["stash"]:
                FM.reset_launches()
            t0 = time.perf_counter()
            for _ in range(n):
                one_step(steps[turn], batch, extras, generator=gen)
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
    then), so the window holds stop - start whole steps of the epoch; both
    ends must fall on a chunk's first batch."""

    def __init__(self, loader, start: int, stop: int):
        self.loader, self.start, self.stop, self.n = loader, start, stop, 0
        self.prof = self.t0 = self.wall = None
        self.overhead = 0.0  # s spent starting and stopping, inside the trainer's t_load

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def next_chunk(self, k: int):
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
        self.n += k
        return self.loader.next_chunk(k)


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
    for kind in ("rgb", "sil"):
        fail += check_gif(os.path.join(export, f"{seq}-{kind}.gif"), n_rendered, rs, rs)
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
          f"{n_fr} frames exported {exported}, {n_rendered} rendered at {rs} px; extract_app.main "
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


# ------------------------------------------------ cold start + frame route
# stage 1 of scripts/template.sh:20-24 from a video without cameras: the
# pose-CNN warmup instead of --use_rtk_file (the cuts are run_trainer's)
COLDSTART_FLAGS = ["--batch_size", "256", "--nsample", "4", "--warmup_shape_ep", "1",
                   "--warmup_rootmlp", "--eikonal_wt", "0.001", "--noppr_eikonal",
                   "--num_epochs", "1", "--dskin_steps", "1"]
COLDSTART_FRAMES, COLDSTART_IMG = 16, 256
FRAME_ROUTE_STEPS = 3  # the frame-decoding route's epoch, cut from 200 steps
# frames whose CSE features are mirrored left to right (DensePose's typical
# failure), so that the OOD check rejects them and their rotations are
# substituted from the nearest accepted frame
MIRRORED_CSE_FRAMES = (2, 5, 9, 13)
READ_RAW_SIZE = 512  # the recipe's default img_size, for the read_raw timing
# the eval grid with a frame reader: observed image, rgb, silhouette, flow
# and feature error
COLDSTART_COLUMNS = 5


class _HostTimer:
    """Seconds and calls of a host function, summed over the threads that
    call it; ``timed`` is the function to patch in (a plain function, so it
    binds as a method where it replaces one)."""

    def __init__(self, fn):
        import threading
        self.s, self.n, lock = 0.0, 0, threading.Lock()

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            with lock:
                self.s += time.perf_counter() - t0
                self.n += 1
            return out
        self.timed = timed


def _so3_deg(r_pred, r_gt):
    import numpy as np
    cos = (np.trace(r_pred @ np.swapaxes(r_gt, -1, -2), axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def run_coldstart(results: list, card: str, tmp: str) -> dict:
    """The cold-start route of stage 1 (a DAVIS-layout video with frames,
    masks, flow and CSE features but no camera files in use), at full
    widths, on a 16-frame 256 px MeshScene (data/synth_mesh.py, the
    articulated "a-flap" fixture) written by ``write_frame_dataset`` (PNG
    bytes under the DAVIS .jpg names) with line shards cut from its frames
    by ``write_lines``, into ``tmp``; the CSE features of MIRRORED_CSE_FRAMES
    are mirrored left to right first:

    1. ``train_app.main`` with COLDSTART_FLAGS, ``--lineload --img_size 256
       --prior_mesh_path <prior.pkl> --warmup_pose_ep 1``: the shape warmup,
       200 pose-CNN steps at batch 16, ``extract_cams_cnn`` over all 16
       frames through the frame reader, ``preset_rootmlp``, one 200-step
       epoch and the 64 px eval grid with its observed columns;
    2. the frame-decoding route: the same flags without ``--lineload`` and
       with ``--use_rtk_file`` (cameras from Cameras/) and ``--render_size
       0``, its epoch cut to FRAME_ROUTE_STEPS steps (the trainer's
       ITERS_PER_EPOCH patched here, as run_extract patches its timers),
       batch 256, every pair decoded and cropped by the loader's threads;
    3. ``FrameReader.read_raw`` timed at img_size 512 over the 16 frames,
       and the JPEG fixture of the tests decoded by this machine's build.

    Checks (any failure exits non-zero): the warmup's rotation loss finite
    and below its first logged value; pose_cnn.npz and 16 finite init-cam
    files, ``extract_cams_n`` 16; eval-000.png with the observed-image and
    feature-error columns, no ``eval_render_error`` or unreadable eval
    frame; K1/K2/dW launches exactly expected_calls("init", 200) in run 1
    and expected_calls("init", FRAME_ROUTE_STEPS) in run 2, with finite
    losses; the trained PoseCNN's forward on the card within 1e-4
    (relative L2) of a CPU copy on one warmup batch; the fixture within one
    level of cv2's stored pixels; ``extract_cams_valid`` strictly between 0
    and 1 (the OOD check accepts the frames whose features are not mirrored
    and rejects some that are). Reported, not gated: the CNN cameras' median
    SO(3) error against the dataset's Cameras/."""
    import copy

    import numpy as np
    import torch
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.data import frames as F
    from moda_tpu_torch.data import imageio as IO
    from moda_tpu_torch.data.pfm import read_pfm, write_pfm
    from moda_tpu_torch.data.synth_mesh import MeshScene
    from moda_tpu_torch.data.synthetic import write_frame_dataset, write_lines
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train import trainer as TT
    from moda_tpu_torch.train.warmup_pose import render_pose_batch
    from moda_tpu_torch.viz.render_vis import png_size

    seq, db, cfg_dir = "flap-smoke", os.path.join(tmp, "cdb"), os.path.join(tmp, "ccfg")
    parts = {}
    t0 = time.perf_counter()
    write_frame_dataset(db, cfg_dir, seq, MeshScene(img_size=COLDSTART_IMG,
                                                    num_frames=COLDSTART_FRAMES))
    for i in MIRRORED_CSE_FRAMES:
        feat = os.path.join(db, "Densepose", "Full-Resolution", seq, "feat-%05d.pfm" % i)
        write_pfm(feat, np.ascontiguousarray(read_pfm(feat)[0][:, ::-1]))
    parts["write_frames_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_lines(db, seq, COLDSTART_IMG, D.build_datasets(seq, COLDSTART_IMG, cfg_dir))
    parts["write_lines_s"] = time.perf_counter() - t0
    prior = os.path.join(db, "Densepose", "Full-Resolution", seq, "prior.pkl")
    base = ["--seqname", seq, "--config_dir", cfg_dir, "--checkpoint_dir",
            os.path.join(tmp, "clog"), "--img_size", str(COLDSTART_IMG)] + COLDSTART_FLAGS
    argv = base + ["--logname", "cold", "--lineload", "--prior_mesh_path", prior,
                   "--warmup_pose_ep", "1"]
    print(f"[coldstart] {COLDSTART_FRAMES} frames at {COLDSTART_IMG} px and their line shards "
          f"written in {parts['write_frames_s']:.1f} + {parts['write_lines_s']:.1f} s; "
          f"train_app flags {' '.join(argv[6:])}", flush=True)

    FM.reset_launches()
    t0 = time.perf_counter()
    tr = train_app.main(argv)
    torch.cuda.synchronize()
    parts["run_s"] = time.perf_counter() - t0
    calls = dict(FM.launches_by_call)
    rows = [json.loads(line) for line in open(tr.log_path)]
    warm = [r for r in rows if "warmup_pose_rot_loss" in r]
    cams = [r for r in rows if "extract_cams_n" in r]
    epoch = [r for r in rows if "epoch_time" in r]
    step_rows = [r for r in rows if "total_loss" in r]
    cam_dir = os.path.join(tr.save_dir, "init-cam")
    cam_files = sorted(os.listdir(cam_dir)) if os.path.isdir(cam_dir) else []
    pred = np.stack([np.loadtxt(os.path.join(cam_dir, f)) for f in cam_files]) \
        if cam_files else np.zeros((0, 4, 4))
    gt = np.stack([np.loadtxt(os.path.join(db, "Cameras", "Full-Resolution", seq, "%05d.txt" % i))
                   for i in range(COLDSTART_FRAMES)])
    so3 = _so3_deg(pred[:, :3, :3], gt[:len(pred), :3, :3]) if len(pred) else np.zeros(0)
    grid_png = os.path.join(tr.save_dir, "eval-000.png")
    grid_size = png_size(grid_png) if os.path.exists(grid_png) else None
    rs = tr.cfg.render_size

    # the trained CNN on the card against a CPU copy, on one warmup batch
    net = tr.pose_cnn.net
    feats, _ = render_pose_batch(tr.prior_verts_unit, tr.prior_faces, tr.prior_embeds,
                                 tr.pose_cnn.d_mean, 16, np.random.default_rng(0))
    with torch.no_grad():
        cnn_card = net(torch.as_tensor(feats, device=tr.device)).cpu()
        cnn_cpu = copy.deepcopy(net).cpu()(torch.as_tensor(feats))
    cnn_err = rel_l2(cnn_card, cnn_cpu)
    # the CNN's optimizer step alone (no host rendering), and a batch's rendering
    rtk = torch.as_tensor(render_pose_batch(tr.prior_verts_unit, tr.prior_faces,
                                            tr.prior_embeds, tr.pose_cnn.d_mean, 16,
                                            np.random.default_rng(1))[1])
    t0 = time.perf_counter()
    for i in range(5):
        render_pose_batch(tr.prior_verts_unit, tr.prior_faces, tr.prior_embeds,
                          tr.pose_cnn.d_mean, 16, np.random.default_rng(i))
    parts["render_pose_batch_s"] = (time.perf_counter() - t0) / 5
    parts["cnn_step_ms"] = cuda_time(lambda: tr.pose_cnn.step(feats, rtk.numpy()), iters=20,
                                     warmup=3)

    # 2. the frame-decoding route
    argv2 = base + ["--logname", "frames", "--use_rtk_file", "--render_size", "0"]
    timer = _HostTimer(F.FrameReader.read_raw)
    FM.reset_launches()
    t0 = time.perf_counter()
    with _patched([(TT, "ITERS_PER_EPOCH", FRAME_ROUTE_STEPS), (F.FrameReader, "read_raw", timer.timed)]):
        tr2 = train_app.main(argv2)
        torch.cuda.synchronize()
    parts["frame_route_run_s"] = time.perf_counter() - t0
    calls2 = dict(FM.launches_by_call)
    rows2 = [json.loads(line) for line in open(tr2.log_path)]
    ep2 = [r for r in rows2 if "epoch_time" in r]
    steps2 = [r for r in rows2 if "total_loss" in r]
    read_raw_s = timer.s / max(timer.n, 1)

    # 3. read_raw at img_size 512, one thread; the JPEG fixture
    reader = D.build_datasets(seq, READ_RAW_SIZE, cfg_dir)[0].reader
    t0 = time.perf_counter()
    for i in range(COLDSTART_FRAMES):
        reader.read_raw(i, flowfw=i < COLDSTART_FRAMES - 1, dframe=1)
    read_raw_512_s = (time.perf_counter() - t0) / COLDSTART_FRAMES
    here = os.path.dirname(os.path.abspath(__file__))
    z = np.load(os.path.join(here, "tests", "goldens", "torch_jpeg_fixture.npz"))
    jpeg_err = int(max(np.abs(IO.decode_jpeg(z["jpeg"].tobytes()).astype(int) - z["rgb"]).max(),
                       np.abs(IO.decode_jpeg(z["jpeg"].tobytes(), gray=True).astype(int)
                              - z["grey"]).max()))

    fail = []
    w = warm[0] if len(warm) == 1 else {}
    curve = w.get("warmup_pose_rot_loss_t", [])
    if not (curve and math.isfinite(w["warmup_pose_rot_loss"])
            and w["warmup_pose_rot_loss"] < curve[0]):
        fail.append(f"pose warmup rotation loss {w.get('warmup_pose_rot_loss')} against its "
                    f"first logged {curve[:1]}")
    if not os.path.exists(os.path.join(tr.save_dir, "pose_cnn.npz")):
        fail.append("no pose_cnn.npz")
    if len(cam_files) != COLDSTART_FRAMES or not np.isfinite(pred).all() or \
            not cams or cams[0]["extract_cams_n"] != COLDSTART_FRAMES:
        fail.append(f"init-cam files {len(cam_files)}, extract_cams {cams}")
    elif not 0 < cams[0]["extract_cams_valid"] < 1:
        fail.append(f"the OOD check accepted a share {cams[0]['extract_cams_valid']} of the "
                    f"frames, {len(MIRRORED_CSE_FRAMES)} of them with mirrored features")
    want_grid = (3 * rs, 3 * rs * COLDSTART_COLUMNS)
    if grid_size != want_grid:
        fail.append(f"eval-000.png of size {grid_size}, not {want_grid}")
    bad = [r for r in rows if "eval_render_error" in r or "eval_frames_unreadable" in r]
    if bad:
        fail.append(f"eval grid faults {bad}")
    if not step_rows or not all(math.isfinite(r["total_loss"]) for r in step_rows):
        fail.append("a logged step of the cold-start epoch is not finite")
    want = expected_calls("init", TT.ITERS_PER_EPOCH)
    if calls != want:
        fail.append(f"cold-start launches by call site {calls} != {want}")
    if not cnn_err <= 1e-4:
        fail.append(f"the PoseCNN on the card is {cnn_err:.2e} from the CPU's")
    want2 = expected_calls("init", FRAME_ROUTE_STEPS)
    if calls2 != want2:
        fail.append(f"frame-route launches by call site {calls2} != {want2}")
    if not steps2 or not all(math.isfinite(r["total_loss"]) for r in steps2) or len(ep2) != 1:
        fail.append(f"frame-route steps {steps2} epochs {len(ep2)}")
    if not jpeg_err <= 1:
        fail.append(f"the JPEG fixture decodes {jpeg_err} levels from cv2's pixels")

    ep = epoch[0] if epoch else {}
    out = {**parts, "warmup_pose_s": w.get("warmup_pose_time"),
           "warmup_pose_rot_loss": w.get("warmup_pose_rot_loss"),
           "warmup_pose_rot_loss_t": curve, "pose_cnn_rel_l2_vs_cpu": cnn_err,
           "extract_cams_s": cams[0].get("extract_cams_time") if cams else None,
           "extract_cams_valid": cams[0].get("extract_cams_valid") if cams else None,
           "so3_median_deg": float(np.median(so3)) if len(so3) else None,
           "so3_deg": [round(float(a), 2) for a in so3],
           "epoch_s": ep.get("epoch_time"), "steps_s": ep.get("t_steps"),
           "t_eval": ep.get("t_eval"), "t_load": ep.get("t_load"),
           "eval_grid_size": list(grid_size) if grid_size else None,
           "frame_route_t_load_per_step_s": ep2[0]["t_load"] / FRAME_ROUTE_STEPS if ep2 else None,
           "frame_route_epoch_s": ep2[0]["epoch_time"] if ep2 else None,
           "frame_route_split": {k: ep2[0][k] for k in ("t_load", "t_upload", "t_dispatch",
                                                        "t_fetch", "t_mesh", "t_save")}
           if ep2 else None,
           "read_raw_s": read_raw_s, "read_raw_calls": timer.n,
           "read_raw_512_s": read_raw_512_s, "jpeg_fixture_max_abs": jpeg_err, "card": card}
    print(f"[coldstart] run 1 (train_app --lineload --warmup_pose_ep 1) {parts['run_s']:.2f} s: "
          f"pose warmup {out['warmup_pose_s']} s ({TT.ITERS_PER_EPOCH} steps at batch 16; "
          f"rotation loss {curve[:1]} -> {out['warmup_pose_rot_loss']}), CNN step "
          f"{parts['cnn_step_ms']:.2f} ms alone, a batch's host rendering "
          f"{parts['render_pose_batch_s'] * 1e3:.1f} ms; extract_cams_cnn "
          f"{out['extract_cams_s']} s over {len(cam_files)} frames (valid share "
          f"{out['extract_cams_valid']}); SO(3) error against Cameras/ median "
          f"{out['so3_median_deg']} deg; epoch {out['epoch_s']} s (steps {out['steps_s']} s, "
          f"t_load {out['t_load']}, t_eval {out['t_eval']}); eval grid {grid_size}; PoseCNN "
          f"card against CPU rel L2 {cnn_err:.2e} ({card})", flush=True)
    bs = COLDSTART_FLAGS[COLDSTART_FLAGS.index("--batch_size") + 1]
    print(f"[coldstart] run 2 (the frame-decoding route, {FRAME_ROUTE_STEPS} steps at batch "
          f"{bs}) {parts['frame_route_run_s']:.2f} s: t_load "
          f"{out['frame_route_t_load_per_step_s']} s a step (epoch {out['frame_route_epoch_s']} s: "
          f"{out['frame_route_split']}), read_raw {read_raw_s * 1e3:.1f} ms "
          f"a call over {timer.n} calls in the loader's threads at img_size {COLDSTART_IMG}; "
          f"read_raw at img_size {READ_RAW_SIZE} on one thread {read_raw_512_s * 1e3:.1f} ms; "
          f"JPEG fixture max abs {jpeg_err}; launches {calls2}", flush=True)
    if fail:
        raise SystemExit("coldstart: " + "; ".join(fail))
    for r in results:
        n = sum(c.get(f"{counter_kind(r['name'], False)}:{site}:{nets_of(site)}", 0)
                for c in (calls, calls2) for stage, site in r["runs"] if stage == "init")
        r["launches"] += n
        r["coldstart_launches"] = n
    return out


# ------------------------------------------------------------- branches
FT_CSE_BATCH = 256  # pairs: 512 full 256 px crops through the CSE net a step
FT_CSE_STEPS = 2    # the ft_cse epoch, cut from 200 steps (the frame route's t_load)
DISTILL_STEPS, DISTILL_SIZE = 20, 224


def run_branch_step(name: str, results: list, card: str) -> dict:
    """One step of ``name`` (STAGES) at init's shapes (2048 rays) on the
    kernel path against one plain fp32 step from the same parameters and
    draws (total loss within 2e-2, gradients finite), its launches per call
    site exactly init's (accu2: twice, one set a micro-batch). freeze_coarse
    distils against a snapshot of the input-layer kernels moved by 0.01, and
    its frozen gradients must be exactly zero on the card (Adam's first
    moment after one step from zero is a tenth of the gradient). flowbw's
    gate leaves proj_loss out (reason at the gate)."""
    import copy
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train.optim import INPUT_LAYERS, POS_DIM, MoDAOptimizer, group_of
    from moda_tpu_torch.train.step import make_train_step, micro_batches

    _, ns, na, use_fine, use_dskin = STAGES[name]
    cfg, model, batch, extras, rays = make_stage(name, "cuda")
    plain = copy.deepcopy(model)
    plain.cfg = cfg.replace(use_pallas=False)
    snap = None
    if cfg.freeze_coarse:
        g = torch.Generator(device="cuda").manual_seed(4)
        snap = {c: {l: getattr(model, c).get_submodule(l).kernel.detach() + 0.01 * torch.randn(
            getattr(model, c).get_submodule(l).kernel.shape, generator=g, device="cuda")
            for l in INPUT_LAYERS} for c in ("nerf_coarse", "nerf_feat")}
    kw = dict(nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
              use_bones=model.has_bones, nsample_active=na, xyz_wt_snapshot=snap,
              accu_steps=cfg.accu_steps)
    opts = {m: MoDAOptimizer(cfg, total_steps=24000) for m in ("kernel", "plain")}
    step_k = make_train_step(model, opts["kernel"], **kw)
    step_p = make_train_step(plain, opts["plain"], **kw)
    if cfg.accu_steps > 1:
        draws = [stage_draws(name, cfg, model, plain, mb, extras, rays // cfg.accu_steps,
                             seed=1 + j)
                 for j, mb in enumerate(micro_batches(batch, cfg.accu_steps))]
    else:
        draws = stage_draws(name, cfg, model, plain, batch, extras, rays)
    aux_p, _ = one_step(step_p, batch, extras, draws=draws)
    torch.cuda.synchronize()
    FM.reset_launches()
    t0 = time.perf_counter()
    aux_k, _ = one_step(step_k, batch, extras, draws=draws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    calls = dict(FM.launches_by_call)
    # Without bones kp_reproj projects the feat-match points straight from
    # canonical space: at random weights some land near the camera plane,
    # where the perspective division turns the bf16 feat-match's rounding
    # into a different proj_loss (2.3x apart on the CPU at a small size).
    # That term is printed, the rest of the loss gated.
    skip = ("proj_loss",) if cfg.flowbw else ()
    lk, lp = (float(a["total_loss"]) - sum(float(a[k]) for k in skip) for a in (aux_k, aux_p))
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    terms = {k: (float(aux_k[k]), float(aux_p[k])) for k in
             ("s3im_loss", "shape_xyz_wt_loss", "feat_xyz_wt_loss", "cyc_loss", "proj_loss")
             if k in aux_k}
    print(f"[branches] {name}: one step, same inputs: kernel loss {lk:.6f}  plain loss "
          f"{lp:.6f}{' (less ' + ', '.join(skip) + ')' if skip else ''}  rel diff {rel:.3e} "
          f"(tol 2e-2); {terms}; kernel step {dt * 1e3:.1f} ms with the first call's "
          f"overheads ({card}); launches {calls}", flush=True)
    fail = []
    if not (rel <= 2e-2 and math.isfinite(lk)) or float(aux_k["grad_finite"]) != 1.0:
        fail.append("the kernel-path step disagrees with the plain step or is not finite")
    want = expected_calls("init", cfg.accu_steps)
    if calls != want:
        fail.append(f"launches by call site {calls} != {want}")
    if cfg.flowbw and any(n.startswith(("bones", "nerf_skin", "nerf_dis"))
                          for n, _ in model.named_parameters()):
        fail.append("the flowbw model has bones")
    out = {"loss_kernel": lk, "loss_plain": lp, "step_ms": dt * 1e3, "launches": calls}
    if cfg.freeze_coarse:
        mu = opts["kernel"].state.mu
        leaked, free = 0, 0.0
        for n, m in mu.items():
            grp, parts = group_of(n), n.split(".")
            if grp in ("nerf_coarse", "nerf_feat"):
                if parts[-2] in INPUT_LAYERS and parts[-1] == "kernel":
                    free += float(m[:POS_DIM].abs().sum())
                    m = m[POS_DIM:]
                leaked += int((m != 0).sum())
            elif grp in ("bones", "skin_aux", "nerf_vis"):
                leaked += int((m != 0).sum())
        print(f"[branches] freeze_coarse: {leaked} nonzero gradient entries where frozen; "
              f"|first moment| of the free input rows {free:.3e}", flush=True)
        if leaked or not free > 0:
            fail.append(f"freeze_coarse: {leaked} frozen entries moved, free rows {free}")
        out["frozen_nonzero"] = leaked
    if fail:
        raise SystemExit(f"branches {name}: " + "; ".join(fail))
    for r in results:
        r["launches"] += sum(calls.get(f"{counter_kind(r['name'], False)}:{site}:"
                                       f"{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == "init")
    return out


def run_ft_cse(results: list, card: str, tmp: str) -> dict:
    """ft_cse on the frame route: train_app with --ft_cse and without
    --lineload on the cold-start phase's 16-frame 256 px MeshScene (its
    Densepose/ features), COLDSTART_FLAGS at batch FT_CSE_BATCH,
    --use_rtk_file, no eval grid, its epoch cut to FT_CSE_STEPS steps. Every
    step's aux is read through a wrapper of the trainer's step: csenet_loss
    finite at every step, and a nonzero csenet gradient norm at a step past
    ftcse_steps (0: every step after the first); K1/K2/dW launches exactly
    init's a step. Reports steps/s and the card's peak memory."""
    import torch
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train import trainer as TT

    seq, cfg_dir = "flap-smoke", os.path.join(tmp, "ccfg")
    flags = list(COLDSTART_FLAGS)
    flags[flags.index("--batch_size") + 1] = str(FT_CSE_BATCH)
    argv = ["--seqname", seq, "--config_dir", cfg_dir, "--checkpoint_dir",
            os.path.join(tmp, "clog"), "--img_size", str(COLDSTART_IMG), "--logname", "ftcse",
            "--ft_cse", "--use_rtk_file", "--render_size", "0"] + flags
    seen = []
    get_step = TT.Trainer.get_step_fn

    def recorded(self, *a, **k):
        fn, ns_u, ns_a = get_step(self, *a, **k)

        def step(*b, **kw):  # one step a call (steps_chunk 0)
            aux, host = fn(*b, **kw)
            seen.append((self.progress, {k: aux[k][0].detach() for k in
                                         ("csenet_loss", "csenet_g", "total_loss")}))
            return aux, host
        return step, ns_u, ns_a

    torch.cuda.reset_peak_memory_stats()
    FM.reset_launches()
    t0 = time.perf_counter()
    with _patched([(TT, "ITERS_PER_EPOCH", FT_CSE_STEPS), (TT.Trainer, "get_step_fn", recorded)]):
        tr = train_app.main(argv)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    calls = dict(FM.launches_by_call)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [json.loads(line) for line in open(tr.log_path)]
    ep = [r for r in rows if "epoch_time" in r]
    steps = [(p, {k: float(v) for k, v in a.items()}) for p, a in seen]
    print(f"[branches] ft_cse (train_app --ft_cse, the frame route, {FT_CSE_STEPS} steps at "
          f"batch {FT_CSE_BATCH}) {run_s:.2f} s: epoch {ep[0] if ep else None}; steps "
          f"{[(round(p, 5), a) for p, a in steps]}; peak memory {peak:.2f} GiB ({card}); "
          f"launches {calls}", flush=True)
    fail = []
    if len(steps) != FT_CSE_STEPS or not all(math.isfinite(a["csenet_loss"]) and
                                             math.isfinite(a["total_loss"]) for _, a in steps):
        fail.append(f"ft_cse steps {steps}")
    if not any(p > tr.cfg.ftcse_steps and a["csenet_g"] > 0 for p, a in steps):
        fail.append("no csenet gradient past ftcse_steps")
    want = expected_calls("init", FT_CSE_STEPS)
    if calls != want:
        fail.append(f"ft_cse launches by call site {calls} != {want}")
    if fail:
        raise SystemExit("branches ft_cse: " + "; ".join(fail))
    for r in results:
        r["launches"] += sum(calls.get(f"{counter_kind(r['name'], False)}:{site}:"
                                       f"{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == "init")
    e = ep[0] if ep else {}
    return {"run_s": run_s, "steps_per_s": e.get("steps_per_s"), "epoch_s": e.get("epoch_time"),
            "split": {k: e.get(k) for k in ("t_load", "t_upload", "t_dispatch", "t_fetch")},
            "steps": steps, "peak_gib": peak, "batch": FT_CSE_BATCH}


def run_distiller(card: str, tmp: str) -> dict:
    """CSEDistiller on the card: DISTILL_STEPS AdamW steps on one batch of 8
    of the MeshScene's frames at 224 px with their resampled CSE features
    and masks (at 112 px); the loss must fall."""
    import numpy as np
    import torch
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.train.cse_distill import CSEDistiller

    reader = D.build_datasets("flap-smoke", DISTILL_SIZE, os.path.join(tmp, "ccfg"))[0].reader
    raws = [reader.read_raw(i, flowfw=True, dframe=1) for i in range(8)]
    imgs = np.stack([r["img"] for r in raws]).astype(np.float32)
    imgs = imgs / max(float(imgs.max()), 1.0)
    feats = np.stack([r["dp_feat_rsmp"].transpose(1, 2, 0)[::2, ::2] for r in raws])
    masks = np.stack([r["mask"][::2, ::2, None] for r in raws]).astype(np.float32)
    d = CSEDistiller(lr=1e-3)
    t0 = time.perf_counter()
    losses = d.train(iter([(imgs, feats, masks)] * DISTILL_STEPS), DISTILL_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[branches] CSEDistiller: {DISTILL_STEPS} steps at batch 8, {DISTILL_SIZE} px, "
          f"{dt / DISTILL_STEPS * 1e3:.1f} ms a step ({card}); loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}", flush=True)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"branches: the CSE distiller's loss did not fall: {losses}")
    return {"losses": losses, "ms_per_step": dt / DISTILL_STEPS * 1e3}


def run_branches(results: list, card: str, tmp: str, profile: bool = False) -> dict:
    """Phase 9, the step's branches at full widths (trunk D8 W256, feature
    head D5 W128, visibility and skin D5 W64, dis D5 W128, unc D8 W256), 25
    bones, 128 depth samples: (a) the ft2 stage with the displacement field
    nerf_dis (run_stage: K1/K2/dW at dis_bw and dis_fw, K1 at
    dis_bw_coarse, launches exact per site); (b) one step each of
    BRANCH_STEPS at init's shapes (run_branch_step); (c) ft_cse on the frame
    route (run_ft_cse, on run_coldstart's dataset in ``tmp``) and the CSE
    distiller (run_distiller)."""
    t0 = time.perf_counter()
    out = {"ft2_dis": run_stage("ft2_dis", results, card, profile=profile)}
    t_a = time.perf_counter() - t0
    for name in BRANCH_STEPS:
        out[name] = run_branch_step(name, results, card)
    t_b = time.perf_counter() - t0 - t_a
    out["ft_cse"] = run_ft_cse(results, card, tmp)
    out["distiller"] = run_distiller(card, tmp)
    t_c = time.perf_counter() - t0 - t_a - t_b
    out["times_s"] = {"ft2_dis": t_a, "steps": t_b, "ft_cse_and_distiller": t_c}
    print(f"[branches] phase {time.perf_counter() - t0:.1f} s: ft2 with nerf_dis {t_a:.1f} s, "
          f"branch steps {t_b:.1f} s, ft_cse and the distiller {t_c:.1f} s", flush=True)
    return out


# ------------------------------------------------------------ viz tools
NVS_FRAMES = 9     # nvs_app's default --test_frames: replay and bullet-time frames
CTRAJ_FRAMES = 4   # --maxframe of the ctraj route (phase 7 exports 15 trajectories)
# rays a render chunk: one 64 px frame (the default 32,768 pads each frame's
# 4,096 rays 8-fold, in both packages; the chunk's rays set VolSDF's
# beta floor, so the CPU copy must render the same chunks)
NVS_CHUNK = 4096
# The NVS renders cull samples by hard tests (outside the object bound,
# visibility < 0.5; nvs.py:150). Where the card and the CPU put a sample's
# value on either side of a test's threshold, that pixel differs by far more
# than rounding while the rest agree to ~1e-6. Such a sample is a rounding
# flip, and its pixel is left out of the comparison, only where the two
# values of the test that differs are within NVS_CULL_EPS (visibility,
# absolute; coordinates, relative to the bound); a wider gap fails the phase.
NVS_CULL_EPS = 1e-4
MATCH_PAIR = "0 8"
# match_app on the card (K1's bf16 feature head) against a CPU copy of the
# model (the plain fp32 head; both read the Sinkhorn's kernel matrix in
# bf16): relative L2 of the 64 canonical points and of their pixels. The
# soft argmax over 8,000 grid points moves with every bf16 rounding of the
# features. Phase 8's checkpoint differs from run to run; on two of them
# the H100 read 6.1e-3 and 8.5e-3 (points) and 2.8e-3 and 5.0e-3 (pixels;
# at most 2.3 px at 256 px), so the gates sit at ~3x the larger reads.
MATCH_PTS_TOL, MATCH_PX_TOL = 2.5e-2, 1.5e-2
POSENET_CROPS = 64


def posenet_state_dict(seed: int = 0) -> dict:
    """A state dict in the layout of the reference's posenet checkpoint
    (Sequential(Encoder, RTHead) under ``module.nerf_root_rts.``, as
    save_network writes mesh_material/posenet/*.pth): seeded random weights
    (x 0.05) and BatchNorm running statistics (mean x 0.05, variance in
    [0.75, 1.25)), as tests/test_posenet.py fills its torch copy of the
    net."""
    import torch

    g = torch.Generator().manual_seed(seed)
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[name + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)
        shapes[name + ".num_batches_tracked"] = ()

    def lin(name, cout, cin):
        shapes[name + ".weight"], shapes[name + ".bias"] = (cout, cin), (cout,)

    r = "0.resnet_conv.resnet."
    conv(r + "conv1", 64, 16, 7)
    bn(r + "bn1", 64)
    cin = 64
    for li, c in enumerate((64, 128, 256, 512), 1):
        for bi in range(2):
            t = f"{r}layer{li}.{bi}."
            conv(t + "conv1", c, cin if bi == 0 else c, 3)
            bn(t + "bn1", c)
            conv(t + "conv2", c, c, 3)
            bn(t + "bn2", c)
            if bi == 0 and li > 1:
                conv(t + "downsample.0", c, cin, 1)
                bn(t + "downsample.1", c)
        cin = c
    conv("0.conv1.0", 128, 512, 3, bias=True)
    bn("0.conv1.1", 128)
    lin("1.xyz_encoding_1.0", 256, 128)
    lin("1.xyz_encoding_final", 256, 256)
    lin("1.dir_encoding.0", 128, 256)
    lin("1.sigma", 1, 256)
    lin("1.rgb.0", 7, 128)
    shapes["1.beta"] = (1,)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            v = torch.zeros((), dtype=torch.long)
        elif k.endswith("running_var"):
            v = torch.rand(shape, generator=g) * 0.5 + 0.75
        else:
            v = torch.randn(shape, generator=g) * 0.05
        sd["module.nerf_root_rts." + k] = v
    return sd


def check_gif(path: str, frames: int, height: int, width: int, fps: int = 10) -> list:
    """Failures of a GIF against its expected frame count, size and delay,
    read from its block structure (the card's machine has no GIF reader)."""
    from moda_tpu_torch.viz.render_vis import gif_info

    try:
        info = gif_info(path)
    except (OSError, ValueError) as e:
        return [f"{path}: {e}"]
    with open(path, "rb") as f:
        head = f.read(6)
    want = {"frames": frames, "height": height, "width": width,
            "delays": [100 // fps] * frames}
    got = {k: info[k] for k in want}
    return [] if head == b"GIF89a" and got == want else [f"{path}: {head} {got}, not {want}"]


def culling_inputs(store: dict, inference):
    """Wraps render/pipeline.py's ``_inference``: keeps, from its first call
    with the novel-view culling on, the culling tests' inputs on the host
    (the samples' points [R, S, 3], the object bound [3], the visibility
    [R, S])."""
    def wrapped(*a, clip_bound=None, vis_pred=None, **k):
        if clip_bound is not None and not store:
            store.update(xyz=a[2].cpu().numpy(), bound=clip_bound.cpu().numpy(),
                         vis=vis_pred.cpu().numpy())
        return inference(*a, clip_bound=clip_bound, vis_pred=vis_pred, **k)
    return wrapped


def culling_flips(a: dict, b: dict):
    """The samples [R, S] that one of two renders culls and the other keeps
    (``culling_inputs``' records), and the largest gap, over those samples,
    between the two values of a test that differs there: the visibility
    (absolute) or a coordinate's magnitude (relative to the bound)."""
    import numpy as np

    out_a, out_b = np.abs(a["xyz"]) > a["bound"], np.abs(b["xyz"]) > b["bound"]
    hid_a, hid_b = a["vis"] < 0.5, b["vis"] < 0.5
    flips = (out_a.any(-1) | hid_a) != (out_b.any(-1) | hid_b)
    gap_xyz = np.where(out_a != out_b, np.abs(np.abs(a["xyz"]) - np.abs(b["xyz"]))
                       / a["bound"], 0.0).max(-1)
    gap_vis = np.where(hid_a != hid_b, np.abs(a["vis"] - b["vis"]), 0.0)
    gap = np.maximum(gap_xyz, gap_vis)[flips]
    return flips, float(gap.max()) if gap.size else 0.0


def run_viz(results: list, card: str, tmp: str) -> dict:
    """Phase 10, the viz tools and the pretrained posenet on the artifacts
    of phases 6-8 in ``tmp``, at full widths:

    (a) ``nvs_app.main`` on phase 6's ``latest`` (replay and bullet time,
        NVS_FRAMES frames each at render_size 64, ndepth 128, NVS_CHUNK
        rays a chunk): replay.gif
        and bullet.gif are GIF89a with the frame count, size and 1/10 s
        delay; every frame finite; the first replay frame within 1e-4
        (relative L2) of a CPU copy of the model, over the pixels where no
        sample's culling decision flipped within NVS_CULL_EPS of its
        threshold (every pixel when none did); no kernel launch;
    (b) the ctraj route on phase 7's ``-ctrajs-``/``-refsil-`` exports
        (``--scale 1 --maxframe`` CTRAJ_FRAMES): an rgb, sil and vis PNG of
        the composite's size per frame, values finite and in [0, 1] before
        quantization, the rgb GIF; no kernel launch;
    (c) ``match_app.main`` on phase 8's MeshScene and ``latest`` (frames
        MATCH_PAIR, 64 mask pixels): exactly one K1 launch, at feat_grid
        (added to K1:feat_grid's launches), the points and pixels within
        MATCH_PTS_TOL / MATCH_PX_TOL of a CPU copy, the canvas PNG written;
        K1's device time inside one match_frames call, profiled;
    (d) the pretrained posenet: a reference-layout .pth from
        ``posenet_state_dict``; the Trainer route of ``--pose_cnn_path``
        through ``cold_start`` on phase 8's scene (the .pth loaded, no
        warmup training, extract_cams_cnn's 16 cameras finite); its
        ``PoseWarmup.predict`` on POSENET_CROPS crops of
        ``render_pose_batch`` on the scene's prior mesh within 1e-4 of the
        net on the CPU, and timed."""
    import numpy as np
    import torch
    from moda_tpu_torch.cli import match_app, nvs_app
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.preproc.posenet import load_posenet, predict_rtk
    from moda_tpu_torch.render import pipeline as RP
    from moda_tpu_torch.train.trainer import Trainer
    from moda_tpu_torch.train.warmup_pose import render_pose_batch
    from moda_tpu_torch.viz.nvs import render_nvs
    from moda_tpu_torch.viz.render_vis import png_size

    out, fail, t_phase = {"card": card}, [], time.perf_counter()

    def capture(store, name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            store.setdefault(name, []).append((a, k, res, time.perf_counter() - t0))
            return res
        return wrapped

    # (a) replay and bullet time on phase 6's checkpoint
    log = os.path.join(tmp, "log")
    base6 = ["--seqname", "syn-smoke", "--config_dir", os.path.join(tmp, "cfg"), "--logname",
             "smoke", "--checkpoint_dir", log, "--model_path",
             os.path.join(log, "smoke", "latest"), "--img_size", str(TRAINER_IMG),
             "--chunk", str(NVS_CHUNK)]
    seen, cull_card, cull_cpu = {}, {}, {}
    FM.reset_launches()
    t0 = time.perf_counter()
    with _patched([(nvs_app, "render_nvs", capture(seen, "nvs", nvs_app.render_nvs)),
                   (RP, "_inference", culling_inputs(cull_card, RP._inference))]):
        tr = nvs_app.main(base6 + ["--test_frames", str(NVS_FRAMES)])
    out["nvs_app_s"] = time.perf_counter() - t0
    calls_a = dict(FM.launches_by_call)
    digest = hashlib.sha256()
    for _, v in sorted(tr.model.state_dict().items()):
        digest.update(v.detach().cpu().numpy().tobytes())
    out["nvs_model_sha256"] = digest.hexdigest()[:16]  # is phase 6's model the same run to run?
    rs, nvs_dir = tr.cfg.render_size, os.path.join(log, "smoke-nvs")
    frames = [f for _, _, res, _ in seen["nvs"] for f in res]
    out["render_nvs_ms_per_frame"] = sum(t for *_, t in seen["nvs"]) / len(frames) * 1e3
    for name in ("replay", "bullet"):
        fail += check_gif(os.path.join(nvs_dir, f"{name}.gif"), NVS_FRAMES, rs, rs)
    if len(frames) != 2 * NVS_FRAMES or not all(np.isfinite(v).all() for f in frames
                                                for v in f.values()):
        fail.append(f"nvs: {len(frames)} frames, not all finite")
    (_, cams, ids, *_), _, replay, _ = seen["nvs"][0]
    t0 = time.perf_counter()
    with _patched([(RP, "_inference", culling_inputs(cull_cpu, RP._inference))]):
        want = render_nvs(cpu_copy(tr.model), cams[:1], ids[:1], rs, tr.cfg.ndepth,
                          chunk=tr.cfg.chunk)[0]
    out["nvs_cpu_frame_s"] = time.perf_counter() - t0
    out["nvs_rel_l2_vs_cpu"] = {k: rel_l2(replay[0][k], want[k]) for k in want}
    if cull_card["xyz"].shape[0] != rs * rs:
        fail.append(f"nvs: the first replay frame spans several chunks of {tr.cfg.chunk} rays")
    flips, gap = culling_flips(cull_card, cull_cpu)
    keep = ~flips.any(-1).reshape(rs, rs)
    out.update(nvs_culling_flips=int(flips.sum()), nvs_flipped_pixels=int((~keep).sum()),
               nvs_flip_gap=gap,
               nvs_rel_l2_unflipped={k: rel_l2(np.asarray(replay[0][k])[keep],
                                               np.asarray(want[k])[keep]) for k in want})
    print(f"[viz] nvs frame of the model {out['nvs_model_sha256']} against the CPU's: over "
          f"all pixels {out['nvs_rel_l2_vs_cpu']}; "
          f"{out['nvs_culling_flips']} samples culled on one side only, in "
          f"{out['nvs_flipped_pixels']} pixels (largest gap between the two values of the "
          f"test that differs {gap:.2e}, limit {NVS_CULL_EPS}); over the other pixels "
          f"{out['nvs_rel_l2_unflipped']} (tol 1e-4)", flush=True)
    if gap > NVS_CULL_EPS or not max(out["nvs_rel_l2_unflipped"].values()) <= 1e-4:
        fail.append(f"nvs frame on the card {out['nvs_rel_l2_unflipped']} from the CPU's "
                    f"({out['nvs_culling_flips']} culling flips, gap {gap:.2e})")
    print(f"[viz] nvs_app replay + bullet time: {len(frames)} frames at {rs} px in "
          f"{out['nvs_app_s']:.2f} s, render_nvs {out['render_nvs_ms_per_frame']:.1f} ms a frame "
          f"({card}); card against CPU {out['nvs_rel_l2_vs_cpu']} (CPU frame "
          f"{out['nvs_cpu_frame_s']:.1f} s); launches {calls_a}", flush=True)

    # (b) the ctraj route on phase 7's exports
    seen, prefix = {}, os.path.join(nvs_dir, "ctraj")
    FM.reset_launches()
    t0 = time.perf_counter()
    with _patched([(nvs_app, "render_nvs_ctraj",
                    capture(seen, "ctraj", nvs_app.render_nvs_ctraj))]):
        nvs_app.main(base6 + ["--rootdir", os.path.join(log, "smoke-export", "syn-smoke-ctrajs-"),
                              "--nvs_outpath", prefix, "--scale", "1",
                              "--maxframe", str(CTRAJ_FRAMES)])
    out["ctraj_s"] = time.perf_counter() - t0
    calls_b = dict(FM.launches_by_call)
    cframes = seen["ctraj"][0][2]
    out["ctraj_render_ms_per_frame"] = seen["ctraj"][0][3] / len(cframes) * 1e3
    for i, f in enumerate(cframes):
        for kind in ("rgb", "sil", "vis"):
            v = f[kind]
            if not (np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1):
                fail.append(f"ctraj frame {i} {kind} outside [0, 1]")
            path = f"{prefix}-{kind}_{i:05d}.png"
            if not os.path.exists(path) or png_size(path) != v.shape[:2]:
                fail.append(f"{path} missing or not {v.shape[:2]}")
    if len(cframes) != CTRAJ_FRAMES:
        fail.append(f"ctraj: {len(cframes)} frames, not {CTRAJ_FRAMES}")
    fail += check_gif(prefix + "-rgb.gif", CTRAJ_FRAMES, *cframes[0]["rgb"].shape[:2])
    print(f"[viz] nvs_app ctraj route: {len(cframes)} frames of {cframes[0]['rgb'].shape[:2]} "
          f"in {out['ctraj_s']:.2f} s (with the rest mesh's extraction), render "
          f"{out['ctraj_render_ms_per_frame']:.1f} ms a frame; launches {calls_b}", flush=True)
    if calls_a or calls_b:
        fail.append(f"nvs_app launched kernels: {calls_a} {calls_b}")

    # (c) match_app on phase 8's scene
    seq, cfg_dir, clog = "flap-smoke", os.path.join(tmp, "ccfg"), os.path.join(tmp, "clog")
    base8 = ["--seqname", seq, "--config_dir", cfg_dir, "--checkpoint_dir", clog,
             "--img_size", str(COLDSTART_IMG)]
    seen = {}
    FM.reset_launches()
    t0 = time.perf_counter()
    with _patched([(match_app, "match_frames", capture(seen, "match", match_app.match_frames))]):
        match_app.main(base8 + ["--logname", "cold", "--model_path",
                                os.path.join(clog, "cold", "latest"),
                                "--match_frames", MATCH_PAIR])
    out["match_app_s"] = time.perf_counter() - t0
    calls_c = dict(FM.launches_by_call)
    (model, *args), kw, (pts, px), t_match = seen["match"][0]
    want_key = f"fwd:feat_grid:{nets_of('feat_grid')}"
    if calls_c != {want_key: 1}:
        fail.append(f"match_app launches {calls_c}, not one {want_key}")
    for r in results:
        r["launches"] += sum(calls_c.get(f"{counter_kind(r['name'], False)}:{site}:"
                                         f"{nets_of(site)}", 0)
                             for stage, site in r["runs"] if stage == "match")
    cpu_pts, cpu_px = match_app.match_frames(cpu_copy(model), *args, **kw)
    out["match_pts_rel_l2_vs_cpu"] = rel_l2(pts, cpu_pts)
    out["match_px_rel_l2_vs_cpu"] = rel_l2(px, cpu_px)
    out["match_px_max_abs_vs_cpu"] = float(np.abs(px - cpu_px).max())
    if not (out["match_pts_rel_l2_vs_cpu"] <= MATCH_PTS_TOL
            and out["match_px_rel_l2_vs_cpu"] <= MATCH_PX_TOL):
        fail.append(f"match_frames on the card: points {out['match_pts_rel_l2_vs_cpu']:.3e}, "
                    f"pixels {out['match_px_rel_l2_vs_cpu']:.3e} from the CPU's")
    f0, f1 = MATCH_PAIR.split()
    canvas = os.path.join(clog, f"cold-match-{f0}-{f1}.png")
    if not os.path.exists(canvas) or png_size(canvas) != (COLDSTART_IMG, 2 * COLDSTART_IMG):
        fail.append(f"{canvas} missing or not {COLDSTART_IMG} x {2 * COLDSTART_IMG}")
    _, dev, busy = profiled(lambda: match_app.match_frames(model, *args, **kw), 3)
    out["match_k1_device_ms"] = device_ms(dev, 3, ["fmlp_fwd"])
    out["match_device_busy_ms"] = busy
    out["match_frames_ms"] = t_match * 1e3
    k1 = next(r for r in results if r["name"] == "K1:feat_grid")
    print(f"[viz] match_app {MATCH_PAIR}: {len(pts)} pixels, app {out['match_app_s']:.2f} s, "
          f"match_frames {t_match * 1e3:.1f} ms (device busy {busy:.3f} ms a call); K1 at "
          f"feat_grid {out['match_k1_device_ms']:.4f} ms device (kernel phase, same shape: "
          f"{k1['device_ms']:.4f} ms device, plain {k1['plain_ms']:.4f} ms, bf16 F.linear "
          f"chain {k1['layer_chain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms) ({card}); card "
          f"against CPU: points rel L2 {out['match_pts_rel_l2_vs_cpu']:.3e} (tol "
          f"{MATCH_PTS_TOL}), pixels rel L2 {out['match_px_rel_l2_vs_cpu']:.3e} (tol "
          f"{MATCH_PX_TOL}, max {out['match_px_max_abs_vs_cpu']:.3f} px); launches {calls_c}",
          flush=True)
    FM.reset_launches()  # the profiled calls are not the main path's

    # (d) the pretrained posenet: the --pose_cnn_path route to extract_cams_cnn
    pth = os.path.join(tmp, "posenet.pth")
    torch.save(posenet_state_dict(0), pth)
    cdb = os.path.join(tmp, "cdb")
    prior = os.path.join(cdb, "Densepose", "Full-Resolution", seq, "prior.pkl")
    cfg = parse_config(base8 + ["--logname", "posenet", "--pose_cnn_path", pth,
                                "--warmup_pose_ep", "1", "--prior_mesh_path", prior])
    datasets = D.build_datasets(seq, COLDSTART_IMG, cfg_dir)
    info = DataInfo(offset=D.data_offsets(datasets),
                    intrinsics=tuple(tuple(s.ks) for s in load_seq_config(seq, cfg_dir)))
    t0 = time.perf_counter()
    ptr = Trainer(cfg, info, loader=None, eval_datasets=datasets)
    ptr.load_prior_mesh(prior)
    ptr.cold_start()
    torch.cuda.synchronize()
    out["pose_cnn_path_cold_start_s"] = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(ptr.log_path)]
    n_cams = [r["extract_cams_n"] for r in rows if "extract_cams_n" in r]
    if ptr.pose_cnn.ref_net is None or any("warmup_pose_rot_loss" in r for r in rows) or \
            n_cams != [COLDSTART_FRAMES] or not np.isfinite(ptr.latest_vars["rtk"]).all():
        fail.append(f"--pose_cnn_path: cameras {n_cams}, rows {rows}")
    feats, _ = render_pose_batch(ptr.prior_verts_unit, ptr.prior_faces, ptr.prior_embeds,
                                 ptr.pose_cnn.d_mean, POSENET_CROPS, np.random.default_rng(0))
    card_rtk = ptr.pose_cnn.predict(feats)
    out["posenet_rel_l2_vs_cpu"] = rel_l2(card_rtk, predict_rtk(load_posenet(pth), feats))
    if not out["posenet_rel_l2_vs_cpu"] <= 1e-4:
        fail.append(f"posenet on the card {out['posenet_rel_l2_vs_cpu']:.2e} from the CPU's")
    out["posenet_predict_ms"] = cuda_time(lambda: ptr.pose_cnn.predict(feats))
    x = torch.as_tensor(feats, device=ptr.device).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        out["posenet_forward_ms"] = cuda_time(lambda: ptr.pose_cnn.ref_net(x))
    print(f"[viz] posenet: --pose_cnn_path cold start {out['pose_cnn_path_cold_start_s']:.2f} s "
          f"({COLDSTART_FRAMES} cameras, no warmup training); predict of {POSENET_CROPS} crops "
          f"{out['posenet_predict_ms']:.2f} ms (forward on the card alone "
          f"{out['posenet_forward_ms']:.2f} ms) ({card}); card against CPU rel L2 "
          f"{out['posenet_rel_l2_vs_cpu']:.2e} (tol 1e-4)", flush=True)

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[viz] phase {out['phase_s']:.1f} s", flush=True)
    if fail:
        raise SystemExit("viz: " + "; ".join(fail))
    return out


PREPROC_CHECK_TESTRES = 1.25  # 256 px frames -> a 320 x 320 input for the card-vs-CPU check
PREPROC_TIMED_PAIRS = 3


def kernels_by_op(fn, n: int, rows: int) -> float:
    """torch.profiler (with input shapes) over n calls of fn: prints the
    device time of each kernel by the aten op that launched it and that
    op's input shapes (for a convolution, its layer), the top ``rows`` rows,
    and the share of the device's busy time so attributed; returns the busy
    time a call in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    acc: dict = {}
    for e in prof.events():
        # the profiler's own events (buffer flushes) are handed kernels too
        for k in e.kernels if e.name.startswith("aten::") else ():
            key = (k.name[:60], e.name, str(e.input_shapes)[:100])
            t, c = acc.get(key, (0.0, 0))
            acc[key] = (t + k.duration, c + 1)
    busy = sum(_dev_us(e, True) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / n / 1e3
    print(f"[profile by op] {sum(t for t, _ in acc.values()) / n / 1e3:.1f} of {busy:.1f} "
          "device ms a call attributed; device ms a call, launches a call, kernel, op, "
          "input shapes", flush=True)
    for (kern, op, shapes), (t, c) in sorted(acc.items(), key=lambda kv: -kv[1][0])[:rows]:
        print(f"[profile by op]   {t / n / 1e3:9.3f}  {c / n:7.1f}  {kern}  {op}  {shapes}",
              flush=True)
    return busy


def profile_vcn(params, im, card: str) -> dict:
    """Where ``vcn_forward``'s device time goes on ``im``: kernels by the op
    and layer that launched them (``kernels_by_op``), then the call timed by
    CUDA events with cuDNN's heuristics (the port's setting) and with its
    autotuner (``cudnn.benchmark``), in turns."""
    import torch
    from moda_tpu_torch.preproc import vcn_flow as V

    with torch.inference_mode():
        busy = kernels_by_op(lambda: V.vcn_forward(params, im), 1, 20)
        old, times = torch.backends.cudnn.benchmark, {False: [], True: []}
        for flag in (False, True, True, False):
            torch.backends.cudnn.benchmark = flag
            V.vcn_forward(params, im)  # the autotuner's first call tries the algorithms
            times[flag].append(cuda_time(lambda: V.vcn_forward(params, im), iters=3, warmup=1))
        torch.backends.cudnn.benchmark = old
    print(f"[profile] vcn_forward at {tuple(im.shape[2:])}: {busy:.1f} ms device busy a pair; "
          f"event ms a pair, in turns: cuDNN heuristics {times[False]}, cudnn.benchmark "
          f"{times[True]} ({card})", flush=True)
    return {"device_busy_ms": busy, "cudnn_heuristics_ms": times[False],
            "cudnn_benchmark_ms": times[True]}


def listing(db: str, seq: str, kind: str, pattern: str) -> list:
    return sorted(glob.glob(os.path.join(db, kind, "Full-Resolution", seq, pattern)))


def check_database(db: str, seq: str, cfg_dir: str, res: dict, fail: list):
    """The checks of a database that ``preproc_app.main`` wrote from phase
    8's scene: the frames and masks, FlowFW_d/FlowBW_d flo-/occ- PFMs for
    each d of pipeline.DFRAMES with pipeline.py:89-96's pair counts (finite
    flows, occlusion in [0, 1]) and one VCN call a pair each way, the
    config, one line-shard dir of COLDSTART_IMG rows a pair, and one line
    batch read back through the port's line loader. Appends to ``fail``;
    returns (readings, the batch)."""
    import numpy as np
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.data.pfm import read_pfm
    from moda_tpu_torch.preproc.pipeline import DFRAMES

    n = COLDSTART_FRAMES
    pairs = {d: sum(1 for i in range(n - d) if i % d == 0) for d in DFRAMES}
    if len(listing(db, seq, "JPEGImages", "*.jpg")) != n \
            or len(listing(db, seq, "Annotations", "*.png")) != n:
        fail.append("frames or masks missing")
    flo_min, flo_max, occ_lo, occ_hi = np.inf, -np.inf, np.inf, -np.inf
    for d, k in pairs.items():
        for kind in (f"FlowFW_{d}", f"FlowBW_{d}"):
            flo, occ = listing(db, seq, kind, "flo-*.pfm"), listing(db, seq, kind, "occ-*.pfm")
            if len(flo) != k or len(occ) != k:
                fail.append(f"{kind}: {len(flo)} flo and {len(occ)} occ files, want {k}")
            for p in flo:
                f = read_pfm(p)[0]
                if f.shape != (COLDSTART_IMG, COLDSTART_IMG, 3) or not np.isfinite(f).all():
                    fail.append(f"{p}: shape {f.shape}, finite {np.isfinite(f).all()}")
                flo_min, flo_max = min(flo_min, f[..., :2].min()), max(flo_max, f[..., :2].max())
            for p in occ:
                o = read_pfm(p)[0]
                occ_lo, occ_hi = min(occ_lo, o.min()), max(occ_hi, o.max())
    if not (0 <= occ_lo <= occ_hi <= 1):
        fail.append(f"occlusion in [{occ_lo}, {occ_hi}]")
    if res["flow_calls"] != 2 * sum(pairs.values()):
        fail.append(f"{res['flow_calls']} VCN pairs, want {2 * sum(pairs.values())}")
    if not os.path.exists(os.path.join(cfg_dir, seq + ".config")):
        fail.append("no config")
    shards = sorted(glob.glob(os.path.join(db, "Pixels", "Full-Resolution", seq, "1_*")))
    rows = [len(glob.glob(os.path.join(s, "0*.npy"))) for s in shards]
    if len(shards) != n - 1 or set(rows) != {COLDSTART_IMG}:
        fail.append(f"{len(shards)} shard dirs, rows {sorted(set(rows))}")
    loader = D.PairLoader(D.build_line_datasets(seq, COLDSTART_IMG, cfg_dir), 8,
                          num_threads=1, num_prefetch=1)
    try:
        batch = next(loader)
    finally:
        loader.close()
    if not all(np.isfinite(v).all() for v in batch.values() if v.dtype.kind == "f"):
        fail.append("a line batch holds non-finite values")
    return {"frame_pairs": sum(pairs.values()), "shard_dirs": len(shards),
            "flow_range": [float(flo_min), float(flo_max)],
            "occ_range": [float(occ_lo), float(occ_hi)]}, batch


def database_line(res: dict, info: dict) -> str:
    return (f"{res['flow_calls']} VCN pairs ({info['frame_pairs']} frame pairs both ways, "
            f"{res['times']['flow'] / max(res['flow_calls'], 1) * 1e3:.0f} ms a pair in the "
            f"stage); flow in [{info['flow_range'][0]:.1f}, {info['flow_range'][1]:.1f}] px, "
            f"occlusion in [{info['occ_range'][0]:.3f}, {info['occ_range'][1]:.3f}]; "
            f"{info['shard_dirs']} shard dirs; one line batch read back")


def run_preproc(card: str, tmp: str, profile: bool = False) -> dict:
    """Phase 11, the preprocessing entry point with VCN+ flow, at VCN's
    published widths (seeded weights in the reference's layout,
    ``vcn_flow.reference_state_dict``), on phase 8's 16-frame 256 px scene
    in ``tmp``:

    (a) VCN: frames 0 and 1 of the scene at testres PREPROC_CHECK_TESTRES
        through ``VCNFlowPredictor`` on the card and on a CPU copy, both
        fp32 (resolve_device turns TF32 off): the flow within 1e-3 px on
        99.9% of the pixels and 0.5 px everywhere, the occlusion logits
        within 1e-3; then PREPROC_TIMED_PAIRS pairs at the default ~2 MP
        protocol: ``vcn_forward``'s device time a pair (CUDA events), the
        predictor's wall time a pair, and the peak device memory;
    (b) ``preproc_app.main`` with the scene's JPEGImages as ``--input``,
        its Annotations as ``--mask_dir`` and the seeded ``vcn_rob.npz``
        under ``--weights_dir``: 16 frames, 16 masks and 16 zero-feature
        Densepose sets; FlowFW_d/FlowBW_d flo-/occ- PFMs for each d of
        pipeline.DFRAMES with pipeline.py:89-96's pair counts, finite
        flows, occlusion in [0, 1]; the config; 15 line-shard dirs of 256
        rows, one batch read back through the port's line loader; the
        fused-MLP launch counters still 0 after the phase. Each stage's
        time and the VCN pairs run are printed;
    (c) the refusals raise: a video input and no vcn*.npz (a cse*.npz and
        a pointrend*.npz run: phase 12).
    --profile: ``profile_vcn`` on the ~2 MP input of (a).
    No failure is caught: any exits non-zero."""
    import numpy as np
    import torch
    from moda_tpu_torch.bridge import flatten, vcn_from_jax
    from moda_tpu_torch.cli import preproc_app
    from moda_tpu_torch.data.pfm import read_pfm
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.preproc import vcn_flow as V
    from moda_tpu_torch.preproc.checkpoints import save_pytree_npz
    from moda_tpu_torch.preproc.pipeline import read_bgr

    t_phase = time.perf_counter()
    out, fail = {}, []
    src_seq = "flap-smoke"
    src = {k: os.path.join(tmp, "cdb", k, "Full-Resolution", src_seq)
           for k in ("JPEGImages", "Annotations")}
    mean = np.asarray([0.33, 0.33, 0.33], np.float32)
    params = V.convert_vcn_checkpoint(V.reference_state_dict(0, div=1))
    wdir = os.path.join(tmp, "vcn_weights")
    os.makedirs(wdir, exist_ok=True)
    save_pytree_npz(os.path.join(wdir, "vcn_rob.npz"), {"params": params, "mean": mean})
    n_params = sum(v.size for v in flatten(params).values())
    frames = [read_bgr(p) for p in sorted(glob.glob(os.path.join(src["JPEGImages"], "*.jpg")))]

    # (a) the card against the CPU, then the ~2 MP protocol timed
    card_pred = V.VCNFlowPredictor(vcn_from_jax(params, "cuda"), mean=mean,
                                   testres=PREPROC_CHECK_TESTRES)
    cpu_pred = V.VCNFlowPredictor(vcn_from_jax(params, "cpu"), mean=mean,
                                  testres=PREPROC_CHECK_TESTRES)
    (fc, oc), (fh, oh) = card_pred(frames[0], frames[1]), cpu_pred(frames[0], frames[1])
    d = np.abs(fc - fh)  # the CPU tests' flow gate (tests/test_torch_vcn.py)
    p999, dmax = float(np.percentile(d, 99.9)), float(d.max())
    ok = p999 < 1e-3 and dmax < 0.5
    occ_err = float(np.abs(oc - oh).max())
    out.update(check_input=card_pred.input_size(*frames[0].shape[:2]), flow_p999_vs_cpu=p999,
               flow_max_vs_cpu=dmax, occ_max_vs_cpu=occ_err, vcn_params=n_params)
    if not (ok and occ_err < 1e-3 and np.isfinite(fc).all()):
        fail.append(f"VCN on the card against the CPU: flow p99.9 {p999:.2e} max {dmax:.2e}, "
                    f"occ {occ_err:.2e}")
    print(f"[preproc] VCN+ ({n_params} parameters) at {out['check_input']}: card against CPU "
          f"flow p99.9 {p999:.2e} px, max {dmax:.2e} px (gate 1e-3 / 0.5), occlusion logits "
          f"{occ_err:.2e} (gate 1e-3)", flush=True)

    pred = V.VCNFlowPredictor(card_pred.params, mean=mean)
    h, w = frames[0].shape[:2]
    mh, mw = pred.input_size(h, w)
    im = torch.randn(2, 3, mh, mw, device="cuda") * 0.25
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out["vcn_forward_ms"] = cuda_time(lambda: V.vcn_forward(pred.params, im),
                                          iters=PREPROC_TIMED_PAIRS, warmup=1)
        out["vcn_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    t0 = time.perf_counter()
    for i in range(PREPROC_TIMED_PAIRS):
        pred(frames[i], frames[i + 1])
    out["vcn_pair_wall_ms"] = (time.perf_counter() - t0) / PREPROC_TIMED_PAIRS * 1e3
    print(f"[preproc] VCN+ at the ~2 MP protocol ({h} x {w} frames -> {mh} x {mw}): "
          f"vcn_forward {out['vcn_forward_ms']:.1f} event ms a pair, the predictor "
          f"{out['vcn_pair_wall_ms']:.1f} ms wall a pair (uint8 resize, upload, network, "
          f"download, float resize), peak {out['vcn_peak_gib']:.2f} GiB above the "
          f"{base / 2 ** 30:.2f} GiB held ({card})", flush=True)
    if profile:
        out["profile"] = profile_vcn(pred.params, im, card)

    # (b) the entry point on the scene
    seq, db, cfg_dir = "flap-pre", os.path.join(tmp, "pdb"), os.path.join(tmp, "pcfg")
    argv = ["--seqname", seq, "--input", src["JPEGImages"], "--mask_dir", src["Annotations"],
            "--weights_dir", wdir, "--database", db, "--config_dir", cfg_dir,
            "--img_size", str(COLDSTART_IMG)]
    FM.reset_launches()
    t0 = time.perf_counter()
    res = preproc_app.main(argv)
    out["app_s"] = time.perf_counter() - t0
    out["stage_s"] = res["times"]
    out["vcn_calls"] = res["flow_calls"]
    launches = sum(FM.launches_by_call.values())
    info, batch = check_database(db, seq, cfg_dir, res, fail)
    dp = [listing(db, seq, "Densepose", f) for f in ("0*.pfm", "feat-*.pfm", "bbox-*.txt")]
    if [len(x) for x in dp] != [COLDSTART_FRAMES] * 3 or any(read_pfm(p)[0].any() for p in dp[1]):
        fail.append(f"Densepose files {[len(x) for x in dp]}")
    if launches:
        fail.append(f"{launches} fused-MLP launches in the preprocessing phase")
    out.update(info)
    print(f"[preproc] preproc_app.main {out['app_s']:.1f} s: stages "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res["times"].items())
          + f"; {database_line(res, info)}; {launches} fused-MLP launches", flush=True)

    # (c) what the port refuses
    refusals = []
    video = os.path.join(tmp, "clip.mp4")
    open(video, "wb").close()
    empty = os.path.join(tmp, "no_weights")
    os.makedirs(empty, exist_ok=True)
    for name, (inp, weights) in (("video", [video, empty]), ("no vcn", [src["JPEGImages"], empty])):
        case_argv = ["--seqname", "refused", "--input", inp, "--mask_dir", src["Annotations"],
                     "--weights_dir", weights, "--database", os.path.join(tmp, "rdb"),
                     "--config_dir", os.path.join(tmp, "rcfg")]
        try:
            preproc_app.main(case_argv)
            fail.append(f"preproc_app ran with {name}")
        except NotImplementedError as e:
            refusals.append(name)
            print(f"[preproc] refused ({name}): {str(e)[:120]}", flush=True)
    out["refused"] = refusals
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[preproc] phase {out['phase_s']:.1f} s", flush=True)
    if fail:
        raise SystemExit("preproc: " + "; ".join(fail))
    return out


PR_DETECT = 16  # the seeded PointRend's raised class: dog, one of preproc_app's animals
PR_KEEP = tuple(range(14, 24))  # preproc_app's animal classes (preprocess/mask.py:50-126)
CSE_VERTICES = 5000
GRAPH_FPN_TOL = 1e-4   # relative L2 of each FPN level, card against CPU
GRAPH_SCORE_TOL = 1e-5
GRAPH_BOX_TOL = 1e-2   # px
GRAPH_MASK_TOL = 1e-3  # share of pixels
GRAPH_COS_TOL = 1e-5


def params_count(tree) -> int:
    from moda_tpu_torch.bridge import flatten
    return int(sum(v.size for v in flatten(tree).values()))


def run_preproc_graphs(card: str, tmp: str) -> dict:
    """Phase 12, the detectron2 preprocessing graphs at their published
    widths with seeded detectron2-layout weights (``pointrend_infer.
    reference_state_dict`` with class PR_DETECT raised above the score
    threshold, ``cse_infer.reference_state_dict`` with a unit-norm table of
    CSE_VERTICES vertices), on phase 8's 16-frame 256 px scene in ``tmp``:

    (a) PointRend (R50-FPN, 80 classes, input 512, 5 subdivision steps of
        784 points, the animal classes kept) on frame 0, on the card and on
        a CPU copy, both fp32 (resolve_device turns TF32 off): every FPN
        level within GRAPH_FPN_TOL (relative L2), the same class, the score
        within GRAPH_SCORE_TOL, the box within GRAPH_BOX_TOL px, the masks
        differing on at most GRAPH_MASK_TOL of the pixels; the score's
        margin over the threshold is printed. Then the 16 frames: wall ms a
        frame, the backbone + RPN's device ms (CUDA events, the input
        already on the card), the host share of the wall (everything but
        the device parts: NMS, the subdivision's resizes and point choice,
        the uploads and downloads), the peak device memory;
    (b) DensePose-CSE (R50-FPN, 8 convs of 512, E = 16, input 448) on frame
        0 with the scene's mask, card against CPU: per-pixel cosine >= 1 -
        GRAPH_COS_TOL, the vertex map equal on >= 99.9% of the mask, the
        box equal; the 16 frames' wall ms a frame, ``embed``'s device ms
        (CUDA events), the peak memory;
    (c) ``preproc_app.main`` with ``pointrend.npz``, ``cse.npz`` and phase
        11's ``vcn_rob.npz`` under --weights_dir, no --mask_dir, a fresh
        database: PointRend's 16 masks (the non-empty ones counted), 16
        feature PFMs unit-norm at every pixel where the frame's mask is
        not empty (zero where it is), 16 box files and 16 vertex maps, the
        "train with" line without --nouse_embed, phase 11's flow, shard and
        line-batch checks, the batch's dp_feats non-zero wherever its mask
        is, and no fused-MLP launch. Each stage's time is printed.
    No failure is caught: any exits non-zero."""
    import types

    import numpy as np
    import torch
    from moda_tpu_torch.cli import preproc_app
    from moda_tpu_torch.data import imageio as IO
    from moda_tpu_torch.data.pfm import read_pfm
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.preproc import cse_infer as CI
    from moda_tpu_torch.preproc import pointrend_infer as PR
    from moda_tpu_torch.preproc.checkpoints import save_pytree_npz
    from moda_tpu_torch.preproc.pipeline import read_bgr

    t_phase = time.perf_counter()
    out, fail = {}, []
    src = {k: os.path.join(tmp, "cdb", k, "Full-Resolution", "flap-smoke")
           for k in ("JPEGImages", "Annotations")}
    frames = [read_bgr(p) for p in sorted(glob.glob(os.path.join(src["JPEGImages"], "*.jpg")))]
    masks = [(IO.imread(p, gray=True) > 0).astype(np.uint8)
             for p in sorted(glob.glob(os.path.join(src["Annotations"], "*.png")))]

    # (a) PointRend
    pr_tree = PR.convert_pointrend_checkpoint(PR.reference_state_dict(0, detect_class=PR_DETECT))
    card_p = PR.PointRendPredictor(pr_tree, keep_classes=PR_KEEP, device="cuda")
    cpu_p = PR.PointRendPredictor(pr_tree, keep_classes=PR_KEEP, device="cpu")
    imp, _, hw = CI.pad_resized(frames[0], card_p.input_size)
    fc, fh = card_p.features(imp), cpu_p.features(imp)
    fpn_err = {k: rel_l2(fc[k].cpu(), fh[k]) for k in fc}
    dc, dh = card_p._detect(fc, hw), cpu_p._detect(fh, hw)
    (mc, sc, bc), (mh, sh, bh) = card_p(frames[0]), cpu_p(frames[0])
    if dc is None or dh is None or bc is None or bh is None:
        raise SystemExit(f"preproc graphs: no detection (card {dc}, CPU {dh})")
    box_err = float(np.abs(bc - bh).max())
    mask_diff = float((mc != mh).mean())
    out["pointrend"] = {
        "params": params_count(pr_tree), "fpn_rel_l2": max(fpn_err.values()),
        "class": [dc[1], dh[1]], "score": [sc, sh], "margin": sc - card_p.score_thresh,
        "box_max_err_px": box_err, "mask_diff_share": mask_diff,
        "mask_share": float(mc.mean())}
    if max(fpn_err.values()) > GRAPH_FPN_TOL or dc[1] != dh[1] \
            or abs(sc - sh) > GRAPH_SCORE_TOL or box_err > GRAPH_BOX_TOL \
            or mask_diff > GRAPH_MASK_TOL:
        fail.append(f"PointRend on the card against the CPU: {out['pointrend']}")
    print(f"[graphs] PointRend ({out['pointrend']['params']} parameters, input "
          f"{card_p.input_size}): card against CPU, FPN levels rel L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in fpn_err.items())
          + f" (gate {GRAPH_FPN_TOL:g}); class {dc[1]} / {dh[1]}, score {sc:.7f} / {sh:.7f} "
          f"(margin {sc - card_p.score_thresh:.4f} over {card_p.score_thresh}), box "
          f"{np.round(bc, 2).tolist()} max err {box_err:.2e} px (gate {GRAPH_BOX_TOL:g}), masks "
          f"differ on {mask_diff:.2e} of the pixels (gate {GRAPH_MASK_TOL:g}), mask "
          f"{mc.mean():.3f} of the frame", flush=True)

    x = CI.normalize_image(imp, "cuda")

    def backbone_rpn():
        f = card_p.net.backbone(x)
        f["p6"] = f["p5"][:, :, ::2, ::2]
        return [card_p.net.rpn(f[k]) for k in ("p2", "p3", "p4", "p5", "p6")]

    with torch.inference_mode():
        dev_ms = cuda_time(backbone_rpn, iters=5, warmup=2)
        flops = layer_flops(card_p.net, backbone_rpn)
    stats, outs = timed_frames(card_p, frames, lambda p, f, i: p(f))
    out["pointrend"].update(stats, device_ms=dev_ms, gflop=flops / 1e9,
                            bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                            detections=sum(o[2] is not None for o in outs))
    out["pointrend"]["host_share"] = 1 - dev_ms / out["pointrend"]["wall_ms"]
    # a second pass with the host's NMS and float resizes (the subdivision's
    # 2 a step, the mask's paste and frame resizes) timed on the host clock
    host: dict = {}

    def host_timed(name, fn):
        def timed(*a, **k):
            t = time.perf_counter()
            r = fn(*a, **k)
            host[name] = host.get(name, 0.0) + time.perf_counter() - t
            return r
        return timed

    io_split = types.SimpleNamespace(resize=host_timed("resize", IO.resize),
                                     INTER_LINEAR=IO.INTER_LINEAR)
    with _patched([(PR, "nms", host_timed("nms", PR.nms)), (PR, "IO", io_split)]):
        for f in frames:
            card_p(f)
    out["pointrend"].update({f"{k}_ms": v / len(frames) * 1e3 for k, v in host.items()})
    print(f"[graphs] PointRend over {len(frames)} frames: {out['pointrend']['wall_ms']:.1f} ms "
          f"wall a frame, backbone + RPN {dev_ms:.2f} ms device (CUDA events; "
          f"{flops / 1e9:.1f} GFLOP, bound {out['pointrend']['bound_ms']:.2f} ms at "
          f"{PEAK_FP32_FLOPS / 1e12:g} TFLOP/s fp32), the rest "
          f"{out['pointrend']['host_share']:.2f} of the wall (host clock a frame: NMS "
          f"{out['pointrend']['nms_ms']:.1f} ms, float resizes {out['pointrend']['resize_ms']:.1f}"
          f" ms; the ROI and point heads, transfers); {out['pointrend']['detections']} "
          f"detections; peak {out['pointrend']['peak_gib']:.2f} GiB ({card})", flush=True)

    # (b) DensePose-CSE
    cse_tree = CI.convert_cse_checkpoint(CI.reference_state_dict(0, n_vertices=CSE_VERTICES))
    card_c = CI.CSEPredictor(cse_tree["backbone"], cse_tree["head"],
                             cse_tree["vertex_embeddings"], device="cuda")
    cpu_c = CI.CSEPredictor(cse_tree["backbone"], cse_tree["head"],
                            cse_tree["vertex_embeddings"], device="cpu")
    (ec, vc, bxc), (eh, vh, bxh) = card_c(frames[0], masks[0]), cpu_c(frames[0], masks[0])
    norms = np.linalg.norm(ec, axis=0) * np.linalg.norm(eh, axis=0)
    cos = float(((ec * eh).sum(0) / norms).min())
    inside = masks[0] > 0
    vert_eq = float((vc[inside] == vh[inside]).mean())
    out["cse"] = {"params": params_count({k: cse_tree[k] for k in ("backbone", "head")}),
                  "cos_min": cos, "vert_equal": vert_eq,
                  "box_equal": bool(np.array_equal(bxc, bxh))}
    if cos < 1 - GRAPH_COS_TOL or vert_eq < 0.999 or not out["cse"]["box_equal"]:
        fail.append(f"CSE on the card against the CPU: {out['cse']}")
    print(f"[graphs] CSE ({out['cse']['params']} parameters, {CSE_VERTICES} vertices, input "
          f"{card_c.input_size}): card against CPU, cosine >= {cos:.8f} (gate "
          f"{1 - GRAPH_COS_TOL}), vertex map equal on {vert_eq:.5f} of the mask (gate 0.999), "
          f"box equal {out['cse']['box_equal']}", flush=True)
    imp_c, scale_c, _ = CI.pad_resized(frames[0], card_c.input_size)
    with torch.inference_mode():
        dev_c = cuda_time(lambda: card_c.embed(imp_c, bxc * scale_c), iters=5, warmup=2)
        flops_c = layer_flops(card_c.backbone, lambda: card_c.embed(imp_c, bxc * scale_c)) \
            + layer_flops(card_c.head, lambda: card_c.embed(imp_c, bxc * scale_c))
    stats, _ = timed_frames(card_c, frames, lambda p, f, i: p(f, masks[i]))
    out["cse"].update(stats, device_ms=dev_c, gflop=flops_c / 1e9,
                      bound_ms=flops_c / PEAK_FP32_FLOPS * 1e3)
    print(f"[graphs] CSE over {len(frames)} frames: {out['cse']['wall_ms']:.1f} ms wall a "
          f"frame, embed {dev_c:.2f} ms device (CUDA events, the input's upload included; "
          f"{flops_c / 1e9:.1f} GFLOP, bound {out['cse']['bound_ms']:.2f} ms); peak "
          f"{out['cse']['peak_gib']:.2f} GiB ({card})", flush=True)
    del card_p, cpu_p, card_c, cpu_c

    # (c) the entry point, masks by PointRend and features by CSE
    wdir = os.path.join(tmp, "graph_weights")
    os.makedirs(wdir, exist_ok=True)
    save_pytree_npz(os.path.join(wdir, "pointrend.npz"), pr_tree)
    save_pytree_npz(os.path.join(wdir, "cse.npz"), cse_tree)
    os.symlink(os.path.join(tmp, "vcn_weights", "vcn_rob.npz"),
               os.path.join(wdir, "vcn_rob.npz"))
    seq, db, cfg_dir = "flap-graphs", os.path.join(tmp, "gdb"), os.path.join(tmp, "gcfg")
    argv = ["--seqname", seq, "--input", src["JPEGImages"], "--weights_dir", wdir,
            "--database", db, "--config_dir", cfg_dir, "--img_size", str(COLDSTART_IMG)]
    FM.reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = preproc_app.main(argv)
    out["app_s"] = time.perf_counter() - t0
    print(printed.getvalue(), end="", flush=True)
    launches = sum(FM.launches_by_call.values())
    out["stage_s"] = res["times"]
    info, batch = check_database(db, seq, cfg_dir, res, fail)
    out.update(info)
    n = COLDSTART_FRAMES
    made = [IO.imread(p, gray=True) > 0 for p in listing(db, seq, "Annotations", "*.png")]
    dp = [listing(db, seq, "Densepose", f) for f in ("0*.pfm", "feat-*.pfm", "bbox-*.txt")]
    if [len(x) for x in dp] != [n] * 3 or len(made) != n:
        fail.append(f"{len(made)} masks, Densepose files {[len(x) for x in dp]}")
    norm_err = 0.0
    for m, p in zip(made, dp[1]):
        norms = np.linalg.norm(read_pfm(p)[0].reshape(16, -1), axis=0)
        err = float(np.abs(norms - 1).max()) if m.any() else float(norms.max())
        norm_err = max(norm_err, err)
    if norm_err > 1e-4:
        fail.append(f"feature norms off by {norm_err:.2e}")
    line = [x for x in printed.getvalue().splitlines() if "train with" in x]
    if not res["have_cse"] or len(line) != 1 or "--nouse_embed" in line[0]:
        fail.append(f"have_cse {res['have_cse']}, closing line {line}")
    fg = batch["masks"][:, 0] > 0
    feat_norm = np.linalg.norm(batch["dp_feats"], axis=1)
    if fg.any() and not (feat_norm[fg] > 0).all():
        fail.append(f"{int((feat_norm[fg] == 0).sum())} masked line pixels with zero features")
    if launches:
        fail.append(f"{launches} fused-MLP launches in the preprocessing-graphs phase")
    out["masks_nonempty"] = int(sum(m.any() for m in made))
    out["feature_norm_err"] = norm_err
    out["line_mask_pixels"] = int(fg.sum())
    print(f"[graphs] preproc_app.main {out['app_s']:.1f} s: stages "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res["times"].items())
          + f"; {out['masks_nonempty']} of {n} PointRend masks non-empty, feature norms off "
          f"by {norm_err:.2e} at most; {database_line(res, info)}, {out['line_mask_pixels']} "
          f"masked pixels with CSE features; {launches} fused-MLP launches", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[graphs] phase {out['phase_s']:.1f} s", flush=True)
    if fail:
        raise SystemExit("preproc graphs: " + "; ".join(fail))
    return out


# ------------------------------------- K steps a call, data parallelism
CHUNK_K = 4           # (a): one chunked call of K init steps against K calls
PARALLEL_STEPS = 3    # (b): steps a rank makes; the replicas must then be bit-identical
DP_ITERS = 50         # (c): ITERS_PER_EPOCH of the entry-point run, cut from 200
DP_CHUNK = 10         # (c): --steps_chunk
# (a) chunked against sequential on the card: the same kernels in the same
# order, but scatter-adds (index_add_ and indexing backwards) add in the
# order their atomics land, so the steps part in the last bits and Adam
# (~lr x sign(g) per step) can flip a near-zero component: losses at
# CHUNK_LOSS_TOL, group norms at CHUNK_NORM_TOL, parameters at 2 lr x the
# group LR multiplier (10 at most) a step
CHUNK_LOSS_TOL, CHUNK_NORM_TOL = 1e-4, 1e-3
# (b) two ranks against one process: the losses read the gathered global
# tensors in the one-process order, but each rank's per-ray products run on
# half the rows, where the library may pick other kernels and roundings
# (the first card run read the loss 3.24e-5 apart; a one-rank world reads
# it bit-equal): losses at DP_LOSS_TOL. The gradients add the ranks' shares
# in another order, which the feat-match transport's backward magnifies
# (2.1e-4 of nerf_feat's norm at the CPU tests' widths, 2.2e-3 on the
# card): group norms at DP_NORM_TOL, parameters at 20 lr0 (non-finite or
# runaway updates only: one Adam step moves a component ~lr at most).
# What the gates read for a broken step (--plant, H100 80GB HBM3, 700 W):
# plain DDP of local losses ("gather") the loss 7.2e-2 (norms 7.6e-3); no
# gradient all-reduce ("mean") the norms 0.54 (loss 3.2e-5, as correct)
DP_LOSS_TOL, DP_NORM_TOL = 1e-4, 1e-2
# faults --plant sets in (b)'s two ranks (monkeypatched in the rank's
# process), to read what the gates read for a broken data-parallel step
PLANTS = {"gather": "no gather of the rendered rays: each rank's own loss, "
                    "gradients averaged (plain DDP); the eikonal term samples the "
                    "rank's own points",
          "mean": "no all-reduce of the gradients: each rank's own gradient"}
LOSS_TERMS = ("img_loss", "sil_loss", "flo_loss", "feat_loss", "feat_rnd_loss", "proj_loss",
              "visibility_loss", "ekl_loss", "bone_loc_loss", "cyc_loss", "root_sm_loss")


def _norms(aux, j=None) -> dict:
    return {k: float(v if j is None else v[j]) for k, v in aux.items() if k.endswith("_g")}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _add_launches(results: list, calls: dict, stage: str = "init") -> int:
    """Add the init-stage call sites' launches in ``calls`` to the kernel
    JSON's counts; returns their sum."""
    total = 0
    for r in results:
        n = sum(calls.get(f"{counter_kind(r['name'], False)}:{site}:{nets_of(site)}", 0)
                for st, site in r["runs"] if st == stage)
        r["launches"] += n
        total += n
    return total


def run_chunk(results: list, card: str, fail: list, profile: bool) -> dict:
    """(a) one call of the chunked step (CHUNK_K init steps at full width)
    against CHUNK_K calls of the step, from the same parameters, batch,
    per-step scalars (progress moves each step) and generator state."""
    import copy
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import CHUNK_STEP_FIELDS, make_train_step

    K = CHUNK_K
    t_a = time.perf_counter()
    _, ns, na, use_fine, use_dskin = STAGES["init"]
    cfg, model, batch, extras, rays = make_stage("init", "cuda")
    kw = dict(nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
              use_bones=True, nsample_active=na)
    m_seq, m_ch = model, copy.deepcopy(model)
    seq = make_train_step(m_seq, MoDAOptimizer(cfg, total_steps=24000), **kw)
    chunk = make_train_step(m_ch, MoDAOptimizer(cfg, total_steps=24000), chunk_steps=K, **kw)
    per_step = {f: torch.stack([torch.as_tensor(getattr(extras, f), dtype=torch.float32,
                                                device="cuda")] * K) for f in CHUNK_STEP_FIELDS}
    per_step["progress"] = torch.linspace(0.4, 0.6, K, device="cuda")
    stacked = {k: torch.stack([v] * K) for k, v in batch.items()}

    def run_seq(gen):
        return [one_step(seq, batch, extras._replace(progress=per_step["progress"][j]),
                         generator=gen)[0]
                for j in range(K)]

    def run_chunked(gen):
        return chunk(stacked, extras, per_step, generator=gen)[0]

    FM.reset_launches()
    a_seq = run_seq(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    seq_calls = dict(FM.launches_by_call)
    FM.reset_launches()
    a_ch = run_chunked(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    ch_calls = dict(FM.launches_by_call)
    loss_s = [float(a["total_loss"]) for a in a_seq]
    loss_c = [float(v) for v in a_ch["total_loss"]]
    worst_loss = max(_rel(c, s) for c, s in zip(loss_c, loss_s))
    worst_norm = max(_rel(_norms(a_ch, j)[k], v) for j, a in enumerate(a_seq)
                     for k, v in _norms(a).items())
    lr0 = cfg.learning_rate / 25.0
    worst_p = max(float((p.detach() - q.detach()).abs().max())
                  for p, q in zip(m_ch.parameters(), m_seq.parameters()))
    t_gates = time.perf_counter() - t_a
    bit = all(torch.equal(p, q) for p, q in zip(m_ch.parameters(), m_seq.parameters()))
    print(f"[parallel] (a) {K} init steps in one call against {K} calls ({t_gates:.1f} s with "
          f"the builds): losses "
          f"{[round(v, 6) for v in loss_c]} / {[round(v, 6) for v in loss_s]}, worst rel "
          f"{worst_loss:.2e} (tol {CHUNK_LOSS_TOL}); group norms worst rel {worst_norm:.2e} "
          f"(tol {CHUNK_NORM_TOL}); parameters max abs {worst_p:.3e} (tol "
          f"{2 * K * 10 * lr0:.1e}); bit-identical parameters: {bit}", flush=True)
    if not (worst_loss <= CHUNK_LOSS_TOL and all(math.isfinite(v) for v in loss_c)):
        fail.append(f"(a) chunked losses {loss_c} against {loss_s}")
    if not worst_norm <= CHUNK_NORM_TOL:
        fail.append(f"(a) chunked group norms {worst_norm:.2e} from the sequential steps'")
    if not worst_p <= 2 * K * 10 * lr0:
        fail.append(f"(a) chunked parameters {worst_p:.3e} from the sequential steps'")
    want = expected_calls("init", K)
    print(f"[parallel] (a) launches by call site: chunked {ch_calls}, sequential {seq_calls}",
          flush=True)
    if ch_calls != want or seq_calls != want:
        fail.append(f"(a) launches {ch_calls} / {seq_calls} != {want}")
    launches = _add_launches(results, ch_calls)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / K * 1e3

    gen = torch.Generator(device="cuda").manual_seed(5)
    t = {"seq": [], "chunk": []}
    for name in ("seq", "chunk", "chunk", "seq"):
        t[name].append(timed(run_seq if name == "seq" else run_chunked))
    out = {"ms_per_step_seq": t["seq"], "ms_per_step_chunk": t["chunk"], "losses": loss_c,
           "part_s": time.perf_counter() - t_a,
           "worst_loss_rel": worst_loss, "worst_norm_rel": worst_norm, "param_max_abs": worst_p,
           "bit_identical": bit, "launches": launches}
    print(f"[parallel] (a) ms per step, host clock ending in a sync (seq, chunk, chunk, seq): "
          f"sequential {[round(v, 2) for v in t['seq']]}, chunked "
          f"{[round(v, 2) for v in t['chunk']]} ({card})", flush=True)
    if profile:
        for name, fn in (("seq", run_seq), ("chunk", run_chunked)):
            _, dev, busy = profiled(lambda: fn(gen), 1)
            wall = min(t[name]) * K
            out[f"idle_share_{name}"] = 1 - busy / wall
            print(f"[profile parallel] (a) {name}: device busy {busy / K:.2f} ms/step of "
                  f"{wall / K:.2f}, idle share {out[f'idle_share_{name}']:.3f}", flush=True)
    return out


def _rank_main(rank: int, world: int, port: int, job: str, out_dir: str, args):
    """A spawned rank of phase 13 on cuda:0: job "step" runs the init stage's
    data-parallel step (args: backend, steps, plant: None or a fault of
    PLANTS, set in this process alone), job "app" runs train_app (args:
    argv per rank)."""
    import traceback
    import torch
    try:
        from moda_tpu_torch.ops import fused_mlp as FM
        if job == "step":
            from moda_tpu_torch.parallel import dist
            from moda_tpu_torch.train.optim import MoDAOptimizer
            from moda_tpu_torch.train.step import make_train_step
            backend, steps, plant = args
            if plant == "gather":  # each rank's loss on its own rays (plain DDP)
                dist.Shard.gather_dict = lambda self, d, keys: dict(d)
            elif plant == "mean":  # each rank updates with its own gradient
                dist.Comm.mean_ = lambda self, grads: grads
            comm = dist.init_process(rank, world, port=port, device="cuda:0", backend=backend,
                                     timeout_s=300)
            try:
                _, ns, na, use_fine, use_dskin = STAGES["init"]
                cfg, model, batch, extras, rays = make_stage("init", "cuda")
                step = make_train_step(model, MoDAOptimizer(cfg, total_steps=24000),
                                       nsample=ns, ndepth=cfg.ndepth, use_fine=use_fine,
                                       use_dskin=use_dskin, use_bones=True, nsample_active=na,
                                       comm=comm)
                draws = stage_draws("init", cfg, model, model, batch, extras, rays)
                if plant == "gather":  # the eikonal points: this rank's alone
                    draws["eik_idx"] %= rays // world * cfg.ndepth
                local = dist.shard_batch(batch, rank, world)
                FM.reset_launches()
                aux, _ = one_step(step, local, extras, draws=draws)
                torch.cuda.synchronize()
                res = {"aux": {k: float(v) for k, v in aux.items() if v.dim() == 0},
                       "calls": dict(FM.launches_by_call), "backend": comm.backend,
                       "params1": {n: p.detach().cpu().clone()
                                   for n, p in model.named_parameters()}}
                gen = torch.Generator(device="cuda").manual_seed(2)
                t0 = time.perf_counter()
                for _ in range(steps - 1):
                    one_step(step, local, extras, generator=gen)
                torch.cuda.synchronize()
                res["ms_per_step"] = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
                res["digest"] = (comm.check_same(dict(model.named_parameters()), "phase 13")
                                 if plant is None else None)
            finally:
                comm.close()
        else:
            from moda_tpu_torch.cli import train_app
            from moda_tpu_torch.train import trainer as TT
            os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                               "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
                               "MASTER_PORT": str(port)})
            TT.ITERS_PER_EPOCH = DP_ITERS
            FM.reset_launches()
            t0 = time.time()
            tr = train_app.main(args[rank], device="cuda:0", backend="gloo")
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for _, p in sorted(tr.model.named_parameters()):
                h.update(p.detach().cpu().numpy().tobytes())
            res = {"calls": dict(FM.launches_by_call), "run_s": time.time() - t0,
                   "save_dir": tr.save_dir, "log_path": tr.log_path,
                   "digest": h.hexdigest()[:16], "steps": tr.total_steps_done}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(world: int, job: str, out_dir: str, args, timeout: float) -> list:
    """``world`` spawned ranks of ``job``; their results in rank order.
    Every rank is killed when one fails or the run outlasts ``timeout``."""
    import socket
    import torch
    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, port, job, out_dir, args), nprocs=world,
                             join=False, start_method="spawn")
    t0 = time.time()
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > timeout:
                raise TimeoutError(f"{job}: {world} ranks ran past {timeout} s")
    except Exception as e:
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                if f.endswith(".err")]
        raise SystemExit(f"phase 13 {job}: {e}\n" + "\n".join(errs))
    finally:
        for pr in ctx.processes:
            if pr.is_alive():
                pr.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_ranks(results: list, card: str, tmp: str, fail: list, plant=None) -> dict:
    """(b) two ranks on the one card (gloo), one init step at full width on
    the global batch of 256 pairs (128 a rank) against the one-process step
    on the same batch and draws, then PARALLEL_STEPS - 1 more steps with
    the generator, after which the replicas must be bit-identical; then a
    one-rank NCCL world runs the same step. The loss and group-norm gates
    hold the step to the one-process step; the parameter gate (20 lr0
    after one Adam step of at most ~10 lr0 a component either way) catches
    only non-finite or runaway updates. plant (``--plant``): the first step
    alone, with a fault of PLANTS planted in both ranks, to read what the
    gates read for it."""
    import torch
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import make_train_step

    t_b = time.perf_counter()
    _, ns, na, use_fine, use_dskin = STAGES["init"]
    cfg, model, batch, extras, rays = make_stage("init", "cuda")
    step = make_train_step(model, MoDAOptimizer(cfg, total_steps=24000), nsample=ns,
                           ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
                           use_bones=True, nsample_active=na)
    aux1, _ = one_step(step, batch, extras,
                       draws=stage_draws("init", cfg, model, model, batch, extras, rays))
    torch.cuda.synchronize()
    one = {"loss": float(aux1["total_loss"]), "norms": _norms(aux1),
           "terms": {k: float(aux1[k]) for k in LOSS_TERMS if k in aux1},
           "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}}
    del model, step, batch
    torch.cuda.empty_cache()
    t0 = time.time()
    r0, r1 = spawn_ranks(2, "step", os.path.join(tmp, "ranks"),
                         ("gloo", 1 if plant else PARALLEL_STEPS, plant), 300)
    t_two = time.time() - t0
    worst_norm = max(_rel(r0["aux"][k], v) for k, v in one["norms"].items())
    loss_rel = _rel(r0["aux"]["total_loss"], one["loss"])
    lr0 = cfg.learning_rate / 25.0
    worst_p = max(float((r0["params1"][n] - p).abs().max()) for n, p in one["params"].items())
    out = {"loss_one": one["loss"], "loss_two": r0["aux"]["total_loss"], "loss_rel": loss_rel,
           "worst_norm_rel": worst_norm, "param_max_abs": worst_p}
    print(f"[parallel] (b) two ranks (gloo, one card{', planted: ' + plant if plant else ''}) "
          f"against one process, one init step on 256 pairs: loss "
          f"{r0['aux']['total_loss']:.6f} / {one['loss']:.6f} rel {loss_rel:.2e} "
          f"(tol {DP_LOSS_TOL}; bit-equal: {r0['aux']['total_loss'] == one['loss']}); group "
          f"norms worst rel {worst_norm:.2e} (tol {DP_NORM_TOL}); parameters max abs "
          f"{worst_p:.3e} (tol {20 * lr0:.1e}) ({card})", flush=True)
    print("[parallel] (b) loss terms, two ranks / one process (rel): " + ", ".join(
        f"{k} {r0['aux'][k]:.6g} / {v:.6g} ({_rel(r0['aux'][k], v):.1e})"
        for k, v in one["terms"].items()), flush=True)
    print("[parallel] (b) group norms, two ranks / one process (rel): " + ", ".join(
        f"{k} {_rel(r0['aux'][k], v):.1e}" for k, v in one["norms"].items()), flush=True)
    if not (loss_rel <= DP_LOSS_TOL and worst_norm <= DP_NORM_TOL and worst_p <= 20 * lr0):
        fail.append(f"(b) two ranks against one process: loss {loss_rel:.2e}, norms "
                    f"{worst_norm:.2e}, parameters {worst_p:.3e}")
    if plant:
        return out
    print(f"[parallel] (b) after {PARALLEL_STEPS} steps the replicas' digests {r0['digest']} / "
          f"{r1['digest']}; {r0['ms_per_step']:.1f} / {r1['ms_per_step']:.1f} ms a step a "
          f"rank; {t_two:.1f} s with the spawn ({card})", flush=True)
    for r, res in enumerate((r0, r1)):
        print(f"[parallel] (b) rank {r} launches by call site, one step: {res['calls']}",
              flush=True)
        if res["calls"] != expected_calls("init", 1):
            fail.append(f"(b) rank {r} launches {res['calls']}")
    if r0["digest"] != r1["digest"]:
        fail.append("(b) the replicas parted")
    launches = _add_launches(results, r0["calls"]) + _add_launches(results, r1["calls"])
    t0 = time.time()
    (nc,) = spawn_ranks(1, "step", os.path.join(tmp, "nccl"), (None, 1, None), 300)
    nccl_rel = _rel(nc["aux"]["total_loss"], one["loss"])
    print(f"[parallel] (b) one-rank {nc['backend']} world: loss {nc['aux']['total_loss']:.6f} "
          f"rel {nccl_rel:.2e} from one process (bit-equal: "
          f"{nc['aux']['total_loss'] == one['loss']}); {time.time() - t0:.1f} s with the spawn",
          flush=True)
    if nc["backend"] != "nccl" or not nccl_rel <= DP_LOSS_TOL:
        fail.append(f"(b) the one-rank NCCL step: {nc['backend']}, loss rel {nccl_rel:.2e}")
    launches += _add_launches(results, nc["calls"])
    return dict(out, ms_per_step_rank=[r0["ms_per_step"], r1["ms_per_step"]], spawn_s=t_two,
                nccl_loss_rel=nccl_rel, launches=launches, part_s=time.perf_counter() - t_b)


def run_app(results: list, card: str, tmp: str, fail: list) -> dict:
    """(c) ``train_app.main`` as two ranks (gloo, one card) on phase 6's
    dataset with its flags, --steps_chunk DP_CHUNK, at a global batch of
    256 pairs; ITERS_PER_EPOCH cut from 200 to DP_ITERS (the shape warmup
    too). Rank 1 gets a checkpoint directory of its own, which must stay
    absent: rank 0 alone writes."""
    argv = ["--seqname", "syn-smoke", "--config_dir", os.path.join(tmp, "cfg"), "--logname",
            "dp", "--img_size", str(TRAINER_IMG)] + TRAINER_FLAGS + ["--steps_chunk",
                                                                    str(DP_CHUNK)]
    dirs = [os.path.join(tmp, "log13"), os.path.join(tmp, "log13_rank1")]
    t_c = time.perf_counter()
    r0, r1 = spawn_ranks(2, "app", os.path.join(tmp, "app"),
                         [argv + ["--checkpoint_dir", d] for d in dirs], 600)
    rows = [json.loads(line) for line in open(r0["log_path"])]
    ep = [r for r in rows if "epoch_time" in r]
    step_rows = [r for r in rows if "total_loss" in r]
    for r, res in enumerate((r0, r1)):
        print(f"[parallel] (c) rank {r}: train_app.main {res['run_s']:.1f} s, launches "
              f"{res['calls']}", flush=True)
        if res["calls"] != expected_calls("init", DP_ITERS):
            fail.append(f"(c) rank {r} launches {res['calls']}")
    if os.path.exists(dirs[1]):
        fail.append(f"(c) rank 1 wrote {os.listdir(dirs[1])}")
    if len(ep) != 1 or ep[0].get("world_size") != 2 or not ep[0].get("replica_digest"):
        fail.append(f"(c) epoch lines {ep}")
    if r0["digest"] != r1["digest"] or r0["steps"] != DP_ITERS:
        fail.append(f"(c) digests {r0['digest']} / {r1['digest']}, steps {r0['steps']}")
    if not step_rows or not all(math.isfinite(r["total_loss"]) and r["grad_finite"] == 1.0
                                for r in step_rows):
        fail.append("(c) a logged step has a non-finite loss or gradient")
    e = ep[0] if ep else {}
    print(f"[parallel] (c) epoch {e.get('epoch_time', float('nan')):.2f} s ({DP_ITERS} steps, "
          f"steps_chunk {e.get('steps_chunk')}, t_mesh {e.get('t_mesh')} t_save "
          f"{e.get('t_save')} t_eval {e.get('t_eval')}); per rank "
          f"{e.get('ranks')}; replica digest {e.get('replica_digest')}; losses "
          f"{[round(r['total_loss'], 5) for r in step_rows]} ({card})", flush=True)
    launches = _add_launches(results, r0["calls"]) + _add_launches(results, r1["calls"])
    return {"epoch_s": e.get("epoch_time"), "ranks": e.get("ranks"), "launches": launches,
            "part_s": time.perf_counter() - t_c,
            "run_s": [r0["run_s"], r1["run_s"]], "losses": [r["total_loss"] for r in step_rows]}


def run_parallel(results: list, card: str, tmp: str, profile: bool = False) -> dict:
    """Phase 13: K optimizer steps a call and data parallelism over
    processes, at full widths (the init stage of bench.py's shapes: 256
    pairs x 4 px x 128 samples, D8 W256 trunk):
    (a) ``run_chunk``: one call of CHUNK_K chunked steps against CHUNK_K
        calls (losses, group norms, parameters; launches per call site
        CHUNK_K times one step's); ms per step both ways, with --profile
        the device idle share both ways;
    (b) ``run_ranks``: two ranks on the one card with gloo (NCCL refuses two
        ranks on one device) against the one-process step on the same
        global batch and draws; PARALLEL_STEPS steps, then the replicas
        bit-identical; launches per rank per call site; then a one-rank
        NCCL world's step against the one-process step;
    (c) ``run_app``: train_app.main as two ranks on phase 6's dataset with
        --steps_chunk DP_CHUNK at batch 256. Cut: ITERS_PER_EPOCH 50
        instead of 200 (one epoch, and the shape warmup's 50 steps).
    A two-card run waits for a machine with two cards."""
    t0 = time.perf_counter()
    fail: list = []
    out = {"card": card, "chunk": run_chunk(results, card, fail, profile)}
    import torch
    torch.cuda.empty_cache()
    out["ranks"] = run_ranks(results, card, tmp, fail)
    out["app"] = run_app(results, card, tmp, fail)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[parallel] phase {out['phase_s']:.1f} s: (a) {out['chunk']['part_s']:.1f} s, (b) "
          f"{out['ranks']['part_s']:.1f} s, (c) {out['app']['part_s']:.1f} s ({card})",
          flush=True)
    if fail:
        raise SystemExit("parallel: " + "; ".join(fail))
    return out


def timed_frames(pred, frames, call):
    """``call(pred, frame, i)`` over every frame after one warm-up call, the
    peak device memory reset before: ({wall ms a frame, peak GiB above what
    was held, GiB held}, the calls' outputs)."""
    import torch

    call(pred, frames[0], 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs = [call(pred, f, i) for i, f in enumerate(frames)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(frames) * 1e3
    return {"wall_ms": wall, "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            "held_gib": base / 2 ** 30}, outs


def layer_flops(module, fn) -> int:
    """Operations (2 a multiply-add) of the Conv2d, ConvTranspose2d and
    Linear layers of ``module`` in one call of ``fn``, counted from the
    shapes they see."""
    import torch

    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * mod.out_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, torch.nn.Conv2d):
            total[0] += 2 * out.numel() * mod.in_channels // mod.groups * math.prod(
                mod.kernel_size)
        else:
            total[0] += 2 * out.numel() * mod.in_features
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile the kernels and each stage's kernel-path step")
    ap.add_argument("--plant", choices=sorted(PLANTS),
                    help="run phase 13 (b) alone with this fault planted in both ranks; "
                         "exit 0 iff its gates catch it")
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

    t_start = time.time()
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

    if args.plant:
        base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logdir")
        os.makedirs(base, exist_ok=True)
        fail: list = []
        with tempfile.TemporaryDirectory(prefix="chip_smoke_plant_", dir=base) as tmp:
            out = run_ranks([], card, tmp, fail, plant=args.plant)
        print(json.dumps({"plant": args.plant, "fault": PLANTS[args.plant], "caught": fail,
                          **out}))
        raise SystemExit(0 if fail else 1)

    results: list = []
    check_kernels(results, profile=args.profile)
    print(f"[time] kernel phase done at {time.time() - t0:.1f} s", flush=True)
    check_dw(results)
    print(f"[time] dW phase done at {time.time() - t0:.1f} s", flush=True)
    steps = {}
    for name in RECIPE_STAGES:
        steps[name] = run_stage(name, results, card, profile=args.profile)
        print(f"[time] {name} done at {time.time() - t0:.1f} s", flush=True)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logdir")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_", dir=base) as tmp:
        steps["trainer"] = run_trainer(results, card, tmp, profile=args.profile)
        print(f"[time] trainer done at {time.time() - t0:.1f} s", flush=True)
        steps["extract"] = run_extract(card, tmp)
        print(f"[time] extraction and eval done at {time.time() - t0:.1f} s", flush=True)
        steps["coldstart"] = run_coldstart(results, card, tmp)
        print(f"[time] cold start and frame route done at {time.time() - t0:.1f} s", flush=True)
        steps["branches"] = run_branches(results, card, tmp, profile=args.profile)
        print(f"[time] branches done at {time.time() - t0:.1f} s", flush=True)
        steps["viz"] = run_viz(results, card, tmp)
        print(f"[time] viz tools and posenet done at {time.time() - t0:.1f} s", flush=True)
        steps["preproc"] = run_preproc(card, tmp, profile=args.profile)
        print(f"[time] preprocessing done at {time.time() - t0:.1f} s", flush=True)
        steps["preproc_graphs"] = run_preproc_graphs(card, tmp)
        print(f"[time] preprocessing graphs done at {time.time() - t0:.1f} s", flush=True)
        steps["parallel"] = run_parallel(results, card, tmp, profile=args.profile)
        print(f"[time] K steps a call and data parallelism done at {time.time() - t0:.1f} s",
              flush=True)
    for r in results:
        if r["launches"] == 0:
            raise SystemExit(f"{r['name']} was not launched on the main path")
        del r["runs"]
    print(json.dumps({"steps": steps}))
    print(f"[time] script total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
