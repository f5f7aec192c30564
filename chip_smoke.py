"""Smoke run of the PyTorch/CUDA port on one H100.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile  # plus torch.profiler device-time tables

Phases:
1. print the card's name and power limit, torch and CUDA versions;
2. build the fused-MLP kernels from moda_tpu_torch/csrc;
3. hold K1 (forward) and K2 (backward) against the plain PyTorch version in
   bf16 mode at the three init-stage call sites and at a skin-like case
   with a per-ray trunk code; time the kernel, the plain version, a bf16
   layer-by-layer F.linear chain (yardstick) and compute the bound;
4. drive the port's init-stage train step (bench.py's init shape, full
   widths, random weights from a seed) for a few steps with the kernels,
   counting kernel launches;
5. one step of the plain path on the same inputs and parameters, its loss
   against the kernel path's.
Prints the kernel JSON line, then {"ok": true, "device": {...}} last.
Exits non-zero without printing a result when there is no CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
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


# --------------------------------------------------------------- kernels
def work(mods, N, x, ctc, cdc, win, outs, need_dx):
    """Operations and bytes the fused launch must do: (flops, bytes) of the
    forward and of the backward. Products only (the embed's trig is < 0.1%).
    The backward recomputes the forward (its activations are not inputs),
    then dW for every layer and d(input) for every layer but the first,
    whose input gradient is needed only for dx or a trunk code. Bytes:
    every input read once and every output written once, in fp32."""
    flops_f = flops_first = 0
    for m, use_ct, _ in mods:
        ks = m.flat_weights()[0::2]
        flops_f += sum(2 * N * w.numel() for w in ks)
        if need_dx or use_ct:
            flops_first += 2 * N * ks[0].shape[0] * ks[0].shape[1]
    flops_b = 3 * flops_f - sum(2 * N * m.flat_weights()[0].numel() for m, _, _ in mods) + \
        flops_first
    ins = [x, win] + [t for t in (ctc, cdc) if t is not None]
    n_in = sum(t.numel() for t in ins)
    n_w = sum(w.numel() for m, _, _ in mods for w in m.flat_weights())
    n_out = sum(o.numel() for o in outs)
    bytes_f = 4 * (n_in + n_w + n_out)
    # backward reads the inputs, the weights and the cotangents; writes the
    # weight gradients, the code and window gradients, and dx when needed
    grads_in = n_in - (0 if need_dx else x.numel())
    bytes_b = 4 * (n_in + n_w + n_out + n_w + grads_in)
    return flops_f, bytes_f, flops_b, bytes_b


# (name, nets [(D, W, in_dir, out, raw_feat, use_ct, use_cd)], R, S, ct, cd,
# need_dx, site) at the shapes the init step gives each call site, and the
# skin MLP's shape (a per-ray trunk code), which the init step does not run
KERNEL_CASES = [
    ("site1_trunk_feat", [(8, 256, 27 + 64, 3, False, False, True),
                          (5, 128, 0, 16, True, False, False)],
     2048, 128, 0, 91, True, "moda_tpu/render/pipeline.py:156"),
    ("site2_feat_grid", [(5, 128, 0, 16, True, False, False)],
     8000, 1, 0, 0, False, "moda_tpu/render/pipeline.py:215"),
    ("site3_vis", [(5, 64, 0, 1, True, False, False)],
     524288, 1, 0, 0, False, "moda_tpu/render/pipeline.py:502"),
    ("skin_ct", [(5, 64, 0, 25, True, True, False)],
     256, 128, 128, 0, True, "moda_tpu/render/pipeline.py:83"),
]


# the nets each init call site launches, as the wrapper's per-launch counter
# names them
NETS_OF_SITE = {"site1_trunk_feat": "D8W256+D5W128", "site2_feat_grid": "D5W128",
                "site3_vis": "D5W64"}


def check_kernels(results: list, off_path: list, profile: bool = False):
    """Each case's K1/K2 against the plain version, timed; the init call
    sites go to ``results``, the skin case to ``off_path``."""
    import torch
    from moda_tpu_torch.core.embedding import window_vec
    from moda_tpu_torch.fields.nets import NeRFMLP, reset_denses
    from moda_tpu_torch.ops import fused_mlp as FM

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name, specs, R, S, ct, cd, need_dx, site in KERNEL_CASES:
        N = R * S
        mods = []
        for D, W, in_dir, out, raw, use_ct, use_cd in specs:
            m = NeRFMLP(D=D, W=W, in_channels_xyz=63 + (ct if use_ct else 0),
                        in_channels_dir=in_dir, out_channels=out, raw_feat=raw)
            reset_denses(m, gen)
            mods.append((m.to(dev), use_ct, use_cd))
        x = (torch.randn(N, 3, generator=gen) * 0.3).to(dev)
        ctc = torch.randn(R, ct, generator=gen).to(dev) if ct else None
        cdc = torch.randn(R, cd, generator=gen).to(dev) if cd else None
        win = window_vec(10, 3, 7.5, device=dev)
        weights = [w for m, _, _ in mods for w in m.flat_weights()]
        leaves = [x] + [t for t in (ctc, cdc) if t is not None] + [win] + weights

        def run(kernel: bool, cdt=torch.bfloat16):
            for t in leaves:
                t.grad = None
            req = [t.requires_grad_(True) for t in leaves]
            outs = FM.nerf_mlp_fused(mods, x, code_trunk=ctc, code_dir=cdc,
                                     samples_per_ray=S, need_dx=need_dx, embed_freqs=10,
                                     embed_window=win, compute_dtype=cdt, kernel=kernel)
            return outs, req

        def values(kernel, cdt=torch.bfloat16):
            outs, req = run(kernel, cdt)
            grads = torch.autograd.grad(outs, req, gouts, allow_unused=True)
            return [o.detach() for o in outs], [None if g is None else g.detach() for g in grads]

        outs_f, req = run(False, torch.float32)
        gouts = [torch.randn(o.shape, generator=gen).to(dev) for o in outs_f]
        outs_f, grads_f = values(False, torch.float32)
        outs_p, grads_p = values(False)
        launches0 = dict(FM.launches)
        outs_k, grads_k = values(True)
        torch.cuda.synchronize()
        if (FM.launches["fwd"], FM.launches["bwd"]) != (launches0["fwd"] + 1,
                                                        launches0["bwd"] + 1):
            raise SystemExit(f"{name}: the kernel route did not launch K1 and K2 once each")

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
        names = ["x"] + [n for n, t in (("ct", ctc), ("cd", cdc)) if t is not None] + ["win"] + \
            [f"w{i}" for i in range(len(weights))]
        worst = (0.0, "")
        ok = True
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
                print(f"[kernels] {name} {nm}: rel_l2 {e:.3e} (tol {tol}) max-vs-fp32 kernel "
                      f"{far_k:.3e} plain-bf16 {far_p:.3e}", flush=True)
            d = float((k - p).abs().max())
            if nm.startswith("out"):
                max_abs_out = max(max_abs_out, d)
            else:
                max_abs_grad = max(max_abs_grad, d)
        print(f"[kernels] {name}: N={N} worst rel_l2 {worst[0]:.3e} on {worst[1]} "
              f"(tol out {tol_out}, grads {tol_grad}); max|kernel-plain| out {max_abs_out:.3e} "
              f"grads {max_abs_grad:.3e}", flush=True)
        if not ok:
            raise SystemExit(f"kernel mismatch in {name}")

        # ---- timing (forward, and forward + backward)
        def fwd(kernel):
            with torch.no_grad():
                FM.nerf_mlp_fused(mods, x, code_trunk=ctc, code_dir=cdc, samples_per_ray=S,
                                  need_dx=need_dx, embed_freqs=10, embed_window=win,
                                  compute_dtype=torch.bfloat16, kernel=kernel)

        def fwdbwd(kernel):
            outs, req = run(kernel)
            torch.autograd.grad(outs, req, gouts, allow_unused=True)

        xe_in = torch.randn(N, 63, device=dev, dtype=torch.bfloat16)

        def chain(backward: bool):
            # yardstick: the same stacks as separate bf16 F.linear calls
            ws = [(w.detach().to(torch.bfloat16).t().contiguous().requires_grad_(backward))
                  for w in weights]
            total = None
            with torch.set_grad_enabled(backward):
                for k, (m, use_ct, use_cd) in enumerate(mods):
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
                    if use_cd:
                        hf = torch.cat([hf, cdc.to(torch.bfloat16).repeat_interleave(S, 0)], -1)
                    hd = torch.relu(torch.nn.functional.linear(hf, ws[off + 2 * D + 4]))
                    o = torch.nn.functional.linear(hd, ws[off + 2 * D + 6]).float().sum()
                    total = o if total is None else total + o
                if backward:
                    total.backward()

        n_launch = dict(FM.launches)
        # the kernels' own device time, without the wrapper's host work
        fwdbwd(True)
        _, events, busy = profiled(lambda: fwdbwd(True), 3)
        d_kf = device_ms(events, 3, ["fmlp_fwd"])
        d_kb = device_ms(events, 3, ["fmlp_bwd", "fmlp_dw", "fmlp_reduce"])
        if profile:
            print(f"[kernels] profile K1+K2 {name}: device busy {busy:.3f} ms per call",
                  flush=True)
            print_table("kernels", events, 3, True, 8)
        t_kf = cuda_time(lambda: fwd(True))
        t_kb = cuda_time(lambda: fwdbwd(True)) - t_kf
        FM.launches.update(n_launch)  # timing launches are not main-path launches
        t_pf = cuda_time(lambda: fwd(False))
        t_pb = cuda_time(lambda: fwdbwd(False)) - t_pf
        t_cf = cuda_time(lambda: chain(False))
        t_cb = cuda_time(lambda: chain(True)) - t_cf

        flops_f, bytes_f, flops_b, bytes_b = work(mods, N, x, ctc, cdc, win, outs_p, need_dx)
        for kname, t_k, d_k, t_p, t_c, fl, by in (
                ("K1_fwd", t_kf, d_kf, t_pf, t_cf, flops_f, bytes_f),
                ("K2_bwd", t_kb, d_kb, t_pb, t_cb, flops_b, bytes_b)):
            t_ops, t_bytes = fl / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
            (off_path if name not in NETS_OF_SITE else results).append({
                "name": f"{kname}:{name}", "route": "cuda",
                "source": "moda_tpu_torch/csrc/fused_mlp.cu",
                "replaces": ("moda_tpu/ops/fused_mlp.py:341" if kname == "K1_fwd"
                             else "moda_tpu/ops/fused_mlp.py:375"),
                "call_site": site, "launches": 0,
                "max_abs_err": max_abs_out if kname == "K1_fwd" else max_abs_grad,
                "ms": t_k, "plain_ms": t_p, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "layer_chain_ms": t_c, "device_ms": d_k,
            })
            print(f"[kernels] {kname} {name}: kernel {t_k:.3f} ms (device only {d_k:.3f})  "
                  f"plain {t_p:.3f} ms  F.linear chain {t_c:.3f} ms  bound "
                  f"{max(t_ops, t_bytes):.3f} ms", flush=True)


# ------------------------------------------------------------ train step


def init_stage(device: str, seed: int = 0):
    """bench.py's init stage: 256 line pairs x 4 px x 128 depth samples,
    25 bones, no fine pass, delta-skin off, eikonal 0.001, full widths;
    random weights and data from ``seed``."""
    import numpy as np
    import torch
    from moda_tpu_torch.config import DataInfo, MoDAConfig
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.train.step import StepExtras

    n_pairs, num_fr = 256, 64
    cfg = MoDAConfig(nsample=4, eikonal_wt=0.001, num_bones=25, img_size=512, ndepth=128,
                     feat_ndepth_grid=20, lineload=True)
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
    return cfg, model, batch, extras, bs2 * cfg.nsample


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


def profile_steps(step, batch, extras, gen, step_s: float, n: int = 2):
    """Where the step's time goes on the device: torch.profiler over n
    kernel-path steps; prints device time by kernel and by PyTorch op and
    the device's idle share of the step."""
    ops, dev, busy = profiled(lambda: step(batch, extras, generator=gen), n)
    n_dev = sum(e.count for e in dev) / n
    print(f"[profile] device busy {busy:.2f} ms of {step_s * 1e3:.2f} ms/step "
          f"(idle share {1 - busy / (step_s * 1e3):.3f}); {n_dev:.0f} device activities "
          f"per step; fused-MLP kernels {device_ms(dev, n, ['fmlp_']):.2f} ms", flush=True)
    print_table("profile", dev, n, True, 25)
    print_table("profile", ops, n, False, 40)


def run_step_phases(results: list, card: str, profile: bool = False) -> dict:
    import copy
    import torch
    from moda_tpu_torch.ops import fused_mlp as FM
    from moda_tpu_torch.train.optim import MoDAOptimizer
    from moda_tpu_torch.train.step import make_train_step

    cfg, model, batch, extras, rays = init_stage("cuda")
    plain = copy.deepcopy(model)
    plain.cfg = cfg.replace(use_pallas=False)
    # the same draws for one kernel step and one plain step
    g = torch.Generator(device="cuda").manual_seed(1)
    R, S, G = rays, cfg.ndepth, cfg.feat_ndepth_grid
    draws = {"pix_ids": torch.randint(0, cfg.img_size, (2 * 256, cfg.nsample), generator=g,
                                      device="cuda"),
             "z_u": torch.rand(R, S, generator=g, device="cuda"),
             "grid_noise": torch.randn(G ** 3, 3, generator=g, device="cuda"),
             "vis_neg": torch.rand(R, S, 3, generator=g, device="cuda") * 2 - 1,
             "eik_idx": torch.randint(0, R * S, (1000,), generator=g, device="cuda")}
    opt_k = MoDAOptimizer(cfg, total_steps=24000)
    opt_p = MoDAOptimizer(cfg, total_steps=24000)
    step_k = make_train_step(model, opt_k, nsample=cfg.nsample, ndepth=cfg.ndepth,
                             use_fine=False, use_dskin=False, use_bones=True)
    step_p = make_train_step(plain, opt_p, nsample=cfg.nsample, ndepth=cfg.ndepth,
                             use_fine=False, use_dskin=False, use_bones=True)
    aux_p, _ = step_p(batch, extras, draws=draws)
    FM.launches.update(fwd=0, bwd=0)
    FM.launches_by_nets.clear()
    aux_k, _ = step_k(batch, extras, draws=draws)
    torch.cuda.synchronize()
    lk, lp = float(aux_k["total_loss"]), float(aux_p["total_loss"])
    # bf16 kernel path against the fp32 plain path from the same parameters
    # and draws: the MLP outputs differ by bf16 rounding (~1e-3 relative)
    loss_tol = 2e-2
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    print(f"[step] one step, same inputs: kernel loss {lk:.6f}  plain loss {lp:.6f}  "
          f"rel diff {rel:.3e} (tol {loss_tol})", flush=True)
    for k in ("img_loss", "sil_loss", "flo_loss", "feat_loss", "feat_rnd_loss", "cyc_loss",
              "proj_loss", "visibility_loss", "ekl_loss", "bone_loc_loss"):
        print(f"[step]   {k}: kernel {float(aux_k[k]):.6f} plain {float(aux_p[k]):.6f}", flush=True)
    if not (rel <= loss_tol and math.isfinite(lk) and math.isfinite(lp)):
        raise SystemExit("kernel-path loss disagrees with the plain path")
    if float(aux_k["grad_finite"]) != 1.0:
        raise SystemExit("non-finite gradients on the kernel path")

    gen = torch.Generator(device="cuda").manual_seed(2)
    n_warm, n_timed = 3, 10
    for _ in range(n_warm):
        step_k(batch, extras, generator=gen)
    torch.cuda.synchronize()
    FM.launches.update(fwd=0, bwd=0)
    FM.launches_by_nets.clear()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n_timed):
        aux, _ = step_k(batch, extras, generator=gen)
        losses.append(aux["total_loss"])
        finite = aux["grad_finite"]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    counts = dict(FM.launches)
    by_nets = dict(FM.launches_by_nets)
    losses = [float(v) for v in losses]
    print(f"[step] kernel path: {dt * 1e3:.2f} ms/step, {rays / dt:.1f} rays/s over {n_timed} "
          f"steps ({card}); losses {losses}; launches {counts} {by_nets}", flush=True)
    if not all(math.isfinite(v) for v in losses) or float(finite) != 1.0:
        raise SystemExit("non-finite loss or gradients on the kernel path")
    if counts != {"fwd": 3 * n_timed, "bwd": 3 * n_timed}:
        raise SystemExit(f"expected 3 forward and 3 backward launches per step, got {counts}")
    for r in results:
        site = r["name"].split(":")[1]
        kind = "fwd" if r["name"].startswith("K1") else "bwd"
        r["launches"] = by_nets.get(f"{kind}:{NETS_OF_SITE[site]}", 0)
        if r["launches"] != n_timed:
            raise SystemExit(f"{r['name']} launched {r['launches']} times in {n_timed} steps")

    if profile:
        profile_steps(step_k, batch, extras, gen, dt)
    for _ in range(1):
        step_p(batch, extras, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed // 2):
        step_p(batch, extras, generator=gen)
    torch.cuda.synchronize()
    dtp = (time.perf_counter() - t0) / (n_timed // 2)
    print(f"[step] plain path: {dtp * 1e3:.2f} ms/step, {rays / dtp:.1f} rays/s ({card})",
          flush=True)
    return {"ms_per_step": dt * 1e3, "rays_per_sec": rays / dt, "plain_ms_per_step": dtp * 1e3,
            "loss_kernel": lk, "loss_plain": lp, "card": card}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile the kernels and the kernel-path step")
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
    off_path: list = []
    check_kernels(results, off_path, profile=args.profile)
    step = run_step_phases(results, card, profile=args.profile)
    print(json.dumps({"step": step, "off_path_kernels": off_path}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
