"""K1 and K2 of the port's fused MLP (csrc/fused_mlp.cu) timed at every call
site of chip_smoke.py's kernel phase, for one or more copies of the repo,
each in its own process, in the order given (list a copy twice to time it in
turns: parent, new, new, parent).

    python3 scripts/fmlp_ab.py _ab/parent . . _ab/parent --out ab.json
    python3 scripts/fmlp_ab.py . --sites trunk_feat_r2048,vis_r2048 --no-step

Per copy and site: K1's device ms (``fmlp_fwd_kernel``) and K2's, split
into the block kernel, the dW GEMM and the reductions (torch.profiler, 3
calls); the block kernels' shared memory and CTAs per SM as the wrapper
recorded them; sha256 of K1's outputs and of K2's dx and of all K2's
gradients at each site (the same seeded inputs in every copy, so equal
digests mean bit-identical results); the kernels' registers and what ptxas
said of their stack and spills; then the device-busy ms of an init step
(chip_smoke.py's stage, 3 profiled steps after 2 warm ones) and the
fused-MLP kernels' share of it. The copies' libraries are built first, all
at once. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (16 hex digits; chip_smoke.py's
    digest, which a parent's copy may not have)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def build(tree: str) -> str:
    out = subprocess.run([sys.executable, "-c", "from moda_tpu_torch.ops import fused_mlp as FM;"
                          "FM.build_library()"], cwd=tree, capture_output=True, text=True)
    return out.stderr[-2000:] if out.returncode else ""


def measure(tree: str, sites, step: bool) -> dict:
    """Runs inside the copy's own process (cwd = tree)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as CS
    from moda_tpu_torch.ops import fused_mlp as FM

    lib = FM.build_library()
    res = {"tree": tree, "card": CS.card_line(), "sites": {},
           "registers": {"K1": lib.moda_fmlp_registers(0), "K2": lib.moda_fmlp_registers(1)},
           "ptxas": [ln.strip() for ln in FM.ptxas_report().splitlines()
                     if "stack frame" in ln or "registers" in ln]}
    dev = torch.device("cuda")
    for name in sites:
        _, N, S, _, _, need_dx, _, fwd_only, _, _ = CS.KERNEL_CASES[name]
        gen = torch.Generator().manual_seed(0)
        mods, x, ctc, cdc, win, legacy = CS.build_case(name, gen, dev)
        weights = [w for m, _, _ in mods for w in m.flat_weights()]
        leaves = [x] + [t for t in (ctc, cdc, win) if t is not None] + weights

        def run(grad):
            for t in leaves:
                t.grad = None
            req = [t.requires_grad_(grad) for t in leaves]
            with torch.set_grad_enabled(grad):
                outs = FM.nerf_mlp_fused(mods, x, code_trunk=ctc, code_dir=cdc,
                                         samples_per_ray=S, need_dx=need_dx,
                                         embed_freqs=0 if legacy else 10, embed_window=win,
                                         compute_dtype=torch.bfloat16, kernel=True, site=name)
            return outs, req

        outs, _ = run(False)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
        r = {"points": N}
        _, ev, _ = CS.profiled(lambda: run(False), 3)
        r["K1_ms"] = CS.device_ms(ev, 3, ["fmlp_fwd"])
        r["K1_sha256"] = digest(outs)
        r["K1_smem"], r["K1_ctas"] = [v for k, v in FM.footprints.items()
                                      if k.startswith(f"fwd:{name}:")][0]
        if not fwd_only:
            def fwdbwd():
                o, req = run(True)
                return torch.autograd.grad(o, req, cots, allow_unused=True)

            grads = fwdbwd()
            torch.cuda.synchronize()
            r["K2_dx_sha256"] = digest(grads[:1])
            r["K2_grads_sha256"] = digest([g for g in grads if g is not None])
            _, ev, _ = CS.profiled(fwdbwd, 3)
            r.update({f"K2_{k}": v for k, v in CS.k2_split(ev).items()})
            r["K2_smem"], r["K2_ctas"] = [v for k, v in FM.footprints.items()
                                          if k.startswith(f"bwd:{name}:")][0]
        res["sites"][name] = r
        print(f"[ab] {tree} {name}: " + " ".join(f"{k} {v}" for k, v in r.items()), flush=True)
    if step:
        from moda_tpu_torch.train.optim import MoDAOptimizer
        from moda_tpu_torch.train.step import make_train_step

        _, ns, na, use_fine, use_dskin = CS.STAGES["init"]
        cfg, model, batch, extras, _ = CS.make_stage("init", "cuda")
        stp = make_train_step(model, MoDAOptimizer(cfg, total_steps=24000), nsample=ns,
                              ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
                              use_bones=True, nsample_active=na)
        g = torch.Generator(device="cuda").manual_seed(2)
        for _ in range(2):
            CS.one_step(stp, batch, extras, generator=g)
        _, ev, busy = CS.profiled(lambda: CS.one_step(stp, batch, extras, generator=g), 3)
        res["init_step"] = {"device_busy_ms": busy, "fmlp_ms": CS.device_ms(ev, 3, ["fmlp_"])}
        print(f"[ab] {tree} init step: {res['init_step']}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="copies of the repo, timed in this order")
    ap.add_argument("--sites", default="", help="chip_smoke.py KERNEL_CASES names (default all)")
    ap.add_argument("--no-step", action="store_true", help="skip the init step's device time")
    ap.add_argument("--out", default="fmlp_ab.json")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:  # one copy, in this process
        sys.path.insert(0, os.path.abspath(args.trees[0]))
        import chip_smoke as CS
        sites = args.sites.split(",") if args.sites else list(CS.KERNEL_CASES)
        res = measure(args.trees[0], sites, not args.no_step)
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fmlp_ab.py needs a CUDA card")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    uniq = list(dict.fromkeys(args.trees))
    with ThreadPoolExecutor(len(uniq)) as ex:
        for tree, err in zip(uniq, ex.map(build, uniq)):
            if err:
                raise SystemExit(f"{tree}: the build failed:\n{err}")
    runs = []
    for i, tree in enumerate(args.trees):
        part = os.path.abspath(f"{args.out}.{i}")
        cmd = [sys.executable, os.path.abspath(__file__), os.path.abspath(tree), "--one",
               "--out", part]
        cmd += ["--sites", args.sites] if args.sites else []
        cmd += ["--no-step"] if args.no_step else []
        if subprocess.run(cmd, cwd=tree).returncode:
            raise SystemExit(f"{tree}: the measurement failed")
        with open(part) as f:
            runs.append(json.load(f))
        os.remove(part)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    keys = ("K1_ms", "K2_block_ms")
    for name in runs[0]["sites"]:
        print(f"[ab] {name}: " + " | ".join(
            f"{r['tree']} " + " ".join(f"{k} {r['sites'][name].get(k, float('nan')):.3f}"
                                      for k in keys) for r in runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
