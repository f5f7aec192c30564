"""chip_smoke.py's phase 9 (the step's branches) alone, on one CUDA card,
with the kernel and dW phases at the nerf_dis cases only: builds the
kernels, holds K1/K2/dW against the plain version at ``dis_r2048_s128`` and
``dis_coarse`` (profiled), writes phase 8's 16-frame 256 px MeshScene
dataset into a temporary directory under logdir/ and runs
``chip_smoke.run_branches`` on it (its profile tables included). Prints
the phase's JSON and the dis kernels' JSON line; exits non-zero where a
check fails, as chip_smoke.py does. About 3-4 minutes against the whole
script's 9-10.

    python3 scripts/torch_branches_probe.py
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as CS
    from moda_tpu_torch.data.synth_mesh import MeshScene
    from moda_tpu_torch.data.synthetic import write_frame_dataset
    from moda_tpu_torch.ops import fused_mlp as FM

    if not torch.cuda.is_available():
        raise SystemExit("torch_branches_probe: no CUDA card")
    t0 = time.time()
    card = CS.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    FM.build_library()
    CS.KERNEL_CASES = {k: v for k, v in CS.KERNEL_CASES.items() if k.startswith("dis")}
    results = []
    CS.check_kernels(results, profile=True)
    CS.check_dw(results)
    print(f"[time] kernels {time.time() - t0:.1f} s", flush=True)
    base = os.path.join(ROOT, "logdir")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="branches_", dir=base) as tmp:
        write_frame_dataset(os.path.join(tmp, "cdb"), os.path.join(tmp, "ccfg"), "flap-smoke",
                            MeshScene(img_size=CS.COLDSTART_IMG,
                                      num_frames=CS.COLDSTART_FRAMES))
        out = CS.run_branches(results, card, tmp, profile=True)
    print(json.dumps({"branches": out}, default=str))
    print(json.dumps({"kernels": results}))
    print(f"[time] total {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
