"""Phase 10's card-against-CPU NVS gate of chip_smoke.py alone, and how well
its input is conditioned.

(1) The gate as chip_smoke.py reads it, twice: ``nvs_app.main --test_frames
    1`` on the checkpoint ``nvs_fixed_checkpoint`` writes, on the card and
    on the CPU.
(2) For each seed and camera: ``nvs_fixed_model`` from that seed, the
    camera placed at frame 0, frame 0 rendered on the card, on the CPU in
    fp32 and on the CPU in fp64. Printed: the gate's readings (card against
    CPU fp32: culling flips, their largest gap, the frame's relative L2 over
    the unflipped pixels), the same readings of the card and of the CPU fp32
    against fp64, and each stage's relative L2 on the first (only) chunk:
    ray directions, canonical points after the backward warp, the MLP's
    rgb+SDF output and feature output per sample, visibility, compositing
    weights (unflipped samples), composited features (unflipped pixels).
    ``--rest_init`` keeps the rest pose as initialised (the model without
    its conditioning).

Writes phase 6's 16-frame dataset under ``--dir``. Without a card, (1) and
(2) run with the CPU in the card's place (a dry run). About 35 s a seed and
camera on the card's 8-core host.

    python scripts/nvs_gate_probe.py --seeds 20,21 --cams 0,8
"""
import argparse
import copy
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402

STAGES = ("rays_d", "xyz_c", "mlp_out", "feat", "vis", "weights", "feat_final")


def render(m, cam, rec, ndepth, chunk):
    """render_nvs of frame 0 from ``cam`` [1, 4, 4], with the first chunk's
    stages recorded into ``rec``."""
    import torch
    from moda_tpu_torch.render import pipeline as RP
    from moda_tpu_torch.render import rays as RB
    from moda_tpu_torch.viz.nvs import render_nvs

    bw, inf, build = RP._backward_warp, RP._inference, RB.build_rays_image

    def bw_(*a, **k):
        r = bw(*a, **k)
        rec.setdefault("xyz_c", r[0])
        return r

    def inf_(model, rays, xyz, *a, **k):
        r = inf(model, rays, xyz, *a, **k)
        if "weights" not in rec:
            code = torch.cat([a[1]] + [rays[q] for q in ("env_code", "appearance_code")
                                       if q in rays], -1)
            out, feat = model.apply_coarse_feat(xyz, code_dir=code, embed_raw=True,
                                                embed_alpha=rays.get("embed_alpha"), site=None)
            host = lambda t: t.cpu().double().numpy()  # noqa: E731
            rec.update(mlp_out=out, feat=feat, vis=k["vis_pred"], weights=r[3], feat_final=r[1],
                       cull=dict(xyz=host(xyz), bound=host(k["clip_bound"]),
                                 vis=host(k["vis_pred"])))
        return r

    def build_(view, rtk, kaug, *a, **k):
        dt = torch.get_default_dtype()
        r = build(view, rtk.to(dt), kaug.to(dt), *a, **k)
        rec.setdefault("rays_d", r["rays_d"])
        return r
    with CS._patched([(RP, "_backward_warp", bw_), (RP, "_inference", inf_),
                      (RB, "build_rays_image", build_)]):
        return render_nvs(m, cam, [0], 64, ndepth, chunk=chunk)[0]


def render64(m, cam, rec, ndepth, chunk):
    """``render`` of an fp64 copy of ``m``: the default dtype and
    ``Tensor.float`` are fp64 meanwhile (the ray builder casts to float)."""
    import torch
    from moda_tpu_torch.fields.model import ModelVars

    m64 = copy.deepcopy(m).double()
    m64.mvars = ModelVars(**{f.name: (v.double() if v.is_floating_point() else v)
                             for f in dataclasses.fields(m.mvars)
                             for v in [getattr(m.mvars, f.name)]})
    flt = torch.Tensor.float
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda t, *a, **k: t.to(torch.float64)
    try:
        return render(m64, cam, rec, ndepth, chunk)
    finally:
        torch.set_default_dtype(torch.float32)
        torch.Tensor.float = flt


def compare(a, b, ra, rb):
    """(flips, largest gap, {output: rel L2} over the unflipped pixels,
    {stage: rel L2}) of render ``a`` against ``b``."""
    flips, gap = CS.culling_flips(ra["cull"], rb["cull"])
    keep_p = ~flips.any(-1)
    stages = {}
    for s in STAGES:
        x = ra[s].detach().cpu().double().numpy()
        y = rb[s].detach().cpu().double().numpy()
        if s in ("mlp_out", "feat", "vis", "weights"):
            x, y = x[~flips], y[~flips]
        elif s == "feat_final":
            x, y = x[keep_p], y[keep_p]
        stages[s] = float("%.3g" % CS.rel_l2(x, y))
    kp = keep_p.reshape(64, 64)
    frame = {k: float("%.3g" % CS.rel_l2(np.asarray(a[k], np.float64)[kp],
                                         np.asarray(b[k], np.float64)[kp])) for k in b}
    return int(flips.sum()), float("%.3g" % gap), frame, stages


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default=str(CS.NVS_SEED))
    ap.add_argument("--cams", default="0")
    ap.add_argument("--rest_init", action="store_true")
    ap.add_argument("--skip_app", action="store_true", help="leave out (1)")
    ap.add_argument("--dir", default="")
    args = ap.parse_args()
    import torch
    from moda_tpu_torch.cli import nvs_app
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.data import dataset as D
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset
    from moda_tpu_torch.fields.model import MoDAModel
    from moda_tpu_torch.render import pipeline as RP
    from moda_tpu_torch.runtime import resolve_device

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cuda":
        resolve_device("cuda")  # as chip_smoke.py's main: TF32 off
        print(CS.card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.get_num_threads()} "
          f"CPU threads; the card's place: {dev}", flush=True)
    tmp = args.dir or tempfile.mkdtemp()
    cfgdir = os.path.join(tmp, "cfg")
    write_line_dataset(os.path.join(tmp, "db"), cfgdir, "syn-smoke",
                       SynthScene(img_size=CS.TRAINER_IMG, num_frames=CS.TRAINER_FRAMES))
    cfg = parse_config(["--seqname", "syn-smoke", "--config_dir", cfgdir, "--img_size",
                        str(CS.TRAINER_IMG), "--chunk", str(CS.NVS_CHUNK)] + CS.TRAINER_FLAGS)
    ds = D.build_datasets("syn-smoke", CS.TRAINER_IMG, cfgdir)
    seqs = load_seq_config("syn-smoke", cfgdir)
    info = DataInfo(offset=D.data_offsets(ds), intrinsics=tuple(tuple(s.ks) for s in seqs))
    rtks = np.stack([np.loadtxt(p) for p in ds[0].rtklist]).astype(np.float32)

    log = os.path.join(tmp, "log")
    for run in range(0 if args.skip_app else 2):
        ckpt = os.path.join(log, "nvs-fixed", "fixed")
        digest = CS.nvs_fixed_checkpoint(cfg, info, rtks, ckpt)
        argv = ["--seqname", "syn-smoke", "--config_dir", cfgdir, "--logname", "nvs-fixed",
                "--checkpoint_dir", log, "--model_path", ckpt, "--img_size",
                str(CS.TRAINER_IMG), "--chunk", str(CS.NVS_CHUNK), "--test_frames", "1"]
        got, culls, render_nvs = {}, {"card": {}, "cpu": {}}, nvs_app.render_nvs
        for side in ("card", "cpu"):
            def replay(*a, _side=side, **k):
                r = render_nvs(*a, **k)
                got.setdefault(_side, r[0])
                return r
            with CS._patched([(nvs_app, "render_nvs", replay),
                              (RP, "_inference", CS.culling_inputs(culls[side],
                                                                   RP._inference))]):
                nvs_app.main(argv, device=dev if side == "card" else "cpu")
        flips, gap = CS.culling_flips(culls["card"], culls["cpu"])
        keep = ~flips.any(-1).reshape(64, 64)
        frame = {k: float("%.3g" % CS.rel_l2(got["card"][k][keep], got["cpu"][k][keep]))
                 for k in got["cpu"]}
        print(f"app route, run {run}: model {digest}, flips {int(flips.sum())}, gap {gap:.3g}, "
              f"frame {frame}", flush=True)

    worst = 0.0
    for seed in (int(s) for s in args.seeds.split(",")):
        CS.NVS_SEED = seed
        for ci in (int(c) for c in args.cams.split(",")):
            t0 = time.perf_counter()
            r = rtks.copy()
            r[0] = rtks[ci]
            m = CS.nvs_fixed_model(cfg, info, r)
            if args.rest_init:
                m0 = MoDAModel(cfg, info, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
                with torch.no_grad():
                    m.rest_pose_code.weight.copy_(m0.rest_pose_code.weight)
            card = copy.deepcopy(m).to(dev)
            card.mvars = card.mvars.to(dev)
            recs = {"card": {}, "cpu32": {}, "cpu64": {}}
            frames = {"card": render(card, r[:1], recs["card"], cfg.ndepth, cfg.chunk),
                      "cpu32": render(m, r[:1], recs["cpu32"], cfg.ndepth, cfg.chunk),
                      "cpu64": render64(m, r[:1], recs["cpu64"], cfg.ndepth, cfg.chunk)}
            gate = compare(frames["card"], frames["cpu32"], recs["card"], recs["cpu32"])
            worst = max(worst, gate[1], max(gate[2].values()))
            print(f"seed {seed} cam {ci} sil {frames['cpu32']['sil_coarse'].mean():.3f} "
                  f"GATE card-vs-cpu32 flips {gate[0]} gap {gate[1]} frame {gate[2]} "
                  f"stages {gate[3]}", flush=True)
            for name in ("card", "cpu32"):
                c = compare(frames[name], frames["cpu64"], recs[name], recs["cpu64"])
                print(f"   {name}-vs-cpu64 flips {c[0]} gap {c[1]} frame {c[2]} stages {c[3]}",
                      flush=True)
            print(f"   {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"worst gate reading {worst} (limits: gap {CS.NVS_CULL_EPS}, frame 1e-4)")


if __name__ == "__main__":
    main()
