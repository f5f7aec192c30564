"""Times the rest-mesh grid query and extract_mesh (the work the trainer's
``t_mesh`` times each epoch) on the card at full widths (the default
config: trunk D8 W256, visibility D5 W64), random weights from a seed, at
64^3 and 128^3. ``--root`` names the checkout whose moda_tpu_torch is
timed (this one by default), so that two checkouts can be compared in one
run: parent, change, change, parent. ``--chunks`` times the query at
other points a call too. Needs one CUDA card.

    python scripts/grid_query_time.py [--root DIR] [--grids 64,128] [--reps 5]
        [--chunks 65536,262144]

Prints the card's name and power limit, then one JSON line: for each grid,
the points a query call (0: one call), the query's ms by CUDA events and
by the host clock (median of --reps after one warm-up call), its peak
device memory, and extract_mesh's seconds (median of 3) and vertices.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def time_query(query, pts, reps: int):
    """The query's ms by CUDA events and by the host clock (each of
    ``reps`` calls after a warm-up call) and its peak device GiB."""
    import torch
    query(pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev, wall = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        query(pts)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(a.elapsed_time(b))
    return ev, wall, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--grids", default="64,128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("grid_query_time: no CUDA card")
    from moda_tpu_torch.config import DataInfo, MoDAConfig
    from moda_tpu_torch.extract import mesh as EM
    from moda_tpu_torch.fields.model import MoDAModel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    cfg = MoDAConfig()
    model = MoDAModel(cfg, DataInfo(offset=(0, 16), intrinsics=((1.0, 1.0, 0.0, 0.0),)),
                      device="cuda", generator=torch.Generator().manual_seed(0))
    bound = np.full(3, 0.3, np.float32)
    out = {"root": os.path.abspath(args.root), "grids": {}, "chunks": {}}
    for G in (int(g) for g in args.grids.split(",")):
        axes = [np.linspace(-b, b, G, dtype=np.float32) for b in bound]
        pts = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3),
                              device="cuda")
        query = EM.make_grid_query(model)
        ev, wall, peak = time_query(query, pts, args.reps)
        mesh_s, verts = [], 0
        for _ in range(3):
            t0 = time.perf_counter()
            m = EM.extract_mesh(model, bound, G, cfg.mc_threshold, query=query)
            mesh_s.append(time.perf_counter() - t0)
            verts = len(m.vertices)
        out["grids"][G] = {"points_a_call": getattr(query, "chunk", 0),
                           "query_ms_events": float(np.median(ev)),
                           "query_ms_wall": float(np.median(wall)),
                           "query_ms_events_all": ev, "query_peak_gib": peak,
                           "extract_mesh_s": float(np.median(mesh_s)),
                           "extract_mesh_s_all": mesh_s, "vertices": verts}
        for chunk in (int(c) for c in args.chunks.split(",") if c):
            ev, wall, peak = time_query(EM.make_grid_query(model, chunk), pts, args.reps)
            out["chunks"][f"{G}/{chunk}"] = {"query_ms_events": float(np.median(ev)),
                                             "query_ms_wall": float(np.median(wall)),
                                             "query_peak_gib": peak}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
