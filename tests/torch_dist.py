"""Spawned gloo ranks on the CPU for tests/test_torch_parallel.py and
tests/test_torch_extract_parallel.py: the port's data-parallel step
(parallel/dist.py), extract_mesh over ranks, and train_app and extract_app
under a torchrun-like environment. JAX-free: the ranks import torch and
moda_tpu_torch alone, one torch thread each."""
from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from moda_tpu_torch import bridge
from moda_tpu_torch.config import DataInfo, MoDAConfig
from moda_tpu_torch.extract.mesh import extract_mesh, grid_volume, make_grid_query
from moda_tpu_torch.fields.model import MoDAModel
from moda_tpu_torch.parallel import dist
from moda_tpu_torch.train.optim import MoDAOptimizer
from moda_tpu_torch.train import step as S

INFO = DataInfo(offset=(0, 6), intrinsics=((20.0, 20.0, 8.0, 8.0),))
BASE = dict(num_bones=3, img_size=16, ndepth=8, feat_ndepth_grid=4, lineload=True,
            eikonal_wt=0.001)
# name -> (config, nsample, nsample_active, use_fine, use_dskin, accu_steps, pairs,
#          explicit draws: a draws dict made at the global shapes, else the generator)
CASES = {
    "init": (dict(nsample=4), 4, 0, False, False, 1, 4, True),
    # test_parallel_parity.py's case: the fine pass, active top-k, accu_steps 2
    "ft2": (dict(nsample=4, use_unc=True, eikonal_wt=0.1), 2, 2, True, True, 2, 8, False),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def case_inputs(name: str, seed: int = 0):
    """(cfg, model, global numpy batch, StepExtras) of a case, from ``seed``."""
    cfg = MoDAConfig(**dict(BASE, **CASES[name][0]))
    model = MoDAModel(cfg, INFO, device="cpu", generator=torch.Generator().manual_seed(seed))
    batch, extras = case_batch(name, cfg, seed)
    return cfg, model, batch, extras


def case_batch(name: str, cfg, seed: int):
    """A case's global numpy batch and StepExtras, from ``seed``."""
    n_pairs = CASES[name][6]
    rng = np.random.default_rng(seed)
    P, bs2 = cfg.img_size, 2 * n_pairs

    def img(c):
        return rng.uniform(size=(bs2, c, P)).astype(np.float32)

    fid = rng.integers(0, 5, size=n_pairs)
    fid = np.concatenate([fid, fid + 1]).astype(np.int64)
    batch = {"imgs": img(3), "masks": (img(1) > 0.4).astype(np.float32),
             "vis2d": (img(1) > 0.1).astype(np.float32), "flow": img(2) * 0.1, "occ": img(1),
             "dp_feats": img(16), "kaug": np.tile(np.float32([[1.0, 1.0, 0.0, 0.0]]), (bs2, 1)),
             "frameid": fid, "frameid_sub": fid, "dataid": np.zeros(bs2, np.int64),
             "lineid": rng.integers(0, cfg.img_size, size=bs2).astype(np.int64)}
    t = torch.tensor
    extras = S.StepExtras(
        progress=t(0.5), loss_select=t(1), root_update=t(1.0), body_update=t(1.0),
        shape_update=t(0.0), cvf_update=t(0.0), sil_err_median=t(1e9),
        shape_samp=t((rng.normal(size=(64, 3)) * 0.1).astype(np.float32)),
        shape_samp_valid=t(1.0), embed_alpha=t(10.0))
    return batch, extras


def case_draws(name: str, cfg, n_pairs: int, seed: int = 1) -> dict:
    """Every draw of one step of ``name`` at the global batch's shapes."""
    _, ns, na, use_fine, _, _, _, _ = CASES[name]
    g = torch.Generator().manual_seed(seed)
    R, S, G = 2 * n_pairs * (ns + na), cfg.ndepth, cfg.feat_ndepth_grid
    S0 = S // 2 if use_fine else S
    d = {"pix_ids": torch.randint(0, cfg.img_size, (2 * n_pairs, ns), generator=g),
         "z_u": torch.rand(R, S0, generator=g), "grid_noise": torch.randn(G ** 3, 3, generator=g),
         "vis_neg": torch.rand(R, S, 3, generator=g) * 2 - 1,
         "symm_u": torch.rand(R, S, 1, generator=g),
         "eik_idx": torch.randint(0, R * S, (1000,), generator=g)}
    if use_fine:
        d["pdf_u"] = torch.rand(R, S0, generator=g)
        d["coarse_symm_u"] = torch.rand(R, S0, 1, generator=g)
    if na:
        d["cand_ids"] = torch.randint(0, cfg.img_size, (2 * n_pairs, 4 * (ns + na)), generator=g)
    return d


def one_step(step, batch, extras, generator=None, draws=None):
    """One optimizer step through a step of chunk_steps=1: the batch stacked
    [1, ...] in, the outputs' slice 0 out."""
    auxs, hosts = step({k: v[None] for k, v in batch.items()}, extras, generator=generator,
                       draws=None if draws is None else [draws])
    return {k: v[0] for k, v in auxs.items()}, {k: v[0] for k, v in hosts.items()}


def make_case_step(name: str, model, cfg, comm=None, chunk: int = 1, accu=None, opt=None):
    """The case's step (its accu_steps unless ``accu`` is given)."""
    _, ns, na, use_fine, use_dskin, case_accu, _, _ = CASES[name]
    opt = MoDAOptimizer(cfg, total_steps=100) if opt is None else opt
    return S.make_train_step(model, opt, nsample=ns,
                             ndepth=cfg.ndepth, use_fine=use_fine, use_dskin=use_dskin,
                             use_bones=True, nsample_active=na,
                             accu_steps=case_accu if accu is None else accu,
                             chunk_steps=chunk, comm=comm, device="cpu")


def run_case(name: str, steps: int, comm=None) -> dict:
    """``steps`` steps of case ``name`` from seeded parameters and inputs:
    in one process on the global batch (comm None) or as this rank of
    ``comm`` on its share. The first step takes the case's draws (explicit
    ones, or the generator's); returns each step's aux and host_out and the
    parameters after the first and the last step."""
    cfg, model, batch, extras = case_inputs(name)
    accu, n_pairs, explicit = CASES[name][5:]
    step = make_case_step(name, model, cfg, comm)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if comm is not None:
        tb = dist.shard_batch(tb, comm.rank, comm.world, accu)
    draws = None
    if explicit:
        draws = case_draws(name, cfg, n_pairs)
        if accu > 1:
            draws = [case_draws(name, cfg, n_pairs // accu, seed=1 + j) for j in range(accu)]
    gen = torch.Generator().manual_seed(3)
    out = {"aux": [], "host": []}
    for s in range(steps):
        aux, host = one_step(step, tb, extras, generator=gen, draws=draws if s == 0 else None)
        out["aux"].append({k: v.clone() for k, v in aux.items()})
        out["host"].append({k: v.clone() for k, v in host.items()})
        if s == 0:
            out["params1"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    if comm is not None:
        out["digest"] = comm.check_same(out["params"], f"{name}: replicas")
    return out


def run_saved(path: str, comm=None) -> dict:
    """One step of a setup saved by a test (a JAX model's parameters and
    variables, a global numpy batch, the step's arguments and its draws):
    {"cfg": json, "info": (offset, intrinsics), "params": nested numpy tree,
    "mvars": {field: array}, "batch", "extras": {field: value}, "kw": the
    step's keywords, "draws"}. Returns the aux and the parameters after."""
    d = torch.load(path, weights_only=False)
    cfg = MoDAConfig.from_json(d["cfg"])
    model = MoDAModel(cfg, DataInfo(*d["info"]), device="cpu")
    bridge.load_params(model, d["params"])
    bridge.load_mvars(model, d["mvars"])
    step = S.make_train_step(model, MoDAOptimizer(cfg, total_steps=100), comm=comm,
                             device="cpu", **d["kw"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in d["batch"].items()}
    tb = {k: v.long() if v.dtype == torch.int32 else v for k, v in tb.items()}
    if comm is not None:
        tb = dist.shard_batch(tb, comm.rank, comm.world, d["kw"].get("accu_steps", 1))
    extras = S.StepExtras(**{k: torch.as_tensor(np.asarray(v, np.float32))
                             for k, v in d["extras"].items()})
    aux, _ = one_step(step, tb, extras, draws=d["draws"])
    return {"aux": aux, "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


MESH_BOUND = np.asarray([0.3, 0.25, 0.2], np.float32)


def run_mesh(args, comm=None) -> dict:
    """extract_mesh of a seeded model, in one process or as a rank of
    ``comm``: args (grid size, threshold, points a query call, seed)."""
    grid, thr, chunk, seed = args
    model = MoDAModel(MoDAConfig(**BASE), INFO, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    points = []
    m = extract_mesh(model, MESH_BOUND, grid, thr, query=_counted(make_grid_query(model, chunk),
                                                                  points), comm=comm)
    return {"vertices": m.vertices, "faces": m.faces, "colors": m.colors,
            "frac": m.frac_occupied, "points": sum(points)}


def run_saved_extract(args, comm=None) -> dict:
    """The grid volume, rest mesh and warped frames of a saved model (the
    whole module, torch.save'd), in one process or as a rank of ``comm``:
    args (model path, grid size, threshold, points a query call, frames).
    Each rank warps its share of the frames (extract_app's groups)."""
    from moda_tpu_torch.cli.extract_app import frame_groups, warp_groups

    path, grid, thr, chunk, frames = args
    model = torch.load(path, weights_only=False)
    query = make_grid_query(model, chunk)
    raw, vis = grid_volume(model, MESH_BOUND, grid, query, comm)
    m = extract_mesh(model, MESH_BOUND, grid, thr, query=query, comm=comm)
    rank, world = (comm.rank, comm.world) if comm is not None else (0, 1)
    return {"raw": raw.numpy(), "vis": vis.numpy(), "vertices": m.vertices, "faces": m.faces,
            "colors": m.colors, "frac": m.frac_occupied,
            "warped": warp_groups(model, m.vertices, frame_groups(frames, rank, world))}


def _counted(query, points: list):
    """``query``, the points of each call appended to ``points``."""
    def run(pts, symm=False):
        points.append(len(pts))
        return query(pts, symm)
    run.chunk = query.chunk
    return run


def _run_extract_app(argv) -> dict:
    """extract_app.main in this rank, the grid points it queried and the
    OBJ files it wrote recorded."""
    from moda_tpu_torch.cli import extract_app
    from moda_tpu_torch.extract import mesh as EM

    points, written = [], []
    export, factory = EM.Mesh.export_obj, EM.make_grid_query

    def export_obj(self, path):
        written.append(os.path.basename(path))
        export(self, path)

    EM.Mesh.export_obj = export_obj
    EM.make_grid_query = lambda model, chunk=None: _counted(factory(model, chunk), points)
    tr = extract_app.main(argv, device="cpu")
    return {"is_main": tr.is_main, "points": sum(points), "written": written,
            "params": {n: p.detach().clone() for n, p in tr.model.named_parameters()}}


def _rank_main(rank: int, world: int, port: int, out_dir: str, job: str, args):
    torch.set_num_threads(1)
    try:
        if job in ("steps", "saved", "mesh", "saved_extract"):
            comm = dist.init_process(rank, world, port=port, device="cpu", timeout_s=120)
            try:
                res = ({n: run_case(n, args[1], comm) for n in args[0]} if job == "steps"
                       else run_saved(args, comm) if job == "saved"
                       else run_mesh(args, comm) if job == "mesh"
                       else run_saved_extract(args, comm))
            finally:
                comm.close()
        elif job == "extract":  # extract_app under torchrun's environment
            os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                               "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
                               "MASTER_PORT": str(port)})
            res = _run_extract_app(args)
        else:  # train_app under torchrun's environment
            os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                               "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
                               "MASTER_PORT": str(port)})
            from moda_tpu_torch.cli import train_app
            from moda_tpu_torch.train import trainer as TT
            argv, iters, nudge = args
            TT.ITERS_PER_EPOCH = iters
            nudged = []
            if nudge and rank:
                for name in ("warmup_shape", "preset_rootmlp"):
                    setattr(TT.Trainer, name, _nudged(getattr(TT.Trainer, name), nudged))
            tr = train_app.main(argv[rank], device="cpu")
            res = {"nudged": len(nudged),"params": {n: p.detach().clone() for n, p in tr.model.named_parameters()},
                   "latest_vars": tr.latest_vars, "total_steps_done": tr.total_steps_done,
                   "save_dir": tr.save_dir}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _nudged(fn, calls: list):
    """``fn`` (a Trainer method), then every parameter moved by 1e-6: a rank
    whose warmup parted from the others in the last bits."""
    def run(self, *a, **k):
        out = fn(self, *a, **k)
        with torch.no_grad():
            for p in self.model.parameters():
                p.add_(1e-6)
        calls.append(fn.__name__)
        return out
    return run


def spawn(world: int, out_dir: str, job: str, args, timeout: float = 240.0) -> list:
    """Run ``world`` ranks of ``job`` in spawned processes; returns each
    rank's results. Raises with the ranks' tracebacks when one fails, and
    kills them all when they outlast ``timeout`` seconds."""
    ctx = mp.start_processes(_rank_main, args=(world, free_port(), out_dir, job, args),
                             nprocs=world, join=False, start_method="spawn")
    try:
        import time
        t0 = time.time()
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > timeout:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
    except Exception as e:
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                if f.endswith(".err")]
        raise RuntimeError("\n".join(errs) or str(e)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
