"""Trainer: the optimization schedule around the train step. Counterpart of
moda_tpu/train/trainer.py (train_utils.py:64-1543, v2s_trainer) for stage 1
of the recipe: the epoch loop with per-epoch rest-mesh extraction and
hyperparameter resets, shape warmup, the pose-CNN cold start (warmup_pose
-> extract_cams_cnn), root-table preset from the cameras,
k-means bone re-initialization, the silhouette-outlier history, near/far
management, checkpoints, the explosion rollback and the per-epoch eval
renders.

The model's parameters are updated in place: the step captures them by
reference (train/step.py), so everything that writes them here (shape
warmup, bone re-init, root preset, checkpoint load, rollback) copies into
the existing tensors under ``torch.no_grad()`` and never rebinds them.

An epoch is ITERS_PER_EPOCH optimizer steps in calls of K = ``steps_chunk``
steps each (the JAX trainer's chunked dispatch): a chunk's K batches
come from ``PairLoader.next_chunk`` in one upload, its K per-step scalars
are computed at its start, and its outputs come back in one packed fetch.
Host bookkeeping runs one chunk behind without a sync per call: each
call's outputs are packed into one tensor, copied to pinned host memory
asynchronously and read after the next call is dispatched, once its CUDA
event has completed; the chunk's K steps are then consumed in order.

Data parallelism (``comm``, parallel/dist.py): every rank runs this loop on
its own share of each batch, and the step makes the update one process
would make on the global batch, with the same aux and host outputs on
every rank. Every host decision reads those (or seeded draws), so it is the
same on every rank; parameters, optimizer state, model variables and the
host records are still broadcast from rank 0 at the start and after every
reload and re-initialization, and compared by digest at every epoch's end.
Rank 0 alone writes files (options, log, checkpoints, meshes, cameras,
eval renders, the pose CNN) and reads the checkpoint of a reload.

Random draws (shape-warmup points, k-means initial centres, the body
head's re-init and the step's draws) come from one ``torch.Generator`` on
the trainer's device, seeded from ``seed``; tests pass ``draws``, a
callable ``draws(kind, **info)`` that gives them instead (kinds
"shape_pts", "kmeans_idx", "head_init" and "step").
"""
from __future__ import annotations

import json
import os
import pickle
import time
import traceback
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from moda_tpu_torch import bridge
from moda_tpu_torch.config import DataInfo, MoDAConfig
from moda_tpu_torch.core import quat as Q
from moda_tpu_torch.core import skinning as SK
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data.synthetic import feat_bank_encode
from moda_tpu_torch.extract.mesh import Mesh, extract_mesh, make_grid_query
from moda_tpu_torch.fields.model import MoDAModel
from moda_tpu_torch.ops.kmeans import kmeans
from moda_tpu_torch.render.evalrender import make_frame_renderer
from moda_tpu_torch.render import losses as L
from moda_tpu_torch.runtime import Device, resolve_device
from moda_tpu_torch.train import ckpt as CK
from moda_tpu_torch.train import schedule as SCH
from moda_tpu_torch.train.optim import INPUT_LAYERS, MoDAOptimizer, group_of
from moda_tpu_torch.train.step import CHUNK_STEP_FIELDS, StepExtras, make_train_step
from moda_tpu_torch.train.warmup_pose import (PoseWarmup, nearest_valid_substitution,
                                              ood_check_features)
from moda_tpu_torch.viz.render_vis import draw_cams, save_png, unit_sphere

ITERS_PER_EPOCH = 200  # train_utils.py:933

MVAR_FIELDS = ("near_far", "alpha", "obj_bound", "vis_min", "vis_len", "beta_is_active")
# the epoch's host-time split, per rank in the epoch line under data parallelism
T_SPLIT = ("t_steps", "t_load", "t_upload", "t_dispatch", "t_fetch")


def sample_mesh_points(mesh: Mesh, n: int, rng: np.random.Generator) -> np.ndarray:
    """Area-weighted surface sampling (pytorch3d sample_points_from_meshes
    equivalent, used for the bone regularizer at moda.py:690-692)."""
    if len(mesh.faces) == 0:
        return np.zeros((n, 3), np.float32)
    tri = mesh.vertices[mesh.faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    p = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(mesh.faces), size=n, p=p)
    u = rng.uniform(size=(n, 1))
    w = rng.uniform(size=(n, 1))
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    t = tri[idx]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + w * (t[:, 2] - t[:, 0])).astype(np.float32)


def get_near_far(near_far: np.ndarray, rtk: np.ndarray, idk: np.ndarray,
                 pts: np.ndarray, tol_fac: float = 1.2) -> np.ndarray:
    """Update near/far from scene-point depth ranges per camera
    (geom_utils.py:1105-1135)."""
    out = near_far.copy()
    valid = idk.astype(bool)
    if not valid.any() or len(pts) == 0:
        return out
    R = rtk[valid, :3, :3]
    T = rtk[valid, :3, 3]
    z = (pts[None] @ np.swapaxes(R, -1, -2) + T[:, None])[:, :, 2]
    zmin, zmax = z.min(1), z.max(1)
    delta = (zmax - zmin) * (tol_fac - 1.0)
    out[valid, 0] = np.maximum(zmin - delta, 1e-3)
    out[valid, 1] = np.maximum(zmax + delta, 1e-3)
    return out


def _box_corners(bounds: np.ndarray) -> np.ndarray:
    lo, hi = bounds[0], bounds[1]
    return np.asarray([
        [x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])
    ], np.float32)


class Trainer:
    def __init__(self, cfg: MoDAConfig, data_info: DataInfo,
                 loader: Optional[Iterator] = None, save_dir: Optional[str] = None,
                 prior_verts: Optional[np.ndarray] = None, seed: int = 0,
                 device: Device = None, draws: Optional[Callable] = None,
                 eval_datasets: Optional[list] = None, comm=None):
        """Runs on the card unless device="cpu" is passed. eval_datasets:
        frame datasets at render_size whose ``reader.read_raw`` gives the
        eval grid its observed columns and crop kaug (train_utils.py:140);
        without them the grid renders the full raw frame. comm: this
        process's data-parallel group (module docstring); ``loader`` then
        gives this rank's share of each batch."""
        self.cfg = cfg
        self.comm = comm
        self.is_main = comm is None or comm.rank == 0
        self.data_info = data_info
        self.loader = loader
        self.eval_datasets = eval_datasets
        self._eval_unreadable: list = []  # eval frames that could not be read this epoch
        self.draws = draws
        self.save_dir = save_dir or os.path.join(cfg.checkpoint_dir, cfg.logname)
        if self.is_main:
            os.makedirs(self.save_dir, exist_ok=True)

        self.device = resolve_device(device)
        self.model = MoDAModel(cfg, data_info, device=self.device,
                               generator=torch.Generator().manual_seed(seed))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.is_fine_tune = cfg.model_path != ""
        # host copies of the model's non-optimized state: the loop reads
        # them without a device sync
        self.mvars_host = {f: getattr(self.model.mvars, f).cpu().numpy() for f in MVAR_FIELDS}

        num_fr = data_info.num_fr
        self.latest_vars: Dict[str, np.ndarray] = {
            "rt_raw": np.zeros((num_fr, 3, 4), np.float32),
            "rtk": np.zeros((num_fr, 4, 4), np.float32),
            "idk": np.zeros((num_fr,), np.float32),
            "sil_err": np.zeros((num_fr,), np.float32),
            "obj_bound": self.mvars_host["obj_bound"].copy(),
        }
        self.mesh_rest = Mesh()
        # canonical shape prior: an icosphere with the synthetic fixture's
        # direction-bank embeddings unless a prior mesh is given
        if prior_verts is None:
            sv, sf = unit_sphere(2)
            prior_verts = sv.astype(np.float32)
            self.prior_faces = sf
            self.prior_embeds = feat_bank_encode(sv).astype(np.float32)
        else:
            self.prior_faces = np.zeros((0, 3), np.int32)
            self.prior_embeds = np.zeros((len(prior_verts), 16), np.float32)
        self.prior_verts_unit = prior_verts / np.abs(prior_verts).max()

        self.total_steps_done = 0
        self.progress = 0.0
        self.counter_frz_rebone = 0.0
        self._pending = None  # (fids, fetch handle, first step) of the chunk in flight
        # the epoch's host-time split (train_one_epoch)
        self._t_load_ep = self._t_upload_ep = self._t_dispatch_ep = self._t_fetch_ep = 0.0
        self.np_rng = np.random.default_rng(seed)
        self.grid_query = make_grid_query(self.model)
        self._step_cache: Dict = {}
        self.optimizer: Optional[MoDAOptimizer] = None
        self.xyz_wt_snapshot: Optional[Dict] = None  # freeze_coarse's, taken in train()
        self.log_path = os.path.join(self.save_dir, "log.jsonl")
        if self.is_main:
            with open(os.path.join(self.save_dir, "opts.json"), "w") as f:
                f.write(cfg.to_json())
        if cfg.model_path:
            self.load_model(cfg.model_path)

    # ------------------------------------------------------------------ util
    @property
    def final_steps(self) -> int:
        """Iterations of the run, micro-batches counted: an epoch is
        ITERS_PER_EPOCH steps, each of accu_steps micro-batches and one
        optimizer update, so the schedule's total_steps (final_steps //
        accu_steps) is the run's update count. (The JAX trainer makes
        ITERS_PER_EPOCH * accu_steps calls an epoch, each a whole update, and
        so runs its one-cycle schedule to its end after 1/accu_steps of the
        run.)"""
        return self.cfg.num_epochs * ITERS_PER_EPOCH * self.cfg.accu_steps

    @property
    def steps_chunk(self) -> int:
        """Optimizer steps a call (config.steps_chunk): 0 gives 1 (the JAX
        trainer's 10 is for a TPU's round trips), as does debug (per-step
        timing), and K is rounded down until it divides 50 (the period of
        the near/far re-estimation and of the step log) and the epoch's
        ITERS_PER_EPOCH steps (the JAX trainer counts ITERS_PER_EPOCH x
        accu_steps: see final_steps)."""
        k = self.cfg.steps_chunk
        if k <= 0 or self.cfg.debug:
            k = 1
        while k > 1 and (ITERS_PER_EPOCH % k or 50 % k):
            k -= 1
        return k

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def make_optimizer(self) -> MoDAOptimizer:
        return MoDAOptimizer(self.cfg, total_steps=self.final_steps // self.cfg.accu_steps)

    def _reset_opt_state(self):
        self.optimizer.state = self.optimizer.init(
            {k: v.detach() for k, v in self._params().items()})
        self._sync_replicas()

    def _replica_state(self) -> Dict[str, torch.Tensor]:
        """What every replica must hold alike: parameters and optimizer state."""
        out = {f"param.{k}": v for k, v in self._params().items()}
        st = getattr(self.optimizer, "state", None)
        if st is not None:
            out["opt.count"] = st.count
            out.update({f"opt.mu.{k}": v for k, v in st.mu.items()})
            out.update({f"opt.nu.{k}": v for k, v in st.nu.items()})
        return out

    def _sync_replicas(self):
        """Rank 0's parameters, optimizer state, model variables and host
        records on every rank (no-op in one process)."""
        if self.comm is None:
            return
        lv = {k: torch.from_numpy(np.array(v)) for k, v in self.latest_vars.items()}
        self.comm.broadcast_(list(self._replica_state().values())
                             + [getattr(self.model.mvars, f) for f in MVAR_FIELDS]
                             + list(lv.values()))
        self.latest_vars.update({k: v.numpy() for k, v in lv.items()})
        self.mvars_host = {f: getattr(self.model.mvars, f).cpu().numpy() for f in MVAR_FIELDS}

    def _check_replicas(self, epoch: int) -> Optional[str]:
        """Raise unless every rank holds rank 0's parameters and optimizer
        state; returns their digest (None in one process)."""
        if self.comm is None:
            return None
        return self.comm.check_same(self._replica_state(), f"epoch {epoch}")

    def _per_rank(self, values: list) -> list:
        """``values`` of every rank, in rank order (this rank's alone in one
        process)."""
        if self.comm is None:
            return [values]
        t = torch.zeros(self.comm.world, len(values), dtype=torch.float64,
                        device=self.comm.device)
        t[self.comm.rank] = torch.tensor(values, dtype=torch.float64)
        return self.comm.all_reduce_(t).cpu().tolist()

    def get_step_fn(self, use_fine: bool, use_dskin: bool, use_bones: bool,
                    is_active: bool = False, chunk: int = 1):
        cfg = self.cfg
        # active sampling splits the budget (moda.py:1066-1071)
        if is_active:
            ns_active = int(cfg.nactive * cfg.nsample)
            ns_uniform = int(cfg.nsample * (1 - cfg.nactive))
        else:
            ns_active, ns_uniform = 0, cfg.nsample
        sig = (use_fine, use_dskin, use_bones, ns_uniform, ns_active, cfg.ndepth, chunk)
        if sig not in self._step_cache:
            self._step_cache[sig] = make_train_step(
                self.model, self.optimizer, nsample=ns_uniform, ndepth=cfg.ndepth,
                use_fine=use_fine, use_dskin=use_dskin, use_bones=use_bones,
                nsample_active=ns_active, xyz_wt_snapshot=self.xyz_wt_snapshot,
                accu_steps=cfg.accu_steps, chunk_steps=chunk, comm=self.comm,
                device=self.device)
        return self._step_cache[sig], ns_uniform, ns_active

    def _draw(self, kind: str, **info) -> torch.Tensor:
        """One draw of ``kind`` from the draws provider, or from the
        trainer's generator."""
        if self.draws is not None:
            return torch.as_tensor(self.draws(kind, **info), device=self.device)
        dev, g = self.device, self.gen
        if kind == "shape_pts":
            return torch.rand(info["n"], 3, generator=g, device=dev) * 2.0 - 1.0
        if kind == "kmeans_idx":
            return torch.randperm(info["n"], generator=g, device=dev)[:info["k"]]
        if kind == "head_init":
            return (torch.rand(info["shape"], generator=g, device=dev) * 2.0 - 1.0) * \
                info["limit"]
        raise KeyError(kind)

    # --------------------------------------------------------------- priors
    def reset_nf(self):
        """Initialize near-far planes + obj bound from the prior shape
        (train_utils.py:826-843)."""
        cfg = self.cfg
        nf = self.mvars_host["near_far"]
        shape_verts = self.prior_verts_unit / 3.0 * nf.mean() * 1.2
        if not self.is_fine_tune and cfg.bound_factor > 0:
            shape_verts = shape_verts * cfg.bound_factor
            self.latest_vars["obj_bound"] = np.abs(shape_verts).max(0)
        if nf[:, 0].sum() == 0:
            nf = get_near_far(nf, self.latest_vars["rtk"], self.latest_vars["idk"], shape_verts)
        self._set_mvars(near_far=nf, obj_bound=self.latest_vars["obj_bound"])

    def _set_mvars(self, **kw):
        for k, v in kw.items():
            v = np.asarray(v, np.float32)
            self.mvars_host[k] = v.copy()
            setattr(self.model.mvars, k, torch.as_tensor(v, device=self.device))
        return self.model.mvars

    def set_cameras_from_rtk_files(self, rtk_by_frame: np.ndarray):
        """Install per-frame prior cameras. rtk_by_frame [num_fr, 4, 4]."""
        self.latest_vars["rtk"] = rtk_by_frame.astype(np.float32)
        self.latest_vars["rt_raw"] = rtk_by_frame[:, :3, :4].astype(np.float32)
        self.latest_vars["idk"][:] = 1

    @torch.no_grad()
    def preset_rootmlp(self):
        """warmup_rootmlp: write camera rotations into the explicit root
        table (train_utils.py:662-666). With use_cam the base is a 6-dim
        so3 delta on the prior cameras and already matches them."""
        if self.cfg.use_cam:
            return
        rmat = torch.as_tensor(self.latest_vars["rtk"][:, :3, :3], device=self.device)
        self.model.nerf_root_rts.base_rt.se3[:, 3:7].copy_(Q.matrix_to_q(rmat))

    def load_prior_mesh(self, pkl_path: str):
        """Load a reference-format canonical mesh pkl ({'vertices','faces'}
        and optional 'embeddings' [V,16]) as the shape prior
        (moda.py:409-434)."""
        with open(pkl_path, "rb") as f:
            dp = pickle.load(f)
        v = np.asarray(dp["vertices"], np.float32)
        v = v - v.mean(0, keepdims=True)
        self.prior_verts_unit = v / np.abs(v).max()
        self.prior_faces = np.asarray(dp["faces"], np.int32)
        if dp.get("embeddings") is not None:
            self.prior_embeds = np.asarray(dp["embeddings"], np.float32)
        else:
            self.prior_embeds = np.zeros((len(v), 16), np.float32)

    def warmup_pose(self, num_epochs: int) -> PoseWarmup:
        """Train the pose CNN on rasterized prior-mesh features
        (train_utils.py:871-921), num_epochs x 200 steps at batch 16, or load
        it from ``pose_cnn_path``; saves ``pose_cnn.npz``."""
        cfg = self.cfg
        d_mean = float(self.mvars_host["near_far"].mean()) * self.model.obj_scale
        # the full reference budget (train_utils.py:878 `range(200)` an epoch)
        steps = num_epochs * ITERS_PER_EPOCH
        t0 = time.time()
        w = PoseWarmup(self.prior_verts_unit, self.prior_faces, self.prior_embeds,
                       d_mean=d_mean, total_steps=steps, device=self.device)
        if cfg.pose_cnn_path and os.path.exists(cfg.pose_cnn_path):
            w.load(cfg.pose_cnn_path)  # the pretrained route (template.sh --pose_cnn_path)
        else:
            losses = w.train(steps=steps, bs=16)
            self._log({"warmup_pose_rot_loss": float(np.mean(losses[-5:])),
                       "warmup_pose_rot_loss_t": [
                           round(float(np.mean(losses[max(0, i - 5):i + 1])), 4)
                           for i in range(0, len(losses), max(1, len(losses) // 20))],
                       "warmup_pose_time": time.time() - t0, "warmup_pose_steps": steps})
            if self.is_main:
                w.save(os.path.join(self.save_dir, "pose_cnn.npz"))
        self.pose_cnn = w
        return w

    def extract_cams_cnn(self, datasets, save: bool = True):
        """Per-frame cameras from the trained pose CNN on each frame's
        observed CSE features, read through the frame reader, with the OOD
        filter and nearest-valid rotation substitution; writes
        ``init-cam/cam-%05d.txt`` and installs the cameras
        (train_utils.py:393-453, 732-823). Returns (rtk [F,4,4], valid [F])."""
        if not hasattr(self, "pose_cnn"):
            raise RuntimeError("extract_cams_cnn needs warmup_pose first")
        rtks, valids = [], []
        for ds in datasets:
            feats_seq, dp_idx_seq = [], []
            for i in range(ds.num_frames):
                d = ds.reader.read_raw(i, flowfw=True, dframe=1)
                feats_seq.append(np.transpose(d["dp_feat"], (1, 2, 0)))  # [112,112,16]
                dp_idx_seq.append(IO.resize(d["dp"].astype(np.float32), (112, 112),
                                            IO.INTER_NEAREST).astype(int))
            feats = np.stack(feats_seq)
            feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-9)
            rtk_seq = self.pose_cnn.predict(feats)
            if self.cfg.unc_filter and self.prior_embeds.any():
                valid, _ = ood_check_features(np.transpose(feats, (0, 3, 1, 2)),
                                              self.prior_embeds, np.stack(dp_idx_seq))
                rtk_seq = nearest_valid_substitution(rtk_seq, valid)
            else:
                valid = np.ones(len(rtk_seq), bool)
            for i in range(ds.num_frames):
                rtk = np.eye(4, dtype=np.float32)
                rtk[:3] = rtk_seq[i, :3]
                rtk[:3, 3] *= self.model.obj_scale
                rtk[3] = np.asarray(self.data_info.intrinsics[ds.dataid])
                rtks.append(rtk)
                valids.append(bool(valid[i]))
        rtks = np.stack(rtks)
        if save and self.is_main:
            cam_dir = os.path.join(self.save_dir, "init-cam")
            os.makedirs(cam_dir, exist_ok=True)
            for i, rtk in enumerate(rtks):
                np.savetxt(os.path.join(cam_dir, "cam-%05d.txt" % i), rtk)
        norm = rtks.copy()
        norm[:, :3, 3] /= self.model.obj_scale
        self.set_cameras_from_rtk_files(norm)
        return rtks, np.asarray(valids)

    def cold_start(self):
        """warmup_pose, then, where no cameras are installed, extract_cams_cnn
        through the datasets that have a frame reader (the eval datasets
        first, then the loader's): the reference's warmup_pose -> extract_cams
        chain (train_utils.py:893-921). Without such a dataset it logs a
        warning, where the JAX trainer skips the install silently."""
        cfg = self.cfg
        self.warmup_pose(cfg.warmup_pose_ep)
        if self.latest_vars["idk"].sum() > 0:  # cameras from files (use_rtk_file)
            return
        cam_ds = [d for d in (self.eval_datasets or []) if getattr(d, "reader", None) is not None]
        if not cam_ds and self.loader is not None:
            cam_ds = [d for d in getattr(self.loader, "datasets", [])
                      if getattr(d, "reader", None) is not None]
        if not cam_ds:
            print("warning: the pose CNN was trained but no dataset has a frame reader, so its "
                  "cameras are not installed")
            self._log({"extract_cams_skipped": "no dataset with a frame reader"})
            return
        t0 = time.time()
        rtks, valid = self.extract_cams_cnn(cam_ds)
        self._log({"extract_cams_valid": float(np.mean(valid)), "extract_cams_n": int(len(rtks)),
                   "extract_cams_time": time.time() - t0})

    # -------------------------------------------------------------- warmups
    def warmup_shape(self, num_epochs: int) -> float:
        """Fit the canonical SDF to the prior ellipsoid
        (train_utils.py:845-869; moda.py:795-810). Only nerf_coarse and
        nerf_beta change: the warmup's optimizer holds just those two
        groups, so its weight decay reaches no other parameter (the JAX
        package updates all and keeps these two: the same values)."""
        cfg, dev = self.cfg, self.device
        shape_verts = self.prior_verts_unit * 0.1  # shape_factor (moda.py:803)
        obj_bound = np.abs(shape_verts).max(0)
        bound = torch.as_tensor(obj_bound * cfg.bound_factor * 1.2, dtype=torch.float32,
                                device=dev)
        obj_bound_t = torch.as_tensor(obj_bound, dtype=torch.float32, device=dev)
        params = {n: p for n, p in self._params().items()
                  if group_of(n) in ("nerf_coarse", "nerf_beta")}
        names = list(params)
        opt = MoDAOptimizer(cfg, total_steps=num_epochs * ITERS_PER_EPOCH)
        state = opt.init({n: p.detach() for n, p in params.items()})
        finite = torch.ones((), dtype=torch.bool, device=dev)
        loss = None
        for e in range(num_epochs):
            for _ in range(ITERS_PER_EPOCH):
                pts = self._draw("shape_pts", n=10000) * bound
                loss = L.shape_init_loss(self.model, pts, obj_bound_t,
                                         use_ellips=not cfg.init_ellips)
                gl = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
                grads = {n: torch.zeros_like(params[n]) if g is None else g
                         for n, g in zip(names, gl)}
                new, state = opt.update(grads, state, {n: params[n].detach() for n in names},
                                        finite)
                with torch.no_grad():
                    for n in names:
                        params[n].copy_(new[n])
            self._log({"shape_init_loss": float(loss.detach()), "warmup_epoch": e})
        return float(loss.detach())

    # --------------------------------------------------------- bone re-init
    @torch.no_grad()
    def reinit_bones(self):
        """k-means bone re-init + body-head output-layer reset
        (geom_utils.py:857-903)."""
        cfg, dev = self.cfg, self.device
        num_bones = cfg.num_bones
        if len(self.mesh_rest.vertices) < 100:
            bound = self.latest_vars["obj_bound"]
            rng = np.random.default_rng(0)
            centers = torch.as_tensor(
                (rng.uniform(size=(num_bones, 3)) * 2 - 1) * bound[None], dtype=torch.float32,
                device=dev)
        else:
            pts = torch.as_tensor(self.mesh_rest.vertices, device=dev)
            idx = self._draw("kmeans_idx", n=len(pts), k=num_bones)
            centers = kmeans(pts, num_bones, init_idx=idx)
        orient = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(num_bones, 1)
        scale = torch.zeros((num_bones, 3), device=dev)
        bones_desired = torch.cat([centers, orient, scale], -1)

        # re-init the head's output layer (zero bias, small weights)
        rgb = self.model.nerf_body_rts.trunk.rgb
        fan_in, fan_out = rgb.kernel.shape
        limit = 0.5 * np.sqrt(6.0 / (fan_in + fan_out))  # xavier_uniform gain=0.5
        rgb.kernel.copy_(self._draw("head_init", shape=tuple(rgb.kernel.shape), limit=limit))
        rgb.bias.zero_()

        # store bones pre-warped by the inverse rest transform so that
        # correct_bones() lands them at the k-means centers
        rts_rst = self.model.body_rts_rest()
        if cfg.neudbs:
            stored = SK.bone_transform_dq(bones_desired, rts_rst)[0]
        else:
            stored = SK.bone_transform_rts(bones_desired, rts_rst)[0]
        self.model.bones.copy_(stored)
        self._sync_replicas()  # k-means on the card may part in the last bits

    # ---------------------------------------------------------- eval grid
    def _eval_frame_obs(self, fi: int):
        """Frame fi (global id) read through the render_size eval datasets:
        {'kaug', 'img', ...}, or None where there is none: no eval datasets,
        or a frame file that is missing or not an image (the line-shard
        fixtures' placeholder JPEGs). Any other fault raises; the JAX
        trainer swallows every exception here (trainer.py:443-446)."""
        if not self.eval_datasets:
            return None
        offs = np.asarray(self.data_info.offset)
        di = int(np.searchsorted(offs, fi, side="right")) - 1
        reader = getattr(self.eval_datasets[di], "reader", None)
        if reader is None:
            return None
        try:
            return reader.read_raw(int(fi - offs[di]), flowfw=True, dframe=1)
        except FileNotFoundError as e:
            self._eval_unreadable.append(str(e))
            return None

    def eval_renders(self, epoch: int, num_frames: int = 9) -> str:
        """Per-epoch qualitative renders (train_utils.py:695-704): a grid of
        frames rendered at render_size with flow against the next frame,
        written as ``eval-<epoch>.png``. Returns its path."""
        cfg = self.cfg
        rs = cfg.render_size
        if not hasattr(self, "_frame_renderer"):
            self._frame_renderer = make_frame_renderer(self.model, rs, cfg.ndepth,
                                                       chunk=cfg.chunk, with_flow=True)
        # one fixed stream for every render, as the JAX trainer's fixed key:
        # the training draws do not depend on whether an epoch rendered
        gen = torch.Generator(device=self.device).manual_seed(0)
        ids = np.linspace(0, self.data_info.num_fr - 2, num_frames, dtype=int)
        tiles = []
        self._eval_unreadable = []
        for fi in ids:
            rtk = self.latest_vars["rtk"][fi][None]
            obs = self._eval_frame_obs(fi)
            if obs is not None:
                kaug = np.asarray(obs["kaug"], np.float32)[None]
            else:
                # no eval datasets: the full raw frame (principal point
                # assumed centred, image W ~ 2 px, H ~ 2 py)
                px, py = float(rtk[0, 3, 2]), float(rtk[0, 3, 3])
                kaug = np.asarray([[max(2 * px / rs, 1e-6), max(2 * py / rs, 1e-6), 0.0, 0.0]],
                                  np.float32)
            out = self._frame_renderer(rtk, kaug, [fi], [0],
                                       rtk_target=self.latest_vars["rtk"][fi + 1][None],
                                       frameid_target=[fi + 1], generator=gen)
            tile = [np.clip(out["img_coarse"], 0, 1),
                    np.repeat(np.clip(out["sil_coarse"], 0, 1), 3, axis=-1)]
            if obs is not None:  # the observed column (the reference grid's 'img')
                tile.insert(0, np.asarray(obs["img"], np.float32))
            if "flo_coarse" in out:  # flow magnitude and angle
                flo = out["flo_coarse"]
                mag = np.clip(np.linalg.norm(flo, axis=-1, keepdims=True) * 2, 0, 1)
                ang = (np.arctan2(flo[..., 1:2], flo[..., :1]) / np.pi + 1) / 2
                tile.append(np.concatenate([mag, ang, 1 - mag], -1))
            # feature-error and uncertainty channels (train_utils.py:1482-1514)
            if "feat_rnd" in out and obs is not None and "dp_feat_rsmp" in obs:
                gt_f = np.transpose(np.asarray(obs["dp_feat_rsmp"], np.float32), (1, 2, 0))
                if gt_f.shape[0] != rs:
                    gt_f = IO.resize(gt_f, (rs, rs), IO.INTER_LINEAR)
                err = np.linalg.norm(out["feat_rnd"] - gt_f, axis=-1, keepdims=True) / 2.0
                tile.append(np.repeat(np.clip(err, 0, 1), 3, axis=-1))
            if "unc_pred" in out:
                tile.append(np.repeat(np.clip(out["unc_pred"][..., :1], 0, 1), 3, axis=-1))
            tiles.append(np.concatenate(tile, axis=1))
        n = int(np.ceil(np.sqrt(len(tiles))))
        H, W, _ = tiles[0].shape
        grid = np.ones((n * H, n * W, 3), np.float32)
        for i, t in enumerate(tiles):
            r, c = divmod(i, n)
            grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = t
        path = os.path.join(self.save_dir, f"eval-{epoch:03d}.png")
        save_png(path, (grid * 255).astype(np.uint8))
        if self._eval_unreadable:  # once an epoch
            self._log({"eval_frames_unreadable": len(self._eval_unreadable),
                       "eval_frame_error": self._eval_unreadable[0]})
        return path

    # ------------------------------------------------------------ main loop
    def train(self):
        cfg = self.cfg
        self.optimizer = self.make_optimizer()
        self._reset_opt_state()
        self._step_cache = {}  # the cached steps hold the optimizer

        if cfg.warmup_shape_ep > 0:
            t0 = time.time()
            loss = self.warmup_shape(cfg.warmup_shape_ep)
            self._log({"warmup_shape_time": time.time() - t0, "shape_init_loss": loss})
        if cfg.warmup_pose_ep > 0 and (
                self.prior_embeds.any()
                or (cfg.pose_cnn_path and os.path.exists(cfg.pose_cnn_path))):
            self.cold_start()
        if cfg.warmup_rootmlp and self.latest_vars["idk"].sum() > 0:
            self.preset_rootmlp()
        if not self.is_fine_tune:
            self.reset_nf()
        self.latest_vars["idk"][:] = 0
        # the warmups, the root preset and the near/far reset ran on every
        # rank alike, but the card may part them in the last bits
        self._sync_replicas()
        if cfg.freeze_coarse:
            # the trunks' input-layer kernels at stage start, which the
            # freeze_coarse loss pins (grab_xyz_weights, train_utils.py:680-688)
            self.xyz_wt_snapshot = {
                comp: {layer: getattr(self.model, comp).get_submodule(layer).kernel.detach()
                       .clone() for layer in INPUT_LAYERS}
                for comp in ("nerf_coarse", "nerf_skin", "nerf_feat") if hasattr(self.model, comp)}

        shape_samp = np.zeros((1000, 3), np.float32)
        shape_samp_valid = 0.0
        for epoch in range(cfg.num_epochs):
            t_ep = time.time()
            # epoch-boundary extraction + resets (train_utils.py:695-730, 1094-1152)
            self.mesh_rest = extract_mesh(self.model, self.latest_vars["obj_bound"],
                                          cfg.sample_grid3d, cfg.mc_threshold,
                                          query=self.grid_query)
            if len(self.mesh_rest.vertices) > 100:
                shape_samp = sample_mesh_points(self.mesh_rest, 1000, self.np_rng)
                shape_samp_valid = 1.0
            self.reset_hparams(epoch)
            t_mesh = time.time() - t_ep

            t_loop = time.time()
            self.train_one_epoch(epoch, shape_samp, shape_samp_valid)
            t_loop = time.time() - t_loop
            split = [t_loop, self._t_load_ep, self._t_upload_ep, self._t_dispatch_ep,
                     self._t_fetch_ep]
            ranks = self._per_rank(split)
            digest = self._check_replicas(epoch)
            t_save0 = time.time()
            if self.is_main:
                self.save("latest")
                CK.copy_checkpoint(os.path.join(self.save_dir, "latest"),
                                   os.path.join(self.save_dir, str(epoch + 1)))
            t_save = time.time() - t_save0
            t_eval0 = time.time()
            render_now = (epoch in (0, cfg.num_epochs // 2, cfg.num_epochs - 1)
                          or (cfg.num_epochs >= 20
                              and epoch % max(1, cfg.num_epochs // 20) == 0))
            if cfg.render_size > 0 and self.is_main and self.latest_vars["idk"].sum() > 0 \
                    and render_now:
                try:
                    self.eval_renders(epoch)
                except Exception as e:  # rendering must never end training
                    traceback.print_exc()
                    self._log({"eval_render_error": str(e)})
            t_eval = time.time() - t_eval0
            line = {"epoch": epoch, "epoch_time": time.time() - t_ep,
                    "t_mesh": round(t_mesh, 3), "t_save": round(t_save, 3),
                    "t_eval": round(t_eval, 3), "steps_chunk": self.steps_chunk,
                    "steps_per_s": ITERS_PER_EPOCH / max(t_loop, 1e-9),
                    "mesh_verts": len(self.mesh_rest.vertices),
                    "frac_occupied": round(self.mesh_rest.frac_occupied, 5),
                    "root_steps_rejected": round(getattr(self, "_root_rejected_ep", 0.0), 1)}
            line.update({k: round(v, 3) for k, v in zip(T_SPLIT, split)})
            if self.comm is not None:
                line["world_size"] = self.comm.world
                line["ranks"] = [{k: round(v, 3) for k, v in zip(T_SPLIT, r)} for r in ranks]
                line["replica_digest"] = digest
            self._log(line)
            self._root_rejected_ep = 0.0

    def reset_hparams(self, epoch: int):
        cfg = self.cfg
        # density-collapse root freeze (root_stab_density): freeze root for
        # the coming epoch while the occupied fraction of the density grid
        # is below half its running max
        frac = self.mesh_rest.frac_occupied
        self._frac_max = max(getattr(self, "_frac_max", 0.0), frac)
        self._root_freeze_epoch = bool(
            cfg.root_stab_density and not cfg.freeze_root and epoch > 0
            and (len(self.mesh_rest.vertices) < 100 or frac < 0.5 * self._frac_max))
        if self._root_freeze_epoch:
            self._log({"root_freeze_epoch": epoch, "frac_occupied": frac,
                       "frac_max": self._frac_max})
        # object bound reset (train_utils.py:1102-1104)
        if epoch > int(cfg.num_epochs * cfg.bound_reset):
            if len(self.mesh_rest.vertices) > 100:
                self.latest_vars["obj_bound"] = 1.2 * np.abs(self.mesh_rest.vertices).max(0)
                self._set_mvars(obj_bound=self.latest_vars["obj_bound"])
        # bone re-init epochs (train_utils.py:1106-1121)
        if (cfg.lbs or cfg.neudbs) and not self.is_fine_tune and (
                epoch == int(cfg.num_epochs * cfg.reinit_bone_steps)
                or epoch == 0
                or epoch == int(cfg.num_epochs * cfg.warmup_steps) // 2):
            self.reinit_bones()
            self._reset_opt_state()
            if epoch > 0:
                self.counter_frz_rebone = 0.01
                self.latest_vars["sil_err"][:] = 0

    def _extras_scalars(self, progress: float, step_in_epoch: int) -> Dict[str, np.ndarray]:
        """The step's per-step scalars (CHUNK_STEP_FIELDS order)."""
        cfg = self.cfg
        ind = SCH.compute_indicators(cfg, progress, step_in_epoch,
                                     self.counter_frz_rebone, self.is_fine_tune)
        sil_nonzero = self.latest_vars["sil_err"][self.latest_vars["sil_err"] > 0]
        sil_med = float(np.median(sil_nonzero)) if len(sil_nonzero) else 1e9
        root_update = 0.0 if getattr(self, "_root_freeze_epoch", False) else ind.root_update
        return {
            "progress": np.float32(progress),
            "loss_select": np.int32(ind.loss_select),
            "root_update": np.float32(root_update),
            "body_update": np.float32(ind.body_update),
            "shape_update": np.float32(ind.shape_update),
            "cvf_update": np.float32(ind.cvf_update),
            "sil_err_median": np.float32(sil_med),
            "embed_alpha": np.float32(SCH.embedding_alpha(cfg, progress)),
        }

    def _chunk_scalars(self, i: int, K: int) -> list:
        """The per-step scalars of the K steps of the chunk that starts at
        step i of the epoch, from the state at its start: counter_frz_rebone
        and the silhouette history lag by up to a chunk, as in the JAX
        trainer."""
        final = max(self.final_steps, 1)
        return [self._extras_scalars((self.total_steps_done + j * self.cfg.accu_steps) / final,
                                     i + j) for j in range(K)]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; through pinned memory, without
        waiting, on the card. Integer arrays become int64 (index tensors)."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64 if a.dtype.kind in "iu" else None))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _upload_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: self._to_device(np.asarray(v)) for k, v in batch.items()}

    def _upload_scalars(self, scal: list) -> Dict[str, torch.Tensor]:
        """One upload for a chunk's per-step scalars: {field: [K]}."""
        packed = self._to_device(np.asarray([[s[k] for k in CHUNK_STEP_FIELDS] for s in scal],
                                            np.float32))
        return {k: packed[:, i] for i, k in enumerate(CHUNK_STEP_FIELDS)}

    def _step_draws(self, batch, ns_u: int, ns_a: int, use_fine: bool):
        return {k: v.to(self.device) for k, v in self.draws(
            "step", batch=batch, nsample=ns_u, nsample_active=ns_a, use_fine=use_fine).items()}

    def train_one_epoch(self, epoch: int, shape_samp, shape_samp_valid):
        cfg, dev = self.cfg, self.device
        use_fine = SCH.use_fine_samples(cfg, self.progress)
        use_dskin = SCH.use_dskin(cfg, epoch, cfg.num_epochs)
        use_bones = SCH.use_bones(cfg, epoch, self.is_fine_tune)
        is_active = cfg.use_unc and self.progress >= cfg.warmup_steps
        K = self.steps_chunk
        step_fn, ns_u, ns_a = self.get_step_fn(use_fine, use_dskin, use_bones, is_active,
                                               chunk=K)

        # epoch-invariant device arrays, uploaded once
        fixed = {"shape_samp": torch.as_tensor(shape_samp, dtype=torch.float32, device=dev),
                 "shape_samp_valid": torch.as_tensor(shape_samp_valid, dtype=torch.float32,
                                                     device=dev),
                 "base_rt": (torch.as_tensor(self.latest_vars["rt_raw"], device=dev)
                             if cfg.use_cam else None)}
        self._t_load_ep = self._t_upload_ep = self._t_dispatch_ep = self._t_fetch_ep = 0.0
        for i in range(0, ITERS_PER_EPOCH, K):
            self.progress = self.total_steps_done / max(self.final_steps, 1)
            scal = self._chunk_scalars(i, K)
            t0 = time.time()
            batch, fids = self.loader.next_chunk(K)  # K batches, stacked [K, 2B, ...]
            t1 = time.time()
            per_step = self._upload_scalars(scal)
            batch_dev = self._upload_batch(batch)
            extras = StepExtras(**{k: v[0] for k, v in per_step.items()}, **fixed)
            draws = None
            if self.draws is not None:
                draws = [self._step_draws({k: v[j] for k, v in batch.items()}, ns_u, ns_a,
                                          use_fine) for j in range(K)]
            t2 = time.time()
            aux, host_out = step_fn(batch_dev, extras, per_step, generator=self.gen,
                                    draws=draws)
            fetch = self._start_fetch(aux, host_out)
            t3 = time.time()
            if cfg.debug:  # per-step timing: wait for this step
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._log({"t_load": t2 - t0, "t_step": time.time() - t2,
                           "step": self.total_steps_done})
            self._t_load_ep += t1 - t0
            self._t_upload_ep += t2 - t1
            self._t_dispatch_ep += t3 - t2

            # host bookkeeping runs one chunk behind: the previous chunk's
            # outputs are read once this one is queued behind it
            if self._pending is not None:
                self._process_chunk_outputs(epoch)
            self._pending = (fids, fetch, i)
            self._t_fetch_ep += time.time() - t3

            # a call is accu_steps iterations of the run (final_steps)
            self.total_steps_done += K * cfg.accu_steps
            self.counter_frz_rebone -= K * cfg.accu_steps / max(self.final_steps, 1)

            # near-far re-estimation after nf_reset progress (moda.py:485-491)
            if self.progress >= cfg.nf_reset and len(self.mesh_rest.vertices) > 100 \
                    and i % 50 == 0:
                corners = _box_corners(self.mesh_rest.bounds)
                nf = get_near_far(self.mvars_host["near_far"], self.latest_vars["rtk"],
                                  self.latest_vars["idk"], corners)
                self._set_mvars(near_far=nf)

        # flush the last chunk's outputs at epoch end
        if self._pending is not None:
            t3 = time.time()
            self._process_chunk_outputs(epoch)
            self._pending = None
            self._t_fetch_ep += time.time() - t3

    # ------------------------------------------------------- step outputs
    @staticmethod
    def _start_fetch(aux: Dict, host_out: Dict):
        """Start one packed device->host copy of all of a step's outputs:
        every leaf flattened into one fp32 tensor, copied into pinned host
        memory without waiting, with an event that marks its completion.
        Returns a handle for ``_finish_fetch``."""
        items = [("aux", k, v) for k, v in aux.items()] + \
            [("host", k, v) for k, v in host_out.items()]
        leaves = [torch.as_tensor(v).detach() for _, _, v in items]
        dev = leaves[0].device
        flat = torch.cat([x.to(dev).reshape(-1).float() for x in leaves])
        event = None
        if flat.is_cuda:
            buf = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
            buf.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            buf = flat
        layout = [(part, k, tuple(x.shape)) for (part, k, _), x in zip(items, leaves)]
        return layout, buf, event

    @staticmethod
    def _finish_fetch(handle):
        """Wait for a ``_start_fetch`` copy; -> (aux, host_out) as numpy."""
        layout, buf, event = handle
        if event is not None:
            event.synchronize()
        flat = buf.numpy()
        out = {"aux": {}, "host": {}}
        off = 0
        for part, k, shape in layout:
            n = int(np.prod(shape)) if shape else 1
            out[part][k] = flat[off:off + n].reshape(shape).copy()
            off += n
        return out["aux"], out["host"]

    def _process_chunk_outputs(self, epoch: int):
        """Fetch the pending chunk's stacked outputs once, then consume its
        K steps' slices in order."""
        fids, handle, i0 = self._pending
        aux, host_out = self._finish_fetch(handle)
        for j in range(len(fids)):
            self._consume_step_outputs(fids[j], {k: v[j] for k, v in aux.items()},
                                       {k: v[j] for k, v in host_out.items()}, epoch, i0 + j)

    def _consume_step_outputs(self, fid, aux, host_out, epoch: int, step_in_epoch: int):
        """Deferred host-side consumption of a finished step's outputs
        (save_latest_vars, sil_err history, rollback check, logging);
        aux/host_out are host numpy. Under data parallelism host_out holds
        the global batch's frame ids, which replace the rank's ``fid``."""
        cfg = self.cfg
        if "frameid" in host_out:
            fid = np.asarray(host_out["frameid"]).astype(np.int64)
        # rtk = current composed estimate; rt_raw stays the raw prior
        # (moda.py:1356,1511-1512)
        self.latest_vars["rtk"][fid] = np.asarray(host_out["rtk"])
        self.latest_vars["idk"][fid] = 1
        fe = np.asarray(host_out["frame_err"])
        fc = np.asarray(host_out["frame_cnt"])
        upd = fc > 0
        self.latest_vars["sil_err"][upd] = fe[upd]

        # explosion rollback (train_utils.py:971-974), one step delayed, with
        # a cooldown; with in-step root-step rejection (root_stab_reject) it
        # is a 10x-threshold backstop only
        root_g = float(aux.get("nerf_root_rts_g", 0.0))
        self._root_rejected_ep = getattr(self, "_root_rejected_ep", 0.0) \
            + float(aux.get("root_step_rejected", 0.0))
        rollback_at = cfg.clip_scale * (10.0 if cfg.root_stab_reject else 1.0)
        if (root_g > rollback_at
                and self.total_steps_done > 200 * cfg.accu_steps
                and self.total_steps_done - getattr(self, "_last_rollback", -10**9) > 20):
            latest = os.path.join(self.save_dir, "latest")
            # rank 0 wrote it, and reads it back for every rank (load_model)
            exists = os.path.exists(latest + ".params.npz")
            if self.comm is not None:
                exists = self.comm.agree(exists)
            if exists:
                self._last_rollback = self.total_steps_done
                self._log({"rollback_at": self.total_steps_done, "root_g": root_g})
                self.load_model(latest)
                # fresh Adam moments: the exploded trajectory's second
                # moments at peak LR make the first steps after a reload huge
                if self.optimizer is not None:
                    self._reset_opt_state()

        # dead-density tripwire: a saturated SDF yields exactly-zero density
        # gradients; steps with the shape frozen by the schedule don't count
        if float(aux.get("nerf_coarse_g", 1.0)) == 0.0 \
                and float(aux.get("shape_frozen", 0.0)) == 0.0:
            self._dead_density_steps = getattr(self, "_dead_density_steps", 0) + 1
            if self._dead_density_steps == 50:
                self._log({"dead_density_at": self.total_steps_done})
                print("warning: density gradient has been exactly zero for "
                      "50 steps — the SDF likely collapsed; consider "
                      "reloading an earlier checkpoint with a lower LR")
        else:
            self._dead_density_steps = 0

        if step_in_epoch % 50 == 0:
            scalars = {k: float(v) for k, v in aux.items() if np.ndim(v) == 0}
            scalars.update({"step": self.total_steps_done, "epoch": epoch,
                            "progress": self.progress})
            self._log(scalars)

    # ---------------------------------------------------------- persistence
    def save(self, tag: str):
        if not self.is_main:
            return
        mv = {f: self.mvars_host[f] for f in MVAR_FIELDS if f != "beta_is_active"}
        CK.save_checkpoint(os.path.join(self.save_dir, tag), bridge.export_params(self.model),
                           self.latest_vars, mv,
                           meta={"num_fr": self.data_info.num_fr,
                                 "num_bones": self.cfg.num_bones,
                                 "steps": self.total_steps_done})
        # OBJ/cam text exports only for 'latest'
        if tag != "latest":
            return
        if len(self.mesh_rest.vertices) > 0:
            self.mesh_rest.export_obj(os.path.join(self.save_dir, f"mesh_rest-{tag}.obj"))
        # camera-trajectory mesh (train_utils.py:599-601 mesh_cam export)
        if self.latest_vars["idk"].sum() > 1:
            valid = self.latest_vars["idk"] > 0
            draw_cams(self.latest_vars["rtk"][valid]).export_obj(
                os.path.join(self.save_dir, f"mesh_cam-{tag}.obj"))

    def load_model(self, path: str):
        """Graft a checkpoint (either package's) onto the model, in place;
        under data parallelism rank 0 reads it and broadcasts the result."""
        if self.is_main:
            self._load_model(path)
        self._sync_replicas()

    def _load_model(self, path: str):
        loaded, lv, mv, meta = CK.load_checkpoint(path)
        num_fr_match = meta is None or meta.get("num_fr") == self.data_info.num_fr
        num_bones_match = meta is None or meta.get("num_bones") == self.cfg.num_bones
        merged = CK.merge_params(bridge.export_params(self.model), loaded, num_fr_match,
                                 num_bones_match)
        bridge.load_params(self.model, merged)
        for k, v in lv.items():
            if k in self.latest_vars and (num_fr_match or k == "obj_bound"):
                self.latest_vars[k] = v
        if "obj_bound" in lv:
            self._set_mvars(obj_bound=lv["obj_bound"])
        if num_fr_match and "near_far" in mv:
            self._set_mvars(near_far=mv["near_far"])

    def _log(self, d: Dict):
        if not self.is_main:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps(d) + "\n")
