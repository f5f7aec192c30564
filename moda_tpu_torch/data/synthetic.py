"""Synthetic scene generator: analytic SDF scenes with exact GT.
The port's copy of moda_tpu/data/synthetic.py, plus three writers of
on-disk datasets for the trainer: ``write_line_dataset`` (line shards of
full frames), ``write_frame_dataset`` (the DAVIS layout that
tools/make_synth_dataset.py writes), and, imported from
preproc/pipeline.py where it lives, ``write_lines`` (line shards cut from
a frame dataset through the frame reader).

Role of scripts/synthetic/render_synthetic.py in the reference (which
rasterizes eagle/hands meshes with SoftRas to produce GT cameras/flow for
run_eval.sh) — here the fixture is an analytically ray-marched deforming
ellipsoid, so tests get exact ground truth with zero asset dependencies:
RGB, mask, flow (from 3D correspondences), 16-d surface features (from
canonical surface coords) and GT cameras.
"""
from __future__ import annotations

from dataclasses import dataclass
import os
from typing import Dict, List

import numpy as np

from moda_tpu_torch.data.pfm import write_pfm
from moda_tpu_torch.extract.mesh import Mesh
from moda_tpu_torch.native import marching_cubes
from moda_tpu_torch.preproc.pipeline import write_lines  # noqa: F401  (the callers' import)

# Fixed random direction bank for the CSE stand-in feature (see
# surface_feat): 8 unit directions -> sin+cos = 16-d embedding with no
# rotational symmetry. Seeded so datasets are reproducible across builds.
_FEAT_BANK = np.random.default_rng(7).normal(size=(8, 3))
_FEAT_BANK = (_FEAT_BANK / np.linalg.norm(_FEAT_BANK, axis=-1, keepdims=True)
              * np.linspace(0.7, 2.3, 8)[:, None]).astype(np.float32)


def feat_bank_encode(n: np.ndarray) -> np.ndarray:
    """Unit directions [..., 3] -> 16-d unit features via the FIXED bank.

    This is the fixture's CSE stand-in feature language. The trainer's
    default sphere prior uses the SAME encoder (trainer.py __init__) so
    the pose-CNN warmup trains on the features the fixture's frames
    actually carry — the reference guarantees this consistency by
    computing BOTH the observed features and the template-vertex
    embeddings with one CSE model (moda.py:405-445, utils/cselib.py);
    round-5 forensics: with mismatched encoders the CNN predicts a
    near-constant pose and cold-start collapses to the spin gauge."""
    proj = n @ _FEAT_BANK.T                                  # [...,8]
    enc = np.concatenate([np.sin(np.pi * proj), np.cos(np.pi * proj)], -1)
    return enc / np.maximum(np.linalg.norm(enc, axis=-1, keepdims=True), 1e-9)


@dataclass
class SynthScene:
    """Scale convention matches the reference's data normalization: the
    model divides scene units by obj_scale=10 (near-far init [0,6] ->
    bound 0.3, moda.py:232-247), so a camera at distance 3 lands at the
    canonical base depth 0.3 and the object radius 1 -> 0.1 in model
    units — the regime the shape priors and bound resets assume."""

    radius: float = 1.0
    squash_amp: float = 0.3   # time-varying anisotropic scale (deformation)
    cam_dist: float = 3.0
    num_frames: int = 16
    img_size: int = 64
    focal: float = 2.0        # in units of image half-size

    def scales(self, t: float) -> np.ndarray:
        """Time-varying ellipsoid axes (the 'articulation')."""
        s = 1.0 + self.squash_amp * np.sin(2 * np.pi * t)
        return np.asarray([s, 1.0 / s, 1.0])

    def camera(self, i: int):
        """Orbiting camera i -> (R [3,3], T [3], K [4]) object->cam."""
        t = i / max(self.num_frames - 1, 1)
        ang = 2 * np.pi * t * 0.5  # half orbit
        ca, sa = np.cos(ang), np.sin(ang)
        # rotate about y, then look down z
        R = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        T = np.asarray([0.0, 0.0, self.cam_dist])
        f = self.focal * self.img_size / 2.0
        K = np.asarray([f, f, self.img_size / 2.0, self.img_size / 2.0])
        return R, T, K

    def canonical_pts(self, pts: np.ndarray, t: float) -> np.ndarray:
        """Deformed -> canonical (divide by axis scales)."""
        return pts / self.scales(t)[None]

    def deform_pts(self, pts_c: np.ndarray, t: float) -> np.ndarray:
        return pts_c * self.scales(t)[None]

    def sdf(self, pts: np.ndarray, t: float) -> np.ndarray:
        """Approximate SDF of the deformed ellipsoid at frame-time t."""
        pc = self.canonical_pts(pts, t)
        return (np.linalg.norm(pc, axis=-1) - self.radius) * self.scales(t).min()

    def surface_color(self, pts_c: np.ndarray) -> np.ndarray:
        n = pts_c / np.maximum(np.linalg.norm(pts_c, axis=-1, keepdims=True), 1e-9)
        return 0.5 + 0.5 * n

    def surface_feat(self, pts_c: np.ndarray) -> np.ndarray:
        """16-d unit feature from canonical direction (CSE stand-in).

        Encodes sin/cos of projections onto a FIXED random direction bank
        rather than the coordinate axes. The old axis-aligned encoding was
        invariant under coordinate permutations (a 3-fold rotation symmetry
        of the feature field), which made global yaw ambiguous to the pose
        CNN on the no-prior route — the round-4 full-budget cold-start run
        collapsed to the spin gauge (rooteval median 89 deg) because the
        extracted init cameras aliased. Real CSE embeddings have no such
        symmetry (utils/cselib.py features are semantic), so neither should
        the stand-in: a generic random bank admits no rotation R with
        feat(Rn) == feat(n)."""
        n = pts_c / np.maximum(np.linalg.norm(pts_c, axis=-1, keepdims=True), 1e-9)
        return feat_bank_encode(n)

    def render_frame(self, i: int) -> Dict[str, np.ndarray]:
        """Sphere-trace frame i; returns img/mask/hit 3D points (object coords)."""
        S = self.img_size
        t = i / max(self.num_frames - 1, 1)
        R, T, K = self.camera(i)
        xs, ys = np.meshgrid(np.arange(S) + 0.5, np.arange(S) + 0.5)
        d_cam = np.stack([(xs - K[2]) / K[0], (ys - K[3]) / K[1], np.ones_like(xs)], -1)
        d_obj = d_cam @ R  # R^T d
        o_obj = -R.T @ T
        o_obj = np.broadcast_to(o_obj, d_obj.shape)

        depth = np.full((S, S), self.cam_dist * 0.1)
        for _ in range(64):
            pts = o_obj + d_obj * depth[..., None]
            depth = depth + self.sdf(pts, t) * 0.9
        pts = o_obj + d_obj * depth[..., None]
        hit = np.abs(self.sdf(pts, t)) < 1e-2 * self.radius

        pts_c = self.canonical_pts(pts, t)
        img = np.where(hit[..., None], self.surface_color(pts_c), 1.0)
        feat = np.where(hit[..., None], self.surface_feat(pts_c), 0.0)
        return {
            "img": img.astype(np.float32),
            "mask": hit.astype(np.float32),
            "pts": pts.astype(np.float32),
            "pts_c": pts_c.astype(np.float32),
            "feat": feat.astype(np.float32),
            "rtk": np.concatenate([np.concatenate([R, T[:, None]], 1),
                                   K[None]], 0).astype(np.float32),
            "time": t,
        }

    def flow_between(self, f0: Dict, f1: Dict, i1: int) -> np.ndarray:
        """GT flow frame0 -> frame1 in NDC units (2/img_size px), via the
        canonical correspondence."""
        R1 = f1["rtk"][:3, :3]
        T1 = f1["rtk"][:3, 3]
        K1 = f1["rtk"][3]
        pts1 = self.deform_pts(f0["pts_c"].reshape(-1, 3), f1["time"]).reshape(f0["pts_c"].shape)
        cam = pts1 @ R1.T + T1
        x = cam[..., 0] / cam[..., 2] * K1[0] + K1[2]
        y = cam[..., 1] / cam[..., 2] * K1[1] + K1[3]
        S = self.img_size
        xs, ys = np.meshgrid(np.arange(S) + 0.5, np.arange(S) + 0.5)
        flow = np.stack([x - xs, y - ys], -1)
        flow = np.where(f0["mask"][..., None] > 0, flow, 0.0)
        return (flow * 2.0 / S).astype(np.float32)

    def make_batch(self, pair_ids: List[tuple]) -> Dict[str, np.ndarray]:
        """Frame-pair batch in the trainer's layout ([2B, C, P])."""
        if not hasattr(self, "_frame_cache"):
            self._frame_cache = {}
            self._flow_cache = {}
        frames = self._frame_cache

        def get(i):
            if i not in frames:
                frames[i] = self.render_frame(i)
            return frames[i]

        refs = []
        for (a, b) in pair_ids:
            refs.append((get(a), a, get(b), b))

        def pack(f, flow):
            P = self.img_size ** 2
            return {
                "imgs": f["img"].reshape(P, 3).T,
                "masks": f["mask"].reshape(1, P),
                "vis2d": np.ones((1, P), np.float32),
                "flow": flow.reshape(P, 2).T,
                "occ": f["mask"].reshape(1, P).astype(np.float32),
                "dp_feats": f["feat"].reshape(P, 16).T,
                "rtk": f["rtk"],
                "kaug": np.asarray([1.0, 1.0, 0.0, 0.0], np.float32),
            }

        def flow_cached(f0, i0, f1, i1):
            key = (i0, i1)
            if key not in self._flow_cache:
                self._flow_cache[key] = self.flow_between(f0, f1, i1)
            return self._flow_cache[key]

        first, second = [], []
        fid = []
        for (fa, a, fb, b) in refs:
            first.append(pack(fa, flow_cached(fa, a, fb, b)))
            second.append(pack(fb, flow_cached(fb, b, fa, a)))
            fid.append((a, b))

        batch = {}
        for k in first[0].keys():
            batch[k] = np.stack([d[k] for d in first] + [d[k] for d in second])
        ids = np.asarray([a for a, _ in fid] + [b for _, b in fid], np.int32)
        batch["frameid"] = ids
        batch["frameid_sub"] = ids
        batch["dataid"] = np.zeros_like(ids)
        return batch


def write_line_dataset(root: str, config_dir: str, seqname: str, scene: SynthScene) -> str:
    """Store ``scene`` as a ``--lineload`` dataset under ``root``, in the
    layout of moda_tpu/preproc/pipeline.py::write_lines (dframe 1):

    - ``Pixels/Full-Resolution/<seq>/1_%05d/%04d.npy``: per-row dicts of the
      pair (i, i+1), pair-stacked [1, 2, C, W], plus ``rtk.npy``;
    - ``Cameras/Full-Resolution/<seq>/%05d.txt``: the exact cameras [R|T; K];
    - ``Meshes/Full-Resolution/<seq>/mesh-%05d.obj``: the ground-truth surface
      of each frame, as the ellipsoid branch of tools/make_synth_dataset.py
      makes it (marching tetrahedra on the negated SDF over a 64^3 grid of
      +-1.5 radius, object coordinates);
    - ``JPEGImages/Full-Resolution/<seq>/%05d.jpg``: placeholders (the line
      loader reads only their names);
    - ``<config_dir>/<seq>.config`` with the exact intrinsics.

    Observations are full frames (kaug = [1, 1, 0, 0]) with flow in NDC
    units, as ``SynthScene.make_batch`` gives them. Returns the config path."""
    S = scene.img_size
    dirs = {k: os.path.join(root, k, "Full-Resolution", seqname)
            for k in ("JPEGImages", "Cameras", "Pixels", "Meshes")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    frames = [scene.render_frame(i) for i in range(scene.num_frames)]
    for i, f in enumerate(frames):
        np.zeros(1, np.uint8).tofile(os.path.join(dirs["JPEGImages"], "%05d.jpg" % i))
        np.savetxt(os.path.join(dirs["Cameras"], "%05d.txt" % i), f["rtk"])
    _write_sdf_meshes(dirs["Meshes"], scene)

    def chans(f, flow):  # reference row keys -> [C, S, S]
        return {"img": f["img"].transpose(2, 0, 1), "mask": f["mask"][None],
                "vis2d": np.ones((1, S, S), np.float32), "flow": flow.transpose(2, 0, 1),
                "occ": f["mask"][None], "dp_feat_rsmp": f["feat"].transpose(2, 0, 1),
                "dp": f["mask"][None]}

    kaug = np.asarray([1.0, 1.0, 0.0, 0.0], np.float32)
    for i in range(scene.num_frames - 1):
        f0, f1 = frames[i], frames[i + 1]
        c0 = chans(f0, scene.flow_between(f0, f1, i + 1))
        c1 = chans(f1, scene.flow_between(f1, f0, i))
        shard = os.path.join(dirs["Pixels"], f"1_{i:05d}")
        os.makedirs(shard, exist_ok=True)
        np.save(os.path.join(shard, "rtk.npy"),
                {"rtk": np.stack([f0["rtk"], f1["rtk"]])[None],
                 "kaug": np.stack([kaug, kaug])[None]})
        for row in range(S):
            np.save(os.path.join(shard, "%04d.npy" % row),
                    {k: np.stack([c0[k][:, row], c1[k][:, row]]).astype(np.float32)[None]
                     for k in c0})

    return _write_config(config_dir, seqname, dirs["JPEGImages"], scene)


def _write_sdf_meshes(mesh_dir: str, scene: SynthScene):
    """Ground-truth surface of each frame of the ellipsoid scene: marching
    tetrahedra on the negated SDF over a 64^3 grid of +-1.5 radius, object
    coordinates (the ellipsoid branch of tools/make_synth_dataset.py)."""
    n, half = 64, 1.5 * scene.radius
    lin = np.linspace(-half, half, n).astype(np.float32)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    for i in range(scene.num_frames):
        sdf = -scene.sdf(grid, i / max(scene.num_frames - 1, 1)).reshape(n, n, n)
        v, tris = marching_cubes(sdf.astype(np.float32), 0.0)
        v = (v - n / 2.0) / n * 2.0 * half
        Mesh(v.astype(np.float32), tris).export_obj(os.path.join(mesh_dir, "mesh-%05d.obj" % i))


def _write_config(config_dir: str, seqname: str, img_dir: str, scene: SynthScene) -> str:
    """``<config_dir>/<seq>.config`` with the scene's exact intrinsics."""
    S = scene.img_size
    os.makedirs(config_dir, exist_ok=True)
    fpx = scene.focal * S / 2.0
    path = os.path.join(config_dir, f"{seqname}.config")
    with open(path, "w") as fo:
        fo.write("[data]\ndframe = 1\ninit_frame = 0\nend_frame = -1\ncan_frame = -1\n\n")
        fo.write(f"[data_0]\nks = {fpx} {fpx} {S / 2} {S / 2}\n")
        fo.write(f"datapath = {img_dir}/\n")
    return path


FLOW_DFRAMES = (1, 2, 4, 8)  # the loader's dframes that the fixture gives flow for


def write_frame_dataset(root: str, config_dir: str, seqname: str, scene: SynthScene) -> str:
    """Store ``scene`` (a SynthScene or a data/synth_mesh.py MeshScene) as a
    DAVIS-layout dataset under ``root``, as tools/make_synth_dataset.py:64-125
    does, for the frame-decoding route:

    - ``JPEGImages/Full-Resolution/<seq>/%05d.jpg``: the frames, as PNG bytes
      under their DAVIS names (no JPEG encoder is at hand; the port's reader
      and cv2.imread tell the format by its first bytes);
    - ``Annotations/.../%05d.png``: the masks at 128 (grey PNG);
    - ``FlowFW_<d>/``, ``FlowBW_<d>/`` for d in FLOW_DFRAMES: ground-truth
      ``flo-%05d.pfm`` in pixels and ``occ-%05d.pfm`` (the source frame's mask);
    - ``Densepose/...``: vertex maps ``%05d.pfm`` (a MeshScene's nearest
      rest-vertex ids, ``MeshScene.vertex_ids``; zeros for a SynthScene,
      as the tool writes for every scene), the 16-d features of a
      tight object-bbox crop resized to 112 x 112 (``feat-%05d.pfm``, the
      reference's compute_dp.py crop) and that bbox (``bbox-%05d.txt``), and
      ``prior.pkl`` (rest vertices, faces and embeddings) for a MeshScene;
    - ``Cameras/.../%05d.txt`` and ground-truth ``Meshes/.../mesh-%05d.obj``
      (camera space and ``mesh-rest.obj`` for a MeshScene, the SDF's
      surface in object coordinates for a SynthScene);
    - ``<config_dir>/<seq>.config`` with the exact intrinsics.
    Returns the config path."""
    import pickle

    from moda_tpu_torch.data import imageio as IO
    from moda_tpu_torch.viz.render_vis import save_png

    S = scene.img_size
    dirs = {k: os.path.join(root, k, "Full-Resolution", seqname)
            for k in ("JPEGImages", "Annotations", "Cameras", "Densepose", "Meshes")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    frames = [scene.render_frame(i) for i in range(scene.num_frames)]
    if hasattr(scene, "rest_verts"):
        with open(os.path.join(dirs["Densepose"], "prior.pkl"), "wb") as fpk:
            pickle.dump({"vertices": scene.rest_verts, "faces": scene.faces,
                         "embeddings": scene.vert_feats}, fpk)
    for i, f in enumerate(frames):
        save_png(os.path.join(dirs["JPEGImages"], "%05d.jpg" % i),
                 (f["img"] * 255).astype(np.uint8))
        save_png(os.path.join(dirs["Annotations"], "%05d.png" % i),
                 (f["mask"] * 128).astype(np.uint8))
        np.savetxt(os.path.join(dirs["Cameras"], "%05d.txt" % i), f["rtk"])
        ys, xs = np.where(f["mask"] > 0)
        if len(xs) >= 4:
            bx0, bx1 = int(xs.min()), int(xs.max()) + 1
            by0, by1 = int(ys.min()), int(ys.max()) + 1
        else:
            bx0, by0, bx1, by1 = 0, 0, S, S
        feat112 = IO.resize(f["feat"][by0:by1, bx0:bx1], (112, 112)).transpose(2, 0, 1)
        write_pfm(os.path.join(dirs["Densepose"], "feat-%05d.pfm" % i),
                  feat112.reshape(16 * 112, 112))
        np.savetxt(os.path.join(dirs["Densepose"], "bbox-%05d.txt" % i),
                   np.asarray([bx0, by0, bx1, by1], np.float32))
        # vertex ids at (id + 0.5) / 50 on the mask, so that read_raw's
        # truncating `* 50` gives each id back
        dp = (scene.vertex_ids(f) + 0.5) * 0.02 * (f["mask"] > 0) \
            if hasattr(scene, "vertex_ids") else np.zeros((S, S))
        write_pfm(os.path.join(dirs["Densepose"], "%05d.pfm" % i), dp.astype(np.float32))

    for d in FLOW_DFRAMES:
        fw_dir = os.path.join(root, f"FlowFW_{d}", "Full-Resolution", seqname)
        bw_dir = os.path.join(root, f"FlowBW_{d}", "Full-Resolution", seqname)
        os.makedirs(fw_dir, exist_ok=True)
        os.makedirs(bw_dir, exist_ok=True)
        for i in range(0, scene.num_frames - d, d):
            flo_fw = scene.flow_between(frames[i], frames[i + d], i + d) * S / 2.0
            flo_bw = scene.flow_between(frames[i + d], frames[i], i) * S / 2.0
            for out_dir, k, flo, occ in ((fw_dir, i, flo_fw, frames[i]["mask"]),
                                         (bw_dir, i + d, flo_bw, frames[i + d]["mask"])):
                write_pfm(os.path.join(out_dir, "flo-%05d.pfm" % k),
                          np.concatenate([flo, np.zeros_like(flo[..., :1])], -1))
                write_pfm(os.path.join(out_dir, "occ-%05d.pfm" % k), occ.astype(np.float32))

    if hasattr(scene, "gt_mesh_cam"):
        for i in range(scene.num_frames):
            Mesh(*scene.gt_mesh_cam(i)).export_obj(
                os.path.join(dirs["Meshes"], "mesh-%05d.obj" % i))
        Mesh(*scene.gt_mesh_rest()).export_obj(os.path.join(dirs["Meshes"], "mesh-rest.obj"))
    else:
        _write_sdf_meshes(dirs["Meshes"], scene)
    return _write_config(config_dir, seqname, dirs["JPEGImages"], scene)
