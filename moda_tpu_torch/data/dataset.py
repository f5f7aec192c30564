"""Datasets and the pair batcher. Counterpart of moda_tpu/data/dataset.py
(utils/io.py:277-518 + dataloader/frameloader.py):

- ``VideoDataset`` and ``build_datasets``: the frame-decoding route, a pair
  of frames read and cropped through ``data/frames.py::FrameReader`` per
  sample (vidbase.load_data);
- ``LineShardDataset`` reads the reference's pre-sharded pixel rows
  (``Pixels/<seq>/<dframe>_<frameid>/%04d.npy``, the ``--lineload`` route of
  scripts/template.sh:21), and ``preload_dense`` turns them into dense
  arrays so a batch is numpy gathers;
- ``PairLoader`` assembles [2B, C, npix] batches in worker threads: from
  the dense arrays when every dataset is a line-shard dataset and ``npix``
  is given, else pair by pair through ``sample_pair`` (``collate_pairs``).
  The dense route raises when the shards cannot be preloaded, and a
  worker's fault (a shard or frame that cannot be read) reaches the caller
  of ``next``; the JAX loader substitutes pair 0 for a pair that fails to
  load (dataset.py:251-255), the port does not.

``PairLoader.next_chunk(k)`` stacks the k batches that k calls of ``next``
would return, on the caller's thread: the JAX loader's assembler thread,
started anew (and the old one left running) whenever k changes, is not
copied. ``close()`` stops and joins its workers, after which ``next`` and
``next_chunk`` raise; a worker never drops a batch it drew, so one worker
gives one batch sequence per seed.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from moda_tpu_torch.config import load_seq_config
from moda_tpu_torch.data.frames import FramePaths, FrameReader

DFRAME_CANDIDATES = [2, 4, 8, 16, 32]


@dataclass
class VideoDataset:
    """One video: frame pair access (vidbase.load_data equivalent)."""

    reader: FrameReader
    dataid: int
    num_frames: int

    @property
    def rtklist(self) -> List[str]:
        """The per-frame camera files (as LineShardDataset.rtklist)."""
        return self.reader.paths.rtklist

    def sample_pair(self, rng: np.random.Generator, idx: Optional[int] = None) -> Dict:
        max_id = self.num_frames - 1
        if idx is None:
            idx = int(rng.integers(0, max_id))
        fw = bool(rng.integers(0, 2)) if 0 < idx < max_id else (idx < max_id)
        dir_fac = 1 if fw else -1
        cands = [1] + [d for d in DFRAME_CANDIDATES
                       if idx % d == 0 and 0 <= idx + d * dir_fac <= max_id]
        dframe = int(rng.choice(cands))
        i0, i1 = idx, idx + dframe * dir_fac

        d0 = self.reader.read_raw(i0, flowfw=fw, dframe=dframe)
        d1 = self.reader.read_raw(i1, flowfw=not fw, dframe=dframe)
        flow, flown, occ, occn = self.reader.flow_process(d0, d1)

        def pack(d, fl, oc):
            return {
                "imgs": d["img"].reshape(-1, 3).T,         # [3, P]
                "masks": (d["mask"] * d["vis2d"] > 0).astype(np.float32).reshape(1, -1),
                "vis2d": d["vis2d"].reshape(1, -1).astype(np.float32),
                "flow": fl.reshape(-1, 2).T,
                "occ": oc.reshape(1, -1),
                "dp_feats": d["dp_feat_rsmp"].reshape(16, -1),
                "dps": d["dp"].reshape(1, -1),
                "rtk": d["rtk"].astype(np.float32),
                "kaug": d["kaug"].astype(np.float32),
            }

        return {
            "frames": (pack(d0, flow, occ), pack(d1, flown, occn)),
            "frameid": np.asarray([i0, i1], np.int32),
            "dataid": np.asarray([self.dataid, self.dataid], np.int32),
        }


def build_datasets(seqname: str, img_size: int, config_dir: str = "configs",
                   rtk_base: Optional[str] = None) -> List[VideoDataset]:
    """Parse configs/<seqname>.config into per-video datasets."""
    out = []
    for i, s in enumerate(load_seq_config(seqname, config_dir)):
        imgs = s.image_list()
        if not imgs:
            raise FileNotFoundError(f"no frames under {s.datapath}")
        rtk_path = rtk_base + "/" + imgs[0].split("/")[-2] if rtk_base else s.rtk_path
        reader = FrameReader(FramePaths.from_imglist(imgs, rtk_path), img_size, s.flip)
        out.append(VideoDataset(reader=reader, dataid=i, num_frames=len(imgs)))
    return out


def data_offsets(datasets) -> tuple:
    """Cumulative frame offsets per video (extract_data_info equivalent,
    utils/io.py:537-548)."""
    off = [0]
    for d in datasets:
        off.append(off[-1] + d.num_frames)
    return tuple(off)


PIXEL_KEYS = ("imgs", "masks", "vis2d", "flow", "occ", "dp_feats", "dps")


def collate_pairs(pairs: List[Dict], offsets, npix: Optional[int] = None,
                  rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """B pair dicts -> one [2B, ...] frame batch, reference ordering:
    first all reference frames, then all paired frames (moda.py:1362-1417).
    frameid is made absolute via the video offsets.

    npix: sparse collation — per-entry pixel columns are sampled here and
    only those are stacked (the host-side sampling contract of
    sparsify_batch, fused into collation so the full rows are never
    copied; matters on few-core hosts)."""
    B = len(pairs)
    keys = pairs[0]["frames"][0].keys()
    batch = {}
    ids = None
    if npix is not None:
        P = np.asarray(pairs[0]["frames"][0]["imgs"]).shape[-1]
        ids = rng.integers(0, P, size=(2 * B, npix)).astype(np.int32)
    for k in keys:
        if ids is not None and k in PIXEL_KEYS:
            a = np.stack([np.asarray(p["frames"][0][k])[:, ids[i]]
                          for i, p in enumerate(pairs)])
            b = np.stack([np.asarray(p["frames"][1][k])[:, ids[B + i]]
                          for i, p in enumerate(pairs)])
        else:
            a = np.stack([p["frames"][0][k] for p in pairs])
            b = np.stack([p["frames"][1][k] for p in pairs])
        batch[k] = np.concatenate([a, b], 0)
    if ids is not None:
        batch["pix_ids"] = ids
    fid = np.concatenate([
        np.stack([p["frameid"][0] for p in pairs]),
        np.stack([p["frameid"][1] for p in pairs]),
    ])
    did = np.concatenate([
        np.stack([p["dataid"][0] for p in pairs]),
        np.stack([p["dataid"][1] for p in pairs]),
    ])
    offsets = np.asarray(offsets)
    batch["frameid_sub"] = fid.astype(np.int32)
    batch["frameid"] = (fid + offsets[did]).astype(np.int32)
    batch["dataid"] = did.astype(np.int32)
    if "lineid" in pairs[0]:
        lid = np.concatenate([
            np.stack([p["lineid"][0] for p in pairs]),
            np.stack([p["lineid"][1] for p in pairs]),
        ])
        batch["lineid"] = lid.astype(np.int32)
    return batch


def sparsify_batch(batch: Dict[str, np.ndarray], npix: int,
                   rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Host-side pixel sampling: keep only npix random pixel columns per
    entry, recording their global ids in batch['pix_ids'] [2B, npix].

    The device step only ever gathers nsample(+active pool) pixels per
    entry; uploading full rows/frames through a remote-TPU link costs more
    than the step itself (measured 25 MB -> ~0.4 s vs a 77 ms step), so
    the sampling moves host-side. Layout contract with
    render/rays.py::build_rays: columns [:nsample] are the uniform slots,
    the last 4*(nsample+nsample_active) are the active candidate pool."""
    per_px = [k for k in PIXEL_KEYS if k in batch]
    P = batch[per_px[0]].shape[-1]
    n = batch[per_px[0]].shape[0]
    ids = rng.integers(0, P, size=(n, npix)).astype(np.int32)
    out = dict(batch)
    for k in per_px:
        out[k] = np.take_along_axis(batch[k], ids[:, None, :], axis=2)
    out["pix_ids"] = ids
    return out


class PairLoader:
    """Random pair batches with thread prefetch; per-process sharding by
    disjoint RNG streams (replaces DistributedSampler).

    npix: when set, batches are npix pixel columns per entry: gathered from
    the datasets' dense arrays when every dataset is a line-shard dataset
    (preload_dense, which raises if the shards cannot be read), else
    sampled while the pairs are collated (collate_pairs); when None, full
    rows or frames are collated pair by pair."""

    def __init__(self, datasets: list, batch_size: int,
                 seed: int = 0, process_index: int = 0, num_prefetch: int = 4,
                 num_threads: int = 4, npix: Optional[int] = None):
        self.npix = npix
        self.datasets = datasets
        self.offsets = data_offsets(datasets)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed * 1000 + process_index)
        # dense route: batch assembly is vectorized numpy gathers instead of
        # 2*B per-row sample_pair calls
        self._dense = npix is not None and all(isinstance(d, LineShardDataset)
                                               for d in datasets)
        if self._dense:
            for d in datasets:
                d.preload_dense()
        self._error: Optional[BaseException] = None
        self.q: queue.Queue = queue.Queue(maxsize=num_prefetch)
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(num_threads)
        ]
        self._lock = threading.Lock()
        for t in self.threads:
            t.start()

    def _sample_batch_dense(self) -> Dict[str, np.ndarray]:
        """Vectorized collation from dense line datasets: reference batch
        layout (all reference frames then all paired frames,
        moda.py:1362-1417), grouped by video."""
        with self._lock:
            counts = np.bincount(
                self.rng.integers(0, len(self.datasets), size=self.batch_size),
                minlength=len(self.datasets))
            seeds = self.rng.integers(0, 2**31, size=len(self.datasets))
        parts = []
        for di, (ds, n, s) in enumerate(zip(self.datasets, counts, seeds)):
            if n:
                parts.append((di, ds.sample_batch(
                    np.random.default_rng(int(s)), int(n), self.npix)))
        offsets = np.asarray(self.offsets)
        batch: Dict[str, np.ndarray] = {}
        for k in list(parts[0][1]["ref"]):
            batch[k] = np.concatenate(
                [p["ref"][k] for _, p in parts] +
                [p["pair"][k] for _, p in parts], 0)
        fid = np.concatenate([p["frameid"][:, 0] for _, p in parts] +
                             [p["frameid"][:, 1] for _, p in parts])
        did = np.concatenate([np.full(len(p["frameid"]), di, np.int32)
                              for di, p in parts] * 2)
        batch["frameid_sub"] = fid.astype(np.int32)
        batch["frameid"] = (fid + offsets[did]).astype(np.int32)
        batch["dataid"] = did
        batch["lineid"] = np.concatenate(
            [p["lineid"] for _, p in parts] * 2).astype(np.int32)
        batch["pix_ids"] = np.concatenate(
            [p["pix_ids"][:len(p["lineid"])] for _, p in parts] +
            [p["pix_ids"][len(p["lineid"]):] for _, p in parts], 0)
        return batch

    def _sample_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """One batch; None when the loader stops while the pairs are read."""
        if self._dense:
            return self._sample_batch_dense()
        with self._lock:
            picks = [int(self.rng.integers(0, len(self.datasets)))
                     for _ in range(self.batch_size)]
            seeds = self.rng.integers(0, 2**31, size=self.batch_size + 1)
        pairs = []
        for ds_idx, s in zip(picks, seeds):
            if self._stop.is_set():  # a frame batch takes seconds: stop between pairs
                return None
            pairs.append(self.datasets[ds_idx].sample_pair(np.random.default_rng(int(s))))
        return collate_pairs(pairs, self.offsets, npix=self.npix,
                             rng=np.random.default_rng(int(seeds[-1])))

    def _worker(self):
        # a batch, once drawn, is delivered: dropping it when the queue is
        # full would make the batch sequence depend on the consumer's pace
        while not self._stop.is_set():
            try:
                batch = self._sample_batch()
            except Exception as e:  # handed to the caller of __next__
                self._error = e
                return
            while batch is not None and not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        while True:
            if self._error is not None:
                raise RuntimeError("a PairLoader worker failed") from self._error
            if self._stop.is_set():
                raise RuntimeError("the PairLoader is closed")
            try:
                return self.q.get(timeout=1.0)
            except queue.Empty:
                continue

    def next_chunk(self, k: int):
        """The next k batches stacked: ({field: [k, 2B, ...]}, [each batch's
        frameid]), the batches k calls of ``next`` would return, in order."""
        bl = [next(self) for _ in range(k)]
        return ({f: np.stack([b[f] for b in bl]) for f in bl[0]},
                [np.asarray(b["frameid"]) for b in bl])

    def __iter__(self):
        return self

    def close(self, timeout: float = 10.0):
        """Stop the workers and wait for them: a worker blocked on a full
        queue wakes within a second and returns."""
        self._stop.set()
        for t in self.threads:
            t.join(timeout)


class LineShardDataset:
    """Drop-in reader for the reference's pre-sharded pixel rows
    (preprocess/img2lines.py:33-107 + utils/io.py:380-454):
    ``Pixels/<seq>/<dframe>_<frameid>/%04d.npy`` holding per-row dicts
    {img [1,2,3,W], mask, vis2d, flow [1,2,2,W], occ, dp, dp_feat_rsmp
    [1,2,16,W]} plus ``rtk.npy`` {'rtk','kaug'}. Produces the same pair
    layout as VideoDataset.sample_pair, with one row per sample (lineid)."""

    ROW_CACHE_BYTES = 8 << 30  # the per-row route's row cache stops growing here

    def __init__(self, pixels_dir: str, imglist: List[str], img_size: int,
                 dataid: int = 0, rtklist: Optional[List[str]] = None):
        self.pixels_dir = pixels_dir
        self.img_size = img_size
        self.dataid = dataid
        self.num_frames = len(imglist)
        self.rtklist = rtklist
        # in-memory caches: on few-core hosts the per-pair file parsing
        # (np.load pickle rows + np.loadtxt cams) dominates the train loop;
        # rows fill the cache up to ROW_CACHE_BYTES then stop being added
        self._cache_used = 0
        self._row_cache: Dict = {}
        self._meta_cache: Dict = {}
        self._rtk_cache: Dict = {}

    def _load_rtk(self, idt: int) -> Optional[np.ndarray]:
        if self.rtklist is None:
            return None
        if idt not in self._rtk_cache:
            try:
                self._rtk_cache[idt] = np.loadtxt(self.rtklist[idt])
            except (OSError, FileNotFoundError):
                self._rtk_cache[idt] = None
        return self._rtk_cache[idt]

    def _load_row(self, shard: str, idy: int):
        key = (shard, idy)
        row = self._row_cache.get(key)
        if row is None:
            row = np.load(os.path.join(shard, "%04d.npy" % idy),
                          allow_pickle=True).item()
            if self._cache_used < self.ROW_CACHE_BYTES:
                self._row_cache[key] = row
                self._cache_used += sum(
                    np.asarray(v).nbytes for v in row.values())
        return row

    def _load_meta(self, shard: str):
        meta = self._meta_cache.get(shard)
        if meta is None:
            meta = np.load(os.path.join(shard, "rtk.npy"),
                           allow_pickle=True).item()
            self._meta_cache[shard] = meta
        return meta

    # ---------------------------------------------------------- dense path
    ROW_KEYS = {"imgs": ("img", 3), "masks": ("mask", 1), "vis2d": ("vis2d", 1),
                "flow": ("flow", 2), "occ": ("occ", 1),
                "dp_feats": ("dp_feat_rsmp", 16)}

    def preload_dense(self, cache_path: Optional[str] = None):
        """Load every shard row into dense per-dframe arrays
        [Fd, R, 2, C, W] so batch assembly becomes pure numpy gathers
        (the per-row np.load/pickle path costs ~0.4 s per 256-pair batch
        on a 1-vCPU host — 15x the device step). A consolidated .npy cache
        next to the Pixels dir makes later runs skip the 12k-file read.
        Raises when the shards are missing or unreadable."""
        if getattr(self, "_dense", None) is not None:
            return
        cache_path = cache_path or os.path.join(self.pixels_dir, "_dense_cache.npz")
        dense: Dict = {}
        if os.path.exists(cache_path):
            z = np.load(cache_path, allow_pickle=False)
            dframes = [int(d) for d in z["dframes"]]
            for d in dframes:
                dense[d] = {k: z[f"{k}_d{d}"] for k in
                            list(self.ROW_KEYS) + ["kaug", "rtkmeta"]}
                dense[d]["idts"] = z[f"idts_d{d}"]
        else:
            by_df: Dict[int, list] = {}
            for name in sorted(os.listdir(self.pixels_dir)):
                if "_" not in name or not os.path.isdir(
                        os.path.join(self.pixels_dir, name)):
                    continue
                d, idt = name.split("_")
                by_df.setdefault(int(d), []).append(int(idt))
            if not by_df:
                raise FileNotFoundError(f"no line shards under {self.pixels_dir}")
            for d, idts in by_df.items():
                idts = sorted(idts)
                per_key = {k: [] for k in self.ROW_KEYS}
                kaugs, rtkms = [], []
                for idt in idts:
                    shard = os.path.join(self.pixels_dir, f"{d}_{idt:05d}")
                    rows = [self._load_row(shard, y)
                            for y in range(self.img_size)]
                    for k, (rk, C) in self.ROW_KEYS.items():
                        per_key[k].append(np.stack(
                            [np.asarray(r[rk], np.float32).reshape(2, C, -1)
                             for r in rows]))
                    meta = self._load_meta(shard)
                    kaugs.append(np.asarray(meta["kaug"],
                                            np.float32).reshape(2, 4))
                    rtkms.append(np.asarray(
                        meta.get("rtk", np.tile(np.eye(4, dtype=np.float32),
                                                (2, 1, 1))),
                        np.float32).reshape(2, 4, 4))
                dense[d] = {k: np.stack(v) for k, v in per_key.items()}
                dense[d]["kaug"] = np.stack(kaugs)
                dense[d]["rtkmeta"] = np.stack(rtkms)
                dense[d]["idts"] = np.asarray(idts, np.int32)
            try:
                flat = {"dframes": np.asarray(sorted(dense), np.int32)}
                for d, v in dense.items():
                    for k, a in v.items():
                        if k != "idts":
                            flat[f"{k}_d{d}"] = a
                    flat[f"idts_d{d}"] = v["idts"]
                np.savez(cache_path, **flat)
            except OSError:
                pass  # cache is best-effort
        # slot lookup per dframe + mask/vis composition done once
        for d, v in dense.items():
            slot = -np.ones(self.num_frames, np.int32)
            slot[v["idts"]] = np.arange(len(v["idts"]), dtype=np.int32)
            v["slot"] = slot
            v["masks"] = ((v["masks"] * v["vis2d"]) > 0).astype(np.float32)
        # GT-prior cameras (rtklist), one [F,4,4] array + validity
        rtk_all = np.tile(np.eye(4, dtype=np.float32), (self.num_frames, 1, 1))
        rtk_ok = np.zeros(self.num_frames, bool)
        for i in range(self.num_frames):
            r = self._load_rtk(i)
            if r is not None:
                rtk_all[i] = r
                rtk_ok[i] = True
        self._rtk_all, self._rtk_ok = rtk_all, rtk_ok
        # dframe candidates per start frame (isdir checks hoisted out of
        # the sample loop)
        self._cands = []
        max_id = self.num_frames - 1
        for idt in range(max(max_id, 1)):
            c = [d for d in [1] + DFRAME_CANDIDATES
                 if d in dense and idt % d == 0 and idt + d <= max_id
                 and dense[d]["slot"][idt] >= 0]
            self._cands.append(np.asarray(c or [1], np.int32))
        self._dense = dense
        self._row_cache.clear()  # dense arrays supersede the row cache

    def sample_batch(self, rng: np.random.Generator, n: int, npix: int) -> Dict:
        """Vectorized n-pair sample from the dense arrays. Returns
        {'ref': {key: [n,C,npix]}, 'pair': {...}, 'frameid' [n,2],
        'lineid' [n], 'pix_ids' [2n,npix]} for collation."""
        dense = self._dense
        max_id = self.num_frames - 1
        idt = np.asarray(rng.integers(0, max_id, size=n), np.int32)
        idy = np.asarray(rng.integers(0, self.img_size, size=n), np.int32)
        df = np.asarray([rng.choice(self._cands[t]) for t in idt], np.int32)
        W = dense[df[0]]["imgs"].shape[-1]
        ids = rng.integers(0, W, size=(2 * n, npix)).astype(np.int32)
        ref: Dict[str, np.ndarray] = {}
        pair: Dict[str, np.ndarray] = {}
        for k in self.ROW_KEYS:
            C = dense[df[0]][k].shape[-2]
            ref[k] = np.empty((n, C, npix), np.float32)
            pair[k] = np.empty((n, C, npix), np.float32)
        ref["rtk"] = np.empty((n, 4, 4), np.float32)
        pair["rtk"] = np.empty((n, 4, 4), np.float32)
        ref["kaug"] = np.empty((n, 4), np.float32)
        pair["kaug"] = np.empty((n, 4), np.float32)
        for d in np.unique(df):
            m = df == d
            slots = dense[d]["slot"][idt[m]]
            rows_y = idy[m]
            col_r = ids[:n][m]          # [k, npix]
            col_p = ids[n:][m]
            for k in self.ROW_KEYS:
                a = dense[d][k][slots, rows_y]      # [k, 2, C, W]
                ref[k][m] = np.take_along_axis(a[:, 0], col_r[:, None, :], 2)
                pair[k][m] = np.take_along_axis(a[:, 1], col_p[:, None, :], 2)
            kaug = dense[d]["kaug"][slots]          # [k, 2, 4]
            ref["kaug"][m], pair["kaug"][m] = kaug[:, 0], kaug[:, 1]
            i0, i1 = idt[m], idt[m] + d
            ok = self._rtk_ok[i0] & self._rtk_ok[i1]
            rtkm = dense[d]["rtkmeta"][slots]       # [k, 2, 4, 4]
            ref["rtk"][m] = np.where(ok[:, None, None], self._rtk_all[i0],
                                     rtkm[:, 0])
            pair["rtk"][m] = np.where(ok[:, None, None], self._rtk_all[i1],
                                      rtkm[:, 1])
        return {"ref": ref, "pair": pair,
                "frameid": np.stack([idt, idt + df], 1),
                "lineid": idy, "pix_ids": ids}

    def sample_pair(self, rng: np.random.Generator, idx: Optional[int] = None,
                    idy: Optional[int] = None) -> Dict[str, np.ndarray]:
        max_id = self.num_frames - 1
        idt = int(rng.integers(0, max_id)) if idx is None else idx
        idy = int(rng.integers(0, self.img_size)) if idy is None else idy
        cands = [1] + [d for d in DFRAME_CANDIDATES
                       if idt % d == 0 and idt + d <= max_id]
        # only dframes whose shards exist on disk (partial exports)
        cands = [d for d in cands
                 if os.path.isdir(os.path.join(self.pixels_dir, f"{d}_{idt:05d}"))] or [1]
        dframe = int(rng.choice(cands))
        shard = os.path.join(self.pixels_dir, f"{dframe}_{idt:05d}")
        row = self._load_row(shard, idy)
        meta = self._load_meta(shard)
        kaug = np.asarray(meta["kaug"]).reshape(2, 4)

        rtk0 = self._load_rtk(idt)
        rtk1 = self._load_rtk(idt + dframe)
        if rtk0 is None or rtk1 is None:
            rtk = np.asarray(meta.get("rtk", np.tile(np.eye(4)[None], (1, 2, 1, 1))))
            rtk = rtk.reshape(2, 4, 4)
        else:
            rtk = np.stack([rtk0, rtk1])

        def pack(j):
            d = {
                "imgs": np.asarray(row["img"]).reshape(2, 3, -1)[j],
                "masks": np.asarray(row["mask"]).reshape(2, 1, -1)[j],
                "vis2d": np.asarray(row["vis2d"]).reshape(2, 1, -1)[j],
                "flow": np.asarray(row["flow"]).reshape(2, 2, -1)[j],
                "occ": np.asarray(row["occ"]).reshape(2, 1, -1)[j],
                "dp_feats": np.asarray(row["dp_feat_rsmp"]).reshape(2, 16, -1)[j],
                "rtk": rtk[j].astype(np.float32),
                "kaug": kaug[j].astype(np.float32),
            }
            d["masks"] = ((d["masks"] * d["vis2d"]) > 0).astype(np.float32)
            return d

        return {
            "frames": (pack(0), pack(1)),
            "frameid": np.asarray([idt, idt + dframe], np.int32),
            "dataid": np.asarray([self.dataid, self.dataid], np.int32),
            "lineid": np.asarray([idy, idy], np.int32),
        }


def build_line_datasets(seqname: str, img_size: int, config_dir: str = "configs",
                        rtk_base: Optional[str] = None) -> List[LineShardDataset]:
    """Line-shard datasets from configs/<seq>.config + Pixels/ shards."""
    seqs = load_seq_config(seqname, config_dir)
    out = []
    for i, s in enumerate(seqs):
        imgs = s.image_list()
        seqdir = os.path.basename(os.path.dirname(imgs[0]))
        pixels_dir = imgs[0].replace("JPEGImages", "Pixels").rsplit("/", 1)[0]
        rtk_path = rtk_base + "/" + seqdir if rtk_base else s.rtk_path
        if rtk_path:
            rtklist = ["%s-%05d.txt" % (rtk_path, k) for k in range(len(imgs))]
        else:
            # default Cameras/ layout (FramePaths.from_imglist convention)
            rtklist = [p.replace("JPEGImages", "Cameras").rsplit(".", 1)[0] + ".txt"
                       for p in imgs]
        out.append(LineShardDataset(pixels_dir, imgs, img_size, dataid=i,
                                    rtklist=rtklist))
    return out
