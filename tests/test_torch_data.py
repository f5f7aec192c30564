"""The port's host data pieces against moda_tpu's: the sequence config
reader, the PFM codec, the synthetic scene, batch collation and the
line-shard loader (the same batches from the same seed, bit-equal, with
one worker thread)."""
import numpy as np
import pytest

from moda_tpu import config as JC
from moda_tpu.data import dataset as JD
from moda_tpu.data import pfm as JP
from moda_tpu.data import synthetic as JS
from moda_tpu_torch import config as TC
from moda_tpu_torch.data import dataset as TD
from moda_tpu_torch.data import pfm as TP
from moda_tpu_torch.data import synthetic as TS


def _dataset(root, seq="syn", img_size=12, num_frames=6):
    cfg_dir = str(root / "cfg")
    TS.write_line_dataset(str(root / "db"), cfg_dir, seq, TS.SynthScene(img_size=img_size,
                                                                         num_frames=num_frames))
    return cfg_dir


def test_seq_config_and_pfm_match_jax(tmp_path):
    cfg_dir = _dataset(tmp_path)
    j, t = JC.load_seq_config("syn", cfg_dir), TC.load_seq_config("syn", cfg_dir)
    assert [vars(s) for s in j] == [vars(s) for s in t]
    assert j[0].image_list() == t[0].image_list() and len(t[0].image_list()) == 6
    rng = np.random.default_rng(0)
    for shape in ((5, 7), (4, 6, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        TP.write_pfm(str(tmp_path / "t.pfm"), img)
        JP.write_pfm(str(tmp_path / "j.pfm"), img)
        assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        a, sa = TP.read_pfm(str(tmp_path / "j.pfm"))
        b, sb = JP.read_pfm(str(tmp_path / "t.pfm"))
        np.testing.assert_array_equal(a, img)
        np.testing.assert_array_equal(b, img)
        assert sa == sb == 1.0


def test_synthetic_scene_matches_jax():
    n = np.random.default_rng(1).normal(size=(20, 3))
    np.testing.assert_array_equal(TS.feat_bank_encode(n), JS.feat_bank_encode(n))
    bj = JS.SynthScene(img_size=10, num_frames=4).make_batch([(0, 1), (2, 3)])
    bt = TS.SynthScene(img_size=10, num_frames=4).make_batch([(0, 1), (2, 3)])
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_collate_and_sparsify_match_jax():
    rng = np.random.default_rng(2)
    pairs = []
    for i in range(3):
        fr = tuple({k: rng.normal(size=(c, 9)).astype(np.float32) for k, c in
                    (("imgs", 3), ("masks", 1), ("flow", 2), ("dp_feats", 16))} |
                   {"rtk": rng.normal(size=(4, 4)).astype(np.float32)} for _ in range(2))
        pairs.append({"frames": fr, "frameid": np.asarray([i, i + 1], np.int32),
                      "dataid": np.asarray([i % 2, i % 2], np.int32),
                      "lineid": np.asarray([i + 3, i + 3], np.int32)})
    for npix in (None, 5):
        kw = dict(npix=npix, rng=None if npix is None else np.random.default_rng(5))
        bj = JD.collate_pairs(pairs, (0, 4, 9), **kw)
        kw["rng"] = None if npix is None else np.random.default_rng(5)
        bt = TD.collate_pairs(pairs, (0, 4, 9), **kw)
        assert bj.keys() == bt.keys()
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    full = JD.collate_pairs(pairs, (0, 4, 9))
    sj = JD.sparsify_batch(full, 4, np.random.default_rng(9))
    st = TD.sparsify_batch(full, 4, np.random.default_rng(9))
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


@pytest.mark.parametrize("npix", [20, None], ids=["dense", "rows"])
def test_line_shard_batches_match_jax(tmp_path, npix):
    """Each package reads its own copy of the same shards (the dense path
    writes a cache next to them), one worker thread, a prefetch queue deep
    enough that the reference's worker never drops a batch."""
    loaders = []
    for mod, sub in ((JD, "j"), (TD, "t")):
        cfg_dir = _dataset(tmp_path / sub)
        ds = mod.build_line_datasets("syn", 12, cfg_dir)
        assert mod.data_offsets(ds) == (0, 6)
        loaders.append(mod.PairLoader(ds, 3, seed=4, num_threads=1, num_prefetch=8, npix=npix))
    try:
        for _ in range(5):
            bj, bt = next(loaders[0]), next(loaders[1])
            assert bj.keys() == bt.keys()
            for k in bj:
                assert bj[k].dtype == bt[k].dtype, k
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    finally:
        for lo in loaders:
            lo.close()
    assert loaders[1]._dense == (npix is not None)


def test_pair_loader_raises_on_data_faults(tmp_path):
    """The dense route refuses shards it cannot preload, and a row that
    fails to load on the per-row route reaches the caller of next()."""
    import os
    import shutil

    cfg_dir = _dataset(tmp_path)
    ds = TD.build_line_datasets("syn", 12, cfg_dir)
    pixels = ds[0].pixels_dir
    for name in os.listdir(pixels):
        shutil.rmtree(os.path.join(pixels, name))
    with pytest.raises(FileNotFoundError, match="no line shards"):
        TD.PairLoader(TD.build_line_datasets("syn", 12, cfg_dir), 2, num_threads=1, npix=4)
    loader = TD.PairLoader(TD.build_line_datasets("syn", 12, cfg_dir), 2, num_threads=1)
    try:
        with pytest.raises(RuntimeError, match="worker failed") as e:
            next(loader)
        assert isinstance(e.value.__cause__, OSError)
    finally:
        loader.close()
