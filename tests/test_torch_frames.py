"""The port's frame-decoding route against cv2 and moda_tpu: the JPEG and PNG
decoders and cv2-semantic resize/remap of moda_tpu_torch/data/imageio.py
(native/imgcodec.cpp), data/frames.py's FrameReader, VideoDataset and the
per-pair PairLoader, the synthetic DAVIS-layout writer, and train_app and
extract_app on a dataset without line shards.

Tolerances: JPEG within 1 level of cv2.imread (libjpeg-turbo); PNG and
INTER_NEAREST exact; INTER_LINEAR within 1e-5 absolute; read_raw's mask, dp
and vis2d exact and its other outputs within 1e-5; batches equal within
1e-5.

tests/goldens/torch_jpeg_fixture.npz was made with cv2 as follows:

    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([128 + 100 * np.sin(x / 6 + c) * np.cos(y / 5 - c) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    np.savez_compressed(path, jpeg=enc.reshape(-1),
                        rgb=cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1],
                        grey=cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE))
"""
import json
import os
import pathlib
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.data import dataset as JD
from moda_tpu_torch.data import dataset as TD
from moda_tpu_torch.data import frames as TF
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.data import synthetic as TS
from moda_tpu_torch.data.synth_mesh import MeshScene

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: the tests run in several processes at
    once, and torch's thread pools on every core slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo(rng, h, w):
    """A smooth colour image with noise (the coefficients a photo has)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + c) * np.cos(y / 5 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("sampling", ["444", "420", "422"])
@pytest.mark.parametrize("hw,rst", [((48, 64), 0), ((37, 53), 3), ((17, 9), 1), ((3, 5), 0)])
def test_jpeg_decoding_matches_cv2(sampling, hw, rst):
    """Baseline JPEGs written by cv2 at quality 90, odd sizes, with and
    without a restart interval: within 1 level of cv2.imread, in colour
    and in grey (the Y plane)."""
    img = _photo(np.random.default_rng(hash(hw) % 1000), *hw)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    assert ok
    got = IO.decode_jpeg(enc.tobytes())
    want = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    grey = IO.decode_jpeg(enc.tobytes(), gray=True)
    assert np.abs(grey.astype(int) - cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)).max() <= 1


def test_grey_jpeg_and_refusals(tmp_path):
    """A one-component JPEG reads as grey or as three equal channels; a
    progressive file raises ValueError naming its SOF marker, and so does a
    header past OpenCV's 2^30-pixel limit; imread tells
    the format by the first bytes, not the extension, and gives None for a
    missing, empty or non-image file, as cv2.imread does."""
    rng = np.random.default_rng(3)
    g = _photo(rng, 29, 41)[..., 0]
    ok, enc = cv2.imencode(".jpg", g, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert np.abs(IO.decode_jpeg(enc.tobytes(), gray=True).astype(int)
                  - cv2.imdecode(enc, 0)).max() <= 1
    assert np.abs(IO.decode_jpeg(enc.tobytes()).astype(int)
                  - cv2.imdecode(enc, 1)[..., ::-1]).max() <= 1
    ok, prog = cv2.imencode(".jpg", _photo(rng, 16, 16), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="SOF2"):
        IO.decode_jpeg(prog.tobytes())
    # a header claiming 65535 x 65535 pixels: refused before anything is allocated
    huge = bytearray(enc.tobytes())
    sof = huge.index(b"\xff\xc0")
    huge[sof + 5:sof + 9] = b"\xff\xff\xff\xff"
    with pytest.raises(ValueError, match="too large"):
        IO.decode_jpeg(bytes(huge))
    (tmp_path / "png.jpg").write_bytes(cv2.imencode(".png", g)[1].tobytes())
    np.testing.assert_array_equal(IO.imread(str(tmp_path / "png.jpg"), gray=True), g)
    (tmp_path / "empty.png").write_bytes(b"")
    (tmp_path / "junk.jpg").write_bytes(b"\x00")
    for name in ("missing.png", "empty.png", "junk.jpg"):
        assert IO.imread(str(tmp_path / name)) is None
        assert cv2.imread(str(tmp_path / name)) is None


def test_jpeg_fixture_matches_stored_cv2_pixels():
    """The committed 64 x 48 4:2:0 fixture with a restart interval decodes
    to cv2's stored pixels within 1 level (chip_smoke.py decodes it on the
    card's machine too)."""
    z = np.load(GOLDENS / "torch_jpeg_fixture.npz")
    data = z["jpeg"].tobytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0
    assert np.abs(IO.decode_jpeg(data).astype(int) - z["rgb"]).max() <= 1
    assert np.abs(IO.decode_jpeg(data, gray=True).astype(int) - z["grey"]).max() <= 1


# ------------------------------------------------------------------- PNG
def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(row, prev, bpp, ft):
    """The PNG encoder's filter of one row (the spec's predictors)."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    out = np.zeros_like(r)
    for x in range(len(r)):
        a = r[x - bpp] if x >= bpp else 0
        b = p[x]
        c = p[x - bpp] if x >= bpp else 0
        if ft == 4:
            q = a + b - c
            pa, pb, pc = abs(q - a), abs(q - b), abs(q - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (0, a, b, (a + b) // 2)[ft]
        out[x] = (r[x] - pred) % 256
    return bytes([ft]) + out.astype(np.uint8).tobytes()


def _png(rows, width, height, depth, ctype, bpp, filters, palette=None):
    raw, prev = b"", np.zeros_like(rows[0])
    for y in range(height):
        raw += _filter_row(rows[y], prev, bpp, filters[y % len(filters)])
        prev = rows[y]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                                            ctype, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "rgb", "rgba", "palette"])
def test_png_decoding_is_exact(filters, kind):
    """Hand-built PNGs with each of the five filter types (and all five
    mixed) decode exactly to cv2.imread's pixels, in colour and in grey
    (libpng's rgb_to_gray for colour files)."""
    rng = np.random.default_rng(len(kind) * 10 + len(filters))
    h, w = 11, 13
    chans = {"grey": 1, "grey_alpha": 2, "rgb": 3, "rgba": 4, "palette": 1}[kind]
    ctype = {"grey": 0, "grey_alpha": 4, "rgb": 2, "rgba": 6, "palette": 3}[kind]
    palette = rng.integers(0, 256, (9, 3)) if kind == "palette" else None
    hi = 9 if kind == "palette" else 256
    rows = rng.integers(0, hi, (h, w * chans)).astype(np.uint8)
    data = _png(rows, w, h, 8, ctype, chans, filters, palette)
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(IO.decode_png(data), cv2.imdecode(buf, 1)[..., ::-1])
    np.testing.assert_array_equal(IO.decode_png(data, gray=True), cv2.imdecode(buf, 0))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_low_bit_palette_is_exact(depth):
    rng = np.random.default_rng(depth)
    h, w = 7, 13
    idx = rng.integers(0, 2 ** depth, (h, w))
    bits = np.unpackbits(idx.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:].reshape(h, -1)
    rows = np.packbits(np.pad(bits, ((0, 0), (0, (-bits.shape[1]) % 8))), axis=1)
    data = _png(rows, w, h, depth, 3, 1, (0, 1, 2, 3, 4), rng.integers(0, 256, (2 ** depth, 3)))
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(IO.decode_png(data), cv2.imdecode(buf, 1)[..., ::-1])
    np.testing.assert_array_equal(IO.decode_png(data, gray=True), cv2.imdecode(buf, 0))


# ---------------------------------------------------------- resampling
@pytest.mark.parametrize("cn", [1, 2, 3, 16])
def test_resize_matches_cv2(cn):
    """cv2.resize on random float32, growing and shrinking (no antialias):
    INTER_NEAREST exact, INTER_LINEAR within 1e-5."""
    rng = np.random.default_rng(cn)
    img = rng.random((23, 31, cn) if cn > 1 else (23, 31)).astype(np.float32)
    for dw, dh in ((64, 48), (11, 7), (31, 23), (15, 11), (112, 112), (5, 40), (8, 6)):
        np.testing.assert_array_equal(IO.resize(img, (dw, dh), IO.INTER_NEAREST),
                                      cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST))
        np.testing.assert_allclose(IO.resize(img, (dw, dh), IO.INTER_LINEAR),
                                   cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("cn", [1, 2, 3, 16])
def test_remap_matches_cv2(cn):
    """cv2.remap with float maps that go past every border (BORDER_CONSTANT
    0), and half-pixel coordinates that test cvRound's ties: INTER_NEAREST
    exact, INTER_LINEAR within 1e-5 (2 and 16 channels take cv2's 1/32-pixel
    tables, 1 and 3 its exact weights)."""
    rng = np.random.default_rng(10 + cn)
    H, W = 23, 31
    img = rng.random((H, W, cn) if cn > 1 else (H, W)).astype(np.float32)
    mx = (rng.random((19, 17)) * (W + 6) - 3).astype(np.float32)
    my = (rng.random((19, 17)) * (H + 6) - 3).astype(np.float32)
    mx[0, :6] = [0.5, 1.5, -0.5, W - 0.5, 2.0, -1.5]
    my[0, :6] = [2.5, 0.0, 1.0, 3.0, H - 0.5, 4.0]
    np.testing.assert_array_equal(IO.remap(img, mx, my, IO.INTER_NEAREST),
                                  cv2.remap(img, mx, my, cv2.INTER_NEAREST))
    np.testing.assert_allclose(IO.remap(img, mx, my, IO.INTER_LINEAR),
                               cv2.remap(img, mx, my, cv2.INTER_LINEAR), rtol=0, atol=1e-5)


# ------------------------------------------------------- the frame route
def _frame_dataset(root, num_frames=5, img_size=48):
    """A MeshScene in the DAVIS layout, with real JPEG frames (cv2 at
    quality 90), one mask whose object touches the image border so the
    crop goes past it, one with occluder pixels (values 1 and 255: the
    reference scales by levels[1] before its == 255 test), and a frame
    without its camera file (the default camera)."""
    cfg_dir = str(root / "cfg")
    TS.write_frame_dataset(str(root / "db"), cfg_dir, "flap",
                           MeshScene(img_size=img_size, num_frames=num_frames))
    img_dir = root / "db" / "JPEGImages" / "Full-Resolution" / "flap"
    ann_dir = root / "db" / "Annotations" / "Full-Resolution" / "flap"
    for i in range(num_frames):
        p = str(img_dir / ("%05d.jpg" % i))
        rgb = IO.imread(p)
        cv2.imwrite(p, rgb[..., ::-1].copy(), [cv2.IMWRITE_JPEG_QUALITY, 90])
    edge = np.zeros((img_size, img_size), np.uint8)
    edge[3:img_size // 2, 0:img_size // 3] = 128
    cv2.imwrite(str(ann_dir / "00001.png"), edge)
    occ = (cv2.imread(str(ann_dir / "00002.png"), 0) > 0).astype(np.uint8)
    occ[img_size // 2:img_size // 2 + 4] *= 255
    cv2.imwrite(str(ann_dir / "00002.png"), occ)
    os.remove(root / "db" / "Cameras" / "Full-Resolution" / "flap" / "00003.txt")
    return cfg_dir


@pytest.fixture(scope="module")
def frame_db(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    return root, _frame_dataset(root)


def _readers(cfg_dir, img_size=32):
    j = JD.build_datasets("flap", img_size, cfg_dir)[0]
    t = TD.build_datasets("flap", img_size, cfg_dir)[0]
    return j, t


EXACT = ("mask", "dp", "vis2d")


def test_read_raw_and_flow_process_match_jax(frame_db):
    """FrameReader.read_raw of every frame in both directions and dframes
    1 and 2, and flow_process of their pairs, against moda_tpu's."""
    _, cfg_dir = frame_db
    j, t = _readers(cfg_dir)
    assert vars(j.reader.paths) == vars(t.reader.paths)
    for i, fw, df in ((0, True, 1), (1, True, 1), (2, False, 1), (2, True, 2), (3, False, 1),
                      (4, False, 2)):
        a = j.reader.read_raw(i, flowfw=fw, dframe=df)
        b = t.reader.read_raw(i, flowfw=fw, dframe=df)
        assert a.keys() == b.keys()
        for k in a:
            assert np.shape(a[k]) == np.shape(b[k]), k
            if k in EXACT:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
    # the crop of frame 1 reaches past the image's left edge
    assert t.reader.read_raw(1, True, 1)["kaug"][2] < 0
    np.testing.assert_array_equal(t.reader.read_raw(3, True, 1)["rtk"][:3, 3], [0, 0, 10])
    for i0, i1 in ((0, 1), (1, 2), (2, 4)):
        pj = j.reader.flow_process(j.reader.read_raw(i0, True, i1 - i0),
                                   j.reader.read_raw(i1, False, i1 - i0))
        pt = t.reader.flow_process(t.reader.read_raw(i0, True, i1 - i0),
                                   t.reader.read_raw(i1, False, i1 - i0))
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        TF.FrameReader(TF.FramePaths.from_imglist(["/nonexistent/JPEGImages/x/00000.jpg"]),
                       16).read_raw(0, True, 1)


def test_sample_pair_and_pair_loader_match_jax(frame_db):
    """VideoDataset.sample_pair from the same seeds, and the PairLoader's
    per-pair batch (one worker thread, host pixel sampling) from the same
    seed, against moda_tpu's."""
    _, cfg_dir = frame_db
    j, t = _readers(cfg_dir, img_size=24)
    for seed in range(4):
        a = j.sample_pair(np.random.default_rng(seed))
        b = t.sample_pair(np.random.default_rng(seed))
        np.testing.assert_array_equal(a["frameid"], b["frameid"])
        for fa, fb in zip(a["frames"], b["frames"]):
            for k in fa:
                np.testing.assert_allclose(fb[k], fa[k], rtol=0, atol=1e-5, err_msg=k)
    jl = JD.PairLoader([j], 3, seed=5, num_threads=1, npix=20)
    tl = TD.PairLoader([t], 3, seed=5, num_threads=1, npix=20)
    try:
        assert not tl._dense
        for _ in range(2):
            a, b = next(jl), next(tl)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
    finally:
        jl.close()
        tl.close()


def test_write_lines_cuts_the_frame_pairs(frame_db, tmp_path):
    """write_lines stores the (i, i+1) pair of the frame reader at dframe 1:
    the line-shard dataset reads back the same rows."""
    root, cfg_dir = frame_db
    t = TD.build_datasets("flap", 16, cfg_dir)[0]
    TS.write_lines(str(tmp_path), "flap", 16, [t])
    pix = str(tmp_path / "Pixels" / "Full-Resolution" / "flap")
    line = TD.LineShardDataset(pix, t.reader.paths.imglist, 16)
    row = line.sample_pair(np.random.default_rng(0), idx=1, idy=7)
    d0, d1 = t.reader.read_raw(1, True, 1), t.reader.read_raw(2, False, 1)
    flow, flown, occ, occn = t.reader.flow_process(d0, d1)
    np.testing.assert_allclose(row["frames"][0]["imgs"], d0["img"][7].T, atol=1e-7)
    np.testing.assert_allclose(row["frames"][1]["flow"], flown[7].T, atol=1e-7)
    np.testing.assert_allclose(row["frames"][0]["occ"][0], occ[7], atol=1e-7)
    np.testing.assert_allclose(row["frames"][1]["dp_feats"], d1["dp_feat_rsmp"][:, 7], atol=1e-7)
    np.testing.assert_array_equal(row["frameid"], [1, 2])


def test_pair_loader_raises_on_an_unreadable_frame(frame_db, tmp_path):
    """The per-pair route raises where a frame cannot be read; the JAX
    loader falls back to pair 0 (dataset.py:251-255)."""
    _, cfg_dir = frame_db
    t = TD.build_datasets("flap", 16, cfg_dir)[0]
    t.reader.paths.imglist = [str(tmp_path / "missing.jpg")] * t.num_frames
    loader = TD.PairLoader([t], 2, seed=0, num_threads=1, npix=8)
    try:
        with pytest.raises(RuntimeError, match="worker failed") as e:
            next(loader)
        assert isinstance(e.value.__cause__, FileNotFoundError)
    finally:
        loader.close()


# ------------------------------------------------ entry points on frames
def _flags(cfg_dir, log):
    return ["--seqname", "flap", "--config_dir", cfg_dir, "--logname", "f",
            "--checkpoint_dir", log, "--ndepth", "8", "--img_size", "16", "--num_bones", "3",
            "--feat_ndepth_grid", "4", "--sample_grid3d", "12", "--render_size", "8",
            "--chunk", "64", "--n_data_workers", "1"]


def test_train_app_trains_on_the_frame_route(frame_db, tmp_path, monkeypatch):
    """train_app without --lineload decodes the frames (PairLoader's per-pair
    route): one epoch of two steps with finite losses, cameras from the
    Cameras/ files (the missing one leaves the list short, so none are
    installed: the frame reader's default camera is not a file), and the
    eval grid with its observed-image and feature-error columns."""
    from moda_tpu_torch.cli import train_app
    from moda_tpu_torch.train import trainer as TT
    from moda_tpu_torch.viz.render_vis import png_size

    _, cfg_dir = frame_db
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 2)
    tr = train_app.main(_flags(cfg_dir, str(tmp_path)) + [
        "--num_epochs", "1", "--batch_size", "2", "--nsample", "4", "--warmup_shape_ep", "0",
        "--use_rtk_file"], device="cpu")
    assert not tr.loader._dense and isinstance(tr.loader.datasets[0], TD.VideoDataset)
    rows = [json.loads(line) for line in open(tr.log_path)]
    steps = [r for r in rows if "total_loss" in r]
    assert steps and all(np.isfinite(r["total_loss"]) for r in steps)
    assert not [r for r in rows if "eval_render_error" in r or "eval_frames_unreadable" in r]
    assert png_size(os.path.join(tr.save_dir, "eval-000.png")) == (3 * 8, 3 * 8 * 5)


def test_extract_app_reads_a_dataset_without_line_shards(frame_db, tmp_path):
    """extract_app on a frame dataset (no Pixels/): frame counts from the
    frame datasets, every requested frame exported, and the refsil size
    from the first mask, decoded as cv2 decodes it."""
    from moda_tpu_torch.cli import extract_app
    from moda_tpu_torch.cli.flags import parse_config
    from moda_tpu_torch.config import DataInfo, load_seq_config
    from moda_tpu_torch.extract.mesh import make_grid_query
    from moda_tpu_torch.train.trainer import Trainer
    from moda_tpu_torch.viz.render_vis import png_size

    root, cfg_dir = frame_db
    flags = _flags(cfg_dir, str(tmp_path))
    seq = load_seq_config("flap", cfg_dir)[0]
    tr = Trainer(parse_config(flags), DataInfo(offset=(0, 5), intrinsics=(tuple(seq.ks),)),
                 device="cpu")
    tr.save("latest")
    # the untrained model's surface: the grid's median as the threshold
    b = tr.latest_vars["obj_bound"]
    axes = [np.linspace(-b[i], b[i], 12, dtype=np.float32) for i in range(3)]
    grid = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3))
    thr = float(np.median(make_grid_query(tr.model)(grid)[0].numpy()))
    ex = extract_app.main(flags + ["--model_path", os.path.join(tr.save_dir, "latest"),
                                   "--test_frames", "{0}", "--mc_threshold", str(thr),
                                   "--full_mesh"], device="cpu")
    assert ex.data_info.offset == (0, 5)
    files = os.listdir(str(tmp_path / "f-export"))
    for kind in ("mesh", "cam", "ctrajs", "refsil"):
        assert len([f for f in files if f.startswith(f"flap-{kind}-0")]) == 4, kind
    mask = cv2.imread(str(root / "db" / "Annotations" / "Full-Resolution" / "flap" /
                          "00000.png"), 0)
    assert png_size(str(tmp_path / "f-export" / "flap-refsil-00000.png")) == mask.shape


def test_remap_planes_is_cv2_on_each_plane():
    """remap_planes gives each [H, W] plane what cv2.remap gives it alone
    (exact weights, one channel), not cv2's 16-channel result."""
    rng = np.random.default_rng(7)
    planes = rng.random((16, 23, 31)).astype(np.float32)
    mx = (rng.random((19, 17)) * 37 - 3).astype(np.float32)
    my = (rng.random((19, 17)) * 29 - 3).astype(np.float32)
    for interp in (IO.INTER_NEAREST, IO.INTER_LINEAR):
        want = np.stack([cv2.remap(p, mx, my, interp) for p in planes])
        np.testing.assert_allclose(IO.remap_planes(planes, mx, my, interp), want, rtol=0,
                                   atol=1e-5 if interp else 0)
