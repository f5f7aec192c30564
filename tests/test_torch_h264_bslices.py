"""The port's H.264 decoder on B slices and weighted prediction
(native/h264.cpp's B macroblock layer, direct prediction, weight tables and
output order; preproc/h264.py's inter_plain) against cv2.VideoCapture, on
the CPU.

Every stream comes from the syntax writer of tests/torch_h264.py: each tool
mix of ``B_CASES`` written with CAVLC and with CABAC (every B macroblock and
sub-macroblock type, spatial and temporal direct prediction with and without
direct_8x8_inference_flag, B-refs, list 1's modifications, several slices,
weighted_bipred_idc 0, 1 and 2, explicit weights in P slices, the 8x8
transform, reorder with and without the VUI's bitstream_restriction), and a
natural clip in x264's default structure (IBBP with a B-ref, weighted P,
implicit bi-prediction, spatial direct). Each MP4 carries the ctts and edit
list FFmpeg's mov muxer writes, but for the one written without them, where
cv2's decoder starts from a reorder delay of 0 and FFmpeg drops a picture
("no picture ooo"). A stream counts only if cv2 decodes it with no avcodec
error or warning line; then every frame the port decodes equals cv2's
(tolerance 0: bit-equal), in cv2's number and order. The weighted sample
prediction is held step by step to a NumPy reading of 8.4.2.3 (tolerance
0), and extract_frames on the natural clip to the JAX package's frames
(JPEG_MEAN, JPEG_MAX: tests/test_torch_h264_app.py's gate).
"""
import collections
import os

import cv2
import numpy as np
import pytest
import torch

from moda_tpu.preproc import pipeline as JP
from moda_tpu_torch.data import imageio as IO
from moda_tpu_torch.preproc import h264 as D
from moda_tpu_torch.preproc import pipeline as TP
from moda_tpu_torch.preproc import video as TV
from tests import torch_h264 as H
from tests import torch_video as V

SEED = 5
NAMES = list(H.B_CASES)
# written without ctts and edit list: cv2's decoder starts from delay 0
NO_CTTS = ("b_reorder_without_restriction",)
JPEG_MEAN, JPEG_MAX = 2.0, 24


def _decode(path):
    """Every frame the port gives for a clip, in output order."""
    clip = TV.open_video(path)
    assert clip.kind == "h264"
    dec = D.H264Decoder(clip, "cpu")
    got = [f.numpy() for f in map(dec.decode, map(clip.sample, range(len(clip))))
           if f is not None]
    return got + [f.numpy() for f in dec.flush()]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """(name, entropy) -> (path, cv2's frames, avcodec's lines): every case
    in both coders and the natural clip, read by cv2 in one subprocess; and
    the writer's counters over them."""
    tmp = str(tmp_path_factory.mktemp("h264_b"))
    H.COVERAGE.clear()
    keys, paths = [], []
    for name in NAMES:
        for entropy in ("cavlc", "cabac"):
            seq, samples = H.random_stream(seed=SEED, entropy=entropy, **H.b_case(name))
            paths.append(os.path.join(tmp, f"{name}_{entropy}.mp4"))
            H.write_mp4(paths[-1], seq, samples, ctts=name not in NO_CTTS)
            keys.append((name, entropy))
    frames = [np.clip(f * (1 - 0.03 * k), 0, 255).astype(np.uint8)
              for k, f in enumerate(V.scene(9, 48, 64, seed=SEED))]
    seq, samples = H.natural_stream(frames, qp=26, refs=3, bframes=3, high=True)
    paths.append(os.path.join(tmp, "natural_ibbp.mp4"))
    H.write_mp4(paths[-1], seq, samples)
    keys.append(("natural_ibbp", "cavlc"))
    coverage = collections.Counter(H.COVERAGE)
    read = H.cv2_read(paths, tmp)
    return {k: (p, fr, logs) for k, p, (fr, logs) in zip(keys, paths, read)}, coverage


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("name", NAMES)
def test_frames_bit_equal_to_videocapture(streams, name, entropy):
    """The tool mix's stream is valid (cv2 decodes it with no avcodec error
    or warning) and the port gives cv2's frames on the CPU: as many, in the
    same order, each bit-equal."""
    path, want, logs = streams[0][(name, entropy)]
    assert logs == [], logs
    got = _decode(path)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), (name, entropy, i)


def test_ffmpegs_reorder_drops_where_the_delay_starts_at_0(streams):
    """Without bitstream_restriction and without a ctts, cv2's decoder
    starts from a reorder delay of 0: the first B picture below the last
    output POC is dropped (FFmpeg's "no picture ooo"), and the port drops
    the same one; with a ctts the container's delay keeps every picture."""
    for entropy in ("cavlc", "cabac"):
        path, want, _ = streams[0][(NO_CTTS[0], entropy)]
        clip = TV.open_video(path)
        assert clip.cts is None and clip.reorder_delay == 0
        assert len(want) == len(clip) - 1 == len(_decode(path))
        path, want, _ = streams[0][("b_pyramid_implicit", entropy)]
        clip = TV.open_video(path)
        assert clip.reorder_delay == 2 and len(want) == len(clip)


def test_the_natural_ibbp_clip_and_extract_frames(streams, tmp_path):
    """The natural clip in x264's default structure decodes bit-equal to
    cv2; extract_frames (device "cpu") at --fps 10 stores cv2's frames in
    output order as PNGs, and the JAX package's extract_frames stores the
    same names within the JPEG gates of them."""
    path, vc, logs = streams[0][("natural_ibbp", "cavlc")]
    assert logs == [] and len(vc) == 9
    got = _decode(path)
    assert len(got) == len(vc) and all(np.array_equal(a, b) for a, b in zip(got, vc))
    t = TP.extract_frames(path, str(tmp_path / "t"), fps=10, device="cpu")
    j = JP.extract_frames(path, str(tmp_path / "j"), fps=10)
    kept = V.kept_indices(len(vc), 30.0, 10)
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == \
        ["%05d.jpg" % k for k in range(len(kept))]
    errs = []
    for p, q, i in zip(t, j, kept):
        np.testing.assert_array_equal(IO.imread(p)[..., ::-1], vc[i])
        errs.append(np.abs(cv2.imread(q).astype(int) - vc[i].astype(int)))
    assert np.mean([e.mean() for e in errs]) <= JPEG_MEAN
    assert max(e.max() for e in errs) <= JPEG_MAX


def test_video_frame_is_the_ith_picture_in_output_order(streams):
    """Video.frame(i) of a B clip is cv2's i-th frame (RGB), the pictures
    after it in decoding order decoded as far as its output needs."""
    path, want, _ = streams[0][("b_temporal_direct", "cabac")]
    clip = TV.open_video(path)
    for i in (1, 2, len(want) - 1):
        np.testing.assert_array_equal(clip.frame(i, device="cpu"), want[i][..., ::-1])


def test_the_streams_reach_every_b_type_context_and_weight(streams):
    """The writer's counters over the B streams reach every B mb_type (23
    and B_Skip) and sub_mb_type (13) under each coder, CABAC's B contexts
    24-39 under each cabac_init_idc with both bin values and every B
    binarisation leaf, both direct modes under each coder, explicit weights
    with and without each flag in P and B slices, list 1's modification,
    the VUI's max_num_reorder_frames and the MP4's ctts and edit list."""
    missing = H.b_coverage_expected() - set(streams[1])
    assert not missing, sorted(missing, key=str)


@pytest.mark.parametrize("name", ["b_partitions", "b_temporal_direct", "b_explicit_weights"])
def test_both_coders_give_identical_records(name):
    """One seed written with CAVLC and with CABAC: the host parse gives the
    same pictures, records (both lists' vectors, slots and ref_idx),
    levels, weight tables and output slots, with no oracle."""
    parsed = {}
    for entropy in ("cavlc", "cabac"):
        seq, samples = H.random_stream(seed=SEED, entropy=entropy, **H.b_case(name))
        parser = D.Parser(H.avcc(seq))
        parsed[entropy] = [parser.parse(H.sample_bytes(s)) for s in samples]
    for i, (a, b) in enumerate(zip(parsed["cavlc"], parsed["cabac"])):
        assert (a.slot, a.poc, a.ref, a.types, a.out) == (b.slot, b.poc, b.ref, b.types, b.out)
        for f in ("mbs", "levels", "weights"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, i, f)


def _weighted_reference(p0, p1, u0, u1, r0, r1, comp, wt):
    """8.4.2.3 sample by sample in Python integers."""
    out = np.zeros_like(p0)
    for n in range(p0.shape[0]):
        t = wt[n]
        for m in range(p0.shape[1]):
            a, b, c = int(p0[n, m]), int(p1[n, m]), int(comp[m])
            lw = int(t[D.W_LOGWD + (c > 0)])
            ex = lambda lst, r, k: int(t[D.W_EXPLICIT + ((32 * lst + r) * 3 + c) * 2 + k])
            if u0[n, m] and u1[n, m]:
                if t[D.W_MODE] == 0:
                    v = (a + b + 1) >> 1
                elif t[D.W_MODE] == 1:
                    v = ((a * ex(0, r0[n, m], 0) + b * ex(1, r1[n, m], 0) + 2 ** lw) >> (lw + 1)) \
                        + ((ex(0, r0[n, m], 1) + ex(1, r1[n, m], 1) + 1) >> 1)
                else:
                    w0 = int(t[D.W_IMPLICIT + 32 * r0[n, m] + r1[n, m]])
                    v = (a * w0 + b * (64 - w0) + 32) >> 6
            else:
                lst = 0 if u0[n, m] else 1
                x, r = (a, r0[n, m]) if lst == 0 else (b, r1[n, m])
                v = x
                if t[D.W_MODE] == 1:
                    w, o = ex(lst, r, 0), ex(lst, r, 1)
                    v = ((x * w + 2 ** (lw - 1)) >> lw) + o if lw >= 1 else x * w + o
            out[n, m] = min(max(v, 0), 255)
    return out


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_weighted_prediction_matches_a_stepwise_reference(mode):
    """inter_plain's weighted sample prediction (preproc/h264.py::weighted)
    in the default (0), explicit (1) and implicit (2) modes against 8.4.2.3
    read sample by sample, on random predictions, list use, ref_idx, planes
    and tables (logWD 0-7, weights in -128..127, offsets in -128..127):
    bit-equal."""
    rng = np.random.default_rng(mode)
    n, m = 6, 384
    p0, p1 = (rng.integers(0, 256, (n, m)) for _ in range(2))
    use = rng.integers(1, 4, (n, m))  # 1 list 0, 2 list 1, 3 both
    u0, u1 = (use & 1) > 0, (use & 2) > 0
    r0, r1 = rng.integers(0, 4, (n, m)), rng.integers(0, 4, (n, m))
    comp = np.array(D.SAMPLE_COMP)
    wt = np.zeros((n, D.WT), np.int64)
    wt[:, D.W_MODE] = mode
    wt[:, D.W_LOGWD:D.W_LOGWD + 2] = rng.integers(0, 8, (n, 2)) if mode == 1 else 5
    wt[:, D.W_EXPLICIT:D.W_IMPLICIT:2] = rng.integers(-128, 128, (n, 192))
    wt[:, D.W_EXPLICIT + 1:D.W_IMPLICIT:2] = rng.integers(-128, 128, (n, 192))
    wt[:, D.W_IMPLICIT:] = rng.integers(-64, 128, (n, 1024))
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = D.weighted(t(p0).int(), t(p1).int(), t(u0), t(u1), t(r0).int(), t(r1).int(),
                     t(comp).int()[None], t(wt).int())
    np.testing.assert_array_equal(got.numpy(),
                                  _weighted_reference(p0, p1, u0, u1, r0, r1, comp, wt))


def test_mp4_ctts_and_ffmpegs_edit_list(streams, tmp_path):
    """The demuxer reads a ctts (each sample's composition offset) and takes
    the edit list FFmpeg's mov muxer writes for reordered samples (from the
    earliest composition time, at rate 1, over the media); an edit list
    from another media time still raises naming the box."""
    path, want, _ = streams[0][("b_partitions", "cavlc")]
    clip = TV.open_video(path)
    assert clip.cts is not None and len(clip.cts) == len(clip)
    assert int((clip.dts + clip.cts).min()) == int(clip.cts[0]) > 0
    seq, samples = H.random_stream(seed=SEED, **H.b_case("b_partitions"))
    shift = max(k - d for k, d in enumerate(seq.display))
    bad = str(tmp_path / "elst.mp4")
    V.write_isobmff(bad, [H.sample_bytes(s) for s in samples], seq.height, seq.width,
                    fourcc=b"avc1", brand=b"isom", avcc=H.avcc(seq), elst=((None, shift + 1, 1),),
                    ctts=[d + shift - k for k, d in enumerate(seq.display)])
    with pytest.raises(ValueError, match="elst: an edit list other than the identity"):
        TV.open_video(bad)
