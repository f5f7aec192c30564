"""The port's H.264 decoder on CABAC streams (native/h264.cpp's CABAC engine
and binarisations, the plain versions of csrc/h264.cu's kernels) against
cv2.VideoCapture, on the CPU.

Every stream comes from the syntax writer of tests/torch_h264.py with
``entropy="cabac"``: each tool mix of ``CASES`` (P_8x8ref0, which has no
CABAC binarisation, written as P_8x8 with every ref_idx 0), a natural clip
from its small encoder, I_PCM at each slice's first and last macroblock and
mid-row, mb_qp_delta at its ends, and a reference-rich mix. A stream counts
only if cv2 decodes it with no avcodec error or warning line; then every
frame the port decodes is bit-equal to cv2's. The writer's counters show
that the streams reach every context index of I/P frame coding without the
8x8 transform under each of its tables with both bin values, and every leaf
of every binarisation. One seed written with either coder gives identical
macroblock records and levels, which holds the semantics both coders share
to themselves. The decoder's tables are found byte for byte in cv2's
libavcodec. Refused tools raise ValueError naming them before
extract_frames writes a file.
"""
import collections
import glob
import os

import numpy as np
import pytest
import torch

from moda_tpu_torch.preproc import h264 as D
from moda_tpu_torch.preproc import pipeline as TP
from moda_tpu_torch.preproc import video as TV
from tests import torch_h264 as H
from tests import torch_video as V

SEED = 5
# streams beside the tool cases: (writer, arguments); "references" has its
# own seed, which with the rest reaches every context under every table (the
# coverage test holds it to that)
EXTRAS = {
    "natural": ("natural", dict(n=8, h=96, w=128, qp=26)),
    "pcm_first_mid_row_last": ("random", dict(width=96, height=48, pictures=4, slices=3,
                                              pcm_places=True)),
    "qp_delta_ends": ("random", dict(width=64, height=48, pictures=4, qp_ends=0.3)),
    "references": ("random", dict(seed=1, width=64, height=48, pictures=16, max_refs=4,
                                  slices=3, weights={"I16": 4, "P16x8": 2, "P8x16": 2,
                                                     "P8x8": 2, "SKIP": 1})),
}
NAMES = list(H.CASES) + list(EXTRAS)


def _stream(name, entropy):
    """(Sequence, samples) of the case ``name`` under ``entropy``."""
    if name in H.CASES:
        return H.random_stream(seed=SEED, entropy=entropy, **H.CASES[name])
    kind, args = EXTRAS[name]
    if kind == "natural":
        frames = V.scene(args["n"], args["h"], args["w"], seed=SEED)
        return H.natural_stream(frames, qp=args["qp"], entropy=entropy)
    return H.random_stream(**{"seed": SEED, **args, "entropy": entropy})


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> (path, cv2's frames, avcodec's lines): every CABAC stream
    written, then read by cv2 in one subprocess; and the writer's counters
    over them."""
    tmp = str(tmp_path_factory.mktemp("h264_cabac"))
    H.COVERAGE.clear()
    paths = []
    for name in NAMES:
        seq, samples = _stream(name, "cabac")
        paths.append(os.path.join(tmp, f"{name}.mp4"))
        H.write_mp4(paths[-1], seq, samples)
    coverage = collections.Counter(H.COVERAGE)
    read = H.cv2_read(paths, tmp)
    return {n: (p, fr, logs) for n, p, (fr, logs) in zip(NAMES, paths, read)}, coverage


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_frames_bit_equal_to_videocapture(streams, name):
    """The CABAC stream is valid (cv2 decodes it with no avcodec error or
    warning) and every frame the port decodes on the CPU equals cv2's."""
    path, want, logs = streams[0][name]
    assert logs == [], logs
    clip = TV.open_video(path)
    assert clip.kind == "h264"
    dec = D.H264Decoder(clip, "cpu")
    got = [f.numpy() for f in map(dec.decode, map(clip.sample, range(len(clip))))
           if f is not None] + [f.numpy() for f in dec.flush()]
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), (name, i)


def test_the_streams_reach_every_context_and_binarisation_leaf(streams):
    """The writer's counters over all CABAC streams reach every context
    index of I/P frame coding without the 8x8 transform (3-23, 40-69,
    73-275, and the terminate bin 276) under each table it has (I; P with
    cabac_init_idc 0, 1 and 2), each with both bin values; all 26 I
    mb_types in I slices and as P-slice suffixes, the four P mb_types and
    sub_mb_types, mvd and level prefixes saturating into their escapes (both
    components; every block category), mb_qp_delta -26 and +25, a ref_idx of
    2 or more, and I_PCM first in a slice, mid-row and last in a slice."""
    coverage = streams[1]
    missing = H.cabac_coverage_expected() - set(coverage)
    assert not missing, sorted(missing, key=str)


CODER_CASES = ["intra_types", "p_partitions", "refs_mmco_long_term", "slices_deblocking",
               "constrained_intra", "level_escapes", "natural"]


@pytest.mark.parametrize("name", CODER_CASES)
def test_both_coders_give_identical_records(name):
    """One seed written with CAVLC and with CABAC: the port's host parse
    gives the same pictures, macroblock records and level rows for every
    sample, with no oracle: the macroblock semantics both coders share agree
    with themselves."""
    parsed = {}
    for entropy in ("cavlc", "cabac"):
        seq, samples = _stream(name, entropy)
        parser = D.Parser(H.avcc(seq))
        parsed[entropy] = [parser.parse(H.sample_bytes(s)) for s in samples]
    for i, (a, b) in enumerate(zip(parsed["cavlc"], parsed["cabac"])):
        assert (a.slot, a.idr, a.poc, a.frame_num, a.ref, a.slices, a.types) == \
            (b.slot, b.idr, b.poc, b.frame_num, b.ref, b.slices, b.types), (name, i)
        assert np.array_equal(a.mbs, b.mbs), (name, i)
        assert np.array_equal(a.levels, b.levels), (name, i)
    assert len(parsed["cavlc"]) == len(parsed["cabac"]) > 0


def _libavcodec() -> bytes:
    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    path, = glob.glob(os.path.join(libs, "libavcodec-*.so*"))
    with open(path, "rb") as f:
        return f.read()


def test_the_cabac_tables_occur_in_cv2s_libavcodec():
    """The decoder's context initialisation tables (I, then P of
    cabac_init_idc 0-2: FFmpeg's int8 [1024][2] tables, whose first 460
    entries are these), rangeTabLPS and the state transitions occur byte for
    byte in the libavcodec cv2 decodes with. FFmpeg holds rangeTabLPS as
    four rows of 128 (qCodIRangeIdx; each pStateIdx twice, for valMPS 0 and
    1) and the transitions as one row of 256 indexed by the state
    2 pStateIdx + valMPS: the LPS's next state at 127 - state, the MPS's at
    128 + state."""
    lib = _libavcodec()
    t = D.cabac_tables()
    for k in range(4):
        assert lib.find(t["init"][k].tobytes()) >= 0, k
    lps = np.repeat(t["range_lps"].T, 2, axis=1)  # [4, 128]
    assert lib.find(lps.tobytes()) >= 0
    s = np.arange(128)
    p, mps = s >> 1, s & 1
    to_mps = 2 * t["trans_mps"][p] + mps
    to_lps = 2 * t["trans_lps"][p] + (mps ^ (p == 0))
    trans = np.concatenate([to_lps[::-1], to_mps]).astype(np.uint8)
    assert lib.find(trans.tobytes()) >= 0
    # and they are the standard's at their corners
    assert t["range_lps"][0].tolist() == [128, 176, 208, 240]
    assert t["range_lps"][63].tolist() == [2, 2, 2, 2]
    assert t["trans_mps"][62] == 62 and t["trans_lps"][63] == 63


# ------------------------------------------------------------------ refusals
def _edited(k_at, **edit):
    def hook(k, hdr):
        return edit if k == k_at else {}
    return hook


# (case, random_stream arguments, what the message names); the CABAC
# refusal of tests/test_torch_h264.py before CABAC was decoded became these,
# and the 8x8 transform left them when it was decoded
# (tests/test_torch_h264_high.py), B slices and weighted prediction when
# they were (LIFTED below; tests/test_torch_h264_bslices.py)
REFUSALS = [
    ("cabac_init_idc_3", dict(edit=_edited(2, cabac_init_idc=3)), "sample 2: cabac_init_idc 3"),
]
# the refusals this decoder lifted, each now a CABAC stream of its tool (of
# the refusal cases' size and seed) held to cv2
LIFTED = {
    "cabac_weighted_prediction": dict(seq_args={"pps_extra": {"weighted_pred": 1}}),
    "cabac_b_slice": dict(bframes=1, weights=H.B_WEIGHTS),
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_refusals_decode_bit_equal_to_videocapture(tmp_path, case):
    """Each tool whose refusal was lifted decodes as cv2 does on a CABAC
    stream: the same frames, as many, in the same order, each bit-equal."""
    seq, samples = H.random_stream(seed=SEED, width=48, height=32, pictures=4,
                                   entropy="cabac", **LIFTED[case])
    path = str(tmp_path / f"{case}.mp4")
    H.write_mp4(path, seq, samples)
    (want, logs), = H.cv2_read([path], str(tmp_path))
    assert logs == [] and len(want) == 4
    clip = TV.open_video(path)
    dec = D.H264Decoder(clip, "cpu")
    got = [f.numpy() for f in map(dec.decode, map(clip.sample, range(len(clip))))
           if f is not None] + [f.numpy() for f in dec.flush()]
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case,args,match", REFUSALS, ids=[c for c, _, _ in REFUSALS])
def test_refused_tools_raise_before_anything_is_written(tmp_path, case, args, match):
    """Each tool the port still refuses raises ValueError naming it (and the
    sample, where it shows in one) from extract_frames on a CABAC stream,
    before the output directory exists."""
    seq, samples = H.random_stream(seed=SEED, width=48, height=32, pictures=4,
                                   entropy="cabac", **args)
    path = str(tmp_path / f"{case}.mp4")
    H.write_mp4(path, seq, samples)
    with pytest.raises(ValueError, match=match):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


def test_a_cabac_slice_cut_short_raises(streams):
    """A CABAC slice NAL cut short raises ValueError ("cut short") instead
    of decoding past its end."""
    seq, samples = _stream("intra_types", "cabac")
    parser = D.Parser(H.avcc(seq))
    nals = list(samples[0])
    nals[-1] = nals[-1][:len(nals[-1]) // 2]
    with pytest.raises(ValueError, match="cut short"):
        parser.parse(H.sample_bytes(nals))
