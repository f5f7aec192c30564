"""The port's H.264 decoder (moda_tpu_torch/preproc/h264.py, native/h264.cpp,
the plain versions of csrc/h264.cu's kernels) against cv2.VideoCapture, on
the CPU.

Every stream here comes from the syntax writer of tests/torch_h264.py: one
seeded random stream for each tool (small sizes up to 176 x 144, cropped ones
among them), a natural clip from its small encoder, and the colour and crop
variants. A stream counts only if cv2 decodes it with no error or warning
line from avcodec; then every frame the port decodes is bit-equal to cv2's
(H.264 is exactly specified: no tolerance). The writer's counters show that
the streams together reach every CAVLC table entry, macroblock and
sub-macroblock type, and the port's records every boundary strength 0-4.
Refused tools raise ValueError naming them before extract_frames writes a
file.

The card runs the kernels against these plain versions
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 17).
"""
import collections
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
# streams beside the tool cases: (writer, arguments)
EXTRAS = {
    "natural": ("natural", dict(n=8, h=96, w=128, qp=26)),
    "bt709_matrix": ("random", dict(width=64, height=48, pictures=3, seq_args={"matrix": 1})),
    "bt601_matrix_6": ("random", dict(width=48, height=32, pictures=2, seq_args={"matrix": 6})),
    "crop_top_left_64": ("random", dict(width=64, height=34, pictures=3,
                                        seq_args={"sps_extra": {"crop_left": 64,
                                                                "crop_top": 6}})),
    "avc3_in_band_parameter_sets": ("random", dict(width=48, height=32, pictures=4)),
}


def _write(tmp, name):
    if name in H.CASES:
        seq, samples = H.random_stream(seed=SEED, **H.CASES[name])
    else:
        kind, args = EXTRAS[name]
        if kind == "natural":
            frames = V.scene(args["n"], args["h"], args["w"], seed=SEED)
            seq, samples = H.natural_stream(frames, qp=args["qp"])
        else:
            seq, samples = H.random_stream(seed=SEED, **args)
    path = os.path.join(tmp, f"{name}.mp4")
    H.write_mp4(path, seq, samples, avc3=name.startswith("avc3"))
    return path


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> (path, cv2's frames, avcodec's lines): every stream written,
    then read by cv2 in one subprocess. The writer's counters start here."""
    tmp = str(tmp_path_factory.mktemp("h264"))
    H.COVERAGE.clear()
    names = list(H.CASES) + list(EXTRAS)
    paths = [_write(tmp, n) for n in names]
    coverage = collections.Counter(H.COVERAGE)
    read = H.cv2_read(paths, tmp)
    return {n: (p, fr, logs) for n, p, (fr, logs) in zip(names, paths, read)}, coverage


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode(path):
    clip = TV.open_video(path)
    assert clip.kind == "h264"
    dec = D.H264Decoder(clip, "cpu")
    got = [f.numpy() for f in map(dec.decode, map(clip.sample, range(len(clip))))
           if f is not None]
    return got + [f.numpy() for f in dec.flush()]


@pytest.mark.parametrize("name", list(H.CASES) + list(EXTRAS))
def test_frames_bit_equal_to_videocapture(streams, name):
    """The tool's stream is valid (cv2 decodes it with no avcodec error or
    warning) and every frame the port decodes on the CPU equals cv2's."""
    path, want, logs = streams[0][name]
    assert logs == [], logs
    got = _decode(path)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), (name, i)


def test_the_streams_reach_every_table_entry_type_and_strength(streams):
    """The writer's counters over all streams reach every coeff_token entry
    (the four nC classes and chroma DC), every total_zeros and run_before
    entry, the level escapes, every I and P macroblock type and sub-type,
    every intra mode; the port's records every bS 0-4 (luma edges)."""
    coverage = streams[1]
    missing = H.coverage_expected() - set(coverage)
    assert not missing, sorted(missing, key=str)
    seen = collections.Counter()
    for path, _, _ in streams[0].values():
        clip = TV.open_video(path)
        parser = D.Parser(clip.config)
        for i in range(len(clip)):
            b = clip.h264(parser, i).mbs[:, D.F_BS:D.F_BS + 8].view(np.uint8)
            seen.update(np.unique(b).tolist())
    assert {0, 1, 2, 3, 4} <= set(seen), seen


def test_video_frame_decodes_from_the_last_idr(streams):
    """Video.frame(i) of a clip with an IDR every 12 pictures, at pictures
    past its second IDR (every sample up to i decoded): cv2's frame i,
    turned to RGB."""
    path, want, _ = streams[0]["cropped_176x144_frame_num_wrap"]
    clip = TV.open_video(path)
    for i in (13, 19):
        np.testing.assert_array_equal(clip.frame(i, device="cpu"), want[i][..., ::-1])


def test_extract_frames_stores_videocapture_frames(streams, tmp_path):
    """extract_frames (device "cpu") on the 30 fps natural clip at --fps 10:
    every third picture as an 8-bit RGB PNG of cv2's frame."""
    from moda_tpu_torch.data import imageio as IO

    path, want, _ = streams[0]["natural"]
    out = TP.extract_frames(path, str(tmp_path / "t"), fps=10, device="cpu")
    kept = V.kept_indices(len(want), 30.0, 10)
    assert [os.path.basename(p) for p in out] == ["%05d.jpg" % k for k in range(len(kept))]
    for p, i in zip(out, kept):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(IO.imread(p)[..., ::-1], want[i])


# ------------------------------------------------------------------ refusals
def _edited(k_at, **edit):
    """A stream whose picture ``k_at`` carries ``edit`` (slice options, or
    header fields under "hdr")."""
    def hook(k, hdr):
        if k != k_at:
            return {}
        hdr.update(edit.get("hdr", {}))
        return {key: v for key, v in edit.items() if key != "hdr"}
    return hook


# (case, random_stream arguments, what the message names); the 8x8
# transform and the scaling matrices left this list when they were decoded
# (their fixtures: tests/test_torch_h264_high.py), and so did B slices,
# weighted prediction and an output order other than the decoding order
# (LIFTED below; tests/test_torch_h264_bslices.py)
REFUSALS = [
    ("sp_slice", dict(edit=_edited(2, slice_type_code=3)), "sample 2: an SP slice"),
    ("si_slice", dict(edit=_edited(2, slice_type_code=4)), "sample 2: an SI slice"),
    ("interlace", dict(seq_args={"sps_extra": {"frame_mbs_only": 0}}), "interlace"),
    ("fmo", dict(seq_args={"pps_extra": {"num_slice_groups": 2}}), "FMO"),
    ("arbitrary_slice_order", dict(slices=2, reverse_slices=2), "sample 2: arbitrary slice order"),
    ("redundant_pictures", dict(seq_args={"pps_extra": {"redundant_pic_cnt_present": 1}}),
     "redundant pictures"),
    ("data_partitioning", dict(partition_nal=2), "sample 2: data partitioning"),
    ("weighted_bipred_idc_3", dict(seq_args={"pps_extra": {"weighted_bipred_idc": 3}}),
     "weighted_bipred_idc 3"),
    # explicit bi-prediction at logWD 7 with the default weights (128 + 128,
    # beyond 8.4.2.3's bound): cv2's x86 libavcodec takes them as 8-bit
    ("bi_weights_8bit", dict(bframes=1, weights=H.B_WEIGHTS,
                             seq_args={"pps_extra": {"weighted_bipred_idc": 1}},
                             edit=_edited(2, weights=(7, 7, [[], []]))),
     "sample 2: bi-prediction weights 128 and 128"),
    ("bit_depth_10", dict(seq_args={"sps_extra": {"profile": 110, "bit_depth_luma_minus8": 2}}),
     "bit depth 10"),
    ("chroma_422", dict(seq_args={"sps_extra": {"profile": 122, "chroma_format_idc": 2}}),
     "chroma_format_idc 2"),
    ("separate_colour_plane", dict(seq_args={"sps_extra": {"profile": 244,
                                                           "chroma_format_idc": 3,
                                                           "separate_colour_plane": 1}}),
     "separate_colour_plane"),
    ("gaps_in_frame_num", dict(seq_args={"sps_extra": {"gaps_in_frame_num_allowed": 1}}),
     "gaps in frame_num"),
    ("first_picture_not_idr", dict(first_idr=False), "sample 0: a first picture that is not "
                                                     "an IDR"),
    ("mmco_5", dict(max_refs=2, edit=_edited(2, mmco=[(5,)])),
     "sample 2: memory_management_control_operation 5"),
    ("full_range", dict(seq_args={"full_range": 1}), "video_full_range_flag 1"),
    ("matrix_fcc", dict(seq_args={"matrix": 4}), "matrix_coefficients 4"),
    ("left_crop_2", dict(width=46, seq_args={"sps_extra": {"crop_left": 2}}),
     "frame_crop_left_offset of 2"),
]


@pytest.mark.parametrize("case,args,match", REFUSALS, ids=[c for c, _, _ in REFUSALS])
def test_refused_tools_raise_before_anything_is_written(tmp_path, case, args, match):
    """Each refused tool raises ValueError naming it (and the sample, where
    it shows in one) from extract_frames before the output directory
    exists: the parameter sets and every slice header are read first."""
    kw = dict(width=48, height=32, pictures=4)
    kw.update(args)
    seq, samples = H.random_stream(seed=SEED, **kw)
    path = str(tmp_path / f"{case}.mp4")
    H.write_mp4(path, seq, samples)
    with pytest.raises(ValueError, match=match):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


# the refusals this decoder lifted, each now a stream of its tool (of the
# refusal cases' size and seed) held to cv2: B slices, weighted prediction
# in P slices, and POCs out of decoding order (B pictures after their
# anchor)
LIFTED = {
    "b_slice": dict(bframes=1, weights=H.B_WEIGHTS),
    "weighted_prediction": dict(seq_args={"pps_extra": {"weighted_pred": 1}}),
    "poc_order": dict(bframes=2, weights=H.B_WEIGHTS, max_refs=2),
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_refusals_decode_bit_equal_to_videocapture(tmp_path, case):
    """Each tool whose refusal was lifted decodes as cv2 does: the same
    frames, as many, in the same order, each bit-equal (no avcodec error or
    warning line)."""
    seq, samples = H.random_stream(seed=SEED, width=48, height=32, pictures=4, **LIFTED[case])
    path = str(tmp_path / f"{case}.mp4")
    H.write_mp4(path, seq, samples)
    (want, logs), = H.cv2_read([path], str(tmp_path))
    assert logs == [] and len(want) == 4
    got = _decode(path)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_h264_in_avi_is_refused_by_name(tmp_path):
    """An 'H264' AVI (cv2 would decode it) is refused as H.264 in AVI."""
    seq, samples = H.random_stream(48, 32, 2, seed=SEED)
    path = str(tmp_path / "clip.avi")
    # an AVI holds Annex B byte streams: start codes, parameter sets in-band
    annexb = [b"".join(b"\0\0\0\1" + n for n in ([seq.sps(), seq.pps()] if i == 0 else []) + s)
              for i, s in enumerate(samples)]
    V.write_avi(path, annexb, 32, 48, fourcc=b"H264")
    clip = TV.open_video(path)
    assert clip.kind == ""
    with pytest.raises(ValueError, match="H.264 in AVI"):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


def test_an_avc1_entry_without_avcc_raises(tmp_path):
    """An 'avc1' sample entry without its avcC box is refused by name."""
    path = str(tmp_path / "clip.mp4")
    V.write_isobmff(path, [b"\0\0\0\1\x65"] * 2, 32, 48, fourcc=b"avc1")
    with pytest.raises(ValueError, match="stsd/avc1: no 'avcC' box"):
        TV.open_video(path)


def test_the_parser_writes_no_record_past_its_buffers(streams):
    """Given buffers a macroblock or a row short, the parse refuses instead
    of writing past them."""
    import ctypes

    path = streams[0]["intra_types"][0]
    clip = TV.open_video(path)
    p = D.Parser(clip.config)
    data = clip.sample(0)
    g = p._peek_geometry(data)
    nmb = g.mb_w * g.mb_h
    i32p = ctypes.POINTER(ctypes.c_int32)
    pic = np.zeros(8, np.int32)
    for mb_cap, rows in ((nmb, 2), (nmb - 1, nmb)):
        mbs = np.zeros((nmb + 1, D.FIELDS), np.int32)
        levels = np.zeros((nmb + 1, D.LEVELS), np.int16)
        guard_m, guard_l = mbs[mb_cap:].copy(), levels[rows:].copy()
        err = ctypes.create_string_buffer(256)
        q = D.Parser(clip.config)
        rc = q._lib.h264_parse(q._h, data, len(data), 0, pic.ctypes.data_as(i32p),
                               mbs.ctypes.data_as(i32p), mb_cap,
                               levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), rows, err,
                               len(err))
        assert rc == -1 and b"buffer" in err.value
        assert np.array_equal(mbs[mb_cap:], guard_m) and np.array_equal(levels[rows:], guard_l)
