"""The port's H.264 decoder on High-profile streams (native/h264.cpp's 8x8
transform, Intra 8x8 and scaling matrices, the plain versions of
csrc/h264.cu's kernels) against cv2.VideoCapture, on the CPU.

Every stream comes from the syntax writer of tests/torch_h264.py, in CAVLC
and in CABAC from the same draws: each High tool mix of ``HIGH_CASES``
(Intra 8x8 and the 8x8 transform weighted in, a Cr QP offset apart from
Cb's, constrained intra prediction, several slices a picture), each
scaling-list case of ``SCALING_CASES_HIGH`` (the default lists by flag,
explicit lists in the SPS or the PPS, a PPS falling back to the SPS's lists
and one taking them whole) and the natural clip at High profile; beside
them the four streams the port refused before it decoded these tools. A
stream counts only if cv2 decodes it with no avcodec error or warning line;
then every frame the port decodes is bit-equal to cv2's. The writer's
counters show that the streams reach contexts 399-435 under every table,
every Intra 8x8 mode at every block position and every scaling-list case.
One seed written with either coder gives identical records, level rows and
LevelScale tables. The dequantisation and the 8x8 transform are held
against a numpy transcription of 8.5.12-8.5.13 at the qP where their
rounding changes, and the decoder's High tables are found byte for byte in
cv2's libavcodec.
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
NAMES = list(H.HIGH_CASES) + list(H.SCALING_CASES_HIGH) + ["natural_high"]
# the streams tests/test_torch_h264.py and tests/test_torch_h264_cabac.py
# refused by name before these tools were decoded: (coder, random_stream
# arguments). The first two name a Baseline SPS with constraint_set flags,
# whose PPS extension FFmpeg (and so the port) does not read.
FORMER_REFUSALS = {
    "transform_8x8": ("cavlc", dict(seq_args={"pps_extra": {"transform_8x8_mode": 1}})),
    "pps_scaling_matrices": ("cavlc", dict(seq_args={"pps_extra":
                                                     {"pic_scaling_matrix_present": 1}})),
    "sps_scaling_matrices": ("cavlc", dict(seq_args={"sps_extra": {
        "profile": 100, "seq_scaling_matrix_present": 1}})),
    "cabac_transform_8x8": ("cabac", dict(seq_args={"pps_extra": {"transform_8x8_mode": 1}})),
}


def _stream(name, entropy):
    if name == "natural_high":
        return H.natural_stream(V.scene(6, 64, 96, seed=SEED), qp=26, entropy=entropy,
                                high=True)
    return H.random_stream(seed=SEED, entropy=entropy, **H.high_case(name, SEED))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """(name, coder) -> (path, cv2's frames, avcodec's lines): every High
    stream written in both coders and the former refusals, then read by cv2
    in one subprocess; and the writer's counters over them."""
    tmp = str(tmp_path_factory.mktemp("h264_high"))
    H.COVERAGE.clear()
    keys, paths = [], []
    for entropy in ("cavlc", "cabac"):
        for name in NAMES:
            seq, samples = _stream(name, entropy)
            keys.append((name, entropy))
            paths.append(os.path.join(tmp, f"{name}_{entropy}.mp4"))
            H.write_mp4(paths[-1], seq, samples)
    for name, (entropy, args) in FORMER_REFUSALS.items():
        seq, samples = H.random_stream(seed=SEED, width=48, height=32, pictures=4,
                                       entropy=entropy, **args)
        keys.append((name, entropy))
        paths.append(os.path.join(tmp, f"{name}.mp4"))
        H.write_mp4(paths[-1], seq, samples)
    coverage = collections.Counter(H.COVERAGE)
    read = H.cv2_read(paths, tmp)
    return {k: (p, fr, logs) for k, p, (fr, logs) in zip(keys, paths, read)}, coverage


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_bit_equal(entry, key):
    path, want, logs = entry
    assert logs == [], logs
    clip = TV.open_video(path)
    assert clip.kind == "h264"
    dec = D.H264Decoder(clip, "cpu")
    got = [f.numpy() for f in map(dec.decode, map(clip.sample, range(len(clip))))
           if f is not None]
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), (key, i)


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("name", NAMES)
def test_frames_bit_equal_to_videocapture(streams, name, entropy):
    """The High stream is valid (cv2 decodes it with no avcodec error or
    warning) and every frame the port decodes on the CPU equals cv2's."""
    _check_bit_equal(streams[0][(name, entropy)], (name, entropy))


@pytest.mark.parametrize("name", list(FORMER_REFUSALS))
def test_former_refusals_decode_bit_equal(streams, name):
    """The streams the port refused as "8x8 transform" or "scaling
    matrices" now decode, bit-equal to cv2."""
    _check_bit_equal(streams[0][(name, FORMER_REFUSALS[name][0])], name)


def test_the_streams_reach_every_context_mode_and_list_case(streams):
    """The writer's counters over the High streams of both coders reach
    H.high_coverage_expected(): contexts 399-435 under the I table and the P
    tables of cabac_init_idc 0-2 with both bin values (436-459 are
    field-coded contexts, unreachable in frame coding), every Intra 8x8 mode
    at every 8x8 block position with each availability of its top-right
    samples and of the top, left and corner samples its reference filter
    reads, the 8x8 transform in I_NxN and every inter type that may carry
    it, mixed 4x4/8x8 neighbours on both sides for nC, coded_block_flag and
    mode prediction, and every scaling-list case under both coders; the
    port's records hold every Intra 8x8 mode."""
    missing = H.high_coverage_expected() - set(streams[1])
    assert not missing, sorted(missing, key=str)
    modes = set()
    for path, _, _ in streams[0].values():
        clip = TV.open_video(path)
        parser = D.Parser(clip.config)
        for i in range(len(clip)):
            m = clip.h264(parser, i).mbs
            i8 = m[m[:, D.F_KIND] == D.K_I8]
            modes.update(((i8[:, D.F_MODES:D.F_MODES + 2, None] >> np.arange(0, 32, 16)) & 15)
                         .reshape(-1).tolist())
    assert modes == set(range(9)), modes


CODER_CASES = ["intra_8x8", "p_partitions_8x8", "constrained_intra_8x8",
               "lists_pps_falls_back_to_sps", "natural_high"]


@pytest.mark.parametrize("name", CODER_CASES)
def test_both_coders_give_identical_records(name):
    """One seed written with CAVLC and with CABAC at High profile: the port's
    host parse gives the same pictures, macroblock records, level rows and
    LevelScale tables for every sample."""
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
        assert np.array_equal(a.scales, b.scales), (name, i)
    assert len(parsed["cavlc"]) == len(parsed["cabac"]) > 0
    assert any((p.mbs[:, D.F_T8] == 1).any() for p in parsed["cavlc"])


# ----------------------------------------------------- the residual itself
# normAdjust4x4's and normAdjust8x8's v (8.5.9, 8.5.13.1), transcribed here
NORM4 = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
NORM8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26], [26, 23, 42, 24, 33, 31],
         [28, 25, 45, 26, 35, 33], [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]


def _norm4(m, i, j):
    return NORM4[m][0 if i % 2 == 0 and j % 2 == 0 else 1 if i % 2 and j % 2 else 2]


def _norm8(m, i, j):
    if i % 4 == 0 and j % 4 == 0:
        k = 0
    elif i % 2 and j % 2:
        k = 1
    elif i % 4 == 2 and j % 4 == 2:
        k = 2
    elif (i % 4 == 0 and j % 2) or (i % 2 and j % 4 == 0):
        k = 3
    elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        k = 4
    else:
        k = 5
    return NORM8[m][k]


def _scales(w4, w8):
    """The LevelScale tables (D.SCALES) of weightScale lists w4 [6, 16] and
    w8 [2, 64] (raster), as 8.5.9 defines them."""
    out = [w4[l][4 * i + j] * _norm4(m, i, j)
           for l in range(6) for m in range(6) for i in range(4) for j in range(4)]
    out += [w8[l][8 * i + j] * _norm8(m, i, j)
            for l in range(2) for m in range(6) for i in range(8) for j in range(8)]
    return np.array(out, np.int32)


def _scale4(c, ls, qp):
    """8.5.12.1 on one 4x4 block's levels (no DC exception)."""
    return np.array([int(c[k]) * int(ls[k]) << (qp // 6 - 4) if qp >= 24 else
                     (int(c[k]) * int(ls[k]) + (1 << (3 - qp // 6))) >> (4 - qp // 6)
                     for k in range(16)])


def _scale8(c, ls, qp):
    """8.5.13.1 on one 8x8 block's levels."""
    return np.array([int(c[k]) * int(ls[k]) << (qp // 6 - 6) if qp >= 36 else
                     (int(c[k]) * int(ls[k]) + (1 << (5 - qp // 6))) >> (6 - qp // 6)
                     for k in range(64)])


def _idct8_rows_then_columns(d):
    """8.5.13.2, term by term, on an [8, 8] block: [8, 8] residual."""
    def one(v):
        e0, e1 = v[0] + v[4], -v[3] + v[5] - v[7] - (v[7] >> 1)
        e2, e3 = v[0] - v[4], v[1] + v[7] - v[3] - (v[3] >> 1)
        e4, e5 = (v[2] >> 1) - v[6], -v[1] + v[7] + v[5] + (v[5] >> 1)
        e6, e7 = v[2] + (v[6] >> 1), v[3] + v[5] + v[1] + (v[1] >> 1)
        f0, f1, f2, f3 = e0 + e6, e1 + (e7 >> 2), e2 + e4, e3 + (e5 >> 2)
        f4, f5, f6, f7 = e2 - e4, (e3 >> 2) - e5, e0 - e6, e7 - (e1 >> 2)
        return [f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5, f0 - f7]
    g = np.array([one(list(row)) for row in d.astype(np.int64)])
    m = np.array([one(list(col)) for col in g.T]).T
    return (m + 32) >> 6


@pytest.mark.parametrize("qp", [0, 23, 24, 35, 36, 51])
def test_residual_plain_matches_the_standard(qp):
    """residual_plain with non-flat scaling lists against a transcription of
    8.5.12-8.5.13 (LevelScale, the 4x4 and 8x8 scaling with their rounding
    below qP 24 and 36, the Intra16x16 DC and chroma DC, the 4x4 and 8x8
    transforms) at the qP where the rounding changes: an Intra 8x8, an inter
    8x8-transform, an Intra16x16 and an inter 4x4 macroblock, every sample
    equal. The Intra16x16 DC is scaled as cv2's libavcodec scales it on x86
    (h264_luma_dc_dequant_idct: qmul = LevelScale << (qP / 6 + 2) in 16
    bits, or qmul >> 7 above 32767), which differs from 8.5.10 at qP 23
    with the Intra Y list's weight 255 at (0, 0)."""
    rng = np.random.default_rng(qp)
    w4 = rng.integers(1, 256, (6, 16))
    w4[0, 0] = 255
    w8 = rng.integers(1, 256, (2, 64))
    scales = _scales(w4, w8)
    kinds = [(D.K_I8, 1), (D.K_P, 1), (D.K_I16, 0), (D.K_P, 0)]
    rec = np.zeros((len(kinds), D.FIELDS), np.int32)
    levels = np.zeros((len(kinds), D.LEVELS), np.int16)
    for r, (kind, t8) in enumerate(kinds):
        rec[r, [D.F_KIND, D.F_QP, D.F_CQP0, D.F_CQP1, D.F_ROW, D.F_T8]] = [kind, qp, 3, -5, r, t8]
        levels[r] = rng.integers(-3, 4, D.LEVELS) * (rng.random(D.LEVELS) < 0.4)
    got = D.residual_plain(torch.from_numpy(rec), torch.from_numpy(levels),
                           torch.from_numpy(scales)).numpy()
    H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
    for r, (kind, t8) in enumerate(kinds):
        inter = kind == D.K_P
        ls4 = lambda lst, q: scales[(6 * lst + q % 6) * 16:(6 * lst + q % 6) * 16 + 16]
        L = levels[r].astype(np.int64)
        luma = np.zeros((16, 16), np.int64)
        if t8:
            ls8 = scales[D.S_8X8 + (6 * inter + qp % 6) * 64:][:64]
            for b8 in range(4):
                d = _scale8(L[64 * b8:64 * b8 + 64], ls8, qp).reshape(8, 8)
                luma[8 * (b8 >> 1):8 * (b8 >> 1) + 8, 8 * (b8 & 1):8 * (b8 & 1) + 8] = \
                    _idct8_rows_then_columns(d)
        else:
            f = H4 @ L[D.L_DC:D.L_DC + 16].reshape(4, 4) @ H4
            ls = int(ls4(0, qp)[0])
            spec = (f * ls << (qp // 6 - 6) if qp >= 36 else
                    (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6))
            qmul = ls << (qp // 6 + 2)
            dcy = (f * qmul + 128) >> 8 if qmul <= 32767 else (f * (qmul >> 7) + 1) >> 1
            assert np.array_equal(dcy, spec) == (qp != 23), qp
            for blk in range(16):
                bx, by = D.BLK_X[blk], D.BLK_Y[blk]
                d = _scale4(L[16 * blk:16 * blk + 16], ls4(3 * inter, qp), qp)
                if kind == D.K_I16:
                    d[0] = dcy[by, bx]
                res, _ = H.idct_checked(d)
                luma[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = res.reshape(4, 4)
        assert np.array_equal(got[r, :256], luma.reshape(256)), (qp, kind, t8)
        for c, off in enumerate((3, -5)):
            qc = D.CHROMA_QP[min(max(qp + off, 0), 51)]
            lsc = ls4(3 * inter + 1 + c, qc)
            dc = np.array([[1, 1], [1, -1]]) @ L[D.L_CDC + 4 * c:D.L_CDC + 4 * c + 4] \
                .reshape(2, 2) @ np.array([[1, 1], [1, -1]])
            dcc = ((dc * int(lsc[0])) << (qc // 6)) >> 5
            plane = np.zeros((8, 8), np.int64)
            for b in range(4):
                d = _scale4(L[D.L_CAC + 64 * c + 16 * b:D.L_CAC + 64 * c + 16 * b + 16], lsc, qc)
                d[0] = dcc[b >> 1, b & 1]
                res, _ = H.idct_checked(d)
                plane[4 * (b >> 1):4 * (b >> 1) + 4, 4 * (b & 1):4 * (b & 1) + 4] = \
                    res.reshape(4, 4)
            assert np.array_equal(got[r, 256 + 64 * c:320 + 64 * c], plane.reshape(64)), (qp, c)


def test_the_parse_gives_the_lists_levelscale_tables():
    """The LevelScale tables the parse puts out with a picture of the
    explicit-SPS-lists stream are the writer's weightScale lists times
    normAdjust, as this file transcribes 8.5.9."""
    seq, samples = _stream("lists_pps_falls_back_to_sps", "cavlc")
    pic = D.Parser(H.avcc(seq)).parse(H.sample_bytes(samples[0]))
    assert np.array_equal(pic.scales, _scales(seq.w4, seq.w8))
    assert not np.array_equal(seq.w4, np.full((6, 16), 16))


def _libavcodec() -> bytes:
    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    path, = glob.glob(os.path.join(libs, "libavcodec-*.so*"))
    with open(path, "rb") as f:
        return f.read()


def test_the_high_tables_occur_in_cv2s_libavcodec():
    """The decoder's 8x8 zig-zag scan, CABAC's 8x8 ctxIdxInc of
    significant_coeff_flag (frame) and last_significant_coeff_flag, the
    default scaling lists and normAdjust8x8's v occur byte for byte in the
    libavcodec cv2 decodes with (FFmpeg holds the frame and field
    significance tables as one [2][63] array, the defaults in raster order);
    and they are the standard's at their corners."""
    lib = _libavcodec()
    t = D.high_tables()
    for key in ("zigzag8", "sig8", "last8", "norm8"):
        assert lib.find(t[key].tobytes()) >= 0, key
    assert lib.find(t["default4"].tobytes()) >= 0 and lib.find(t["default8"].tobytes()) >= 0
    assert t["zigzag8"][:4].tolist() == [0, 1, 8, 16] and t["last8"][-1] == 8
    assert t["default4"][0, 0] == 6 and t["default8"][1, 63] == 35
    assert t["norm4"].tolist() == NORM4 and t["norm8"].tolist() == NORM8


def test_slices_with_different_scaling_matrices_are_refused(tmp_path):
    """A picture whose second slice follows a PPS sent again with other
    scaling lists raises ValueError naming it (and the sample) from
    extract_frames before the output directory exists."""
    args = H.high_case("lists_explicit_pps", SEED)
    args.update(slices=2, pictures=3)
    seq, samples = H.random_stream(seed=SEED, **args)
    other = H.high_case("lists_pps_falls_back_to_sps", SEED)["seq_args"]
    pps2 = H.Sequence(seq.width, seq.height, pps_extra=other["pps_extra"],
                      sps_extra=seq.sps_extra).pps()
    assert len(samples[2]) == 2 and pps2 != seq.pps()
    samples[2] = [samples[2][0], pps2, samples[2][1]]
    path = str(tmp_path / "clip.mp4")
    H.write_mp4(path, seq, samples)
    with pytest.raises(ValueError, match="sample 2: slices of one picture with different "
                                         "scaling matrices"):
        TP.extract_frames(path, str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")
