"""H.264 video without FFmpeg: the port's H.264 decoder
(`data/h264.py`, `csrc/h264_decode.cpp`), the conversion to BGR it
shares with the MPEG-4 decoder (`csrc/yuv420_bgr.h`) and the H.264 paths
of `data/mp4.py` (`avc1`/`avc3`) and `data/video.py` (AVI fourccs, raw
Annex B streams), against OpenCV 5.0.0's FFmpeg backend, which JAX's
`detect/stream.py:frame_source` reads through.

* The committed clips (`tests/fixtures/video/h264_*`, written by
  `tools/make_video_fixtures.py --h264` from `tools/h264_streams.py`)
  decode to the sha256 cv2's decode of them has, Y plane and BGR, frame
  for frame; with cv2 installed, the port's `frame_source` equals JAX's.
* Random-syntax streams (`tools/h264_streams.py`) over a grid of tools
  (CAVLC and CABAC, the 8x8 transform, scaling lists, explicit weights,
  several references with list modification and memory management
  (operation 5 too), frame_num gaps, frame_num and POC wraps, deblocking
  modes, several slices, POC types 0-2, odd sizes through a container,
  chroma siting, BT.709) decode in cv2 to the port's decode: the Y plane
  and BGR bitwise.
* Every tool outside the slice raises `VideoError` naming the file, the
  frame and the tool.

Live cv2 comparisons skip without OpenCV.
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

from mvsmplfitting_tpu_torch.data import h264 as D
from mvsmplfitting_tpu_torch.data import video as V

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "video")
with open(os.path.join(FIXTURES, "decoded_h264.json")) as _f:
    RECORD = json.load(_f)
CLIPS = sorted(RECORD)
SMALL = [c for c in CLIPS if "1920x1080" not in c]

sys.path.insert(0, ROOT)
from tools import h264_streams as H  # noqa: E402
from tools import make_video_fixtures as MF  # noqa: E402


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def port_planes(path: str) -> list:
    """The port's (Y, U, V) pictures of an H.264 file, in output order."""
    s = V.open_video(path)
    if s.container == "mp4":
        dec = D.H264Decoder(path, s.mp4.nal_length_size, s.mp4.config,
                            (s.width, s.height))
    else:
        dec = D.H264Decoder(path)
    out = []
    for data in s.packets():
        out += dec.decode(data)
    return out + dec.flush()


def cv2_frames(path: str, raw: bool = False) -> list:
    cv2 = pytest.importorskip("cv2")
    cap = (cv2.VideoCapture(path, cv2.CAP_FFMPEG,
                            [cv2.CAP_PROP_CONVERT_RGB, 0]) if raw
           else cv2.VideoCapture(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


# ---------------------------------------------------------- committed clips

@pytest.mark.parametrize("name", CLIPS)
def test_clip_decodes_to_cv2_sha256(name):
    """Every committed clip: the port's BGR frames and Y planes have the
    sha256 of cv2's, in cv2's count and order, and its size and frame
    rate are cv2's."""
    rec = RECORD[name]
    path = os.path.join(FIXTURES, name)
    s = V.open_video(path)
    assert s.codec == "h264"
    assert (s.width, s.height, s.fps) == (rec["width"], rec["height"],
                                          rec["fps"])
    assert [sha(f) for _, f in V.read_video(path)] == rec["bgr_sha256"]
    assert [sha(p[0]) for p in port_planes(path)] == rec["y_sha256"]


@pytest.mark.parametrize("name", SMALL)
def test_frame_source_matches_jax(name):
    """JAX's `frame_source` (cv2.VideoCapture) and the port's give the
    same frames, bitwise, on the MP4, MOV, AVI and Annex B clips;
    `max_frames` cuts both alike."""
    pytest.importorskip("cv2")
    from mvsmplfitting_tpu.detect import stream as JS
    from mvsmplfitting_tpu_torch.detect import stream as TS
    path = os.path.join(FIXTURES, name)
    want = list(JS.frame_source(path))
    got = list(TS.frame_source(path))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [i for i, _ in TS.frame_source(path, max_frames=3)] == [0, 1, 2]


def test_fixtures_are_current(tmp_path):
    """The committed clips are what `tools/make_video_fixtures.py` writes
    from `tools/h264_streams.py`, and decoded_h264.json is what cv2
    decodes from them."""
    assert sorted(MF.H264_CLIPS) == CLIPS
    for name, (container, fields, box) in sorted(MF.H264_CLIPS.items()):
        fresh = tmp_path / name
        MF.write_h264_clip(str(fresh), container, fields, box)
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            assert fresh.read_bytes() == f.read(), name
    pytest.importorskip("cv2")
    for name in CLIPS:
        path = os.path.join(FIXTURES, name)
        rec = RECORD[name]
        assert [sha(f) for f in cv2_frames(path)] == rec["bgr_sha256"], name
        assert [sha(f) for f in cv2_frames(path, raw=True)] == \
            rec["y_sha256"], name


# ---------------------------------------------------------- random streams

# name: Spec fields; each case writes a fresh stream of a few frames
GRID = {
    "cavlc": dict(frames=5),
    "cabac": dict(frames=5, cabac=True),
    "cavlc_intra": dict(frames=2, intra_p=1.0, pcm=True),
    "cabac_intra_pcm": dict(frames=2, intra_p=1.0, pcm=True, cabac=True),
    "cavlc_8x8": dict(frames=5, t8=True),
    "cabac_8x8": dict(frames=5, t8=True, cabac=True),
    "cavlc_8x8_inter": dict(frames=5, t8=True, intra_p=0.0),
    "scaling_sps": dict(frames=4, t8=True, scaling="sps"),
    "scaling_pps_cabac": dict(frames=4, t8=True, scaling="pps",
                              cabac=True),
    "scaling_both": dict(frames=4, t8=True, scaling="both"),
    "scaling_4x4_only": dict(frames=3, scaling="pps"),
    "weights": dict(frames=5, weighted=True, refs=2, num_ref_active=2),
    "weights_cabac": dict(frames=5, weighted=True, cabac=True, refs=3,
                          num_ref_active=3),
    "refs_mmco": dict(frames=9, refs=4, num_ref_active=3,
                      modification=True, mmco=True),
    "refs_mmco_cabac_long": dict(frames=9, refs=4, num_ref_active=4,
                                 modification=True, mmco=True, cabac=True,
                                 long_term_idr=True),
    "gaps": dict(frames=8, refs=3, num_ref_active=2, gaps=True),
    "mmco5": dict(frames=10, refs=3, num_ref_active=2, mmco=True,
                  mmco5=True),
    "mmco5_poc2_cabac": dict(frames=10, refs=3, num_ref_active=2,
                             mmco=True, mmco5=True, poc_type=2,
                             cabac=True),
    "wraps_poc0": dict(frames=40, width=32, height=32, refs=2,
                       num_ref_active=2),
    "wraps_poc1_gaps": dict(frames=40, width=32, height=32, poc_type=1,
                            nonref=True, gaps=True, refs=3,
                            num_ref_active=2, cabac=True),
    "deblock_modes": dict(frames=4, dbk_idc=(0, 1, 2), dbk_offsets=True,
                          slices=3),
    "deblock_modes_cabac_8x8": dict(frames=4, dbk_idc=(0, 2),
                                    dbk_offsets=True, slices=3, cabac=True,
                                    t8=True),
    "slices": dict(frames=4, slices=5, chroma_offsets=True),
    "poc1_nonref": dict(frames=6, poc_type=1, nonref=True),
    "poc2_nonref_cabac": dict(frames=6, poc_type=2, nonref=True,
                              cabac=True),
    "idr_and_i": dict(frames=7, i_nonidr=True, idr_every=3),
    "vui_reorder_2": dict(frames=6, reorder=2, refs=2, num_ref_active=2),
    "constrained_intra": dict(frames=4, constrained_intra=True,
                              intra_p=0.5),
    "box_175x99": dict(frames=3, width=176, height=100, box=(175, 99)),
    "box_51x37_no_vui": dict(frames=2, width=52, height=38, intra_p=1.0,
                             box=(51, 37)),
    "box_51x37_vui_left": dict(frames=2, width=52, height=38, intra_p=1.0,
                               colour=(0, 6), box=(51, 37)),
    "box_51x37_siting_top": dict(frames=2, width=52, height=38,
                                 intra_p=1.0, chroma_loc=2, box=(51, 37)),
    "box_50x37_siting_bottom": dict(frames=2, width=50, height=38,
                                    intra_p=1.0, chroma_loc=5,
                                    box=(50, 37)),
    "crop_top_left64": dict(frames=2, width=40, height=38, crop_left=64,
                            crop_top=6),
    "bt709": dict(frames=2, width=48, height=32, colour=(0, 1)),
    "bt709_box_47x31": dict(frames=2, width=48, height=32, colour=(0, 1),
                            intra_p=1.0, box=(47, 31)),
    "everything": dict(frames=8, width=50, height=34, cabac=True, t8=True,
                       scaling="both", weighted=True, refs=3,
                       num_ref_active=3, modification=True, mmco=True,
                       dbk_idc=(0, 1, 2), dbk_offsets=True, slices=4,
                       pcm=True, constrained_intra=True,
                       chroma_offsets=True, nonref=True, poc_type=1),
}


@pytest.mark.parametrize("case", sorted(GRID))
def test_random_streams_match_cv2(tmp_path, case):
    """A fresh random-syntax stream of each grid case (an MP4 when the
    case gives a container size, `box`, else Annex B): cv2 (FFmpeg)
    decodes it to the port's decode, the Y plane and BGR bitwise, frame
    for frame (BT.709 streams, whose Y plane cv2 converts, by BGR)."""
    pytest.importorskip("cv2")
    fields = dict(width=64, height=48, seed=sum(map(ord, case)))
    fields.update(GRID[case])
    box = fields.pop("box", None)
    spec = H.Spec(**fields)
    aus = H.write_stream(spec)
    if box:
        path = str(tmp_path / f"{case}.mp4")
        H.write_mp4(path, aus, *box)
    else:
        path = str(tmp_path / f"{case}.h264")
        H.write_annexb(path, aus)
    got = [f for _, f in V.read_video(path)]
    want = cv2_frames(path)
    assert len(got) == len(want) == spec.frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if spec.colour[1:] != (1,):
        for (y, _, _), w in zip(port_planes(path), cv2_frames(path, raw=True)):
            np.testing.assert_array_equal(y, w)


@pytest.mark.parametrize("container", ["mp4_avc1_1", "mp4_avc1_2",
                                       "mov_avc3_4", "avi_X264",
                                       "avi_davc", "annexb_aud"])
def test_containers_match_cv2(tmp_path, container):
    """One stream in each wrapping: MP4 `avc1` (parameter sets in avcC)
    and `avc3` (in band) with NAL lengths of 1, 2 and 4 bytes, AVI under
    two fourccs, Annex B with access unit delimiters; `read_video`
    gives cv2's frames and frame rate."""
    pytest.importorskip("cv2")
    small = container.endswith("_1")
    spec = H.Spec(width=32 if small else 50, height=32 if small else 38,
                  frames=4, seed=7, cabac=True, refs=2, num_ref_active=2,
                  slices=4 if small else 1, light=small)
    aus = H.write_stream(spec)
    kind, *rest = container.split("_")
    if kind in ("mp4", "mov"):
        path = str(tmp_path / f"clip.{kind}")
        H.write_mp4(path, aus, spec.width, spec.height,
                    rest[0].encode(), int(rest[1]))
    elif kind == "avi":
        path = str(tmp_path / "clip.avi")
        H.write_avi(path, aus, spec.width, spec.height, rest[0].encode())
    else:
        path = str(tmp_path / "clip.264")
        H.write_annexb(path, aus, aud=True)
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    s = V.open_video(path)
    assert (s.codec, s.width, s.height, s.fps) == ("h264", spec.width,
                                                   spec.height, fps)
    got = [f for _, f in V.read_video(path)]
    want = cv2_frames(path)
    assert len(got) == len(want) == spec.frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mp4_edit_list_hides_pictures(tmp_path):
    """An edit list that starts two frames late hides the first two
    pictures (decoded, as references), as FFmpeg's demuxer does."""
    pytest.importorskip("cv2")
    aus = H.write_stream(H.Spec(width=48, height=32, frames=6, seed=3,
                                cabac=True, refs=2, num_ref_active=2))
    path = tmp_path / "late.mp4"
    H.write_mp4(str(path), aus, 48, 32)
    data = bytearray(path.read_bytes())
    at = data.index(b"elst") + 4 + 8 + 4    # its one edit's media_time
    struct.pack_into(">i", data, at, 2)      # 2 ticks of 1/30 s
    path.write_bytes(bytes(data))
    assert V.open_video(str(path)).mp4.skip == 2
    got = [f for _, f in V.read_video(str(path))]
    want = cv2_frames(str(path))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_annexb_pieces_cut_anywhere(tmp_path):
    """A raw stream read in small pieces (cut before start codes) gives
    the frames it gives whole."""
    name = "h264_cavlc_176x144.h264"
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        pieces = list(D.annexb_chunks(f, 997))
    assert len(pieces) > 10
    assert all(p.startswith(b"\0\0") for p in pieces)
    dec = D.H264Decoder(path)
    got = []
    for p in pieces:
        got += dec.decode(p)
    got += dec.flush()
    assert [sha(p[0]) for p in got] == RECORD[name]["y_sha256"]


# ---------------------------------------------------------- refusals

def _write(tmp_path, name: str, aus) -> str:
    path = str(tmp_path / name)
    H.write_annexb(path, aus)
    return path


def _stream(**fields):
    base = dict(width=48, height=32, frames=4, seed=5)
    base.update(fields)
    return H.write_stream(H.Spec(**base))


def _drop(aus, k):
    return aus[:k] + aus[k + 1:]


def _data_partition(aus):
    aus = [list(a) for a in aus]
    aus[1].insert(0, H.nal(2, 2, b"\x88\x80"))
    return aus


def _swap_slices():
    for seed in range(40):  # the first stream whose picture 1 has 2+ slices
        aus = [list(a) for a in _stream(slices=4, frames=3, seed=seed)]
        if len(aus[1]) > 1:
            aus[1][0], aus[1][1] = aus[1][1], aus[1][0]
            return aus
    raise AssertionError("no stream with several slices")


def _truncate(aus):
    aus = [list(a) for a in aus]
    aus[1][0] = aus[1][0][:4]
    return aus


def _no_idr(aus):
    return [aus[0][:2] + aus[1]] + aus[2:]


def _new_size(aus):
    other = H.write_stream(H.Spec(width=64, height=32, frames=2, seed=6))
    return aus + other


# name: (stream, the frame named, the words of the message)
REFUSED = {
    "b_slice": (lambda: _stream(tamper=(("slice_type", 1),)), 1,
                "B slices"),
    "sp_slice": (lambda: _stream(tamper=(("slice_type", 3),)), 1,
                 "SP slices"),
    "si_slice": (lambda: _stream(tamper=(("slice_type", 4),)), 1,
                 "SI slices"),
    "interlace": (lambda: _stream(tamper=(("frame_mbs_only", 0),)), 0,
                  "interlaced"),
    "chroma_422": (lambda: _stream(t8=True,
                                   tamper=(("chroma_format_idc", 2),)), 0,
                   "chroma_format_idc 2"),
    "separate_planes": (lambda: _stream(
        t8=True, tamper=(("chroma_format_idc", 3),
                         ("separate_planes", 1))), 0,
        "separate_colour_plane"),
    "high10": (lambda: _stream(t8=True, tamper=(("profile", 110),)), 0,
               "profile_idc 110"),
    "bit_depth": (lambda: _stream(t8=True, tamper=(("bit_depth", 10),)),
                  0, "bit depth"),
    "bypass": (lambda: _stream(t8=True, tamper=(("bypass", 1),)), 0,
               "transform_bypass"),
    "extended": (lambda: _stream(tamper=(("profile", 88),)), 0,
                 "profile_idc 88"),
    "fmo": (lambda: _stream(tamper=(("slice_groups", 1),)), 0,
            "slice groups"),
    "aso": (_swap_slices, 1,
            "arbitrary slice order"),
    "redundant": (lambda: _stream(tamper=(("redundant", 1),)), 1,
                  "redundant pictures"),
    "data_partitioning": (lambda: _data_partition(_stream()), 1,
                          "data partitioning"),
    "size_change": (lambda: _new_size(_stream()), 4,
                    "change of picture size"),
    "corrupt": (lambda: _truncate(_stream()), 1, ""),
    "missing_picture": (lambda: _drop(_stream(frames=5), 2), 2,
                        "missing pictures"),
    "no_idr_first": (lambda: _no_idr(_stream()), 0,
                     "does not start with an IDR"),
    "reordered": (lambda: _stream(tamper=(("poc_swap", 1),)), 2,
                  "out of output order"),
    "left_crop": (lambda: _stream(width=46, crop_left=2), 0,
                  "cropping of 2 columns on the left"),
    "full_range": (lambda: _stream(colour=(1, 1)), 0, "full-range"),
    "bt2020": (lambda: _stream(colour=(0, 9)), 0, "matrix_coefficients 9"),
}


@pytest.mark.parametrize("tool", sorted(REFUSED))
def test_tools_refused(tmp_path, tool):
    """Each tool outside the slice raises `VideoError` naming the file,
    the frame (decoding order) and the tool; none decodes approximately."""
    make, frame, words = REFUSED[tool]
    path = _write(tmp_path, f"{tool}.h264", make())
    with pytest.raises(V.VideoError) as e:
        list(V.read_video(path))
    msg = str(e.value)
    assert path in msg and f"frame {frame}" in msg and words in msg, msg


def test_other_codecs_named(tmp_path):
    """An `avc1` sample entry without `avcC`, other sample entries and an
    AVI fourcc outside the three codecs raise naming the file and the
    codec."""
    aus = _stream()
    mp4 = tmp_path / "clip.mp4"
    H.write_mp4(str(mp4), aus, 48, 32)
    data = mp4.read_bytes()
    for old, new, words in ((b"avcC", b"xxxx", "'avc1' without an avcC"),
                            (b"avc1", b"hvc1", "'hvc1' (H.265)"),
                            (b"avc1", b"av01", "'av01' (AV1)")):
        bad = tmp_path / f"{new.decode()}.mp4"
        bad.write_bytes(data.replace(old, new))
        with pytest.raises(V.VideoError) as e:
            V.open_video(str(bad))
        assert str(bad) in str(e.value) and words in str(e.value)
    avi = tmp_path / "clip.avi"
    H.write_avi(str(avi), aus, 48, 32, b"HEVC")
    with pytest.raises(V.VideoError) as e:
        V.open_video(str(avi))
    assert str(avi) in str(e.value) and "'HEVC'" in str(e.value)
    with pytest.raises(V.VideoError, match="H.264 Annex B"):
        (tmp_path / "noise.bin").write_bytes(bytes(range(64)))
        V.open_video(str(tmp_path / "noise.bin"))
