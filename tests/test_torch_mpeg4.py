"""MPEG-4 Part 2 video without FFmpeg: the port's MP4 demuxer and muxer
(`data/mp4.py`), its Simple Profile decoder and encoder
(`data/mpeg4.py`, `csrc/mpeg4_decode.cpp`, `csrc/mpeg4_encode.cpp`) and
the MPEG-4 paths of `data/video.py`, against OpenCV 5.0.0's FFmpeg
backend, which JAX's `detect/stream.py:frame_source` and `viz/video.py`
read and write through.

* The committed clips (`tests/fixtures/video`, written by cv2:
  `tools/make_video_fixtures.py`) decode to the sha256 that cv2's
  decode of them has, Y plane and BGR; with cv2 installed, the port's
  `frame_source` equals JAX's bitwise.
* Streams of the port's encoder, normal and in its test mode (four
  vectors, intra macroblocks in P-VOPs, not-coded macroblocks, dquant,
  video packets, vectors out of the picture, VOPs not coded,
  intra_dc_vlc_thr 13), decode in cv2 to the port's decode: the Y plane
  and BGR bitwise, at even and odd sizes (odd heights take swscale's
  scaling path in cv2, odd widths there its full-chroma output).
* `yuv420_to_bgr` equals swscale's conversion as cv2 runs it, on random
  planes of every kind of size (cv2 reads them from a YUV4MPEG2 file
  whose chroma is sited left, as MPEG-4's is).
* Quality: the PSNR of the port's files as cv2 decodes them is at most
  1 dB below that of cv2's own `mp4v` files of the same frames.
* Every tool outside Simple Profile, and the codecs of other sample
  entries, raise `VideoError` naming the file and what was refused.

Live cv2 comparisons skip without OpenCV.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest

from mvsmplfitting_tpu_torch.data import mp4 as M
from mvsmplfitting_tpu_torch.data import mpeg4 as E
from mvsmplfitting_tpu_torch.data import video as V
from mvsmplfitting_tpu_torch.viz import video as TV

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "video")
VIEWS = os.path.join(HERE, "fixtures", "images", "views")
with open(os.path.join(FIXTURES, "decoded.json")) as _f:
    RECORD = json.load(_f)
CLIPS = sorted(RECORD)
SMALL = [c for c in CLIPS if "1920x1080" not in c]


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def view(v: int) -> np.ndarray:
    from mvsmplfitting_tpu_torch.data.images import read_image
    return read_image(os.path.join(VIEWS, f"Camera0{v}.jpg"))


def pan(w: int, h: int, n: int, step=(3, 2), v: int = 0) -> list:
    img = view(v)
    return [np.ascontiguousarray(img[400 + step[1] * i:400 + step[1] * i + h,
                                     700 + step[0] * i:700 + step[0] * i + w])
            for i in range(n)]


def port_planes(path: str) -> list:
    """The port's (Y, U, V) pictures of an MPEG-4 file, flush included."""
    s = V.open_video(path)
    if s.container == "mp4":
        dec = E.Mpeg4Decoder(path, s.mp4.config)
    else:
        dec = E.Mpeg4Decoder(path, b"", s.avi.fourcc)
    out = [p for p in map(dec.decode, s.packets()) if p is not None]
    last = dec.flush()
    return out + ([last] if last is not None else [])


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


def write_mp4(path: str, frames, fps: float = 30.0, **enc) -> list:
    """Frames through the port's encoder (`enc`: Mpeg4Encoder options)
    into an MP4 at `path`; returns the samples."""
    h, w = frames[0].shape[:2]
    e = E.Mpeg4Encoder(w, h, fps, **enc)
    samples = []
    with open(path, "wb") as f:
        mux = M.Mp4Writer(f, b"isom", w, h, e.res, e.inc, e.config())
        for fr in frames:
            data, key = e.encode(fr)
            mux.write(data, key)
            samples.append(data)
        mux.close()
    return samples


# ---------------------------------------------------------- committed clips

@pytest.mark.parametrize("name", CLIPS)
def test_clip_decodes_to_cv2_sha256(name):
    """Every committed clip: the port's BGR frames and Y planes have the
    sha256 of cv2's, and its size, count and frame rate are cv2's."""
    rec = RECORD[name]
    path = os.path.join(FIXTURES, name)
    s = V.open_video(path)
    assert (s.width, s.height, s.fps) == (rec["width"], rec["height"],
                                          rec["fps"])
    assert [sha(f) for _, f in V.read_video(path)] == rec["bgr_sha256"]
    assert [sha(p[0]) for p in port_planes(path)] == rec["y_sha256"]


@pytest.mark.parametrize("name", SMALL)
def test_frame_source_matches_jax(name):
    """JAX's `frame_source` (cv2.VideoCapture) and the port's give the
    same frames, bitwise; `max_frames` cuts both alike."""
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


def test_fixtures_are_current():
    """decoded.json is what cv2 decodes from the committed clips."""
    for name in CLIPS:
        path = os.path.join(FIXTURES, name)
        rec = RECORD[name]
        assert [sha(f) for f in cv2_frames(path)] == rec["bgr_sha256"], name
        assert [sha(f) for f in cv2_frames(path, raw=True)] == \
            rec["y_sha256"], name


def test_mp4_layouts(tmp_path):
    """The demuxer follows `moov` before `mdat`, `co64`, `stsc` runs of
    several chunk sizes and `stz2`, and an edit list that starts late
    hides the samples before it, as cv2 does."""
    path = os.path.join(FIXTURES, "mp4v_176x144.mp4")
    info = M.mp4_info(path)
    with open(path, "rb") as f:
        data = f.read()
    samples = [data[o:o + n] for o, n in info.samples]
    want = [sha(f) for _, f in V.read_video(path)]
    n = len(samples)
    # chunks of 3, 5, 5, ... samples: stsc (1, 3), (2, 5)
    per = [3] + [5] * ((n - 3) // 5) + ([(n - 3) % 5] if (n - 3) % 5 else [])
    def build(moov_first: bool, co64: bool, stz2: bool, media_time: int):
        mdat = b"".join(samples)
        def moov(base):
            offs, k, o = [], 0, base
            for p in per:
                offs.append(o)
                o += sum(len(s) for s in samples[k:k + p])
                k += p
            runs = [(1, 3, 1), (2, 5, 1)]
            if per[-1] != 5 and len(per) > 2:
                runs.append((len(per), per[-1], 1))
            stsc = M._fullbox(b"stsc", 0, 0, struct.pack(
                f">I{3 * len(runs)}I", len(runs), *sum(runs, ())))
            if stz2:
                stsz = M._fullbox(b"stz2", 0, 0, struct.pack(
                    f">3xBI{n}H", 16, n, *map(len, samples)))
            else:
                stsz = M._fullbox(b"stsz", 0, 0, struct.pack(
                    f">II{n}I", 0, n, *map(len, samples)))
            if co64:
                stco = M._fullbox(b"co64", 0, 0, struct.pack(
                    f">I{len(offs)}Q", len(offs), *offs))
            else:
                stco = M._fullbox(b"stco", 0, 0, struct.pack(
                    f">I{len(offs)}I", len(offs), *offs))
            w = M.Mp4Writer(io.BytesIO(), b"isom", 176, 144, 30, 1,
                            info.config)
            w.sizes = [len(s) for s in samples]
            w.offsets = list(range(n))
            w.keys = [1]
            full = w._moov()
            # swap the sample table's stsc/stsz/stco for ours
            i = full.index(b"stsc") - 4
            j = full.index(b"stco") - 4
            j += struct.unpack(">I", full[j:j + 4])[0]
            box = full[:i] + stsc + stsz + stco + full[j:]
            grow = len(box) - len(full)
            for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                k = box.index(kind) - 4
                size = struct.unpack(">I", box[k:k + 4])[0] + grow
                box = box[:k] + struct.pack(">I", size) + box[k + 4:]
            k = box.index(b"elst") + 4 + 4 + 4 + 4
            return box[:k] + struct.pack(">i", media_time) + box[k + 4:]
        ftyp = M._box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                      b"isomiso2mp41")
        if moov_first:
            probe = moov(0)
            base = len(ftyp) + len(probe) + 8
            return ftyp + moov(base) + M._box(b"mdat", mdat)
        return ftyp + M._box(b"mdat", mdat) + moov(len(ftyp) + 8)
    for case in ((True, False, False, 0), (False, True, False, 0),
                 (True, True, True, 0), (False, False, False, 2)):
        p = tmp_path / ("layout_%d%d%d_%d.mp4" % case)
        p.write_bytes(build(*case))
        got = [sha(f) for _, f in V.read_video(str(p))]
        assert got == want[case[3]:], case
        try:
            import cv2  # noqa: F401
        except ImportError:
            continue
        assert [sha(f) for f in cv2_frames(str(p))] == got, case


# ---------------------------------------------------------- the encoder

TOOLS = {
    "plain": 0,
    "four_mv": E.TOOL_FOUR_MV,
    "intra_in_p": E.TOOL_INTRA_IN_P,
    "not_coded": E.TOOL_NOT_CODED,
    "dquant": E.TOOL_DQUANT,
    "packets": E.TOOL_PACKETS,
    "outside": E.TOOL_OUTSIDE | E.TOOL_FOUR_MV,
    "nvop": E.TOOL_NVOP,
    "dc_thr": E.TOOL_DC_THR | E.TOOL_PACKETS | E.TOOL_DQUANT,
    "all": 255,
}


@pytest.mark.parametrize("size", [(176, 144), (180, 100), (48, 32),
                                  (175, 100), (175, 99), (64, 47)])
@pytest.mark.parametrize("tools", sorted(TOOLS))
def test_encoder_streams_decode_as_ffmpeg(tmp_path, tools, size):
    """The port's encoder in its test mode: cv2 (FFmpeg) decodes its
    streams to the port's decode, Y plane and BGR bitwise, frame for
    frame (a VOP not coded gives no frame, and the last picture again
    when the stream ends with one); odd widths and heights too."""
    w, h = size
    frames = pan(w, h, 18, step=(2, 1), v=2)
    path = str(tmp_path / f"{tools}.mp4")
    write_mp4(path, frames, tools=TOOLS[tools], seed=len(tools))
    mine = port_planes(path)
    raw = cv2_frames(path, raw=True)
    assert len(mine) == len(raw)
    for i, (p, r) in enumerate(zip(mine, raw)):
        np.testing.assert_array_equal(p[0], r, f"frame {i}")
    bgr = cv2_frames(path)
    got = [f for _, f in V.read_video(path)]
    assert len(got) == len(bgr)
    for i, (g, b) in enumerate(zip(got, bgr)):
        np.testing.assert_array_equal(g, b, f"frame {i}")


@pytest.mark.parametrize("size", [(64, 47), (175, 99), (176, 143), (33, 7)])
def test_odd_height_within_recorded_gap(tmp_path, size):
    """Odd heights, which cv2 converts on swscale's scaling path (a
    bicubic chroma filter; full horizontal chroma for an odd width; two
    or one chroma rows a line below a height of 9): the Y plane and BGR
    equal cv2's, bitwise."""
    w, h = size
    frames = pan(w, h, 13, step=(3, 2), v=3)
    path = str(tmp_path / "odd.mp4")
    write_mp4(path, frames, tools=E.TOOL_FOUR_MV | E.TOOL_PACKETS)
    mine = port_planes(path)
    raw = cv2_frames(path, raw=True)
    assert len(mine) == len(raw) == 13
    for p, r in zip(mine, raw):
        np.testing.assert_array_equal(p[0], r)
    bgr = cv2_frames(path)
    got = [f for _, f in V.read_video(path)]
    assert len(got) == len(bgr) == 13
    for i, (g, b) in enumerate(zip(got, bgr)):
        np.testing.assert_array_equal(g, b, f"frame {i}")


def write_y4m(path: str, y, u, v) -> None:
    """One 4:2:0 picture as a YUV4MPEG2 file, chroma sited left."""
    h, w = y.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420mpeg2\nFRAME\n"
                .encode())
        for p in (y, u, v):
            f.write(np.ascontiguousarray(p).tobytes())


# (w, h): even heights (the unscaled converter), odd heights with even
# and odd widths at filter sizes 4 (h >= 9), 2 (h = 7) and 1 (h <= 5)
CONVERT_SIZES = [(64, 48), (63, 48), (1, 2), (64, 47), (63, 47), (176, 7),
                 (175, 7), (8, 5), (9, 5), (4, 3), (1, 3), (6, 1), (5, 1),
                 (2, 9), (3, 9), (640, 361), (641, 359)]


@pytest.mark.parametrize("kind", ["random", "rails"])
@pytest.mark.parametrize("size", CONVERT_SIZES)
def test_yuv420_to_bgr_equals_swscale(tmp_path, size, kind):
    """`yuv420_to_bgr` against cv2's conversion of the same planes,
    bitwise: random planes, and planes at the rails with sharp edges
    (the bicubic filters overshoot below 0 and above 255)."""
    cv2 = pytest.importorskip("cv2")
    w, h = size
    rng = np.random.default_rng(w * 1000 + h)
    cs = ((h + 1) // 2, (w + 1) // 2)
    if kind == "random":
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u = rng.integers(0, 256, cs, dtype=np.uint8)
        v = rng.integers(0, 256, cs, dtype=np.uint8)
    else:
        y = rng.choice(np.array([0, 16, 235, 255], np.uint8), (h, w))
        u = rng.choice(np.array([0, 1, 254, 255], np.uint8), cs)
        v = rng.choice(np.array([0, 255], np.uint8), cs)
    path = str(tmp_path / "p.y4m")
    write_y4m(path, y, u, v)
    cap = cv2.VideoCapture(path)
    ok, want = cap.read()
    cap.release()
    assert ok and want.shape == (h, w, 3)
    np.testing.assert_array_equal(E.yuv420_to_bgr(y, u, v), want)


def psnr(a, b) -> float:
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / err))


@pytest.mark.parametrize("size,n,v", [((176, 144), 30, 0),
                                      ((640, 360), 12, 4)])
def test_quality_against_cv2_writer(tmp_path, size, n, v):
    """PSNR of the port's MP4 as cv2 decodes it against cv2's own
    `mp4v` file of the same frames: at most 1 dB lower.  With OpenCV
    5.0.0 (libavcodec 62.28.101): 176x144 port 41.286 dB / 6745 B, cv2
    40.313 dB / 6491 B; 640x360 port 39.956 dB / 20434 B, cv2 38.471 dB /
    20464 B (the test prints both)."""
    cv2 = pytest.importorskip("cv2")
    w, h = size
    frames = pan(w, h, n, step=(3, 2), v=v)
    theirs = str(tmp_path / "cv2.mp4")
    wr = cv2.VideoWriter(theirs, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                         (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    ours = str(tmp_path / "port.mp4")
    TVw = TV.VideoWriter(ours, 30.0, (w, h))
    for f in frames:
        TVw.write(f)
    TVw.release()
    p_theirs = np.mean([psnr(a, b) for a, b in zip(cv2_frames(theirs),
                                                   frames)])
    decoded = cv2_frames(ours)
    assert len(decoded) == n
    p_ours = np.mean([psnr(a, b) for a, b in zip(decoded, frames)])
    print(f"{w}x{h}: port {p_ours:.3f} dB {os.path.getsize(ours)} B, "
          f"cv2 {p_theirs:.3f} dB {os.path.getsize(theirs)} B")
    assert p_ours >= p_theirs - 1.0


# ---------------------------------------------------------- writing

EXTENSIONS = [".mp4", ".MP4", ".m4v", ".m4a", ".mov", ".avi", ".mkv",
              ".3gp", ".mpg", ".ts", ".wmv", ".webm", ".gif", ".xyz", ""]


@pytest.mark.parametrize("ext", EXTENSIONS)
def test_writer_names_as_cv2(tmp_path, ext):
    """For each name: cv2's `mp4v` writer opens (and which container it
    writes) or does not (JAX then writes MJPG at the .avi name); the port
    writes the same container at the same name, raises where it has no
    such muxer, and cv2 reads the port's file with the same frame count,
    size and frame rate."""
    cv2 = pytest.importorskip("cv2")
    frames = pan(96, 64, 5, v=1)
    theirs = str(tmp_path / "cv2" / ("clip" + ext))
    os.makedirs(os.path.dirname(theirs))
    wr = cv2.VideoWriter(theirs, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                         (96, 64))
    opened = wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    ours = str(tmp_path / "port" / ("clip" + ext))
    if opened and ext.lower() in TV.NO_MUXER:
        with pytest.raises(V.VideoError, match=TV.NO_MUXER[ext.lower()]):
            TV.VideoWriter(ours, 25.0, (96, 64))
        return
    w = TV.VideoWriter(ours, 25.0, (96, 64))
    for f in frames:
        w.write(f)
    w.release()
    if not opened:
        assert (w.container, w.codec) == ("avi", "mjpeg")
        assert w.path == str(tmp_path / "port" / "clip.avi")
        return
    assert w.path == ours and w.codec == "mpeg4"
    with open(theirs, "rb") as f:
        head_theirs = f.read(12)
    with open(ours, "rb") as f:
        head_ours = f.read(12)
    if head_theirs[4:8] == b"ftyp":
        assert head_ours[4:12] == head_theirs[4:12]
    else:
        assert head_ours[:4] == head_theirs[:4] == b"RIFF"
        assert V.avi_info(ours).fourcc == V.avi_info(theirs).fourcc == "mp4v"
    cap = cv2.VideoCapture(ours)
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    got = cv2_frames(ours)
    assert len(got) == 5 and got[0].shape == (64, 96, 3)
    assert [sha(f) for _, f in V.read_video(ours)] == [sha(f) for f in got]


def test_writer_crops_odd_sizes_as_cv2(tmp_path):
    """cv2's MPEG-4 writer drops an odd last column and row; so does the
    port's (frames are still given at the size asked)."""
    frames = pan(97, 65, 3, v=5)
    w = TV.VideoWriter(str(tmp_path / "odd.mp4"), 30.0, (97, 65))
    for f in frames:
        w.write(f)
    w.release()
    got = [f for _, f in V.read_video(w.path)]
    assert len(got) == 3 and got[0].shape == (64, 96, 3)
    assert psnr(got[0], frames[0][:64, :96]) > 30


# ---------------------------------------------------------- refusals

class Bits:
    def __init__(self):
        self.bits = []

    def put(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def stuff(self):
        self.put(1, 0)
        while len(self.bits) % 8:
            self.put(1, 1)

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


def vol(verid=1, interlaced=0, sprite=0, quant_type=0, quarter=0,
        partitioned=0, shape=0, complexity=1, user=b"") -> bytes:
    """VOS/VO/VOL headers (as the port's encoder writes them) with the
    given tools on, and user data after them."""
    b = Bits()
    for code in (0x1B0, 0x01):
        b.put(32 if code > 0xFF else 8, code)
    b.put(32, 0x1B5)
    b.put(12, 0x891)
    b.put(1, 0)
    b.stuff()
    b.put(32, 0x100)
    b.put(32, 0x120)
    b.put(9, 1)
    b.put(1, 1)
    b.put(4, verid)
    b.put(3, 1)
    b.put(4, 1)
    b.put(1, 1)
    b.put(2, 1)
    b.put(1, 1)
    b.put(1, 0)
    b.put(2, shape)
    b.put(1, 1)
    b.put(16, 30)
    b.put(1, 1)
    b.put(1, 0)
    b.put(1, 1)
    b.put(13, 64)
    b.put(1, 1)
    b.put(13, 48)
    b.put(1, 1)
    b.put(1, interlaced)
    b.put(1, 1)
    b.put(1 if verid == 1 else 2, sprite)
    b.put(1, 0)
    b.put(1, quant_type)
    if verid != 1:
        b.put(1, quarter)
    b.put(1, complexity)
    b.put(1, 0)
    b.put(1, partitioned)
    if partitioned:
        b.put(1, 0)
    if verid != 1:
        b.put(2, 0)
    b.put(1, 0)
    b.stuff()
    out = b.bytes()
    if user:
        out += b"\0\0\1\xb2" + user
    return out


@pytest.mark.parametrize("tool,config", [
    ("data partitioning", vol(partitioned=1)),
    ("interlace", vol(interlaced=1)),
    ("quant_type 1", vol(quant_type=1)),
    ("quarter-pel", vol(verid=2, quarter=1)),
    ("sprites", vol(sprite=1)),
    ("non-rectangular", vol(shape=1)),
    ("complexity estimation", vol(complexity=0)),
])
def test_vol_tools_refused(tool, config):
    with pytest.raises(V.VideoError) as e:
        E.Mpeg4Decoder("clip.mp4", config)
    assert "clip.mp4" in str(e.value) and tool in str(e.value)


@pytest.fixture(scope="module")
def stream():
    """A small stream of the port's encoder: (config, VOPs)."""
    frames = pan(64, 48, 4, v=0)
    e = E.Mpeg4Encoder(64, 48, 30.0)
    return e.config(), [e.encode(f)[0] for f in frames]


def test_vop_tools_refused(stream):
    config, vops = stream
    for kind, tool in ((2, "B-VOP"), (3, "S-VOP")):
        dec = E.Mpeg4Decoder("clip.avi", config)
        assert dec.decode(vops[0]) is not None
        p = bytearray(vops[1])
        at = p.index(b"\0\0\1\xb6") + 4
        p[at] = (p[at] & 0x3F) | (kind << 6)
        with pytest.raises(V.VideoError) as e:
            dec.decode(bytes(p))
        assert "clip.avi frame 1" in str(e.value) and tool in str(e.value)
    dec = E.Mpeg4Decoder("clip.avi", config)
    with pytest.raises(V.VideoError, match="clip.avi frame 0.*packed"):
        dec.decode(vops[0] + vops[1])
    with pytest.raises(V.VideoError, match="short_video_header"):
        E.Mpeg4Decoder("clip.avi", config).decode(b"\0\0\x80\x02" + bytes(9))
    for user, who in ((b"XviD0050", "Xvid"), (b"DivX503b1393p", "DivX")):
        dec = E.Mpeg4Decoder("clip.avi", vol(user=user))
        with pytest.raises(V.VideoError) as e:
            dec.decode(vops[0])
        assert "clip.avi" in str(e.value) and who in str(e.value)
    # an Xvid fourcc without libavcodec's user data: Xvid's IDCT in FFmpeg
    with pytest.raises(V.VideoError, match="Xvid"):
        E.Mpeg4Decoder("clip.avi", config, "XVID").decode(vops[0])


def test_packed_avi_and_other_sample_entries_refused(tmp_path, stream):
    """An AVI chunk holding two VOPs (DivX's packed bitstream) and an MP4
    whose sample entry is `avc1` raise, naming the file and the cause."""
    config, vops = stream
    buf = io.BytesIO()
    avi = TV.AviWriter(buf, 64, 48, 30.0, b"DX50")
    avi.write(config + vops[0], True)
    avi.write(vops[1] + vops[2], False)
    avi.close()
    path = tmp_path / "packed.avi"
    path.write_bytes(buf.getvalue())
    with pytest.raises(V.VideoError) as e:
        list(V.read_video(str(path)))
    assert str(path) in str(e.value) and "packed" in str(e.value)
    src = os.path.join(FIXTURES, "mp4v_176x144.mp4")
    with open(src, "rb") as f:
        data = f.read()
    for entry, name in ((b"avc1", "'avc1'"), (b"hvc1", "'hvc1'")):
        bad = tmp_path / f"{entry.decode()}.mp4"
        bad.write_bytes(data.replace(b"mp4v", entry))
        with pytest.raises(V.VideoError) as e:
            V.open_video(str(bad))
        assert str(bad) in str(e.value) and name in str(e.value)
    with pytest.raises(V.VideoError, match="Matroska"):
        TV.VideoWriter(str(tmp_path / "x.mkv"), 30.0, (64, 48))
