"""Streaming keypoints without OpenCV: the port's Motion-JPEG AVI reader
and writer (`data/video.py`, `viz/video.py`), JPEG frames without DHT
(`csrc/image_decode.cpp`'s standard tables) and `detect/stream.py:
run_stream`, against OpenCV and the JAX package.

The reader's yardstick is OpenCV's own Motion-JPEG reader
(`cv2.CAP_OPENCV_MJPEG`, `cv2.imdecode` of each chunk), bitwise.  JAX
reads videos with `cv2.VideoCapture(path)`, whose default backend is
FFmpeg: its decode of the same file differs, and the gap is recorded
and bounded.  `run_stream` is held to JAX's on a folder of frames (both
read it bitwise alike) with the small nets of `test_torch_keypoints.py`
and YOLOX's head fixed (`fixed_yolox_head`): the same boxes, so the
same crops.
"""

import functools
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from torch_port_helpers import fixed_yolox_head, numpy_state, to_tensors

from mvsmplfitting_tpu_torch.data import images as I
from mvsmplfitting_tpu_torch.data import video as V
from mvsmplfitting_tpu_torch.detect import predictor as TP
from mvsmplfitting_tpu_torch.detect import stream as TS
from mvsmplfitting_tpu_torch.viz import video as TV

cv2 = pytest.importorskip("cv2")

DET_HW = (64, 96)
POSE_HW = (64, 48)
J = 17
HW = (120, 160)
# FFmpeg's JPEG decode against libjpeg's (cv2.imdecode) on the smooth
# frames below: measured 9-13 levels at most a frame, on ~80% of the
# pixels (OpenCV 5.0.0 with its FFmpeg); the bound leaves room for other
# FFmpeg builds.
FFMPEG_GAP = 24


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smooth_frames(n, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6, 3)
        img = np.stack([128 + 90 * np.sin(x / (9.0 + c) + ph[c])
                        * np.cos(y / (13.0 - c) - ph[c]) for c in range(3)],
                       -1)
        out.append(np.clip(img + rng.normal(0, 4, img.shape), 0, 255
                           ).astype(np.uint8))
    return out


def strip_dht(data: bytes) -> bytes:
    """A JPEG's bytes without its DHT segments (as Motion-JPEG cameras
    write frames)."""
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        marker = data[p + 1]
        n = int.from_bytes(data[p + 2:p + 4], "big")
        if marker == 0xDA:
            out += data[p:]
            break
        if marker != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    assert b"\xff\xc4" not in bytes(out[:out.index(b"\xff\xda")])
    return bytes(out)


def opencv_mjpeg(path):
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    assert cap.isOpened()
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5-frame MJPEG AVI written by OpenCV's own writer."""
    path = str(tmp_path_factory.mktemp("clip") / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        HW[::-1])
    assert w.isOpened()
    for f in smooth_frames(5):
        w.write(f)
    w.release()
    return path


def test_reader_bitwise_as_opencv_mjpeg_and_ffmpeg_gap(clip):
    info = V.avi_info(clip)
    assert (info.width, info.height, info.fps, info.frames, info.fourcc) \
        == (HW[1], HW[0], 10.0, 5, "MJPG")
    got = [f for _, f in V.read_video(clip)]
    want = opencv_mjpeg(clip)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [i for i, _ in V.read_video(clip, max_frames=2)] == [0, 1]
    # JAX's reader (OpenCV's default backend, FFmpeg) decodes otherwise.
    cap = cv2.VideoCapture(clip)
    gaps = [int(np.abs(cap.read()[1].astype(int) - g).max()) for g in got]
    cap.release()
    assert 0 < max(gaps) <= FFMPEG_GAP, gaps


@pytest.mark.parametrize("gray,quality", [(False, 90), (False, 60),
                                          (True, 85)])
def test_frames_without_dht_decode_as_opencv(gray, quality):
    img = smooth_frames(1, (61, 83), seed=quality)[0]
    if gray:
        img = img[..., 0]
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    data = strip_dht(enc.tobytes())
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(I.decode_jpeg(data), want)
    np.testing.assert_array_equal(I.decode_jpeg(enc.tobytes()), want)


def test_writer_streams_and_reads_back(tmp_path):
    """Motion-JPEG at the .avi name where cv2's mp4v writer does not open
    (JAX's fallback), bitwise as OpenCV's MJPEG reader; MPEG-4 at a .mp4
    or .avi name, read back by cv2 (FFmpeg) and the port alike."""
    frames = smooth_frames(4, seed=3)
    w = TV.VideoWriter(str(tmp_path / "out.webm"), 30.0, HW[::-1])
    for f in frames:
        w.write(f)
    w.release()
    assert w.path == str(tmp_path / "out.avi")
    with open(w.path, "rb") as f:
        data = f.read()
    jpegs = [I.encode_jpeg(f, TV.JPEG_QUALITY) for f in frames]
    assert data.startswith(b"RIFF") and len(data) == 8 + struct.unpack(
        "<I", data[4:8])[0]
    assert sum(j in data for j in jpegs) == 4
    got = [f for _, f in V.read_video(w.path)]
    want = opencv_mjpeg(w.path)
    assert len(got) == len(want) == 4
    for g, o, j in zip(got, want, jpegs):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, I.decode_jpeg(j))
    with pytest.raises(ValueError, match="frame"):
        w2 = TV.VideoWriter(str(tmp_path / "b.avi"), 30.0, (10, 10))
        try:
            w2.write(frames[0])
        finally:
            w2.release()
    for name, head in (("m.mp4", b"ftypisom"), ("m.avi", b"RIFF")):
        w = TV.VideoWriter(str(tmp_path / name), 30.0, HW[::-1])
        for f in frames:
            w.write(f)
        w.release()
        assert w.path == str(tmp_path / name) and w.codec == "mpeg4"
        with open(w.path, "rb") as f:
            assert head in f.read(12)
        cap = cv2.VideoCapture(w.path)
        assert cap.get(cv2.CAP_PROP_FPS) == 30.0
        want = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            want.append(f)
        got = [f for _, f in V.read_video(w.path)]
        assert len(got) == len(want) == 4
        for g, o in zip(got, want):
            np.testing.assert_array_equal(g, o)


def _chunk(fourcc, data):
    return fourcc + struct.pack("<I", len(data)) + data + b"\0" * (
        len(data) % 2)


def avi_bytes(jpegs, fps):
    buf = io.BytesIO()
    w = TV.AviWriter(buf, HW[1], HW[0], fps)
    for j in jpegs:
        w.write(j)
    w.close()
    return buf.getvalue()


def test_opendml_continuation_rec_lists_and_other_streams(tmp_path):
    """Frames without DHT, in a `rec ` list beside an audio chunk, and in
    an OpenDML `AVIX` RIFF after the first: all read, in order."""
    frames = smooth_frames(4, seed=5)
    jpegs = [strip_dht(cv2.imencode(".jpg", f)[1].tobytes()) for f in frames]
    base = avi_bytes(jpegs[:2], 25.0)
    body = _chunk(b"01wb", b"\1\2\3") + _chunk(b"00dc", jpegs[2])
    rec = b"LIST" + struct.pack("<I", len(body) + 4) + b"rec " + body
    movi = rec + _chunk(b"ix00", bytes(24)) + _chunk(b"00dc", jpegs[3])
    avix = (b"RIFF" + struct.pack("<I", len(movi) + 16) + b"AVIX" + b"LIST"
            + struct.pack("<I", len(movi) + 4) + b"movi" + movi)
    path = tmp_path / "odml.avi"
    path.write_bytes(base + avix)
    got = [f for _, f in V.read_video(str(path))]
    assert len(got) == 4
    for g, j in zip(got, jpegs):
        np.testing.assert_array_equal(
            g, cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR))


def test_other_codecs_and_webcams_refused(tmp_path, small_cli, monkeypatch):
    frames = smooth_frames(2)
    for name, cc in (("x.avi", "DIV3"), ("m.mp4", "MJPG")):
        path = str(tmp_path / name)
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*cc), 10.0,
                            HW[::-1])
        assert w.isOpened()
        for f in frames:
            w.write(f)
        w.release()
        with pytest.raises(V.VideoError) as e:
            list(V.read_video(path))
        assert path in str(e.value)
        assert ("'DIV3'" if cc == "DIV3" else "JPEG") in str(e.value)

    def boom(*a, **k):
        raise AssertionError("built a net before refusing")
    monkeypatch.setattr(TP, "PersonDetector", boom)
    for src in ("0", str(tmp_path / "x.avi"), str(tmp_path / "none.avi")):
        with pytest.raises((V.VideoError, FileNotFoundError)) as e:
            small_cli.main(["--video", src, "--device", "cpu"])
        assert ("webcam 0" if src == "0" else src) in str(e.value)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "a.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(I.ImageError, match="a.bmp"):
        list(TS.frame_source(str(tmp_path / "bad")))


# ---- run_stream against JAX's ------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    det = fixed_yolox_head(numpy_state(YOLOX(depth_mul=0.33,
                                             width_mul=0.25), 0))
    return det, numpy_state(FastPose(J), 1)


@pytest.fixture
def small_cli(monkeypatch):
    """The keypoint CLI with the test's small nets."""
    monkeypatch.setattr(TP, "PersonDetector", functools.partial(
        TP.PersonDetector, input_hw=DET_HW, depth_mul=0.33, width_mul=0.25))
    monkeypatch.setattr(TP, "PoseEstimator", functools.partial(
        TP.PoseEstimator, input_hw=POSE_HW))
    from mvsmplfitting_tpu_torch.cli import keypoints
    return keypoints


def port_nets(weights):
    det_sd, pose_sd = weights
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    det = TP.PersonDetector(to_tensors(det_sd), input_hw=DET_HW,
                            depth_mul=0.33, width_mul=0.25, device="cpu")
    pose = TP.PoseEstimator(to_tensors(pose_sd), num_joints=J,
                            input_hw=POSE_HW, model=FastPose(J),
                            device="cpu")
    return det, pose


def frame_folder(root, frames):
    os.makedirs(root, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(root, f"f{i:02d}.png"), f)
    return root


def read_tree(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name)) as f:
            people = json.load(f)["people"]
        out[name] = np.asarray([p["pose_keypoints_2d"] for p in people]
                               ).reshape(len(people), -1, 3)
    return out


def loose_joints(pose, det, img):
    """(P, J) mask of the joints whose decoded coordinate rests on a
    heatmap difference under 1e-4 (`decode_margins`)."""
    from mvsmplfitting_tpu_torch.detect.preprocess import (
        bbox_to_center_scale, crop_affine, decode_margins)
    t = torch.from_numpy(img)
    boxes = det.detect_batch([t])[0]
    c, s = bbox_to_center_scale(boxes[:, :4], POSE_HW[1] / POSE_HW[0])
    crops = crop_affine(TP.rgb01(t), torch.from_numpy(c),
                        torch.from_numpy(s), POSE_HW)
    return (decode_margins(pose.heatmaps(crops)) < 1e-4).numpy()


def test_run_stream_matches_jax(tmp_path, weights):
    from mvsmplfitting_tpu.detect import convert as JC
    from mvsmplfitting_tpu.detect import predictor as JPr
    from mvsmplfitting_tpu.detect import stream as JS
    from mvsmplfitting_tpu.detect.fastpose import FastPose as JFastPose
    det_sd, pose_sd = weights
    frames = smooth_frames(4, seed=7)     # two chunks of 2: one batch shape
    src = frame_folder(str(tmp_path / "frames"), frames)
    jdet = JPr.PersonDetector(JC.convert_yolox_sd(det_sd, 0.33),
                              input_hw=DET_HW, depth_mul=0.33,
                              width_mul=0.25)
    jpose = JPr.PoseEstimator(JC.convert_fastpose_sd(pose_sd), num_joints=J,
                              input_hw=POSE_HW, model=JFastPose(J))
    n_jax = JS.run_stream(src, jdet, jpose, out_json_dir=str(tmp_path / "j"),
                          chunk=2, results_dir=str(tmp_path / "jr"))
    det, pose = port_nets(weights)
    n = TS.run_stream(src, det, pose, out_json_dir=str(tmp_path / "p"),
                      chunk=2, results_dir=str(tmp_path / "pr"))
    assert n == n_jax == 4
    want = read_tree(tmp_path / "j" / "stream")
    got = read_tree(tmp_path / "p" / "stream")
    assert sorted(got) == sorted(want) == [f"{i:06d}_keypoints.json"
                                           for i in range(4)]
    for i, name in enumerate(sorted(want)):
        g, w = got[name], want[name]
        assert g.shape == w.shape and len(g) == 6, name
        np.testing.assert_allclose(g[..., 2], w[..., 2], atol=2e-4,
                                   rtol=1e-3)
        close = np.isclose(g[..., :2], w[..., :2], atol=1e-3, rtol=0).all(-1)
        assert (close | loose_joints(pose, det, frames[i])).all(), name
    with open(tmp_path / "jr" / "alphapose-results.json") as f:
        jres = json.load(f)
    with open(tmp_path / "pr" / "alphapose-results.json") as f:
        pres = json.load(f)
    assert [r["image_id"] for r in pres] == [r["image_id"] for r in jres]
    np.testing.assert_allclose([r["score"] for r in pres],
                               [r["score"] for r in jres], atol=1e-3)
    np.testing.assert_allclose([r["box"] for r in pres],
                               [r["box"] for r in jres], atol=1e-3)


def test_run_stream_writes_video_as_jax(tmp_path, weights):
    """`out_video` at a .mp4, .avi and .webm name: JAX's `run_stream`
    (cv2.VideoWriter, mp4v, then MJPG at the .avi name) and the port's
    write the same file name and container, with the same frame count,
    size and frame rate as cv2 reads them."""
    from mvsmplfitting_tpu.detect import convert as JC
    from mvsmplfitting_tpu.detect import predictor as JPr
    from mvsmplfitting_tpu.detect import stream as JS
    from mvsmplfitting_tpu.detect.fastpose import FastPose as JFastPose
    det_sd, pose_sd = weights
    src = frame_folder(str(tmp_path / "frames"), smooth_frames(3, seed=9))
    jdet = JPr.PersonDetector(JC.convert_yolox_sd(det_sd, 0.33),
                              input_hw=DET_HW, depth_mul=0.33,
                              width_mul=0.25)
    jpose = JPr.PoseEstimator(JC.convert_fastpose_sd(pose_sd), num_joints=J,
                              input_hw=POSE_HW, model=JFastPose(J))
    det, pose = port_nets(weights)

    def probe(path):
        with open(path, "rb") as f:
            head = f.read(12)
        cap = cv2.VideoCapture(path)
        n = 0
        shape = None
        while True:
            ok, f = cap.read()
            if not ok:
                break
            n, shape = n + 1, f.shape
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
        kind = head[4:12] if head[4:8] == b"ftyp" else head[8:12]
        return kind, n, shape, fps

    for name, made in (("out.mp4", "out.mp4"), ("out.avi", "out.avi"),
                       ("out.webm", "out.avi")):
        JS.run_stream(src, jdet, jpose, out_json_dir=str(tmp_path / "jj"),
                      out_video=str(tmp_path / "j" / name), chunk=3)
        TS.run_stream(src, det, pose, out_json_dir=str(tmp_path / "pj"),
                      out_video=str(tmp_path / "p" / name), chunk=3)
        assert sorted(os.listdir(tmp_path / "j")) == \
            sorted(os.listdir(tmp_path / "p"))
        want = probe(str(tmp_path / "j" / made))
        assert probe(str(tmp_path / "p" / made)) == want
        assert want[1:] == (3, HW + (3,), 30.0), want
        if made.endswith(".avi"):
            j = V.avi_info(str(tmp_path / "j" / made))
            p = V.avi_info(str(tmp_path / "p" / made))
            assert (p.fourcc.upper(), p.codec) == (j.fourcc.upper(), j.codec)


def test_cli_video_mode(tmp_path, weights, small_cli, clip):
    """`--video <avi> --out_video --results_dir --max_frames 4`: the
    frames as OpenCV's MJPEG reader gives them, through the same nets as
    `run_stream` on a folder of those frames."""
    det_sd, pose_sd = weights
    yolox_ckpt, pose_ckpt = tmp_path / "y.pth", tmp_path / "p.pth"
    torch.save({"model": to_tensors(det_sd)}, yolox_ckpt)
    torch.save(to_tensors(pose_sd), pose_ckpt)
    data = tmp_path / "data"
    rc = small_cli.main([
        "--video", clip, "--data_folder", str(data), "--out_video",
        str(tmp_path / "drawn.mp4"), "--results_dir", str(tmp_path / "res"),
        "--results_form", "open", "--max_frames", "4", "--num_joints",
        str(J), "--yolox_ckpt", str(yolox_ckpt), "--pose_ckpt",
        str(pose_ckpt), "--device", "cpu"])
    assert rc == 0
    got = read_tree(data / "keypoints" / "stream")
    assert sorted(got) == [f"{i:06d}_keypoints.json" for i in range(4)]
    src = frame_folder(str(tmp_path / "frames"), opencv_mjpeg(clip)[:4])
    det, pose = port_nets(weights)
    TS.run_stream(src, det, pose, out_json_dir=str(tmp_path / "direct"))
    want = read_tree(tmp_path / "direct" / "stream")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # MPEG-4 at the name given, as cv2's mp4v writer writes it
    cap = cv2.VideoCapture(str(tmp_path / "drawn.mp4"))
    drawn = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        drawn.append(f)
    assert len(drawn) == 4 and drawn[0].shape == HW + (3,)
    got = [f for _, f in V.read_video(str(tmp_path / "drawn.mp4"))]
    assert len(got) == 4
    for g, d in zip(got, drawn):
        np.testing.assert_array_equal(g, d)
    with open(tmp_path / "res" / "alphapose-results.json") as f:
        assert len(json.load(f)) == 4
