"""Write the MPEG-4 video fixtures of the port's video tests.

    python tools/make_video_fixtures.py [--out tests/fixtures/video]

Needs OpenCV with its FFmpeg backend (cv2 writes the clips with
`cv2.VideoWriter` and records what `cv2.VideoCapture` decodes), so it
runs where OpenCV is installed; the files it writes are committed.  Each
clip pans over one of the committed views (`tests/fixtures/images/
views/Camera0*.jpg`, edge-extended) a few pixels a frame, so that the
P-VOPs carry motion vectors (noise would give only I-VOPs):

* MP4 (`isom`) 176x144 and 1920x1080, M4V 180x100 and MOV 176x144, all
  with fourcc `mp4v`;
* AVI with fourccs `FMP4` 180x100, `XVID` 176x144, `DIVX` 180x100 and
  `mp4v` 176x144 (libavcodec's user data marks each stream, so FFmpeg
  decodes them all with its own IDCT);
* two clips of odd sizes, which cv2's writer cannot make (it drops an
  odd last column and row): an MP4 175x99 and an `mp4v` AVI 175x100,
  written by the port's encoder (`mvsmplfitting_tpu_torch.data.mpeg4`)
  with test-mode tools on (every VOP coded).  OpenCV converts odd
  heights to BGR on swscale's scaling path, and odd widths then with
  full chroma.

`decoded.json` records per clip its size, frame count and frame rate as
cv2 reads them, and the sha256 of each frame's BGR array (the default
`cv2.VideoCapture`) and of its Y plane (`CAP_PROP_CONVERT_RGB` 0), so
that the port's reader can be held to OpenCV where OpenCV is not
installed.  Clips already written with other bytes are overwritten; the
run prints which changed.

The H.264 clips (`H264_CLIPS`) are random-syntax streams of
`tools/h264_streams.py` (cv2 here has no H.264 writer; FFmpeg's decoder
is the yardstick): Annex B, MP4 `avc1`/`avc3` with NAL lengths of 4 and 2
bytes, MOV and AVI, at small sizes (175x99 among them) and one
1920x1080 clip coded at 1088 rows, mostly skipped macroblocks.
`decoded_h264.json` records them as `decoded.json` records the MPEG-4
clips.  `--h264` writes only those.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS = os.path.join(ROOT, "tests", "fixtures", "images", "views")

# name: (fourcc, width, height, frames, view, step (dx, dy) a frame)
CLIPS = {
    "mp4v_176x144.mp4": ("mp4v", 176, 144, 30, 0, (3, 2)),
    "mp4v_1920x1080.mp4": ("mp4v", 1920, 1080, 12, 1, (4, -3)),
    "mp4v_180x100.m4v": ("mp4v", 180, 100, 14, 2, (-2, 1)),
    "mp4v_176x144.mov": ("mp4v", 176, 144, 14, 3, (1, 3)),
    "fmp4_180x100.avi": ("FMP4", 180, 100, 26, 4, (5, 1)),
    "xvid_176x144.avi": ("XVID", 176, 144, 14, 5, (-3, -2)),
    "divx_180x100.avi": ("DIVX", 180, 100, 14, 0, (2, 4)),
    "mp4v_176x144.avi": ("mp4v", 176, 144, 14, 1, (-4, 2)),
}
# written by the port's encoder: name: (width, height, frames, view,
# step, test-mode tools)
PORT_CLIPS = {
    "port_175x99.mp4": (175, 99, 13, 2, (2, -1), 255 & ~64),
    "port_175x100.avi": (175, 100, 13, 4, (-3, 1), 1 | 16),
}


# name: (container, Spec fields, the container's size or None); the
# container is "annexb", "avi" (its fourcc), or "mp4" with the sample
# entry and NAL length size.  H.264 crops 4:2:0 pictures to even sizes;
# libavcodec crops further to a container's smaller size (175x99 here).
H264_CLIPS = {
    "h264_cavlc_176x144.h264": (("annexb",), dict(
        width=176, height=144, frames=10, seed=101, refs=2,
        num_ref_active=2, slices=2, pcm=True), None),
    "h264_cabac_175x99.mp4": (("mp4", b"avc1", 4), dict(
        width=176, height=100, frames=10, seed=102, cabac=True, t8=True,
        refs=3, num_ref_active=3, modification=True, mmco=True,
        dbk_offsets=True, poc_type=2, nonref=True, chroma_loc=0),
        (175, 99)),
    "h264_main_180x100.mov": (("mp4", b"avc3", 2), dict(
        width=180, height=100, frames=10, seed=103, cabac=True,
        weighted=True, refs=2, num_ref_active=2, dbk_idc=(0, 2),
        slices=3, poc_type=1, chroma_offsets=True), None),
    "h264_high_176x144.avi": (("avi", b"H264"), dict(
        width=176, height=144, frames=10, seed=104, t8=True,
        scaling="both", refs=2, num_ref_active=2, constrained_intra=True,
        chroma_offsets=True, gaps=True), None),
    "h264_1920x1080.mp4": (("mp4", b"avc1", 4), dict(
        width=1920, height=1080, frames=12, seed=105, cabac=True, t8=True,
        light=True, skip_p=0.85, intra_p=0.02, refs=2, num_ref_active=2),
        None),
}


def write_h264_clip(path: str, container, fields: dict, box) -> None:
    sys.path.insert(0, ROOT)
    from tools import h264_streams as H

    spec = H.Spec(**fields)
    aus = H.write_stream(spec)
    w, h = box or (spec.width, spec.height)
    if container[0] == "annexb":
        H.write_annexb(path, aus, aud=True)
    elif container[0] == "avi":
        H.write_avi(path, aus, w, h, container[1])
    else:
        H.write_mp4(path, aus, w, h, container[1], container[2])


def write_h264_clips(out: str) -> int:
    record = {}
    for name, (container, fields, box) in sorted(H264_CLIPS.items()):
        path = os.path.join(out, name)
        old = open(path, "rb").read() if os.path.exists(path) else None
        tmp = os.path.join(out, "tmp_" + name)
        write_h264_clip(tmp, container, fields, box)
        os.replace(tmp, path)
        if old != open(path, "rb").read():
            print("changed", name)
        bgr, y, fps = cv2_read(path)
        n = fields["frames"]
        w, h = box or (fields["width"], fields["height"])
        assert len(bgr) == n and len(y) == n, (name, len(bgr), len(y))
        assert y[0].shape == (h, w), (name, y[0].shape)
        record[name] = {"container": container[0], "width": w, "height": h,
                        "frames": n, "fps": fps,
                        "bgr_sha256": [sha(f) for f in bgr],
                        "y_sha256": [sha(f) for f in y]}
    with open(os.path.join(out, "decoded_h264.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(out, k)) for k in H264_CLIPS)
    print(f"{len(H264_CLIPS)} H.264 clips, {total} bytes")
    return 0


def write_port_clip(path: str, w: int, h: int, frames: list,
                    tools: int) -> None:
    """`frames` through the port's MPEG-4 encoder in its test mode, into
    an MP4 (`isom`) or an AVI with fourcc `mp4v`, by `path`'s extension."""
    sys.path.insert(0, ROOT)
    from mvsmplfitting_tpu_torch.data.mp4 import Mp4Writer
    from mvsmplfitting_tpu_torch.data.mpeg4 import Mpeg4Encoder
    from mvsmplfitting_tpu_torch.viz.video import AviWriter

    enc = Mpeg4Encoder(w, h, 30.0, tools=tools, seed=w + h)
    with open(path, "wb") as f:
        if path.endswith(".mp4"):
            mux = Mp4Writer(f, b"isom", w, h, enc.res, enc.inc, enc.config())
        else:
            mux = AviWriter(f, w, h, 30.0, b"mp4v")
        for i, fr in enumerate(frames):
            data, key = enc.encode(fr, with_headers=i == 0 and
                                   path.endswith(".avi"))
            mux.write(data, key)
        mux.close()


def clip_frames(width: int, height: int, frames: int, view: int,
                step) -> list:
    """`frames` crops of view `view` panning by `step` pixels a frame
    (the full view, shifted with its edges repeated, at 1920x1080)."""
    import cv2

    img = cv2.imread(os.path.join(VIEWS, f"Camera0{view}.jpg"))
    pad = 64
    big = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    x0 = pad if width == w else (w - width) // 2 + pad
    y0 = pad if height == h else (h - height) // 2 + pad
    out = []
    for i in range(frames):
        x, y = x0 + step[0] * i, y0 + step[1] * i
        out.append(np.ascontiguousarray(big[y:y + height, x:x + width]))
    return out


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_read(path: str):
    """(BGR frames, Y planes, fps) as cv2.VideoCapture reads them."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    bgr = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        bgr.append(f)
    cap.release()
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_CONVERT_RGB, 0])
    y = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        y.append(f)
    cap.release()
    return bgr, y, fps


def main() -> int:
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                  "video"))
    ap.add_argument("--h264", action="store_true",
                    help="write only the H.264 clips")
    args = ap.parse_args()
    out = args.out
    os.makedirs(out, exist_ok=True)
    if args.h264:
        return write_h264_clips(out)
    record = {}
    clips = {**{k: v[:-1] for k, v in PORT_CLIPS.items()},
             **{k: v[1:] for k, v in CLIPS.items()}}
    for name, (w, h, n, view, step) in sorted(clips.items()):
        path = os.path.join(out, name)
        old = open(path, "rb").read() if os.path.exists(path) else None
        tmp = os.path.join(out, "tmp_" + name)
        frames = clip_frames(w, h, n, view, step)
        if name in PORT_CLIPS:
            cc = "mp4v"
            write_port_clip(tmp, w, h, frames, PORT_CLIPS[name][-1])
        else:
            cc = CLIPS[name][0]
            writer = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*cc), 30.0,
                                     (w, h))
            if not writer.isOpened():
                print(f"cv2 cannot write {name}", file=sys.stderr)
                return 1
            for f in frames:
                writer.write(f)
            writer.release()
        os.replace(tmp, path)
        if old != open(path, "rb").read():
            print("changed", name)
        bgr, y, fps = cv2_read(path)
        assert len(bgr) == n and len(y) == n, (name, len(bgr), len(y))
        assert y[0].shape == (h, w), (name, y[0].shape)
        record[name] = {"fourcc": cc, "width": w, "height": h, "frames": n,
                        "fps": fps, "bgr_sha256": [sha(f) for f in bgr],
                        "y_sha256": [sha(f) for f in y]}
    with open(os.path.join(out, "decoded.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(out, k)) for k in clips)
    print(f"{len(clips)} clips, {total} bytes")
    return write_h264_clips(out)


if __name__ == "__main__":
    sys.exit(main())
