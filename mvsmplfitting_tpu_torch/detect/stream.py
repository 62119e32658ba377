"""Streaming detection: a video file or a folder of images -> keypoints
(port of `detect/stream.py`; the reference's `DetectionLoader` and
`DataWriter` / `DataWriterSMPL`, `alphapose/utils/writer*.py`).

Frames are read on the host (`data/video.py` without OpenCV:
Motion-JPEG AVI, MPEG-4 Part 2 in AVI or MP4/M4V/MOV through
`data/mp4.py` and `data/mpeg4.py`, H.264 in AVI, MP4/M4V/MOV or Annex B
through `data/h264.py`; `data/images.py` for a folder),
gathered into chunks of 4, run through the detector as one batch on the
device and through the pose net (or HybrIK) per frame, then written: one
OpenPose JSON per frame (`<out>/<serial>/%06d_keypoints.json`), the
reference's aggregated results file (`pose_nms.write_results_json`) and
a drawn video at 30 fps (`viz/video.py:VideoWriter`: MPEG-4 at a `.mp4`,
`.m4v`, `.mov` or `.avi` name, as cv2's `mp4v` writer writes it, else
JAX's Motion-JPEG fallback at the `.avi` name).  A webcam index (V4L2)
is refused, and so is any other video (H.265, Matroska, H.264 with B
slices, ...), naming the file and the codec, container or tool.  A folder's `.jpg`, `.jpeg`, `.png` and `.bmp` frames
are read as `cv2.imread` reads them (`data/images.py`); a file the
image reader refuses raises naming it (JAX's `cv2.imread` reads it or
skips it).

Each stage is timed by a `utils.profiling.StageTimer`: "demux" and
"decode" (per frame), the detector's and pose net's stages
(`predictor.py`), "json", "results", "draw" and "encode".
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..data.images import read_image
from ..data.video import VideoError, open_video
from ..utils.profiling import StageTimer

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def parse_source(src: str) -> Union[int, str]:
    """A CLI video-source string -> `frame_source`'s argument (digits: a
    webcam index)."""
    return int(src) if isinstance(src, str) and src.isdigit() else src


def check_source(src) -> None:
    """Refuses a source the port cannot read before any net is built:
    a webcam index, a missing path, a video other than Motion-JPEG AVI,
    MPEG-4 Part 2 in AVI or MP4, or H.264 in AVI, MP4 or Annex B."""
    if isinstance(src, int):
        raise VideoError(f"webcam {src}: live capture (V4L2) is not "
                         "supported; pass a video file or a folder of "
                         "images")
    if os.path.isdir(src):
        return
    if not os.path.exists(src):
        raise FileNotFoundError(f"{src}: no such video file or folder")
    open_video(src)


def frame_source(src, max_frames: int = 0,
                 timer: Optional[StageTimer] = None
                 ) -> Iterator[Tuple[int, np.ndarray]]:
    """(frame index, (H, W, 3) uint8 BGR) from a folder of images (sorted
    names, JAX's `frame_source` semantics) or a video file; "demux" times
    the reading of each chunk or sample, "decode" its decoding to BGR."""
    timer = StageTimer() if timer is None else timer
    check_source(src)
    if os.path.isdir(src):
        names = sorted(n for n in os.listdir(src)
                       if n.lower().endswith(IMAGE_SUFFIXES))
        for i, n in enumerate(names):
            if max_frames and i >= max_frames:
                return
            with timer.time("decode"):
                img = read_image(os.path.join(src, n))
            yield i, img
        return
    stream = open_video(src)
    packets, dec = stream.packets(), stream.decoder()
    i = 0
    while not (max_frames and i >= max_frames):
        with timer.time("demux"):
            data = next(packets, None)
        with timer.time("decode"):
            imgs = dec.decode(data) if data is not None else dec.flush()
        for img in imgs:
            if max_frames and i >= max_frames:
                return
            yield i, img
            i += 1
        if data is None:
            return


def open_video_writer(path: str, fps: float, size_wh):
    """The streaming writer (JAX's `open_video_writer`): MPEG-4 at `path`,
    or JAX's Motion-JPEG fallback at the `.avi` name
    (`viz/video.py:writer_target`)."""
    from ..viz.video import VideoWriter
    return VideoWriter(path, fps, size_wh)


def _chunks(src, chunk: int, max_frames: int, timer: StageTimer):
    pending = []
    for idx, img in frame_source(src, max_frames, timer):
        pending.append((idx, img))
        if len(pending) >= chunk:
            yield pending
            pending = []
    if pending:
        yield pending


def _box_xywh(b) -> list:
    return [float(b[0]), float(b[1]), float(b[2] - b[0]),
            float(b[3] - b[1])]


def run_stream(src, detector=None, pose=None, *,
               out_json_dir: Optional[str] = None,
               out_video: Optional[str] = None,
               serial: str = "stream", chunk: int = 4,
               max_frames: int = 0, fps: float = 30.0, draw: bool = True,
               results_dir: Optional[str] = None,
               results_form: Optional[str] = None,
               for_eval: bool = False,
               timer: Optional[StageTimer] = None) -> int:
    """Detect and pose every frame of `src`; write per-frame OpenPose
    JSONs (`<out_json_dir>/<serial>/%06d_keypoints.json`), the
    aggregated results file in `results_dir` (`results_form` None /
    "cmu" / "open", `for_eval` numeric COCO image ids) and the drawn
    video.  Returns the number of frames processed."""
    from ..data.keypoints import save_keypoints_json
    from ..viz.overlay import draw_keypoints
    from .predictor import PersonDetector, PoseEstimator, rgb01

    timer = StageTimer() if timer is None else timer
    detector = detector or PersonDetector()
    pose = pose or PoseEstimator()
    dev = detector.device
    writer = None
    n = 0
    all_results = []
    try:
        for pending in _chunks(src, chunk, max_frames, timer):
            imgs = [torch.from_numpy(im).to(dev) for _, im in pending]
            boxes_per = detector.detect_batch(imgs, timer)
            for (idx, img), dimg, boxes in zip(pending, imgs, boxes_per):
                with timer.time("crop") as box:
                    image = rgb01(dimg)
                    box["sync"] = image
                kps = pose.estimate(image, boxes, timer)      # (P, J, 3)
                if out_json_dir is not None:
                    with timer.time("json"):
                        save_keypoints_json(os.path.join(
                            out_json_dir, serial,
                            f"{idx:06d}_keypoints.json"), kps)
                if results_dir is not None:
                    frame_res = []
                    for k in range(len(kps)):
                        s = kps[k, :, 2]
                        b = (boxes[k] if k < len(boxes)
                             else np.zeros(5, np.float32))
                        bs = float(b[4]) if len(b) > 4 else 1.0
                        frame_res.append({
                            "keypoints": kps[k, :, :2], "kp_score": s,
                            # `writer.py:update`'s proposal formula
                            "proposal_score": float(s.mean() + bs
                                                    + 1.25 * s.max()),
                            "box": _box_xywh(b), "idx": k})
                    all_results.append({"imgname": f"{idx:06d}.jpg",
                                        "result": frame_res})
                if out_video is not None:
                    with timer.time("draw"):
                        frame = img.copy()
                        if draw:
                            for person in kps:
                                draw_keypoints(frame, person)
                    if writer is None:
                        h, w = frame.shape[:2]
                        writer = open_video_writer(out_video, fps, (w, h))
                    with timer.time("encode"):
                        writer.write(frame)
                n += 1
    finally:
        if writer is not None:
            writer.release()
    if results_dir is not None:
        from .pose_nms import write_results_json
        with timer.time("results"):
            write_results_json(all_results, results_dir, form=results_form,
                               for_eval=for_eval)
    return n


def shear_to_pinhole(verts: np.ndarray, focal: float, scale_w: float,
                     center: np.ndarray, img_center: np.ndarray,
                     input_size: float) -> np.ndarray:
    """One person's camera-frame mesh seen by its weak-perspective crop
    camera (focal f_p = f0 * scale_w / input_size, the crop's center),
    folded into the one pinhole (f0, image center) of the frame by the
    exact shear X' = X f_p / f0 + Z (c_p - c_img) / f0; depths are kept,
    so the frame's depth-sorted render keeps occlusion between people."""
    v = verts.astype(np.float64)
    fp = focal * scale_w / input_size
    off = (center - img_center) / focal
    xy = v[:, :2] * (fp / focal) + v[:, 2:3] * off[None, :]
    return np.concatenate([xy, v[:, 2:3]], axis=1)


def run_stream_smpl(src, detector=None, smpl=None, *,
                    out_json: Optional[str] = None,
                    out_video: Optional[str] = None, chunk: int = 4,
                    max_frames: int = 0, fps: float = 30.0,
                    render: bool = True, draw_skeleton: bool = False,
                    timer: Optional[StageTimer] = None) -> int:
    """Streaming direct SMPL regression (the reference's `DataWriterSMPL`):
    detect people per frame, regress SMPL bodies with HybrIK, write one
    results JSON (the writer's keys: keypoints, pred_xyz_jts, kp_score,
    proposal_score, bbox_score, idx, box, crop_box) and an overlay video
    with each frame's meshes in one depth-sorted render
    (`viz/overlay.render_multiperson_overlay`).  Returns the number of
    frames processed."""
    from ..viz.overlay import render_multiperson_overlay
    from ..viz.skeletons import vis_frame
    from .predictor import PersonDetector, SmplPoseEstimator, rgb01

    timer = StageTimer() if timer is None else timer
    detector = detector or PersonDetector()
    smpl = smpl or SmplPoseEstimator()
    dev = detector.device
    f0 = smpl.focal_length
    in_h = float(smpl.input_hw[0])
    writer = None
    n = 0
    results = []
    try:
        for pending in _chunks(src, chunk, max_frames, timer):
            imgs = [torch.from_numpy(im).to(dev) for _, im in pending]
            boxes_per = detector.detect_batch(imgs, timer)
            for (idx, img), dimg, boxes in zip(pending, imgs, boxes_per):
                with timer.time("crop") as box:
                    image = rgb01(dimg)
                    box["sync"] = image
                out = smpl.estimate(image, boxes, timer)
                frame_res = []
                for k in range(len(out["proposal_score"])):
                    b = boxes[k]
                    cx, cy = out["centers"][k]
                    sw, sh = out["scales"][k]
                    frame_res.append({
                        "keypoints": out["keypoints"][k].tolist(),
                        "pred_xyz_jts": out["pred_xyz_jts"][k].tolist(),
                        "kp_score": out["kp_score"][k].tolist(),
                        "proposal_score": float(out["proposal_score"][k]),
                        "bbox_score": float(b[4]) if len(b) > 4 else 1.0,
                        "idx": k,
                        "box": _box_xywh(b),             # `writer_smpl.py:134-137`
                        "crop_box": [float(cx - sw / 2), float(cy - sh / 2),
                                     float(sw), float(sh)]})
                results.append({"imgname": f"{idx:06d}.jpg",
                                "result": frame_res})
                if out_video is not None:
                    with timer.time("draw"):
                        frame = img.copy()
                        P = len(out["verts"])
                        if P and render:
                            h, w = frame.shape[:2]
                            cimg = np.array([w / 2.0, h / 2.0])
                            sheared = [shear_to_pinhole(
                                out["verts"][k], f0, out["scales"][k][0],
                                out["centers"][k], cimg, in_h)
                                for k in range(P)]
                            frame = render_multiperson_overlay(
                                frame, sheared, smpl.faces, np.eye(3),
                                np.zeros(3), np.array([f0, f0]), cimg)
                        if draw_skeleton:
                            for k in range(P):
                                vis_frame(frame, out["keypoints"][k],
                                          out["kp_score"][k][:, 0],
                                          fast=True)
                    if writer is None:
                        h, w = frame.shape[:2]
                        writer = open_video_writer(out_video, fps, (w, h))
                    with timer.time("encode"):
                        writer.write(frame)
                n += 1
    finally:
        if writer is not None:
            writer.release()
    if out_json is not None:
        with timer.time("results"):
            os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
            with open(out_json, "w") as f:
                json.dump(results, f)
    return n
