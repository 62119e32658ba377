"""Keypoint-prediction CLI (port of `cli/keypoints.py`; the reference's
`code/keypoint_predict.py`).

Walks `<data_folder>/images/<serial>/<CameraXX>/*.jpg|png`, runs the
detector and the pose net for each frame across all cameras, and writes
`<data_folder>/keypoints/<serial>/<CameraXX>/<frame>_keypoints.json` in
the OpenPose format that `mvsmplfitting_tpu_torch.cli.main` reads:

    python -m mvsmplfitting_tpu_torch.cli.keypoints --data_folder <dir> \
        [--yolox_ckpt x.pth.tar] [--pose_ckpt y.pth] [--device cuda|cpu]

The other modes, as JAX's flow (`cli/keypoints.py:83-174`):

* ``--video <clip.mp4 | clip.avi | clip.h264 | folder> [--out_video v.mp4]
  [--results_dir d
  --results_form cmu|open --for_eval] [--max_frames N]``: the streaming
  mode (`detect/stream.py:run_stream`), one JSON per frame under
  `<data_folder>/keypoints/stream/` (`./keypoints/stream/` without
  `--data_folder`);
* ``--video ... --smpl [--smpl_ckpt h.pth]``: HybrIK's SMPL regression
  (`run_stream_smpl`), `<data_folder or .>/smpl-results.json` and a mesh
  overlay video;
* ``--pose_cfg <AlphaPose YAML>``: the pose net, its crop size, joint
  count and flip pairs from the reference's config file, read once;
  ``--pose_model hrnet|hardnet|...`` picks a zoo net by name.

The nets run on `--device` (CUDA unless ``--device cpu``; no fall back
to the CPU).  Without checkpoints they run on weights made from seed 0
(pipeline smoke tests only: the detections mean nothing).  Checkpoints
load in the reference's names.  A webcam index, a video other than
Motion-JPEG AVI, MPEG-4 Part 2 in AVI or MP4/M4V/MOV, or H.264 (I and P
slices) in AVI, MP4/M4V/MOV or Annex B, `--smpl` without `--video` and a
config the zoo cannot build are refused before any net is built (an
H.264 tool outside the port's, such as B slices, when its picture is
reached).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

from ..utils.profiling import StageTimer


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Images or video to keypoint JSONs on one GPU "
                    "(PyTorch/CUDA)")
    p.add_argument("--data_folder", default=None,
                   help="holds images/<serial>/<cam> (offline mode)")
    p.add_argument("--video", default=None,
                   help="streaming mode: a video (MPEG-4 Part 2 in MP4, "
                        "M4V, MOV or AVI; H.264 in MP4, M4V, MOV, AVI or "
                        "Annex B; Motion-JPEG AVI) or a folder of images "
                        "(detect/stream.py)")
    p.add_argument("--out_video", default=None,
                   help="streaming mode: the drawn video, as cv2's mp4v "
                        "writer writes it: MPEG-4 at a .mp4/.m4v/.mov/.avi "
                        "name, else Motion-JPEG at the .avi name")
    p.add_argument("--results_dir", default=None,
                   help="streaming mode: also write the aggregated "
                        "alphapose-results.json here")
    p.add_argument("--results_form", default=None, choices=["cmu", "open"],
                   help="aggregated results format (default: the "
                        "alphapose-results.json list)")
    p.add_argument("--for_eval", action="store_true",
                   help="numeric COCO image ids in the results file")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--img_folder", default="images")
    p.add_argument("--keyp_folder", default="keypoints")
    p.add_argument("--yolox_ckpt", default=None,
                   help="the reference's YOLOX-X checkpoint "
                        "(bytetrack_x_mot17.pth.tar)")
    p.add_argument("--pose_ckpt", default=None,
                   help="the reference's pose checkpoint "
                        "(fast_res50_256x192.pth)")
    p.add_argument("--det_thresh", type=float, default=0.1)
    p.add_argument("--pose_model", default="fastpose",
                   help="pose zoo net (detect/zoo.py)")
    p.add_argument("--pose_cfg", default=None,
                   help="AlphaPose model-config YAML (the reference's "
                        "configs/**/*.yaml, read by detect/config.py); "
                        "overrides --pose_model/--num_joints")
    p.add_argument("--num_joints", type=int, default=26)
    p.add_argument("--flip_test", action="store_true",
                   help="mirrored-batch heatmap ensembling")
    p.add_argument("--format", default=None,
                   help="keypoint format of the flip-test pairs (skeleton "
                        "registry: halpe26, halpe136, ...); default the "
                        "reference predictor's COCO-17 pairs whatever the "
                        "joint count (`alphapose_core.py:249-253`)")
    p.add_argument("--pose_nms", action="store_true",
                   help="parametric pose NMS for crowded scenes")
    p.add_argument("--bf16", action="store_true",
                   help="run the nets in bfloat16 (HybrIK's IK stays fp32)")
    p.add_argument("--smpl", action="store_true",
                   help="streaming mode: direct SMPL regression (HybrIK) "
                        "with a mesh-overlay video and smpl-results.json "
                        "(the reference's writer_smpl.py)")
    p.add_argument("--smpl_ckpt", default=None,
                   help="HybrIK checkpoint (weights from seed 0 if absent)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the nets (default cuda; 'cpu' "
                        "runs them on the CPU)")
    return p.parse_args(argv)


def frames_of(img_root: str):
    """(serial, frame file, [(camera, path), ...]) for each frame, in
    sorted order, as JAX's walk (`cli/keypoints.py:158-175`)."""
    for serial in sorted(os.listdir(img_root)):
        sdir = os.path.join(img_root, serial)
        if not os.path.isdir(sdir):
            continue
        cams = sorted(d for d in os.listdir(sdir)
                      if os.path.isdir(os.path.join(sdir, d)))
        frames: Dict[str, list] = {}
        for cam in cams:
            for fn in sorted(os.listdir(os.path.join(sdir, cam))):
                if fn.lower().endswith((".jpg", ".png")):
                    frames.setdefault(fn, []).append(
                        (cam, os.path.join(sdir, cam, fn)))
        for fn, entries in sorted(frames.items()):
            yield serial, fn, entries


def main(argv=None, timer: Optional[StageTimer] = None,
         stats: Optional[List[Dict]] = None) -> int:
    """Run the CLI; `timer` collects each stage's seconds (see
    `detect/predictor.py`, `detect/stream.py`) and `stats` one record per
    view (candidate and kept boxes, NMS seconds, people written) in the
    offline mode, when given.  The video source, the pose config and the
    mode's flags are checked before any net is built."""
    args = parse_args(argv)
    timer = StageTimer() if timer is None else timer
    if args.video is None and (args.smpl or args.smpl_ckpt):
        raise SystemExit("--smpl/--smpl_ckpt need --video (streaming mode)")
    if args.video is None and args.data_folder is None:
        raise SystemExit("--data_folder or --video is required")

    from ..detect.predictor import (KeypointPipeline, PersonDetector,
                                    PoseEstimator)
    from ..detect.preprocess import flip_pairs_for
    from ..detect.weights import load_checkpoint
    from ..device import resolve_device

    source = None
    if args.video is not None:
        from ..detect.stream import check_source, parse_source
        source = parse_source(args.video)
        check_source(source)
    est_kw = None             # the pose net's arguments (not for --smpl)
    if args.pose_cfg and not args.smpl:
        # Parsed once: the estimator's arguments and the net both come
        # from this one read.
        from ..detect.config import estimator_kwargs_from_config
        est_kw = estimator_kwargs_from_config(args.pose_cfg)
    elif not args.smpl:
        from ..detect.zoo import build_pose_model
        est_kw = {"num_joints": args.num_joints,
                  "model": build_pose_model(args.pose_model,
                                            args.num_joints)}

    device = resolve_device(args.device)
    det_sd = load_checkpoint(args.yolox_ckpt) if args.yolox_ckpt else None
    detector = PersonDetector(det_sd, conf_thresh=args.det_thresh,
                              bf16=args.bf16, device=device)

    if args.smpl:
        from ..detect.predictor import SmplPoseEstimator
        from ..detect.stream import run_stream_smpl
        smpl_sd = load_checkpoint(args.smpl_ckpt) if args.smpl_ckpt else None
        out_dir = args.data_folder or "."
        start = time.time()
        n = run_stream_smpl(
            source, detector,
            SmplPoseEstimator(smpl_sd, bf16=args.bf16, device=device),
            out_json=os.path.join(out_dir, "smpl-results.json"),
            out_video=args.out_video, max_frames=args.max_frames,
            timer=timer)
        print(f"Processed {n} frame(s) in {time.time() - start:.2f}s")
        return 0

    pose_sd = load_checkpoint(args.pose_ckpt) if args.pose_ckpt else None
    if args.format:
        est_kw["joint_pairs"] = flip_pairs_for(est_kw["num_joints"],
                                               args.format)
    pose = PoseEstimator(pose_sd, flip_test=args.flip_test,
                         use_pose_nms=args.pose_nms, bf16=args.bf16,
                         device=device, **est_kw)

    if source is not None:
        from ..detect.stream import run_stream
        out_dir = (os.path.join(args.data_folder, args.keyp_folder)
                   if args.data_folder else "keypoints")
        start = time.time()
        n = run_stream(source, detector, pose, out_json_dir=out_dir,
                       out_video=args.out_video, max_frames=args.max_frames,
                       results_dir=args.results_dir,
                       results_form=args.results_form,
                       for_eval=args.for_eval, timer=timer)
        print(f"Processed {n} frame(s) in {time.time() - start:.2f}s")
        return 0

    pipeline = KeypointPipeline(detector, pose, timer=timer)
    img_root = os.path.join(args.data_folder, args.img_folder)
    keyp_root = os.path.join(args.data_folder, args.keyp_folder)
    start = time.time()
    n = 0
    for serial, fn, entries in frames_of(img_root):
        cam_names = [c for c, _ in entries]
        paths = [pth for _, pth in entries]
        first = len(pipeline.stats)
        pipeline.process_images(paths, keyp_root, serial, cam_names)
        n += 1
        people = ",".join(str(s["people"])
                          for s in pipeline.stats[first:])
        print(f"{serial}/{fn}: {len(paths)} views, people {people}")
    dt = time.time() - start
    if stats is not None:
        stats.extend(pipeline.stats)
    print(f"Processed {n} frame(s) in {dt:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
