"""Keypoint-prediction CLI (port of `cli/keypoints.py`; the reference's
`code/keypoint_predict.py`).

Walks `<data_folder>/images/<serial>/<CameraXX>/*.jpg|png`, runs the
detector and the pose net for each frame across all cameras, and writes
`<data_folder>/keypoints/<serial>/<CameraXX>/<frame>_keypoints.json` in
the OpenPose format that `mvsmplfitting_tpu_torch.cli.main` reads:

    python -m mvsmplfitting_tpu_torch.cli.keypoints --data_folder <dir> \
        [--yolox_ckpt x.pth.tar] [--pose_ckpt y.pth] [--device cuda|cpu]

The nets run on `--device` (CUDA unless ``--device cpu``; no fall back
to the CPU).  Without checkpoints they run on weights made from seed 0
(pipeline smoke tests only: the detections mean nothing).  Video input
(`--video`), SMPL regression (`--smpl`) and AlphaPose config files
(`--pose_cfg`) are not ported yet (ROADMAP queue A item 11b): the CLI
stops on them before it loads anything.
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
        description="Images to OpenPose keypoint JSONs on one GPU "
                    "(PyTorch/CUDA)")
    p.add_argument("--data_folder", default=None,
                   help="holds images/<serial>/<cam> (offline mode)")
    p.add_argument("--video", default=None,
                   help="streaming input (not ported yet)")
    p.add_argument("--out_video", default=None,
                   help="streaming mode only")
    p.add_argument("--results_dir", default=None,
                   help="streaming mode only")
    p.add_argument("--results_form", default=None, choices=["cmu", "open"],
                   help="streaming mode only")
    p.add_argument("--for_eval", action="store_true",
                   help="streaming mode only")
    p.add_argument("--max_frames", type=int, default=0,
                   help="streaming mode only")
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
                   help="AlphaPose model-config YAML (not ported yet)")
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
                   help="run both nets in bfloat16")
    p.add_argument("--smpl", action="store_true",
                   help="direct SMPL regression (not ported yet)")
    p.add_argument("--smpl_ckpt", default=None,
                   help="HybrIK checkpoint (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the nets (default cuda; 'cpu' "
                        "runs them on the CPU)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    pending = [("--video", args.video is not None,
                "video input needs video decoding without cv2 "
                "(detect/stream.py)"),
               ("--smpl", args.smpl or args.smpl_ckpt is not None,
                "SMPL regression needs HybrIK (detect/hybrik.py)"),
               ("--pose_cfg", args.pose_cfg is not None,
                "AlphaPose config files need the nested-YAML reader "
                "(detect/config.py)")]
    for flag, given, why in pending:
        if given:
            raise NotImplementedError(
                f"{flag}: not ported yet (ROADMAP queue A item 11b): {why}")


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
    `detect/predictor.py`) and `stats` one record per view (candidate
    and kept boxes, NMS seconds, people written) when given."""
    args = parse_args(argv)
    _refuse_unported(args)
    if args.data_folder is None:
        raise SystemExit("--data_folder is required")

    from ..detect.predictor import (KeypointPipeline, PersonDetector,
                                    PoseEstimator)
    from ..detect.preprocess import flip_pairs_for
    from ..detect.weights import load_checkpoint
    from ..detect.zoo import build_pose_model
    from ..device import resolve_device

    device = resolve_device(args.device)
    det_sd = load_checkpoint(args.yolox_ckpt) if args.yolox_ckpt else None
    detector = PersonDetector(det_sd, conf_thresh=args.det_thresh,
                              bf16=args.bf16, device=device)
    model = build_pose_model(args.pose_model, args.num_joints)
    pose_sd = load_checkpoint(args.pose_ckpt) if args.pose_ckpt else None
    est_kw = {}
    if args.format:
        est_kw["joint_pairs"] = flip_pairs_for(args.num_joints, args.format)
    pose = PoseEstimator(pose_sd, num_joints=args.num_joints,
                         flip_test=args.flip_test,
                         use_pose_nms=args.pose_nms, bf16=args.bf16,
                         model=model, device=device, **est_kw)
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
