"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device and environment: torch version, card name and power limit,
     TF32 off;
  2. build: the four CUDA sources of `mvsmplfitting_tpu_torch/csrc` with
     nvcc for sm_90a, one process each, all at once, with the seconds it
     took and, per kernel, ptxas's registers, spill bytes and static
     shared memory;
  3. kernels at B=512, the batched fit's batch, and at the batches the
     collision fits call them with (B=8 for [collide], B=2 for [multi]'s
     two people): each kernel against its plain PyTorch version on the
     card (joint Jacobian for smpl and smpllsp at RTOL 3e-5 / ATOL 1e-5;
     VPoser tail at z~N(0,0.6) and z~N(0,1e-3), aa at 3e-5 / 1e-5, D at
     3e-4 / 3e-4 max|D|), with device times per call (CUDA events around
     queued calls; the tail's is the larger of its two batches) and
     bounds;
  4. short fit parity: an 8-frame batched fit (init + 4 stages, chol,
     classic LM, 3 iterations) on the card and on the CPU plain path,
     stage losses at rtol 1e-3;
  5. the slice at full width: `batched_fit_frames` on 512 distinct
     synthetic frames (6 views, smpl, library defaults, max_iters=40),
     launch counters reset just before and read just after;
  6. [sdf] the three voxelizer kernels on two posed synthetic bodies
     (VPoser z ~ N(0, 0.8)), normalized as `person_grids` does:
     at G=64 and G=128 the brute force bitwise equal to the plain
     `sdf_grid` on the card and the two-phase result bitwise equal to
     the brute force; then the eight-body shape that [collide] voxelizes
     (one launch, G=128), two-phase bitwise equal to brute force; each
     kernel's work list holding its inside voxels; per shape the device
     times per call of the brute force's two passes and whole call, of
     phase A, phase B and the whole two-phase wrapper, the pairs that
     passed the brute force's pre-test, the admitted pairs per voxel,
     the phase-B groups and their visits, and bounds from the pairs each
     kernel evaluates (and the brute force's first design's, over all
     pairs, as `bound_all_pairs_ms`);
  7. [collide] the single-person fit with the collision term
     (`batched_fit_frames`, coll weights (0, 0, 1000, 4500), G=128, 8
     frames, library defaults, max_iters=40, as the [fit] phase), then
     card-vs-CPU parity on 2 frames at G=16: a fit through the first
     collision stage (1 chol iteration per stage at init_lambda 1.0,
     stage losses at rtol 1e-3) and one collision-stage linearization
     (grids: the same inside set, atol 1e-5; rows rtol 1e-5, J.v rtol
     1e-4, energy rtol 1e-5);
  8. [multi] `fit_people` with the grid engine and the hybrid schedule
     on the two-person fixture (dx0=0.2) at G=128 with the weights of
     `cfg_files/fit_multi_person_sdf.yaml` and `session.py`'s LM defaults
     (max_iters=60): collision sums after the solo fits and after the
     refinement (which must be lower), voxelizer launches and event-timed
     seconds; then card-vs-CPU parity at G=16 (2 stages of 3 chol
     iterations at init_lambda 1.0, 1 lagged + 1 exact refinement
     iteration; losses at rtol 1e-2, sums at rtol 5e-2);
  9. [points] `fit_people` with the points engine at JAX's defaults (15
     refinement iterations annealed over the collision stages, two
     starts) on the same fixture under JAX's quality-test configuration
     (library stage weights, max_iters=40), once with the forward-mode
     refinement Jacobian and once with the analytic one: wall, field
     evaluations with their host and event-timed seconds, per-person
     losses and reprojection errors, collision sums before and after;
     `tests/test_multi_person.py:244-271`'s bounds (sums to <= 5% of the
     solo fits', mean px <= 3.25 and each <= 4.25; the just-clear pair
     dx0=0.26 untouched: sums <= 1e-6, px <= 0.75); the field on the
     card against the CPU on the refined bodies and against B4 at G=64
     voxel centers (the same inside set, atol 1e-5, differing points
     counted); a short points fit on the card against the CPU (losses
     rtol 1e-2, sums 5e-2);
 10. [fused] the [fit] problem with `FitConfig.fused` (all stages in one
     LM loop): frames/s and the share of frames whose final loss is
     within rtol 0.1 of [fit]'s; an 8-frame fused fit (chol, classic)
     on the card against the CPU, stage losses at rtol 1e-3;
 11. [lbfgs] `batched_fit_frames` with the strong-Wolfe L-BFGS parity
     solver as `session.py` maps `cfg_files/fit_smpl_lbfgs_parity.yaml`
     (smpllsp, VPoser, l2, no collision, 120 iterations per stage,
     history 16, 25 line-search steps) on `B_LBFGS` frames (8, cut from
     512, see there): frames/s, per stage the iterations and objective
     evaluations (min/median/max over frames) and the batched
     evaluations, the median final loss; no kernel launches (the
     gradient is one reverse pass through the plain joint model, as
     JAX's `value_and_grad`); an 8-frame fit (3 iterations per stage) on
     the card against the CPU at rtol 1e-3;
 12. [grad] adam on 512 frames (lr 1e-2, 150 steps per stage, JAX's
     `tests/test_fitting.py:248-266`): every frame's final loss below its
     last-stage energy at the start; no kernel launches;
 13. [gmm] `init_guess` + `fit_frame` on 512 frames without VPoser and
     with the GMM pose prior (`random_gmm`: 8 components x 69), body_pose
     from [1]*6 + [0]*63 as `cli/main.py:293-298`, LM library defaults
     with 40 iterations: B1 launches >= LM iterations, B2 none; an
     8-frame fit (chol, classic) on the card against the CPU at rtol
     1e-3;
 14. [seq] 512 sequences of 4 steps in lockstep (`synthetic.
     make_sequence`, smpllsp, VPoser, `cfg_files/fit_seq.yaml`'s
     weights, `is_seq`): step 0 from scratch, each later step through
     `warm_start` and `fit_frame(seq_start=False)` (2 stages); per step
     frames/s and the share of frames that took the previous solution;
     B1 and B2 launch on every step;
 15. [adjust] `refit_with_observations` on [fit]'s result against
     keypoints of each body moved +8 cm in x (`tests/test_misc.py:51-79`):
     the translation moves by (0.08, 0, 0) within 0.02 on >= 95% of the
     frames;
 16. [smplx] `batched_fit_frames` on 512 frames of synthetic SMPL-X
     (10475 vertices, 55 joints, OpenPose BODY_25, the truth with hand
     PCA, expression and jaw) with `EnergySpec(hand_dim=6, num_expr=10,
     opt_face=True)` (80 unknowns), VPoser, the library anneal and LM
     with max_iters=40 (`tests/test_smplx_family.py:225-277`): frames/s,
     median loss and reprojection px (< 8), peak device memory, no
     kernel launches (the AD Jacobian, as in JAX); an 8-frame fit (4
     stages of 3 chol iterations) on the card against the CPU at rtol
     1e-3;
 17. [smplh] the same on 64 frames of SMPL-H (coco17) with
     `hand_dim=6` and max_iters=30 (`tests/test_smplx_family.py:
     280-322`): median reprojection px < 6, card against the CPU;
 18. [schur] `schur_sequence_fit` on one person's 512-frame sequence
     (`synthetic.make_person_sequence`: shared betas, scale 1.15), smpl
     with the joint model, VPoser, LM max_iters=40, 4 stages: frames/s,
     LM iterations per stage, the shared scale within rtol 0.05 and the
     betas within atol 0.6 of the truth (`tests/test_schur.py:81-91`),
     B1 and B2 launched at least once per LM iteration; an 8-frame
     sequence (4 stages of 3 chol iterations) on the card against the
     CPU, per-frame losses at rtol 1e-3, the shared block at rtol 1e-3
     and atol 1e-4 (betas near 0);
 19. [shard] the camera- and frame-sharded fits over torch.distributed
     (`mvsmplfitting_tpu_torch.parallel`) on [fit]'s fixture cut to
     `B_SHARD` (64) distinct frames, 6 views, smpl, the bundled VPoser,
     `LMOptions` defaults: (a) a world of 1 in this process on NCCL (mesh
     1x1), `camera_sharded_fit` with its per-stage cap at 3 and at 40
     LM iterations, the yardstick; (b) two ranks spawned on this card
     with gloo, mesh 1x2 (3 views each); (c) four ranks, mesh 2x2.  For
     each rank of (b) and (c): losses against (a) at rtol 5e-2 after 3
     iterations and 1e-3 after 40 (`__graft_entry__.py:186-190`), finite
     and not all equal, B1 and B2 launches >= the rank's LM iterations.
     Then on the two ranks (mesh 2x1) `batched_fit_frames(mesh=)`
     against the one-card fit (losses rtol 1e-2,
     `tests/test_parallel.py:74-76`) and `schur_sequence_fit(mesh=)` on
     a 64-frame sequence against the one-card one (shared block atol
     0.15, losses rtol 0.3, `tests/test_schur.py:110-113`), all at
     max_iters=40.  Per run and rank: wall, LM iterations per stage,
     collectives, floats all-reduced per iteration and per call, host
     seconds inside the collectives (the card synchronized around each)
     and their share of the wall, and the launches; the spawned worlds'
     start-to-end seconds.  A rank's exception fails the phase;
     collectives time out after `SHARD_TIMEOUT_S`;
 20. [cli] the fitting CLI (`mvsmplfitting_tpu_torch.cli.main`) on
     workspaces in the reference's layout (`synthetic.write_workspace`):
     `cfg_files/fit_batched.yaml` (`save_images: false`) on 128
     frames x 6 views in this process (B1 and B2 launches >= the LM
     iterations, 128 pkls with the reference's keys and shapes and 128
     meshes of 6890 vertices, median reprojection px < 2, the pkls equal
     to `batched_fit_frames` on the same session's observations at rtol
     1e-5 or the spread of two library calls if that is larger, the
     dumped `conf.yaml` read back equal; the session, read, fit and write
     seconds, frames/s and the keypoint loader's route);
     `cfg_files/fit_seq.yaml` on 4 frames of a sequence through a
     subprocess with `--no_save_images` (frames 1-3 warm-started;
     per-frame seconds and px), then again with `--resume` (all frames
     skipped, no file touched); `cfg_files/fit_multi_person_sdf.yaml` on
     one frame of the two-person fixture (dx0=0.2) with its overlays
     (`save_overlays_multi` at 1920x1080, six files): one pkl per person
     in the truth's x order, the refined collision sums below the solo
     fits';
 21. [keypoints] the keypoint CLI (`mvsmplfitting_tpu_torch.cli.
     keypoints`) at full width: the image reader against OpenCV's
     recorded decodes of `tests/fixtures/images` (sha256: baseline and
     progressive JPEG, plain, Adam7 and eXIf-turned PNG, BMP; the
     incomplete progressive JPEG and the RLE8 BMP refused), the host
     decode ms of a 1920x1080 baseline and progressive 4:2:0 view;
     YOLOX-X
     (800x1440) and FastPose (256x192, 26 joints) checkpoints in the
     reference's names from seed 0 (YOLOX's BaseConv convolutions at
     half gain, box-size biases + log 6, the objectness bias shifted to
     ~8 candidates a view at `--det_thresh` 0.1; bfloat16 takes the
     threshold that passes as many); 4 frames x the six 1920x1080
     fixture views, fp32 and `--bf16`, each run twice and the second
     reported: per-stage seconds (`StageTimer`; the nets' forwards also
     by CUDA events), frames/s of the whole CLI (net builds and
     checkpoint loads included) and of its frame loop, peak memory, candidate and kept boxes
     and NMS host ms per view, conv FLOPs counted from the modules'
     shapes and the share of the fp32 (67 TFLOP/s) or bf16 (989) peak;
     every JSON written and read back by the fitting dataset; no B1-B4
     launch; `--bf16` on one frame whose views are a progressive JPEG, a
     BMP of view 1 and four baseline JPEGs (views 1-5 against the bf16
     run's frame 0, the largest difference reported);
     `python -m mvsmplfitting_tpu_torch.cli.keypoints` in a
     subprocess with its default device, its JSONs against the
     in-process fp32 run's (the same people; the largest difference
     reported); the detector's 6-view forward with and without cuDNN's
     autotuner (information); view 0 on the card against the CPU
     (decoded boxes rtol/atol 1e-3, heatmaps on the same crops atol
     1e-4, keypoints equal to 1e-3 px wherever the heatmap's top-two
     margin and neighbour differences exceed 1e-4) and bfloat16 against
     fp32 (heatmaps within 5% of their magnitude, keypoints within 8 px
     where the fp32 peak clears twice bfloat16's change);
 22. [overlay] the overlays and the adjustment GUI, on the host beside
     the card: (a) `viz/draw.py`'s primitives (342 recorded cv2 calls in
     17 groups) and `fill_faces` (393 triangles) against OpenCV's
     sha256 (`tests/fixtures/overlay/golden.json`); (b) `encode_jpeg` on
     the six 1920x1080 fixture views at quality 95 and 80 against
     `cv2.imencode`'s sha256; (c) `render_mesh_overlay` of the committed
     body (6890 vertices, 13776 faces) with the committed face order on
     `Camera00.jpg` against JAX's sha256, and this host's projection and
     shading against the recorded ones (numpy's BLAS must round as the
     fixture's); (d) `cfg_files/fit_smpl_demo.yaml` as shipped
     (`save_images: true`) through the CLI on the card, on 4 frames whose
     six views are the fixture JPEGs: 24 overlays at
     `images/<serial>/<frame>/<v:02d>.jpg`, each read back with more than
     1000 pixels changed by over 32 levels, the per-view seconds of read,
     projection and sort, `fill_faces`, blend and encode, and the
     overlays' share of the CLI's wall; (f) `cli.adjust_gui` on that
     workspace, served on 127.0.0.1 in this process: `/`, `/api/state`
     (six 640x360 JPEGs), a keypoint moved 8 px, `/api/refit`,
     `/api/state` and `/api/save`, with the first fit's, the state's and
     the refit's seconds, the losses and the B1/B2 launches; (g)
     `AdjustApp.state()` on a 1280x720 progressive view (scale exactly
     0.5, OpenCV's INTER_AREA halving), the app built without a session
     on the committed body: the served JPEG against the sha256 of
     cv2's `imencode(resize(render, fx=fy=0.5), q80)`;
 23. [stream] the keypoint CLI's other modes at full width, with
     `keypoint_weights`' YOLOX-X and FastPose checkpoints: (a) the six
     fixture JPEGs muxed into a Motion-JPEG AVI as written and with
     their DHT segments stripped, every frame read back equal (sha256)
     to `read_image` of its JPEG, demux and decode ms a frame, an HEVC
     fourcc refused naming the file; (b) `--video` on a 12-frame clip of
     those views with `--out_video` and `--results_dir`: frames/s, the
     per-stage seconds a frame (demux, decode, the nets' stages, json,
     draw, encode, results), 12 JSONs read back by the fitting data
     layer's reader, the results file (one entry a person) and the drawn
     video (Motion-JPEG: `--out_video drawn.webm`, JAX's fallback name)
     re-read (12 frames); (e) `--video` on a folder of a baseline JPEG, a
     progressive JPEG and a 24-bit BMP frame, each read to
     `read_image`'s sha256, 3 JSONs; (f) MPEG-4 Part 2: every committed
     clip of `tests/fixtures/video` (cv2's `mp4v` in MP4/M4V/MOV, `FMP4`,
     `XVID`, `DIVX` and `mp4v` AVIs) decoded to cv2's recorded sha256;
     the 1920x1080 MP4's demux, decode and BGR conversion ms a frame, 6
     of its frames through the encoder (ms a frame, bytes); `--video
     clip.mp4 --out_video drawn.mp4` on it: frames/s, per-stage seconds,
     12 JSONs, the drawn MP4 re-read by the port (12 frames); no B1-B4
     launch; (g) H.264: every committed clip of `tests/fixtures/video`
     (`decoded_h264.json`: Annex B, MP4 `avc1`/`avc3`, MOV, AVI; CAVLC
     and CABAC; 175x99 through the MP4's size) decoded to cv2's recorded
     sha256; the 1920x1080 MP4's (coded 1088) demux, decode and BGR ms a
     frame; `--video clip.mp4 --out_video drawn.mp4` on it: frames/s over
     the loop and the wall, per-stage seconds, 12 JSONs, the drawn MP4
     re-read (12 frames); no B1-B4 launch; (c) `--pose_cfg` with three configs in
     the reference's layout, all 256x192: FastPose-DCN (halpe26,
     CONV_DIM 256, STAGE_WITH_DCN [F, T, T, T], offset convs at 3x gain:
     their |offset| mean and max and the share of taps outside the
     image), HRNet-W32 (coco17, convolutions at half gain) and
     HarDNet-68 (coco17), each through the CLI on 2 frames x 6 views,
     the pose net's device seconds a frame and its conv FLOPs' share of
     the fp32 peak, view 0's heatmaps on the card against the CPU at
     atol 1e-4; (d) `--video --smpl` with HybrIK (256x256, seed 0) on 4
     frames: smpl-results.json with the writer's keys, the overlay
     video's 4 frames, the net's and the IK's device seconds a frame;
     view 0's crops on the card against the CPU (uvd, shape, phi, camera
     and the peaks at atol 2e-4, rtol 1e-3), and the IK on the same
     inputs on both: the root's Kabsch rotation (cuSOLVER's batched 3x3
     SVD against LAPACK's) within 1e-5, the vertices within
     `HYBRIK_VERT_ATOL` (1e-4 m) for every person whose swings stay
     clear of antiparallel (1 + cos >= 1e-4), the others reported apart;
     no B1-B4 launch in any of its CLI runs;
 24. [train] the training of the detector and the pose nets, on a
     synthetic COCO workspace over the six 1920x1080 fixture views
     (`TR_PER_VIEW` persons a view with 17 keypoints; `TR_DET_IMAGES`
     image entries with 1-4 person boxes): (a) `cli.train_pose` at its
     defaults (FastPose, 256x192, heatmap 64x48, batch 32, adam) for
     `TR_POSE_STEPS` steps; (b) `cli.train_yolox` at YOLOX-X (640x640,
     batch 8) for `TR_YOLOX_STEPS` steps with mosaic and mixup, then one
     no-aug step with the L1 loss (its L1 term > 0, the others' 0); (c)
     `TR_HYBRIK_STEPS` HybrIK steps (256x256, batch `TR_HYBRIK_BATCH`,
     theta through the analytic IK); per run steps/s, crops or images a
     second, device seconds a step (CUDA events) against host
     data-loading seconds a step, checkpoint seconds, peak memory, the
     first and last loss, checkpoints read back, finite losses and no
     B1-B4 launch; (d) one SGD step of a FastPose (128x96, batch 8) and
     a small YOLOX (0.33/0.25, 128x128, batch 4) on the card against
     the CPU from the same weights: in float64 the loss and every
     parameter and buffer at rtol 1e-4 / atol 1e-6, in float32 the loss
     at rtol 1e-4 and the card's step no farther from the CPU's float64
     one than 3x the CPU's float32 step plus 1 (in units of 1e-6 +
     1e-4 |p|: float32 gradients of train-mode BatchNorm nets at small
     batches are far from float64 on any device); (e) `data/imgproc.py`
     against OpenCV's recorded results (`tests/fixtures/imgproc`:
     sha256, one case within its one-ulp bound), with host ms per call;
     (f) data parallelism (extends (a)-(e)): `TR_DP_WORLD` (2) gloo
     ranks spawned on the card as [shard]'s (NCCL refuses two ranks on
     one GPU), each holding its block of every global batch: one float64
     SGD step of (d)'s two nets against this process's step on the whole
     batch (rtol 1e-4 / atol 1e-6; every rank's parameters and buffers
     bitwise equal), then `cli.train_pose` and `cli.train_yolox` as in
     (a) and (b) on the world (every rank the same result, rank 0's
     files only, the first global loss within 1e-3 of (a)'s / (b)'s);
     per rank steps/s, host data seconds a step beside (a)'s / (b)'s,
     all_reduce seconds a step for the gradients and for BatchNorm
     (`parallel.COMM`, the device synchronized around each), the bytes
     reduced, peak memory and no B1-B4 launch;
then the total seconds, the card line, the kernels JSON line and the
result line.  Each path's launch counters are set to 0 just before it
and read just after; the JSON line gives every kernel's launches summed
over [fit], [collide], [multi], [points] (both runs), [fused], [lbfgs],
[grad], [gmm], [seq] (all steps), [adjust], [smplx], [smplh], [schur],
[shard] (every fit of (a), every rank's fits in (b) and (c), the
one-card and frames-sharded batched and Schur fits), [cli] (its batched and two-person runs; the sequence subprocess's
launches are its own), [keypoints] (none), [overlay] (the demo CLI and
the GUI), [stream] and [train] (none).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks used for the bounds (dense, full power).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
B_KERNEL = 512
B_FIT = 512
B_COLLIDE = 8
B_MULTI = 2            # [multi]'s two people, fitted side by side
B_CHECK = 8            # the card-vs-CPU fits
# [lbfgs]'s frames, cut from B_FIT: a batch's line search runs until its
# slowest frame is done, so the wall follows the worst frames (on an H100
# at 700 W, 512 frames took 138.7 s: 7118 batched evaluations at ~19.5
# ms of host time each); `tools/profile_torch_fit.py --solver lbfgs` runs
# all 512.
B_LBFGS = 8
SEQ_STEPS = 4
B_SMPLH = 64           # [smplh]'s frames
B_SCHUR = 512          # [schur]'s sequence length
G_FIT = 128            # the reference's production grid (fitting.py:374)
B_CLI = 128            # [cli]: cfg_files/fit_batched.yaml's batch_frames
SEQ_CLI = 4            # [cli]: the sequence run's frames
ROOT = os.path.dirname(os.path.abspath(__file__))
G_CHECK = 64           # the grid of the kernel-vs-plain check


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn`: one event pair around `reps`
    calls, with the stream held by a spin kernel while the host queues
    them all, so the host's launch time does not show as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Spin twice the host's queueing time (at up to 2 GHz SM clock).
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ptxas_summary(log_text: str) -> list:
    """Per kernel in nvcc's `-Xptxas -v` output: its (mangled) name,
    registers, stack frame and spill stores/loads in bytes, static shared
    memory."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"] = int(m.group(1))
            cur["spill"] = f"{m.group(2)}/{m.group(3)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def joint_kernel_work(jm, tables, B: int):
    """(bytes, flops) the joint-Jacobian function needs for B frames:
    inputs and the kernel's constant tables read once, outputs written
    once; multiply-adds that touch a non-zero constant only: the rest
    joints take the fold's JB columns, the Kv vertex slots the fold's
    full rows, the pose-corrective and beta products; chain slots take
    their joint's ancestors only.  Rodrigues and other per-joint scalar
    work (a few hundred operations per frame) is left out."""
    from mvsmplfitting_tpu_torch.models.joint_jac import _ancestry
    J, K, NB, Kv = 24, tables.K, tables.NB, tables.Kv
    P9 = 9 * (J - 1)
    anc = _ancestry(jm.parents)
    chain = (jm.chain_mask > 0).cpu().numpy()
    cidx = jm.chain_idx.cpu().numpy()
    macs = 3 * J * NB + Kv * 3 * J * (NB + P9)                # fold
    macs += J * 12 * 3                                        # chain walk
    macs += J * 3 * 27 + J * 9 * (9 + 9 + 6)                  # generators
    for k in range(K):
        if chain[k]:
            n_anc = int(anc[:, cidx[k]].sum())
            macs += 3 * n_anc * 3 * 4                         # pose/orient
            macs += 3 * NB * n_anc * 4                        # betas
        else:
            macs += J * 3 * 4 + J * 3 * J + J * 3             # contrib, Y
            macs += 3 * J * 3 * 4                             # rigid pose
            macs += 3 * (J - 1) * 9 * (3 * J + 3)             # corrective
            macs += 3 * NB * (3 * J + J * 4)                  # betas
    io = B * (3 * J + NB + 1) + B * (K * 3 * (1 + 3 * J + NB + 1))
    return tables.nbytes() + 4.0 * io, 2.0 * B * macs


def vposer_tail_work(B: int):
    """(bytes, flops): o and Do read, aa and D written; the 6-term
    composition per D element plus the dual-number tail (about 90
    operations on 7-float duals per joint)."""
    nbytes = 4.0 * B * (138 + 138 * 32 + 69 + 69 * 32)
    flops = 2.0 * B * 69 * 32 * 6 + B * 23 * 90 * 14
    return nbytes, flops


def event_ms(fn) -> float:
    """Milliseconds of one call between two CUDA events, host waits
    included (for the plain versions, which synchronize inside)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def sdf_work(SK, tri: torch.Tensor, G: int, work: dict, work3: dict):
    """(bytes, operations) per kernel for triangles (M, F, 9) at G, and
    the pairs each kernel evaluates: each input read once, each output
    written once; operations over the (voxel, triangle) pairs each
    kernel evaluates.  The brute force: what the row form of the crossing
    needs for every pair, whatever the kernel's tile (14 per triangle and
    (y, z) row, 5 per triangle and x, the other 32 of the 37 per voxel),
    10 more per pair that passed its pre-test (the kernel's own count)
    and the distance for every (inside voxel, triangle) pair;
    `sdf_grid_all_pairs` is its first design's work (distance and
    crossing for every pair).  Phase A: the per-face test (7 compares per
    face and row of 4 voxels) over the faces of the chunks the brick mask
    admits, and the row form of the crossing (14 per face and row, 37 per
    voxel) over the (row, face) pairs that pass it (the kernel's own
    count); phase B: the distance over the chunks each group visited
    (the kernel's visit counts) and the group's inside voxels.  `work`
    and `work3` are those of `sdf_grid_fast_cuda` and `sdf_grid_cuda`."""
    M, F = tri.shape[:2]
    N = G ** 3
    io = 4.0 * (tri.numel() + M * N)
    inside = float(work3["counts"][:M].sum())
    passed = float(work3["counts"][M])
    out = {"sdf_grid": (io, float(
        M * F * (G * G * SK.CROSS_ROW_OPS + G * SK.CROSS_COLUMN_OPS
                 + N * (SK.CROSS_VOXEL_OPS - SK.CROSS_COLUMN_OPS))
        + passed * SK.CROSS_PASS_OPS + inside * F * SK.DIST_OPS)),
           "sdf_grid_all_pairs": (io, float(M * N * F * (SK.DIST_OPS
                                                         + SK.CROSS_OPS)))}
    pairs = {"passed": passed}
    tb = work["tables"]
    nb, nc = tb.nb, tb.nc
    dev = tri.device
    faces = torch.clamp(F - torch.arange(nc, device=dev) * SK.CHUNK,
                        max=SK.CHUNK).double()                  # (nc,)
    w = torch.clamp(G - torch.arange(nb, device=dev) * SK.BRICK,
                    max=SK.BRICK).double()                      # (nb,)
    wz, wy, wx = torch.meshgrid(w, w, w, indexing="ij")
    voxels = (wz * wy * wx).reshape(-1)                         # (NB,)
    rows = (wz * wy * torch.ceil(wx / SK.X_PER_THREAD)).reshape(-1)
    admitted = tb.mask.double() @ faces                         # (M, NB)
    pairs_a = (admitted * voxels).sum().item()
    rows_a = (admitted * rows).sum().item()
    evaluated = float(work["counts"][2])            # (row, face) pairs
    n = int(work["counts"][0])
    groups = work["work"][:n * SK.GROUP].reshape(n, SK.GROUP)
    lanes = (groups >= 0).sum(-1).double()
    pairs_b = (work["visits"][:n].double() * SK.CHUNK * lanes).sum().item()
    out["sdf_cross"] = (
        4.0 * (tb.tria.numel() + M * N + n * SK.GROUP) + tb.mask.numel(),
        rows_a * SK.FACE_TEST_OPS + evaluated * (
            SK.CROSS_ROW_OPS + SK.X_PER_THREAD * SK.CROSS_VOXEL_OPS))
    out["sdf_dist"] = (4.0 * (tb.trib.numel() + tb.boxes.numel()
                              + n * SK.GROUP + lanes.sum().item() + n),
                       pairs_b * SK.DIST_OPS)
    pairs.update(sdf_cross=pairs_a, sdf_dist=pairs_b,
                 evaluated=evaluated * SK.X_PER_THREAD)
    return out, pairs


def posed_local(dev, n: int, seed: int):
    """n posed synthetic smpl bodies (VPoser z ~ N(0, 0.8)) normalized as
    `person_grids` does, their triangles (n, 13776, 9) and the faces."""
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.synthetic import make_people_problem

    assets, vw, _, _ = make_people_problem(0.2, device=dev)
    z = np.random.default_rng(seed).normal(0, 0.8, (n, 32)).astype(
        np.float32)
    body_pose = V.decode(vw, torch.as_tensor(z, device=dev))
    verts, _ = smpl_forward(assets, SMPLParams.zeros(n, device=dev),
                            body_pose)
    centers, scales = S.box_frame(verts)
    local = ((verts - centers[:, None]) / scales[:, None, None]).contiguous()
    return local, S.triangles(local, assets.faces), assets.faces


def sdf_times(SK, tri: torch.Tensor, G: int, reps: int) -> dict:
    """Device ms per call of the brute force's pass 1 (`b3_parity`), pass
    2 (`b3_dist`) and both with their tables (`sdf_grid`), and of phase
    A, phase B and the whole two-phase wrapper (tables and both kernels).
    Phase B takes a fresh copy of phase A's counts each call: its work
    counter must start at 0."""
    from mvsmplfitting_tpu_torch.ops import cuda_build
    cross_fn, dist_fn = SK.bind_fast(cuda_build.load("sdf_grid_fast"))
    grid_fns = SK.bind_grid(cuda_build.load("sdf_grid"))
    stream = torch.cuda.current_stream(tri.device).cuda_stream
    blocks = SK.dist_blocks(tri.device)
    gt = SK.grid_tables(tri, G)
    phi3, lst3, counts3 = SK.call_parity(grid_fns[0], gt, stream)
    tb = SK.cull_tables(tri, G)
    phi, lst, counts = SK.call_cross(cross_fn, tb, stream)
    fresh = [counts.clone() for _ in range(2 * reps + 1)]   # cuda_ms's calls
    return {
        "b3_parity": cuda_ms(lambda: SK.call_parity(grid_fns[0], gt, stream),
                             reps=reps, warmup=1),
        "b3_dist": cuda_ms(lambda: SK.call_inside_dist(
            grid_fns[1], gt, phi3, lst3, counts3, blocks, stream),
            reps=reps, warmup=1),
        "sdf_grid": cuda_ms(lambda: SK.call_grid(grid_fns, tri, G, stream),
                            reps=reps, warmup=1),
        "sdf_cross": cuda_ms(lambda: SK.call_cross(cross_fn, tb, stream),
                             reps=reps, warmup=1),
        "sdf_dist": cuda_ms(lambda: SK.call_dist(dist_fn, tb, phi, lst,
                                                 fresh.pop(), blocks,
                                                 stream),
                            reps=reps, warmup=1),
        "whole": cuda_ms(lambda: SK.sdf_grid_fast_cuda(tri, G), reps=reps,
                         warmup=1)}


def sdf_check(SK, tri: torch.Tensor, G: int, what: str):
    """Both voxelizers on tri at G: the two-phase result bitwise equal to
    the brute force, and their work lists the same voxels, each once,
    with every voxel of phi > 0 among them (a listed voxel on the surface
    has phi 0).  Returns (phi, work3, work)."""
    M, N = tri.shape[0], G ** 3
    b3, work3 = SK.sdf_grid_cuda(tri, G, with_work=True)
    b4, work = SK.sdf_grid_fast_cuda(tri, G, with_work=True)
    torch.cuda.synchronize()
    assert torch.equal(b4, b3), f"{what}: two-phase != brute force"
    listed3 = torch.sort(torch.cat([
        work3["work"][m, :int(work3["counts"][m])].long() + m * N
        for m in range(M)])).values
    n = int(work["counts"][0])
    listed4 = work["work"][:n * SK.GROUP].long()
    listed4 = torch.sort(listed4[listed4 >= 0]).values
    assert torch.equal(listed3, listed4), f"{what}: B3 and B4a list " \
        f"{listed3.numel()} and {listed4.numel()} voxels, not the same"
    assert bool((listed3[1:] > listed3[:-1]).all()), f"{what}: listed twice"
    positive = torch.nonzero(b3.reshape(-1) > 0).flatten()
    assert bool(torch.isin(positive, listed3).all()), \
        f"{what}: a voxel with phi > 0 is not listed"
    return b3, work3, work


def sdf_phase(dev, kernels: dict) -> None:
    """[sdf]: the voxelizer kernels against the plain version and each
    other, their device times and bounds (see the module docstring)."""
    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK

    local, tri, faces = posed_local(dev, 2, seed=3)
    timing = {}
    for G in (G_CHECK, G_FIT):
        b3, work3, work = sdf_check(SK, tri, G, f"G={G}")
        kept = []
        plain_ms = event_ms(lambda: kept.append(S.sdf_grid(local, faces, G)))
        plain = kept[0]
        inside = int((plain > 0).sum())
        assert inside > G, f"G={G}: only {inside} inside voxels"
        err = (b3 - plain).abs().max().item()
        ndiff = int((b3 != plain).sum())
        assert ndiff == 0, f"G={G}: {ndiff} voxels differ from plain ({err})"
        ms = sdf_times(SK, tri, G, 3 if G == G_FIT else 10)
        log_sdf(SK, tri, G, work, work3, ms, inside=inside,
                b3_equals_plain="bitwise", b4_equals_b3="bitwise",
                plain_ms=f"{plain_ms:.1f}")
        timing[G] = (ms, plain_ms, sdf_work(SK, tri, G, work, work3)[0],
                     err)

    # The shape [collide] voxelizes: eight bodies in one launch, G=128.
    _, tri8, _ = posed_local(dev, B_COLLIDE, seed=4)
    b3, work3, work = sdf_check(SK, tri8, G_FIT, "8 bodies")
    inside = int((b3 > 0).sum())
    assert inside > B_COLLIDE * G_FIT, f"8 bodies: {inside} inside voxels"
    log_sdf(SK, tri8, G_FIT, work, work3, sdf_times(SK, tri8, G_FIT, 3),
            inside=inside, b4_equals_b3="bitwise")
    del b3, work3, work, tri8

    ms, plain_ms, bounds, err = timing[G_FIT]   # the fits' grid size
    for name, label, line in (
            ("sdf_grid", "sdf_grid.cu", ":599"),
            ("sdf_cross", "sdf_grid_fast.cu", ":798"),
            ("sdf_dist", "sdf_grid_fast.cu", ":888")):
        bnd, by = bound_ms(*bounds[name])
        kernels[name] = dict(
            name=name, route="cuda",
            source=f"mvsmplfitting_tpu_torch/csrc/{label}",
            replaces=f"mvsmplfitting_tpu/ops/sdf.py{line}",
            max_abs_err=err, ms=ms[name], plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None)


def log_sdf(SK, tri: torch.Tensor, G: int, work: dict, work3: dict,
            ms: dict, **extra) -> None:
    """One [sdf] line: the shape, the work each kernel evaluated, the
    device times and the bounds."""
    work_by, pairs = sdf_work(SK, tri, G, work, work3)
    all_pairs_ms = bound_ms(*work_by.pop("sdf_grid_all_pairs"))[0]
    bounds = {k: round(bound_ms(*v)[0], 5) for k, v in work_by.items()}
    M = tri.shape[0]
    n = int(work["counts"][0])
    lanes = int((work["work"][:n * SK.GROUP] >= 0).sum())
    log("sdf", G=G, meshes=M, faces=tri.shape[1], **extra,
        b3_ms=f"{ms['sdf_grid']:.4f}", b3_parity_ms=f"{ms['b3_parity']:.4f}",
        b3_dist_ms=f"{ms['b3_dist']:.4f}",
        b3_share=f"{bounds['sdf_grid'] / ms['sdf_grid']:.3f}",
        bound_all_pairs_ms=f"{all_pairs_ms:.4f}",
        b3_pretest_passed_per_voxel=f"{pairs['passed'] / (M * G ** 3):.2f}",
        admitted_pairs_per_voxel=f"{pairs['sdf_cross'] / (M * G ** 3):.1f}",
        evaluated_pairs_per_voxel=f"{pairs['evaluated'] / (M * G ** 3):.2f}",
        groups=n, group_lanes_used=f"{lanes / max(1, n * SK.GROUP):.3f}",
        chunks_per_group=f"{work['visits'][:n].double().mean().item():.2f}",
        max_chunks_per_group=int(work["visits"][:n].max()),
        faces_per_inside_voxel=f"{pairs['sdf_dist'] / max(1, lanes):.1f}",
        b4a_ms=f"{ms['sdf_cross']:.4f}", b4b_ms=f"{ms['sdf_dist']:.4f}",
        b4_ms=f"{ms['whole']:.4f}",
        bounds_ms=json.dumps(bounds).replace(" ", ""))


class EventClock:
    """Calls of `module.name` for the length of a `with` block: each one's
    host seconds and CUDA event pair (their stream time includes the
    device's waits for the host inside the call)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.pairs = []
        self.host_s = 0.0

    def __enter__(self):
        inner = self.orig = getattr(self.module, self.name)

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = inner(*a, **k)
            end.record()
            self.host_s += time.perf_counter() - t0
            self.pairs.append((start, end))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs) / 1e3


def reset_launches(JK, VK, SK) -> None:
    JK.LAUNCHES = 0
    VK.LAUNCHES = 0
    for k in SK.LAUNCHES:
        SK.LAUNCHES[k] = 0


def read_launches(JK, VK, SK) -> dict:
    return {"joint_jacobian": JK.LAUNCHES, "vposer_tail": VK.LAUNCHES,
            **SK.LAUNCHES}


def collide_phase(dev, launches: dict) -> None:
    """[collide]: the single-person fit with the collision term on."""
    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    B = B_COLLIDE
    cfg = FitConfig(spec=EnergySpec(interpenetration=True,
                                    coll_grid_size=G_FIT),
                    coll_weights=(0.0, 0.0, 1000.0, 4500.0),
                    lm=LMOptions(max_iters=40))
    assets, vw, cam, obs = make_problem(6, B, seed=0, device=dev)
    batch = BatchedFitInputs(obs, torch.full((B,), 1080.0, device=dev))
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    with EventClock(SK, "sdf_grid_fast_cuda") as clock:
        t0 = time.perf_counter()
        res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert res.stage_losses.shape == (B, 4)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    assert got["sdf_cross"] > 0 and got["sdf_dist"] > 0, got
    launches["collide"] = got
    log("collide", frames=B, grid=G_FIT, wall_s=f"{wall:.3f}",
        voxelizer_s=f"{clock.seconds():.3f}", voxelizer_calls=len(clock.pairs),
        lm_iterations=json.dumps(res.lm_iters.amax(0).tolist()).replace(
            " ", ""),
        stage_losses_mean=json.dumps([round(v, 3) for v in
                                      res.stage_losses.mean(0).tolist()]
                                     ).replace(" ", ""),
        launches=json.dumps(got).replace(" ", ""))

    # Parity, card against the CPU plain path, 2 frames at G=16.  (a) A
    # short fit through the first collision stage (1 LM iteration per
    # stage, init_lambda 1.0), stage losses at rtol 1e-3.  Longer budgets
    # and the 4500 stage cannot be compared: there a 1e-6 change of the
    # keypoints moves the stage losses by percents in the JAX package and
    # the port alike (`tests/torch_collide_sensitivity.py`, PERF.md
    # section 6).  (b) One collision-stage linearization at a fixed x.
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.stages import (default_stages,
                                                         stage_jacobian)
    from mvsmplfitting_tpu_torch.synthetic import true_params
    short = FitConfig(spec=EnergySpec(interpenetration=True,
                                      coll_grid_size=16),
                      pose_weights=(404.0, 404.0, 57.4),
                      shape_weights=(100.0, 50.0, 10.0),
                      coll_weights=(0.0, 0.0, 1000.0),
                      lm=LMOptions(max_iters=1, linsolve="chol",
                                   speculative=False, init_lambda=1.0))
    z, cols = true_params(2, seed=1)
    rng = np.random.default_rng(5)
    x = np.concatenate([z, cols["betas"], cols["global_orient"],
                        cols["transl"], cols["scale"][:, None]], 1)
    x = (x + rng.normal(0, 0.02, x.shape)).astype(np.float32)
    v = rng.normal(0, 1.0, (2,) + x.shape).astype(np.float32)
    cfg16 = FitConfig(spec=EnergySpec(interpenetration=True,
                                      coll_grid_size=16),
                      coll_weights=(0.0, 0.0, 1000.0, 4500.0))
    out = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        assets, vw, cam, obs = make_problem(6, 2, seed=1, device=d)
        h = torch.full((2,), 1080.0, device=d)
        fit = batched_fit_frames(short, assets, cam,
                                 BatchedFitInputs(obs, h), vposer_w=vw,
                                 device=d)
        weights = default_stages(cfg16, h)[3]
        xt = torch.as_tensor(x, device=d)
        phi = E.collision_grids(cfg16.spec, assets, vw, xt)[0]
        r, J = stage_jacobian(cfg16, assets, cam, obs, weights, vw,
                              None)(xt)
        e = E.total_energy(cfg16.spec, assets, cam, obs, weights, vw, None,
                           xt)
        Jv = torch.einsum("bmn,kbn->kbm", J, torch.as_tensor(v, device=d))
        out[name] = [t.cpu() for t in (fit.stage_losses, phi, r, Jv, e)]
    (l1, phi1, r1, Jv1, e1), (l0, phi0, r0, Jv0, e0) = (out["cuda"],
                                                        out["cpu"])
    torch.testing.assert_close(l1, l0, rtol=1e-3, atol=0.0)
    # The vertices differ by fp32 rounding between the card's and the
    # CPU's LBS, so the grids agree to the voxelizer test's tolerance.
    assert torch.equal(phi1 > 0, phi0 > 0), "inside sets differ"
    torch.testing.assert_close(phi1, phi0, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(r1, r0, rtol=1e-5,
                               atol=1e-5 * r0.abs().max().item())
    torch.testing.assert_close(Jv1, Jv0, rtol=1e-4,
                               atol=1e-4 * Jv0.abs().max().item())
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=0.0)
    log("collide", parity_frames=2, grid=16,
        stage_losses_max_rel=f"{((l1 - l0).abs() / l0.abs()).max().item():.3e}",
        grids_max_abs=f"{(phi1 - phi0).abs().max().item():.3e}",
        collision_rows=json.dumps([round(t, 3) for t in
                                   r0[:, -1].tolist()]).replace(" ", ""),
        rows_max_rel=f"{((r1 - r0).abs().max() / r0.abs().max()).item():.3e}",
        jv_max_rel=f"{((Jv1 - Jv0).abs().max() / Jv0.abs().max()).item():.3e}",
        energy_max_rel=f"{((e1 - e0).abs() / e0.abs()).max().item():.3e}",
        tolerance="losses 1e-3, rows 1e-5, J.v 1e-4, energy 1e-5")


def multi_phase(dev, launches: dict) -> None:
    """[multi]: the two-person grid-engine fit with the hybrid schedule."""
    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.multi_person import fit_people
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.smpl import smpl_forward
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import make_people_problem

    G = G_FIT
    # cfg_files/fit_multi_person_sdf.yaml's weights; session.py's LM
    # defaults (max_iters = max(60, 2 * maxiters)).
    cfg = FitConfig(spec=EnergySpec(interpenetration=True, coll_grid_size=G),
                    pose_weights=(404.0, 404.0, 57.4, 4.78),
                    shape_weights=(100.0, 50.0, 10.0, 5.0),
                    coll_weights=(0.0, 0.0, 1000.0, 4500.0),
                    lm=LMOptions(max_iters=60))
    assets, vw, cam, obs = make_people_problem(0.2, device=dev)

    def sums_of(r):
        verts, _ = smpl_forward(assets, r.params, V.decode(vw, r.z))
        return S.collision_sums(verts, assets.faces, G)

    solo, _ = fit_people(cfg, assets, cam, obs, vposer_w=vw,
                         refine_collision=False, sdf_engine="grid",
                         device=dev)
    s_solo = sums_of(solo)
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    with EventClock(SK, "sdf_grid_fast_cuda") as clock:
        t0 = time.perf_counter()
        res, s_ref = fit_people(cfg, assets, cam, obs, vposer_w=vw,
                                sdf_engine="grid", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert bool(torch.isfinite(res.loss).all()), "non-finite loss"
    assert bool(torch.isfinite(s_ref).all()), "non-finite sums"
    assert float(s_ref.sum()) < float(s_solo.sum()), (s_solo, s_ref)
    assert got["sdf_cross"] > 0 and got["sdf_dist"] > 0, got
    launches["multi"] = got
    log("multi", people=2, grid=G, schedule="hybrid(12+5)",
        wall_s=f"{wall:.3f}", voxelizer_s=f"{clock.seconds():.3f}",
        voxelizer_calls=len(clock.pairs),
        per_person_loss=json.dumps([round(v, 3) for v in
                                    res.loss.tolist()]).replace(" ", ""),
        sums_solo=json.dumps([round(v, 4) for v in
                              s_solo.tolist()]).replace(" ", ""),
        sums_refined=json.dumps([round(v, 4) for v in
                                 s_ref.tolist()]).replace(" ", ""),
        refine_lm_iterations=int(res.lm_iters[0, 0]),
        launches=json.dumps(got).replace(" ", ""))

    short = FitConfig(spec=EnergySpec(interpenetration=True,
                                      coll_grid_size=16),
                      pose_weights=(404.0, 57.4), shape_weights=(100.0, 10.0),
                      coll_weights=(0.0, 1000.0),
                      lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False, init_lambda=1.0))
    out = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else "cpu"
        a, w, c, o = make_people_problem(0.2, device=d)
        r, s = fit_people(short, a, c, o, vposer_w=w, sdf_engine="grid",
                          refine_iters=1, polish_iters=1, device=d)
        out[name] = (r.loss.cpu(), s.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-2,
                               atol=0.0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=5e-2,
                               atol=0.0)
    rel_l = ((out["cuda"][0] - out["cpu"][0]).abs()
             / out["cpu"][0].abs()).max().item()
    rel_s = ((out["cuda"][1] - out["cpu"][1]).abs()
             / out["cpu"][1].abs()).max().item()
    log("multi", parity_people=2, grid=16, loss_max_rel=f"{rel_l:.3e}",
        sums_max_rel=f"{rel_s:.3e}", tolerance="losses rtol 1e-2, sums 5e-2")


def _people_px(cfg, assets, cam, obs, vw, res) -> torch.Tensor:
    """Each person's mean reprojection error in pixels."""
    from mvsmplfitting_tpu_torch.fitting import energy as E
    solo = dataclasses.replace(cfg.spec, interpenetration=False)
    x = E.pack(solo, res.params, res.z)
    return E.reprojection_error_px(solo, assets, cam, obs, vw, x)


def _compact(t: torch.Tensor, nd: int = 4) -> str:
    return json.dumps([round(v, nd) for v in t.tolist()]).replace(" ", "")


def points_phase(dev, launches: dict) -> None:
    """[points]: `fit_people` with the points engine at JAX's defaults
    on the two-person fixture, with both refinement Jacobians."""
    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.multi_person import fit_people
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.smpl import smpl_forward
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import make_people_problem

    # The configuration of JAX's quality test (`tests/test_multi_person.
    # py:244-256`): the library's 4-stage weights, 40 LM iterations.
    cfg = FitConfig(spec=EnergySpec(interpenetration=True),
                    lm=LMOptions(max_iters=40))
    assets, vw, cam, obs = make_people_problem(0.2, device=dev)

    def verts_of(r):
        return smpl_forward(assets, r.params, V.decode(vw, r.z))[0]

    solo, _ = fit_people(cfg, assets, cam, obs, vposer_w=vw,
                         refine_collision=False, device=dev)
    s_solo = S.collision_sums_points(verts_of(solo), assets.faces)
    px_solo = _people_px(cfg, assets, cam, obs, vw, solo)
    assert float(s_solo.sum()) > 0.1, s_solo            # the bodies overlap
    refined = {}
    for jac in ("ad", "analytic"):
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        evals = S.FIELD_EVALS
        with EventClock(S, "_sdf_at_points_impl") as clock:
            t0 = time.perf_counter()
            res, s_ref = fit_people(cfg, assets, cam, obs, vposer_w=vw,
                                    points_jac=jac, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evals = S.FIELD_EVALS - evals
        got = read_launches(JK, VK, SK)
        px = _people_px(cfg, assets, cam, obs, vw, res)
        assert bool(torch.isfinite(res.loss).all()), "non-finite loss"
        # `tests/test_multi_person.py:244-256`'s bounds.
        assert float(s_ref.sum()) <= 0.05 * float(s_solo.sum()) + 1e-6, (
            jac, s_solo, s_ref)
        assert float(px.mean()) <= 3.25 and bool((px <= 4.25).all()), (
            jac, px_solo, px)
        assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
        launches[f"points_{jac}"] = got
        refined[jac] = res
        log("points", people=2, points_jac=jac, schedule="15 iters, anneal, "
            "2 starts", wall_s=f"{wall:.3f}", field_evals=evals,
            field_event_s=f"{clock.seconds():.3f}",
            field_host_s=f"{clock.host_s:.3f}",
            refine_lm_iterations=int(res.lm_iters[0, 0]),
            per_person_loss=_compact(res.loss, 3), sums_solo=_compact(s_solo),
            sums_refined=_compact(s_ref, 6), px_solo=_compact(px_solo),
            px=_compact(px), launches=json.dumps(got).replace(" ", ""))

    # The just-clear pair (true penetration 0) comes through untouched
    # (`tests/test_multi_person.py:259-271`).
    a, w, c, o = make_people_problem(0.26, device=dev)
    t0 = time.perf_counter()
    res, s = fit_people(cfg, a, c, o, vposer_w=w, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    px = _people_px(cfg, a, c, o, w, res)
    assert float(s.sum()) <= 1e-6, s
    assert bool((px <= 0.75).all()), px
    log("points", clear_pair="dx0=0.26", wall_s=f"{wall:.3f}",
        sums=_compact(s, 6), px=_compact(px))

    # The field on the card against the CPU: each person's queries (the
    # other's vertices) on the refined bodies.
    verts = verts_of(refined["ad"])
    centers, scales = S.box_frame(verts)
    ndiff, err = 0, 0.0
    for i in range(2):
        mesh = (verts[i] - centers[i]) / scales[i]
        q = (verts[1 - i] - centers[i]) / scales[i]
        card = S._sdf_at_points_impl(q, mesh, assets.faces)
        cpu = S._sdf_at_points_impl(q.cpu(), mesh.cpu(), assets.faces.cpu())
        card = [t.cpu() for t in card]
        assert torch.equal(card[2], cpu[2]), "inside sets differ"
        err = max(err, (card[0] - cpu[0]).abs().max().item())
        ndiff += int((card[0] != cpu[0]).sum())
    assert err <= 1e-5, err
    # The field at G=64 voxel centers against B4 on the card.  Inside the
    # mesh's box both run the same arithmetic.  Outside it the field's
    # cull gives 0 where the voxelizer's parity ray may graze an edge
    # and count an odd number of crossings: such voxels must be inside
    # by the field's full evaluation too.
    local, _, faces = posed_local(dev, 2, seed=3)
    G = G_CHECK
    centers = S.voxel_centers(G, dev)
    grid = SK.sdf_grid_fast(local[:1], faces, G).reshape(-1)
    pts = S.sdf_at_points(centers, local[0], faces)
    box = ((centers >= local[0].amin(0) - 1e-6)
           & (centers <= local[0].amax(0) + 1e-6)).all(-1)
    differ = (pts > 0) != (grid > 0)
    outside = torch.nonzero(differ & ~box).flatten()
    full = S._sdf_at_points_impl(centers[outside], local[0], faces,
                                 _full=True)[0]
    err_b4 = (pts - grid)[box].abs().max().item()
    ms = event_ms(lambda: S.sdf_at_points(centers, local[0], faces))
    log("points", field_card_vs_cpu="refined bodies", max_abs=f"{err:.3e}",
        points_not_bitwise=ndiff, field_vs_b4=f"G={G}",
        b4_max_abs_in_box=f"{err_b4:.3e}",
        voxels_not_bitwise=int((pts != grid).sum()),
        inside_voxels=int((grid > 0).sum()),
        inside_sets_differ_in_box=int((differ & box).sum()),
        b4_inside_outside_box=outside.numel(),
        b4_phi_there=_compact(grid[outside][:8], 5), field_G64_ms=f"{ms:.2f}",
        tolerance="same inside set in the box, atol 1e-5")
    assert not (differ & box).any(), "field vs B4: inside sets differ"
    assert err_b4 <= 1e-5, err_b4
    assert torch.equal(full, grid[outside]), (full, grid[outside])

    # A short points fit on both devices (the CPU test's budget).
    short = FitConfig(spec=EnergySpec(interpenetration=True),
                      pose_weights=(404.0,), shape_weights=(100.0,),
                      coll_weights=(1000.0,),
                      lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False, init_lambda=1.0))
    out = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else "cpu"
        a, w, c, o = make_people_problem(0.2, device=d)
        r, s = fit_people(short, a, c, o, vposer_w=w, points_iters=2,
                          device=d)
        out[name] = (r.loss.cpu(), s.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-2,
                               atol=0.0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=5e-2,
                               atol=0.0)
    rel_l = ((out["cuda"][0] - out["cpu"][0]).abs()
             / out["cpu"][0].abs()).max().item()
    rel_s = ((out["cuda"][1] - out["cpu"][1]).abs()
             / out["cpu"][1].abs()).max().item()
    log("points", parity_people=2, loss_max_rel=f"{rel_l:.3e}",
        sums_max_rel=f"{rel_s:.3e}", tolerance="losses rtol 1e-2, sums 5e-2")


def fused_phase(dev, launches: dict, fit_loss: torch.Tensor) -> None:
    """[fused]: the [fit] problem with `FitConfig.fused`, then an 8-frame
    fused fit on the card against the CPU."""
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    assets, vw, cam, obs = make_problem(6, B_FIT, seed=0, device=dev)
    batch = BatchedFitInputs(obs, torch.full((B_FIT,), 1080.0, device=dev))
    cfg = FitConfig(lm=LMOptions(max_iters=40), fused=True)
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert res.stage_losses.shape == (B_FIT, 4)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
    launches["fused"] = got
    near = torch.isclose(res.loss, fit_loss, rtol=0.1, atol=0.0)
    log("fused", frames=B_FIT, fps=f"{B_FIT / wall:.1f}",
        wall_s=f"{wall:.3f}",
        lm_iterations=int(res.lm_iters.sum(1).amax().item()),
        final_loss_mean=f"{res.loss.mean().item():.3f}",
        share_within_rtol_0_1_of_fit=f"{near.double().mean().item():.4f}",
        launches=json.dumps(got).replace(" ", ""))

    short = FitConfig(lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False), fused=True)
    losses = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else "cpu"
        a, w, c, o = make_problem(6, 8, seed=1, device=d)
        r = batched_fit_frames(short, a, c,
                               BatchedFitInputs(o, torch.full((8,), 1080.0,
                                                              device=d)),
                               vposer_w=w, device=d)
        losses[name] = r.stage_losses.cpu()
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-3,
                               atol=0.0)
    rel = ((losses["cuda"] - losses["cpu"]).abs()
           / losses["cpu"].abs()).max().item()
    log("fused", parity_frames=8, stage_losses_max_rel=f"{rel:.3e}",
        tolerance="rtol 1e-3")


def _spread(t: torch.Tensor) -> str:
    """min/median/max of per-frame counts."""
    t = t.double()
    return f"{int(t.min())}/{t.median().item():g}/{int(t.max())}"


class LBFGSStats:
    """Each call of the staged fit's `lbfgs_fit` for the length of a
    `with` block: per-frame iterations and evaluations, and the batched
    objective evaluations it made."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from mvsmplfitting_tpu_torch.fitting import stages
        self.stages, self.orig = stages, stages.lbfgs_fit

        def counted_fit(fg, x0, mask, opts):
            n = [0]

            def counted(x):
                n[0] += 1
                return fg(x)
            out = self.orig(counted, x0, mask, opts)
            self.calls.append((out[2].cpu(), out[3].cpu(), n[0]))
            return out
        stages.lbfgs_fit = counted_fit
        return self

    def __exit__(self, *exc):
        self.stages.lbfgs_fit = self.orig


def check_fits(run, dev, rtol: float = 1e-3) -> float:
    """`run(device)` -> stage losses of a short fit, on the card `dev`
    and on the CPU; they must agree at rtol.  Returns the largest
    relative difference."""
    got = {name: run(d).cpu() for name, d in (("cuda", dev),
                                                ("cpu", "cpu"))}
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=rtol, atol=0.0)
    return ((got["cuda"] - got["cpu"]).abs()
            / got["cpu"].abs()).max().item()


def lbfgs_phase(dev, launches: dict) -> None:
    """[lbfgs]: the parity solver on B_LBFGS frames (see the
    docstring)."""
    from mvsmplfitting_tpu_torch.fitting.lbfgs import LBFGSOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    def config(max_iters):
        # `session.py:115-142` on fit_smpl_lbfgs_parity.yaml: maxiters 30
        # gives 120 L-BFGS iterations per stage; lr 1, ftol = gtol = 1e-9.
        return FitConfig(solver="lbfgs",
                         coll_weights=(0.0, 0.0, 0.0, 0.0),
                         lbfgs=LBFGSOptions(max_iters=max_iters, lr=1.0,
                                            ftol=1e-9, gtol=1e-9))

    def problem(d, B):
        return make_problem(6, B, seed=0, device=d, model_type="smpllsp")

    def fit(prob, cfg):
        assets, vw, cam, obs = prob
        B = obs.gt2d.shape[0]
        return batched_fit_frames(
            cfg, assets, cam, BatchedFitInputs(
                obs, torch.full((B,), 1080.0, device=obs.gt2d.device)),
            vposer_w=vw, device=obs.gt2d.device)

    cfg = config(120)
    prob = problem(dev, B_LBFGS)
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    with LBFGSStats() as stats:
        t0 = time.perf_counter()
        res = fit(prob, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert res.stage_losses.shape == (B_LBFGS, 4)
    assert bool(torch.isfinite(res.loss).all()), "non-finite loss"
    assert got["joint_jacobian"] == 0 and got["vposer_tail"] == 0, got
    launches["lbfgs"] = got
    log("lbfgs", frames=B_LBFGS, model="smpllsp",
        fps=f"{B_LBFGS / wall:.2f}",
        wall_s=f"{wall:.3f}",
        iterations_per_stage=",".join(_spread(c[0]) for c in stats.calls),
        evaluations_per_stage=",".join(_spread(c[1]) for c in stats.calls),
        batched_evaluations=",".join(str(c[2]) for c in stats.calls),
        median_final_loss=f"{res.loss.median().item():.3f}",
        launches=json.dumps(got).replace(" ", ""))
    rel = check_fits(lambda d: fit(problem(d, B_CHECK),
                                   config(3)).stage_losses, dev)
    log("lbfgs", parity_frames=B_CHECK, iterations_per_stage=3,
        stage_losses_max_rel=f"{rel:.3e}", tolerance="rtol 1e-3")


def grad_phase(dev, launches: dict) -> None:
    """[grad]: adam on 512 frames with its quality gate."""
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.gradient import GradientOptions
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.stages import (FitConfig,
                                                         default_stages)
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    cfg = FitConfig(solver="adam",
                    grad=GradientOptions(optim_type="adam", lr=1e-2,
                                         max_iters=150))
    assets, vw, cam, obs = make_problem(6, B_FIT, seed=0, device=dev)
    h = torch.full((B_FIT,), 1080.0, device=dev)
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = batched_fit_frames(cfg, assets, cam, BatchedFitInputs(obs, h),
                             vposer_w=vw, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert got["joint_jacobian"] == 0 and got["vposer_tail"] == 0, got
    launches["grad"] = got
    guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
    e0 = E.total_energy(cfg.spec, assets, cam, obs,
                        default_stages(cfg, h)[-1], vw, None,
                        E.pack(cfg.spec, guess.params, guess.z))
    below = res.loss < e0
    log("grad", frames=B_FIT, optimizer="adam", fps=f"{B_FIT / wall:.1f}",
        wall_s=f"{wall:.3f}",
        steps_per_stage=",".join(_spread(c) for c in res.lm_iters.T),
        median_final_loss=f"{res.loss.median().item():.3f}",
        median_start_energy=f"{e0.median().item():.3f}",
        share_below_start=f"{below.double().mean().item():.4f}",
        launches=json.dumps(got).replace(" ", ""))
    assert bool(torch.isfinite(res.loss).all()), "non-finite loss"
    assert bool(below.all()), (res.loss[~below], e0[~below])


def gmm_phase(dev, launches: dict) -> None:
    """[gmm]: the GMM pose prior without VPoser on 512 frames."""
    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig, fit_frame
    from mvsmplfitting_tpu_torch.models.priors import random_gmm
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    spec = EnergySpec(use_vposer=False, prior_type="gmm")

    def problem(d, B):
        assets, _, cam, obs = make_problem(6, B, seed=0, device=d)
        return assets, cam, obs, random_gmm(device=d)

    def fit(prob, lm):
        assets, cam, obs, gmm = prob
        guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
        bent = torch.zeros_like(guess.params.body_pose)
        bent[:, :6] = 1.0
        params = dataclasses.replace(guess.params, body_pose=bent)
        return fit_frame(FitConfig(spec=spec, lm=lm), assets, cam, obs,
                         params, guess.z, gmm=gmm, img_height=1080.0)

    prob = problem(dev, B_FIT)
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = fit(prob, LMOptions(max_iters=40))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    lm_iters = int(res.lm_iters.amax(dim=0).sum().item())
    assert res.stage_losses.shape == (B_FIT, 4)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    assert got["joint_jacobian"] >= lm_iters, (got, lm_iters)
    assert got["vposer_tail"] == 0, got
    launches["gmm"] = got
    log("gmm", frames=B_FIT, model="smpl", unknowns=86, components=8,
        fps=f"{B_FIT / wall:.1f}", wall_s=f"{wall:.3f}",
        lm_iterations=lm_iters,
        median_final_loss=f"{res.loss.median().item():.3f}",
        launches=json.dumps(got).replace(" ", ""))
    rel = check_fits(lambda d: fit(problem(d, B_CHECK), LMOptions(
        max_iters=3, linsolve="chol", speculative=False)).stage_losses, dev)
    log("gmm", parity_frames=B_CHECK, stage_losses_max_rel=f"{rel:.3e}",
        tolerance="rtol 1e-3")


def seq_phase(dev, launches: dict) -> None:
    """[seq]: 512 sequences of SEQ_STEPS steps in lockstep."""
    from mvsmplfitting_tpu_torch.fitting.initialize import (init_guess,
                                                             warm_start)
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig, fit_frame
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import make_sequence

    # cfg_files/fit_seq.yaml's weights; LM as [fit].
    cfg = FitConfig(pose_weights=(404.0, 404.0, 57.4, 4.78),
                    shape_weights=(100.0, 50.0, 10.0, 5.0),
                    coll_weights=(0.0, 0.0, 0.0, 0.0), is_seq=True,
                    lm=LMOptions(max_iters=40))
    assets, vw, cam, steps = make_sequence(6, B_FIT, SEQ_STEPS, seed=0,
                                           device=dev, model_type="smpllsp")
    prev = None
    per_step = []
    t_all = time.perf_counter()
    for k, obs in enumerate(steps):
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
        warm = 0.0
        if prev is not None:
            warm = (prev.loss <= 5000.0).double().mean().item()
            guess = warm_start(prev.params, prev.z, prev.loss, guess)
        prev = fit_frame(cfg, assets, cam, obs, guess.params, guess.z,
                         vposer_w=vw, seq_start=k == 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        assert prev.stage_losses.shape == (B_FIT, 4 if k == 0 else 2)
        assert bool(torch.isfinite(prev.loss).all()), "non-finite loss"
        assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
        launches[f"seq_{k}"] = got
        per_step.append(f"{B_FIT / wall:.1f}")
        log("seq", step=k, frames=B_FIT, stages=prev.stage_losses.shape[1],
            fps=f"{B_FIT / wall:.1f}", wall_s=f"{wall:.3f}",
            share_warm_started=f"{warm:.4f}",
            lm_iterations=int(prev.lm_iters.amax(dim=0).sum().item()),
            median_final_loss=f"{prev.loss.median().item():.3f}",
            launches=json.dumps(got).replace(" ", ""))
    log("seq", sequences=B_FIT, steps=SEQ_STEPS,
        wall_s=f"{time.perf_counter() - t_all:.3f}",
        fps_per_step=",".join(per_step))


def adjust_phase(dev, launches: dict, cfg, assets, vw, cam, obs,
                 first) -> None:
    """[adjust]: one refit of [fit]'s result against keypoints of each
    body moved +8 cm in x."""
    from mvsmplfitting_tpu_torch.fitting.adjust import (
        refit_with_observations)
    from mvsmplfitting_tpu_torch.models.camera import project_points
    from mvsmplfitting_tpu_torch.models.smpl import smpl_forward
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK

    shift = torch.tensor([0.08, 0.0, 0.0], device=dev)
    moved = dataclasses.replace(first.params,
                                transl=first.params.transl + shift)
    _, joints = smpl_forward(assets, moved, first.body_pose)
    edited = dataclasses.replace(
        obs, gt2d=project_points(cam, joints).transpose(0, 1).contiguous())
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = refit_with_observations(cfg, assets, cam, edited, first,
                                  vposer_w=vw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
    launches["adjust"] = got
    delta = res.params.transl - first.params.transl
    ok = ((delta - shift).abs() <= 0.02).all(-1)
    log("adjust", frames=B_FIT, fps=f"{B_FIT / wall:.1f}",
        wall_s=f"{wall:.3f}", lm_iterations=int(res.lm_iters.max()),
        median_delta=_compact(delta.median(0).values, 4),
        share_within_0_02=f"{ok.double().mean().item():.4f}",
        launches=json.dumps(got).replace(" ", ""))
    assert bool(torch.isfinite(res.loss).all()), "non-finite loss"
    assert ok.double().mean().item() >= 0.95, delta


def family_phase(dev, launches: dict, model_type: str, frames: int,
                 spec_kw: dict, max_iters: int, px_limit: float) -> None:
    """[smplx] / [smplh]: the batched fit of SMPL-X (coco25) or SMPL-H
    (coco17) with the tail blocks of `spec_kw`, VPoser, the library LM
    and anneal; the AD Jacobian, as in JAX (no kernel launches)."""
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    spec = E.EnergySpec(**spec_kw)
    cfg = FitConfig(spec=spec, lm=LMOptions(max_iters=max_iters))
    assets, vw, cam, obs = make_problem(6, frames, seed=0, device=dev,
                                        model_type=model_type)
    batch = BatchedFitInputs(obs, torch.full((frames,), 1080.0, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    peak = torch.cuda.max_memory_allocated(dev)
    assert res.stage_losses.shape == (frames, 4)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    assert sum(got.values()) == 0, got
    launches[model_type] = got
    px = E.reprojection_error_px(spec, assets, cam, obs, vw,
                                 E.pack(spec, res.params, res.z))
    med_px = px.median().item()
    log(model_type, frames=frames, views=6, keypoints=obs.gt2d.shape[2],
        unknowns=E.num_unknowns(spec), fps=f"{frames / wall:.1f}",
        wall_s=f"{wall:.3f}",
        lm_iterations=int(res.lm_iters.amax(dim=0).sum().item()),
        median_final_loss=f"{res.loss.median().item():.3f}",
        median_reproj_px=f"{med_px:.4f}",
        max_reproj_px=f"{px.max().item():.4f}",
        peak_alloc_mib=f"{peak / 2**20:.1f}",
        peak_over_inputs_mib=f"{(peak - base) / 2**20:.1f}",
        launches=json.dumps(got).replace(" ", ""))
    assert med_px < px_limit, (model_type, med_px)

    short = FitConfig(spec=spec, lm=LMOptions(max_iters=3, linsolve="chol",
                                              speculative=False))
    prob = make_problem(6, B_CHECK, seed=1, device="cpu",
                        model_type=model_type)

    def run(d):
        a, w, c, o = (v.to(d) for v in prob)
        return batched_fit_frames(
            short, a, c, BatchedFitInputs(o, torch.full((B_CHECK,), 1080.0,
                                                        device=d)),
            vposer_w=w, device=d).stage_losses
    rel = check_fits(run, dev)
    log(model_type, parity_frames=B_CHECK, stage_losses_max_rel=f"{rel:.3e}",
        tolerance="rtol 1e-3")


def schur_phase(dev, launches: dict) -> None:
    """[schur]: one person's sequence with one shared (betas, scale)."""
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.schur import schur_sequence_fit
    from mvsmplfitting_tpu_torch.synthetic import make_person_sequence

    def fit(cfg, prob, d):
        assets, vw, cam, obs = (v.to(d) for v in prob[:4])
        guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
        return schur_sequence_fit(cfg, assets, cam, obs, guess.params,
                                  guess.z, vposer_w=vw, device=d)

    cfg = FitConfig(lm=LMOptions(max_iters=40))
    prob = make_person_sequence(B_SCHUR, seed=0, device=dev)
    truth = prob[4]
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    params, z, losses, shared, iters = fit(cfg, prob, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches(JK, VK, SK)
    launches["schur"] = got
    scale, betas = shared[10].item(), shared[:10].cpu().numpy()
    beta_err = np.abs(betas - truth["betas"][0]).max()
    assets, vw, cam, obs = prob[:4]
    px = E.reprojection_error_px(cfg.spec, assets, cam, obs, vw,
                                 E.pack(cfg.spec, params, z))
    log("schur", frames=B_SCHUR, views=6, model="smpl",
        fps=f"{B_SCHUR / wall:.1f}", wall_s=f"{wall:.3f}",
        lm_iterations=",".join(str(i) for i in iters),
        median_final_loss=f"{losses.median().item():.3f}",
        mean_final_loss=f"{losses.mean().item():.3f}",
        max_final_loss=f"{losses.max().item():.3f}",
        median_reproj_px=f"{px.median().item():.4f}",
        max_reproj_px=f"{px.max().item():.4f}",
        scale=f"{scale:.4f}", scale_true=f"{truth['scale'][0]:.4f}",
        betas_max_abs_err=f"{beta_err:.4f}",
        launches=json.dumps(got).replace(" ", ""))
    assert bool(torch.isfinite(losses).all()), "non-finite loss"
    assert abs(scale - 1.15) <= 0.05 * 1.15, scale
    assert beta_err <= 0.6, (betas, truth["betas"][0])
    for name in ("joint_jacobian", "vposer_tail"):
        assert got[name] >= sum(iters), (name, got, iters)

    # Card against the CPU: 8 frames, 4 stages of 3 LM iterations.
    short = FitConfig(lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False))
    small = make_person_sequence(B_CHECK, seed=1, device="cpu")
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, _, l8, s8, it8 = fit(short, small, d)
        out[name] = (s8.cpu(), l8.cpu(), it8)
    # Betas near 0 (~1e-2) differ by ~2e-5 in fp32, hence the shared
    # block's atol.
    assert out["cuda"][2] == out["cpu"][2], (out["cuda"][2], out["cpu"][2])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-3,
                               atol=0.0)
    d_shared = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    rel = ((out["cuda"][1] - out["cpu"][1]).abs()
           / out["cpu"][1].abs()).max().item()
    log("schur", parity_frames=B_CHECK, shared_max_abs=f"{d_shared:.3e}",
        losses_max_rel=f"{rel:.3e}",
        tolerance="shared rtol 1e-3 atol 1e-4, losses rtol 1e-3")


B_SHARD = 64           # [shard]'s frames (cut from B_FIT to hold ~90 s)
SHARD_CAPS = (3, 40)   # [shard]: LM iterations per stage, smoke and converged
SHARD_RTOL = {3: 5e-2, 40: 1e-3}   # `__graft_entry__.py:186-190`
SHARD_TIMEOUT_S = 240  # a collective that waits longer fails the rank


class CollectiveClock:
    """Every `torch.distributed.all_reduce` for the length of a `with`
    block: calls, floats and host seconds inside them (the device is
    synchronized before and after each, so the time is the collective's
    own and not the queued kernels')."""

    def __init__(self, dev):
        self.dev = dev
        self.calls, self.floats, self.seconds = 0, 0, 0.0

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.orig = dist, dist.all_reduce

        def timed(t, *args, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = self.orig(t, *args, **kw)
            _sync(self.dev)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.floats += t.numel()
            return out
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


class ShardIters:
    """The loop turns of each `_lm_sharded` call (one Jacobian each, so
    one B1 and one B2 launch each) for the length of a `with` block."""

    def __init__(self):
        self.iters = []

    def __enter__(self):
        from mvsmplfitting_tpu_torch.parallel import camera_shard
        self.module, self.orig = camera_shard, camera_shard._lm_sharded

        def counted(*args, **kw):
            out = self.orig(*args, **kw)
            self.iters.append(int(out[2].max()))
            return out
        camera_shard._lm_sharded = counted
        return self

    def __exit__(self, *exc):
        self.module._lm_sharded = self.orig


def _sharded_runs(dev, mesh, problem) -> dict:
    """`camera_sharded_fit` of `problem` on `mesh` at each of SHARD_CAPS:
    per cap the losses, wall, LM iterations per stage, B1/B2 launches
    and collective calls, floats and seconds."""
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel import camera_sharded_fit
    assets, vw, cam, obs = problem
    out = {}
    for cap in SHARD_CAPS:
        with ShardIters() as its, CollectiveClock(dev) as clock:
            _sync(dev)
            reset_launches(JK, VK, SK)
            t0 = time.perf_counter()
            x, loss = camera_sharded_fit(FitConfig(), assets, cam, obs, mesh,
                                         vposer_w=vw, max_iters_cap=cap,
                                         device=dev)
            _sync(dev)
            wall = time.perf_counter() - t0
            got = read_launches(JK, VK, SK)
        out[cap] = dict(x=x.cpu(), loss=loss.cpu(), wall=wall,
                        iters=its.iters, launches=got, calls=clock.calls,
                        floats=clock.floats, comm_s=clock.seconds)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frames_runs(dev, mesh, problem, seq) -> dict:
    """`batched_fit_frames` and `schur_sequence_fit` with `mesh` (None:
    one card): results, walls, launches and collectives."""
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel import (BatchedFitInputs,
                                                  batched_fit_frames,
                                                  schur_sequence_fit)
    assets, vw, cam, obs = problem
    sa, sw, sc, so = seq[:4]
    cfg = FitConfig(lm=LMOptions(max_iters=40))
    out = {}
    for name in ("batched", "schur"):
        with CollectiveClock(dev) as clock:
            _sync(dev)
            reset_launches(JK, VK, SK)
            t0 = time.perf_counter()
            if name == "batched":
                res = batched_fit_frames(
                    cfg, assets, cam, BatchedFitInputs(
                        obs, torch.full((B_SHARD,), 1080.0, device=dev)),
                    vposer_w=vw, mesh=mesh, device=dev)
                got = dict(loss=res.loss.cpu(),
                           iters=res.lm_iters.amax(0).tolist())
            else:
                g = init_guess(sa, sc, so.gt2d, so.conf, so.view_mask)
                _, _, losses, shared, iters = schur_sequence_fit(
                    cfg, sa, sc, so, g.params, g.z, vposer_w=sw, mesh=mesh,
                    device=dev)
                got = dict(loss=losses.cpu(), shared=shared.cpu(),
                           iters=iters)
            _sync(dev)
            got.update(wall=time.perf_counter() - t0,
                       launches=read_launches(JK, VK, SK),
                       calls=clock.calls, floats=clock.floats,
                       comm_s=clock.seconds)
        out[name] = got
    return out


def _shard_inputs(dev):
    from mvsmplfitting_tpu_torch.synthetic import (make_person_sequence,
                                                   make_problem)
    return (make_problem(6, B_SHARD, seed=0, device=dev),
            make_person_sequence(B_SHARD, seed=0, device=dev))


def shard_child(rank: int, world: int, port: int, device: str,
                out_dir: str) -> None:
    """One spawned rank of [shard] (b) or (c): a gloo world on one card;
    writes its results to ``out_dir/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mvsmplfitting_tpu_torch import parallel as P
    from mvsmplfitting_tpu_torch.ops import cuda_build
    dev = torch.device(device)
    if dev.type == "cuda":
        # The parent built the kernels; a rank only loads them.
        for name in ("joint_jacobian", "vposer_tail"):
            path = cuda_build.library_path(name)
            assert path.exists(), f"rank {rank}: {path} was not built"
    dev = P.init_distributed(f"localhost:{port}", world, rank,
                             backend="gloo", device=dev,
                             timeout=datetime.timedelta(
                                 seconds=SHARD_TIMEOUT_S))
    problem, seq = _shard_inputs(dev)
    layout = (1, 2) if world == 2 else (2, 2)
    got = {"layout": layout, "sharded": _sharded_runs(
        dev, P.make_mesh(P.MeshLayout(*layout)), problem)}
    if world == 2:
        got["frames"] = _frames_runs(dev, P.make_mesh(P.MeshLayout(2, 1)),
                                     problem, seq)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_line(run, rank, mesh, cap, r) -> dict:
    """The fields of one sharded run's log line."""
    calls = max(r["calls"], 1)
    iters = sum(r["iters"])
    return dict(run=run, rank=rank, mesh=mesh, cap=cap,
                wall_s=f"{r['wall']:.3f}",
                lm_iterations=",".join(str(i) for i in r["iters"]),
                collectives=r["calls"],
                floats_per_iteration=f"{r['floats'] / max(iters, 1):.0f}",
                floats_per_call=f"{r['floats'] / calls:.0f}",
                collective_s=f"{r['comm_s']:.3f}",
                collective_share=f"{r['comm_s'] / r['wall']:.3f}",
                launches=json.dumps(r["launches"]).replace(" ", ""))


def shard_phase(dev, launches: dict) -> None:
    """[shard]: the camera- and frame-sharded fits over torch.distributed
    (see the docstring)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from mvsmplfitting_tpu_torch import parallel as P
    t_phase = time.perf_counter()
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    # (a) the yardstick: a world of 1 in this process, NCCL on the card.
    backend = "nccl" if dev.type == "cuda" else "gloo"
    P.init_distributed(f"localhost:{_free_port()}", 1, 0, backend=backend,
                       device=dev)
    try:
        assert dist.get_backend() == backend
        problem, seq = _shard_inputs(dev)
        ref = _sharded_runs(dev, P.make_mesh(P.MeshLayout(1, 1)), problem)
    finally:
        dist.destroy_process_group()
    for cap, r in ref.items():
        count(r["launches"])
        loss = r["loss"]
        log("shard", backend=backend, frames=B_SHARD, views=6,
            median_loss=f"{loss.median().item():.3f}",
            **_run_line("a", 0, "1x1", cap, r))
        assert bool(torch.isfinite(loss).all()), "non-finite loss"
        assert len(np.unique(np.round(loss.numpy(), 3))) > 1, loss
        for name in ("joint_jacobian", "vposer_tail"):
            assert r["launches"][name] >= sum(r["iters"]), (name, r)
    one = _frames_runs(dev, None, problem, seq)
    for name, r in one.items():
        count(r["launches"])

    # (b), (c): spawned ranks, gloo on the same card.
    out_dir = tempfile.mkdtemp(prefix="mvsf_shard_")
    try:
        ranks = {}
        for world in (2, 4):
            t0 = time.perf_counter()
            sub = os.path.join(out_dir, str(world))
            os.makedirs(sub)
            mp.spawn(shard_child, args=(world, _free_port(), str(dev), sub),
                     nprocs=world, join=True)
            ranks[world] = [torch.load(os.path.join(sub, f"rank{r}.pt"),
                                       weights_only=False)
                            for r in range(world)]
            log("shard", world=world, spawn_and_run_s=
                f"{time.perf_counter() - t0:.2f}")
    finally:
        shutil.rmtree(out_dir)

    for world, run in ((2, "b"), (4, "c")):
        for rank, got in enumerate(ranks[world]):
            mesh = "x".join(str(a) for a in got["layout"])
            for cap, r in got["sharded"].items():
                count(r["launches"])
                loss, want = r["loss"], ref[cap]["loss"]
                rel = ((loss - want).abs() / want.abs()).max().item()
                log("shard", max_rel_vs_a=f"{rel:.3e}",
                    **_run_line(run, rank, mesh, cap, r))
                assert bool(torch.isfinite(loss).all()), (run, rank, loss)
                assert len(np.unique(np.round(loss.numpy(), 3))) > 1, loss
                torch.testing.assert_close(loss, want, rtol=SHARD_RTOL[cap],
                                           atol=0.0)
                for name in ("joint_jacobian", "vposer_tail"):
                    assert r["launches"][name] >= sum(r["iters"]), (name, r)

    # The frames-sharded batched and Schur fits against one card.
    for rank, got in enumerate(ranks[2]):
        for name, r in got["frames"].items():
            count(r["launches"])
            want = one[name]
            rel = ((r["loss"] - want["loss"]).abs()
                   / want["loss"].abs()).max().item()
            extra = {}
            if name == "schur":
                extra["shared_max_abs_vs_one_card"] = (
                    f"{(r['shared'] - want['shared']).abs().max().item():.3e}")
                torch.testing.assert_close(r["shared"], want["shared"],
                                           rtol=0.0, atol=0.15)
                torch.testing.assert_close(r["loss"], want["loss"],
                                           rtol=0.3, atol=0.0)
            else:
                torch.testing.assert_close(r["loss"], want["loss"],
                                           rtol=1e-2, atol=0.0)
            log("shard", fit=name, one_card_wall_s=f"{want['wall']:.3f}",
                one_card_lm_iterations=",".join(str(i)
                                                for i in want["iters"]),
                max_rel_vs_one_card=f"{rel:.3e}", **extra,
                **_run_line("b", rank, "2x1", 40, r))
            for k in ("joint_jacobian", "vposer_tail"):
                assert r["launches"][k] >= sum(r["iters"]), (name, k, r)
    launches["shard"] = total
    log("shard", seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches=json.dumps(total).replace(" ", ""))


def _tree_mtimes(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = os.stat(path).st_mtime_ns
    return out


def _run_cli(argv, timer=None):
    """`cli.main.main(argv)` in this process; (return code, stdout)."""
    import contextlib
    import io

    from mvsmplfitting_tpu_torch.cli import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, timer=timer)
    return rc, buf.getvalue()


def cli_phase(dev, launches: dict) -> None:
    """[cli]: the fitting CLI on workspaces in the reference's layout
    (`synthetic.write_workspace`): batched mode at full width in this
    process, sequence mode and `--resume` through a subprocess, the
    two-person mode in this process."""
    import tempfile

    from mvsmplfitting_tpu_torch.config import load_config
    from mvsmplfitting_tpu_torch.data import native
    from mvsmplfitting_tpu_torch.data.dataset import (cat_observations,
                                                      frame_to_observations)
    from mvsmplfitting_tpu_torch.data.results import (load_result_pkl,
                                                      zero_extremities)
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.fitting.multi_person import fit_people
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (BatchedFitInputs,
                                                          batched_fit_frames)
    from mvsmplfitting_tpu_torch.session import build_session
    from mvsmplfitting_tpu_torch.synthetic import write_workspace
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer

    keys = {"betas": (1, 10), "global_orient": (1, 3), "transl": (1, 3),
            "scale": (1, 1), "body_pose": (1, 69), "pose": (1, 72),
            "pose_embedding": (1, 32)}
    with tempfile.TemporaryDirectory(prefix="mvsf_cli_") as tmp:
        absent = os.path.join(tmp, "absent")

        def argv(config, ws, out, *extra, images=False):
            return ["--config", os.path.join(ROOT, "cfg_files", config),
                    "--data_folder", ws["data_folder"], "--cam_param",
                    ws["cam_param"], "--output_folder", out,
                    "--model_folder", absent, "--prior_folder", absent,
                    *(() if images else ("--no_save_images",)),
                    "--device", dev.type, *extra]

        # ---- batched mode at full width --------------------------------
        t0 = time.perf_counter()
        ws = write_workspace(os.path.join(tmp, "ws"), num_frames=B_CLI,
                             model_type="smpllsp", device=dev)
        ws_s = time.perf_counter() - t0
        out = os.path.join(tmp, "batched")
        args = argv("fit_batched.yaml", ws, out)
        timer = StageTimer()
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        rc, printed = _run_cli(args, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches["cli_batched"] = got
        assert rc == 0, printed
        spans = timer.totals()

        # The same session's observations through the library, twice.
        cfg = load_config(args[1], data_folder=ws["data_folder"],
                          cam_param=ws["cam_param"], output_folder=out,
                          model_folder=absent, prior_folder=absent,
                          save_images=False)
        back = load_config(os.path.join(out, "conf.yaml"))
        assert dataclasses.asdict(back) == dataclasses.asdict(cfg), back
        sess = build_session(cfg, device=dev)
        frames = list(sess.dataset)
        assert len(frames) == B_CLI and cfg.batch_frames == B_CLI
        obs = cat_observations([frame_to_observations(
            f, sess.joint_weights, device=dev) for f in frames])
        batch = BatchedFitInputs(obs, torch.tensor(
            [float(f.img_hw[0]) for f in frames], device=dev))
        refs = []
        for _ in range(2):
            r = batched_fit_frames(sess.fit_config, sess.assets,
                                   sess.cameras, batch, vposer_w=sess.vposer,
                                   device=dev)
            refs.append({
                "loss": r.loss, "betas": r.params.betas,
                "global_orient": r.params.global_orient,
                "transl": r.params.transl, "scale": r.params.scale,
                "pose_embedding": r.z,
                "body_pose": torch.as_tensor(zero_extremities(
                    r.body_pose.cpu().numpy()))})
        lm_iters = int(r.lm_iters.amax(dim=0).sum().item())
        refs = [{k: v.cpu() for k, v in ref.items()} for ref in refs]

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30)).item()

        spread = max(rel(refs[0][k], refs[1][k]) for k in refs[0])
        tol = max(1e-5, spread)
        pkls = [load_result_pkl(os.path.join(
            out, "results", ws["serial"], fr, "000.pkl"))
            for fr in ws["frames"]]
        for d in pkls:
            assert sorted(d) == sorted(list(keys) + ["loss"]), sorted(d)
            for k, shp in keys.items():
                assert d[k].shape == shp and d[k].dtype == np.float32, k
        cli_vals = {k: torch.as_tensor(np.stack(
            [np.asarray(d[k], np.float32).reshape(-1) for d in pkls]))
            for k in refs[0]}
        cli_vals["scale"] = cli_vals["scale"][:, 0]
        cli_vals["loss"] = cli_vals["loss"][:, 0]
        assert bool(torch.isfinite(cli_vals["loss"]).all()), "non-finite"
        cli_err = max(rel(cli_vals[k], refs[0][k]) for k in refs[0])
        for k in refs[0]:
            # rtol, with an atol of the same share of the key's largest
            # magnitude (betas and poses sit near 0).
            torch.testing.assert_close(
                cli_vals[k], refs[0][k], rtol=tol,
                atol=tol * refs[0][k].abs().max().item(), msg=k)
        n_v = []
        for fr in ws["frames"]:
            with open(os.path.join(out, "meshes", ws["serial"], fr,
                                   "000.obj"), "rb") as f:
                data = f.read()
            n_v.append(data.count(b"\nv ") + data.startswith(b"v "))
        assert n_v == [6890] * B_CLI, set(n_v)
        # The reprojection error of the CLI's own results.
        x = E.pack(sess.fit_config.spec, SMPLParams(
            betas=cli_vals["betas"], global_orient=cli_vals["global_orient"],
            body_pose=torch.zeros((B_CLI, 69)), transl=cli_vals["transl"],
            scale=cli_vals["scale"]), cli_vals["pose_embedding"]).to(dev)
        px = E.reprojection_error_px(sess.fit_config.spec, sess.assets,
                                     sess.cameras, obs, sess.vposer, x).cpu()
        for name in ("joint_jacobian", "vposer_tail"):
            assert got[name] >= lm_iters, (name, got, lm_iters)
        assert px.median().item() < 2.0, px.median()
        log("cli", mode="batched", config="fit_batched.yaml",
            frames=B_CLI, views=6, model=cfg.model_type,
            native_loader=native.available(), workspace_s=f"{ws_s:.3f}",
            wall_s=f"{wall:.3f}", fps=f"{B_CLI / wall:.1f}",
            session_s=f"{spans['session']:.3f}",
            read_s=f"{spans['read']:.3f}", fit_s=f"{spans['fit']:.3f}",
            write_s=f"{spans['write']:.3f}",
            fit_fps=f"{B_CLI / spans['fit']:.1f}",
            io_share=f"{(spans['read'] + spans['write']) / wall:.4f}",
            lm_iterations=lm_iters,
            median_final_loss=f"{cli_vals['loss'].median().item():.3f}",
            median_reproj_px=f"{px.median().item():.4f}",
            max_reproj_px=f"{px.max().item():.4f}",
            library_spread_rel=f"{spread:.3e}",
            cli_vs_library_rel=f"{cli_err:.3e}", tolerance=f"rtol {tol:.0e}",
            conf_yaml="reads back equal",
            launches=json.dumps(got).replace(" ", ""))

        # ---- sequence mode in a subprocess, then --resume ---------------
        ws = write_workspace(os.path.join(tmp, "ws_seq"), kind="sequence",
                             num_frames=SEQ_CLI, model_type="smpllsp",
                             device=dev)
        out = os.path.join(tmp, "seq")
        cmd = [sys.executable, "-m", "mvsmplfitting_tpu_torch.cli.main",
               *argv("fit_seq.yaml", ws, out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout + proc.stderr
        rows = re.findall(r"stages \[([^\]]*)\] final ([0-9.eE+-]+) reproj "
                          r"([0-9.]+)px in ([0-9.]+)s", proc.stdout)
        done = float(re.search(r"Processed \d+ frame\(s\) in ([0-9.]+)s",
                               proc.stdout).group(1))
        assert [len(r[0].split()) for r in rows] == [4] + [2] * (SEQ_CLI - 1)
        # Frames 1.. warm-start: the sequence schedule ran, and the frame
        # before each ended at or below `warm_start`'s loss threshold.
        assert all(float(r[1]) <= 5000.0 for r in rows[:-1]), rows
        before = _tree_mtimes(out)
        assert len(before) == 2 * SEQ_CLI + 1, sorted(before)
        t0 = time.perf_counter()
        again = subprocess.run(cmd + ["--resume"], capture_output=True,
                               text=True, cwd=ROOT, timeout=600)
        wall_resume = time.perf_counter() - t0
        assert again.returncode == 0, again.stdout + again.stderr
        assert again.stdout.count("Skipping (resume)") == SEQ_CLI
        assert "Processing" not in again.stdout
        assert _tree_mtimes(out) == before
        log("cli", mode="sequence", config="fit_seq.yaml", frames=SEQ_CLI,
            subprocess_s=f"{wall:.3f}", loop_s=f"{done:.3f}",
            start_s=f"{wall - done:.3f}",
            frame_s=",".join(r[3] for r in rows),
            reproj_px=",".join(r[2] for r in rows),
            final_loss=",".join(r[1] for r in rows),
            warm_started=SEQ_CLI - 1, resume_s=f"{wall_resume:.3f}",
            resume="skipped all, files unchanged")

        # ---- two people with the collision refinement --------------------
        ws = write_workspace(os.path.join(tmp, "ws_people"), kind="people",
                             dx0=0.2, device=dev)
        out = os.path.join(tmp, "multi")
        # With the overlays, as the config ships (`save_overlays_multi`).
        args = argv("fit_multi_person_sdf.yaml", ws, out, images=True)
        timer = StageTimer()
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        rc, printed = _run_cli(args, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches["cli_multi"] = got
        assert rc == 0, printed
        img_dir = os.path.join(out, "images", ws["serial"], ws["frames"][0])
        assert sorted(os.listdir(img_dir)) == [f"{v:02d}.jpg"
                                               for v in range(6)]
        images_s = timer.totals()["images"]
        s_ref = [float(v) for v in re.search(
            r"coll \[([^\]]*)\]", printed).group(1).split(",")]
        d = os.path.join(out, "results", ws["serial"], ws["frames"][0])
        people = [load_result_pkl(os.path.join(d, f"{p:03d}.pkl"))
                  for p in range(2)]
        x = [p["transl"][0, 0] for p in people]
        assert x[0] < x[1], x                   # the truth: -0.2, +0.2
        # The solo fits' sums: the same session without the refinement.
        cfg = load_config(args[1], data_folder=ws["data_folder"],
                          cam_param=ws["cam_param"], model_folder=absent,
                          prior_folder=absent, save_images=False)
        sess = build_session(cfg, device=dev)
        frame = sess.dataset[0]
        obs = cat_observations([frame_to_observations(
            frame, sess.joint_weights, person=p, device=dev)
            for p in range(2)])
        solo, _ = fit_people(sess.fit_config, sess.assets, sess.cameras, obs,
                             vposer_w=sess.vposer, refine_collision=False,
                             img_height=float(frame.img_hw[0]), device=dev)
        verts = smpl_forward(sess.assets, solo.params,
                             V.decode(sess.vposer, solo.z))[0]
        s_solo = S.collision_sums_points(verts, sess.assets.faces).cpu()
        assert sum(s_ref) < float(s_solo.sum()), (s_ref, s_solo)
        assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
        log("cli", mode="multi_person", config="fit_multi_person_sdf.yaml",
            people=2, engine=cfg.sdf_engine, wall_s=f"{wall:.3f}",
            transl_x=",".join(f"{v:.4f}" for v in x),
            sums_solo=_compact(s_solo), sums_refined=",".join(
                f"{v:.4g}" for v in s_ref),
            losses=",".join(f"{p['loss']:.3f}" for p in people),
            overlays=6, images_s=f"{images_s:.3f}",
            launches=json.dumps(got).replace(" ", ""))


KP_FRAMES = 4          # [keypoints]: frames of the six fixture views
KP_TARGET = 8          # [keypoints]: detector candidates per view (mean)
KP_CHECK_CROPS = 16    # [keypoints]: crops of the card-vs-CPU pose check
KP_PROGRESSIVE = "jpeg_prog_420_1920x1080_q90.jpg"   # [keypoints], [stream]


def write_bmp24(path: str, img: np.ndarray) -> None:
    """`img` ((H, W, 3) uint8 BGR) as a 24-bit bottom-up BMP."""
    h, w = img.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, 3 * w)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835,
                       2835, 0, 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
                + info + rows.tobytes())
IMAGE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "images")
VIDEO_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "video")
ST_MPEG4_CLIP = "mp4v_1920x1080.mp4"   # [stream] (f): 12 frames
ST_ENCODE_FRAMES = 6   # [stream] (f): 1080p frames timed through the encoder
ST_H264_CLIP = "h264_1920x1080.mp4"    # [stream] (g): 12 frames, coded 1088


def _obj_bias_shift(decoded: torch.Tensor, thresh: float, target: int
                    ) -> float:
    """The shift of YOLOX's objectness logits after which `target`
    anchors of `decoded` (N, A, 6) score >= `thresh`: the least one, by
    bisection (each anchor's score grows with the shift)."""
    obj = decoded[..., 4].double().clamp(1e-30, 1 - 1e-7)
    logit = torch.log(obj) - torch.log1p(-obj)
    cls = decoded[..., 5].double()

    def count(d):
        return int(((torch.sigmoid(logit + d) * cls) >= thresh).sum())

    lo, hi = -60.0, 60.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if count(mid) >= target else (mid, hi)
    return hi


def keypoint_weights(dev):
    """YOLOX-X and FastPose (26 joints) checkpoints in the reference's
    names from seed 0, made once in `main` for [keypoints] and [stream]:
    (det_sd, pose_sd, objectness shift, the six fixture views'
    letterboxed batch on `dev`).

    Random YOLOX-X weights at `random_state_dict`'s gain are chaotic on
    raw 0-255 pixels: activations reach ~1e4, box logits ~600, and fp32
    rounding moves box logits by ~1e-3 (~1e-2 with BatchNorm statistics
    set from data); at half that gain on the BaseConv convolutions the
    net is contractive (fp32 moves its outputs by ~3e-7 against float64,
    on a CPU at 256x448).  The box-size biases get log(6) (boxes ~6
    strides wide), and the objectness bias is shifted so that ~KP_TARGET
    anchors a view pass `--det_thresh` 0.1 (`_obj_bias_shift`).
    FastPose's random weights keep heatmaps O(1) on normalized crops and
    are used as they are."""
    from mvsmplfitting_tpu_torch.data.images import read_image
    from mvsmplfitting_tpu_torch.detect import predictor as TP
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    from mvsmplfitting_tpu_torch.detect.weights import random_state_dict
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    dev_imgs = [torch.from_numpy(read_image(os.path.join(
        IMAGE_FIXTURES, "views", f"Camera0{v}.jpg"))).to(dev)
        for v in range(6)]
    gen = torch.Generator().manual_seed(0)
    det_sd = random_state_dict(YOLOX(), gen)
    pose_sd = random_state_dict(FastPose(26), gen)
    for k in det_sd:
        if k.endswith(".conv.weight"):
            det_sd[k] *= 0.5
    for i in range(3):
        det_sd[f"head.reg_preds.{i}.bias"][2:] += float(np.log(6.0))
    det = TP.PersonDetector(det_sd, device=dev)
    batch, _ = det.letterbox_batch(dev_imgs)
    shift = _obj_bias_shift(det.forward(batch), det.conf_thresh,
                            KP_TARGET * len(dev_imgs))
    for i in range(3):
        det_sd[f"head.obj_preds.{i}.bias"] += shift
    return det_sd, pose_sd, shift, batch


def keypoints_phase(dev, launches: dict, weights) -> None:
    """[keypoints]: the keypoint CLI (`mvsmplfitting_tpu_torch.cli.
    keypoints`) at full width on the committed 1920x1080 views, with
    `keypoint_weights`' checkpoints."""
    import contextlib
    import hashlib
    import io
    import shutil
    import tempfile

    from mvsmplfitting_tpu_torch.cli import keypoints as kcli
    from mvsmplfitting_tpu_torch.data.dataset import FittingDataset
    from mvsmplfitting_tpu_torch.data.images import ImageError, read_image
    from mvsmplfitting_tpu_torch.detect import predictor as TP
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    from mvsmplfitting_tpu_torch.detect.preprocess import (
        bbox_to_center_scale, crop_affine, decode_margins, heatmap_to_coords)
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer, conv_flops

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # ---- the image reader against OpenCV's recorded decodes -----------
    with open(os.path.join(IMAGE_FIXTURES, "decoded.json")) as f:
        recorded = json.load(f)
    for name, rec in sorted(recorded.items()):
        path = os.path.join(IMAGE_FIXTURES, name)
        if rec is None:
            try:
                read_image(path)
            except ImageError:
                continue
            raise AssertionError(f"{name}: decoded, should be refused")
        img = read_image(path)
        assert list(img.shape) == rec["shape"], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == rec["sha256"], \
            f"{name}: not OpenCV's bytes"
    views = [os.path.join(IMAGE_FIXTURES, "views", f"Camera0{v}.jpg")
             for v in range(6)]
    t0 = time.perf_counter()
    imgs = [read_image(p) for p in views]
    read_s = (time.perf_counter() - t0) / 6
    # The progressive fixture is view 1's render: the two decodes of that
    # view in turns, the median of each.
    progressive = os.path.join(IMAGE_FIXTURES, KP_PROGRESSIVE)
    turns = {views[1]: [], progressive: []}
    for _ in range(6):
        for p, ts in turns.items():
            t0 = time.perf_counter()
            read_image(p)
            ts.append(time.perf_counter() - t0)
    base_s, prog_s = (float(np.median(ts)) for ts in turns.values())
    kinds = {}
    for name in recorded:
        kind = name.split("_")[0] if "_" in name else "view"
        kinds[kind] = kinds.get(kind, 0) + 1
    log("keypoints", reader_files=len(recorded),
        refused=sum(r is None for r in recorded.values()),
        files_by_kind=json.dumps(kinds).replace(" ", ""),
        matches="opencv_sha256", decode_ms_1080p=f"{1e3 * read_s:.2f}",
        decode_ms_view1_baseline_median=f"{1e3 * base_s:.2f}",
        decode_ms_view1_progressive_median=f"{1e3 * prog_s:.2f}",
        card=repr(card_line()))

    # ---- weights from seed 0 in the reference's names (see
    # `keypoint_weights`) ------------------------------------------------
    t0 = time.perf_counter()
    dev_imgs = [torch.from_numpy(i).to(dev) for i in imgs]
    det_sd, pose_sd, shift, batch = weights
    # bfloat16 moves these near-uniform scores by more than their spread
    # and rounds them to a few hundred values (~700 candidates a view at
    # 0.1): its run takes the least threshold that passes at most
    # KP_TARGET a view on the same views.
    det16 = TP.PersonDetector(det_sd, bf16=True, device=dev)
    dec16 = det16.forward(batch)
    score16 = (dec16[..., 4] * dec16[..., 5]).flatten()
    thresh16 = float(score16.topk(KP_TARGET * len(views)).values[-1])
    if int((score16 >= thresh16).sum()) > KP_TARGET * len(views):
        thresh16 = float(score16[score16 > thresh16].min())
    log("keypoints", weights="seed 0", yolox_conv_gain=0.5,
        obj_bias_shift=f"{shift:.4f}", det_thresh_fp32=0.1,
        det_thresh_bf16=f"{thresh16:.6f}",
        seconds=f"{time.perf_counter() - t0:.2f}")

    with tempfile.TemporaryDirectory(prefix="mvsf_kp_") as tmp:
        yolox_ckpt = os.path.join(tmp, "bytetrack_x_mot17.pth.tar")
        pose_ckpt = os.path.join(tmp, "fast_res50_256x192.pth")
        torch.save({"model": det_sd}, yolox_ckpt)
        torch.save(pose_sd, pose_ckpt)
        ws = os.path.join(tmp, "data")
        for v, src in enumerate(views):
            d = os.path.join(ws, "images", "0000", f"Camera0{v}")
            os.makedirs(d)
            for f in range(KP_FRAMES):
                shutil.copy(src, os.path.join(d, f"{f:06d}.jpg"))
        args = ["--data_folder", ws, "--yolox_ckpt", yolox_ckpt,
                "--pose_ckpt", pose_ckpt, "--device", dev.type]

        # Each mode runs twice; the second (warm) run is reported, the
        # first run's wall beside it.
        runs = {}
        for tag, extra in (("fp32", []), ("bf16", [
                "--bf16", "--keyp_folder", "keypoints_bf16",
                "--det_thresh", repr(thresh16)])):
            for rep in range(2):
                timer, stats = StageTimer(), []
                buf = io.StringIO()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches(JK, VK, SK)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = kcli.main(args + extra, timer=timer, stats=stats)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = read_launches(JK, VK, SK)
                launches[f"keypoints_{tag}_{rep}"] = got
                assert rc == 0, buf.getvalue()
                assert not any(got.values()), f"[keypoints] launched {got}"
                runs[tag] = dict(timer=timer, stats=stats, wall=wall,
                                 peak=torch.cuda.max_memory_allocated(),
                                 first_wall=runs.get(tag, {}).get("wall",
                                                                  wall))

        # ---- the module entry point with its default device ---------
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mvsmplfitting_tpu_torch.cli.keypoints",
             "--data_folder", ws, "--yolox_ckpt", yolox_ckpt, "--pose_ckpt",
             pose_ckpt, "--keyp_folder", "keypoints_module"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        module_s = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout + proc.stderr
        from mvsmplfitting_tpu_torch.data.keypoints import read_keypoints_json
        diff = 0.0
        for f in range(KP_FRAMES):
            for v in range(6):
                rel = os.path.join("0000", f"Camera0{v}",
                                   f"{f:06d}_keypoints.json")
                a = read_keypoints_json(os.path.join(ws, "keypoints", rel),
                                        26)
                b = read_keypoints_json(os.path.join(
                    ws, "keypoints_module", rel), 26)
                assert len(a) == len(b), rel
                for pa, pb in zip(a, b):
                    diff = max(diff, float(np.abs(pa - pb).max()))
        log("keypoints", check="module_entry_default_device",
            subprocess_s=f"{module_s:.2f}", max_diff_vs_in_process=diff)

        # ---- every JSON is there and the fitting dataset reads it -----
        for folder in ("keypoints", "keypoints_bf16", "keypoints_module"):
            ds = FittingDataset(ws, keyp_folder=folder)
            assert len(ds) == KP_FRAMES and ds.num_views() == 6
            for f in range(KP_FRAMES):
                for v in range(6):
                    assert os.path.exists(os.path.join(
                        ws, folder, "0000", f"Camera0{v}",
                        f"{f:06d}_keypoints.json"))
                fr = ds[f]
                assert fr.keypoints.shape == (6, 1, 17, 3)
                assert np.isfinite(fr.keypoints).all()
                assert fr.img_hw == (1080, 1920)

        # ---- one frame whose views include a progressive JPEG and a BMP
        # (under the frame's .jpg name: the CLI groups views by file name
        # and lists .jpg/.png names as JAX's does, and imread, like the
        # port's reader, goes by the bytes)
        mixed = os.path.join(tmp, "mixed")
        for v, src in enumerate(views):
            d = os.path.join(mixed, "images", "0000", f"Camera0{v}")
            os.makedirs(d)
            if v == 0:
                shutil.copy(progressive, os.path.join(d, "000000.jpg"))
            elif v == 1:
                write_bmp24(os.path.join(d, "000000.jpg"), imgs[1])
            else:
                shutil.copy(src, os.path.join(d, "000000.jpg"))
        assert hashlib.sha256(read_image(os.path.join(
            mixed, "images", "0000", "Camera01", "000000.jpg")).tobytes()
            ).hexdigest() == hashlib.sha256(imgs[1].tobytes()).hexdigest()
        buf = io.StringIO()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = kcli.main(["--data_folder", mixed, "--yolox_ckpt",
                            yolox_ckpt, "--pose_ckpt", pose_ckpt, "--device",
                            dev.type, "--bf16", "--det_thresh",
                            repr(thresh16)])
        torch.cuda.synchronize()
        mixed_s = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches["keypoints_mixed_formats"] = got
        assert rc == 0, buf.getvalue()
        assert not any(got.values()), f"[keypoints] launched {got}"
        diff = 0.0
        for v in range(6):
            rel = os.path.join("0000", f"Camera0{v}", "000000_keypoints.json")
            a = read_keypoints_json(os.path.join(mixed, "keypoints", rel), 26)
            assert all(np.isfinite(pa).all() for pa in a), rel
            if v > 0:         # the same pixels as the bf16 run's frame 0
                b = read_keypoints_json(os.path.join(
                    ws, "keypoints_bf16", rel), 26)
                if len(a) == len(b):
                    for pa, pb in zip(a, b):
                        diff = max(diff, float(np.abs(pa - pb).max()))
                else:
                    diff = float("inf")
        log("keypoints", check="mixed_formats_bf16", frames=1,
            views="progressive_jpeg,bmp,4_baseline_jpeg",
            wall_s=f"{mixed_s:.3f}",
            views1to5_max_diff_vs_bf16_run=diff)

    # ---- per-stage times, frames/s, memory, share of peak ------------
    det_flops = conv_flops(YOLOX().to("meta"),
                           torch.zeros(1, 3, 800, 1440, device="meta"))
    pose_flops = conv_flops(FastPose(26).to("meta"),
                            torch.zeros(1, 3, 256, 192, device="meta"))
    stages = ("decode", "letterbox", "detector", "nms", "crop", "pose",
              "heatmap", "json")
    for tag, run in runs.items():
        st = run["stats"]
        people = sum(s["people"] for s in st)
        timings = run["timer"].timings
        dev_s = run["timer"].device_totals()
        flops = det_flops * len(st) + pose_flops * people
        busy = dev_s["detector"] + dev_s.get("pose", 0.0)
        peak = 989e12 if tag == "bf16" else PEAK_FP32_FLOPS
        per_frame = {k: sum(v) / KP_FRAMES for k, v in timings.items()}
        loop_s = sum(per_frame.values()) * KP_FRAMES
        log("keypoints", run=tag, frames=KP_FRAMES, views=6,
            fps=f"{KP_FRAMES / run['wall']:.3f}",
            wall_s=f"{run['wall']:.3f}",
            first_run_wall_s=f"{run['first_wall']:.3f}",
            loop_fps=f"{KP_FRAMES / loop_s:.3f}",
            setup_s=f"{run['wall'] - loop_s:.3f}",
            peak_mem_gb=f"{run['peak'] / 1e9:.3f}",
            candidates=",".join(str(s["candidates"]) for s in st[:6]),
            kept=",".join(str(s["kept"]) for s in st[:6]),
            crops=people,
            nms_host_ms_max=f"{1e3 * max(s['nms_s'] for s in st):.3f}",
            det_gflop_per_view=f"{det_flops / 1e9:.2f}",
            pose_gflop_per_crop=f"{pose_flops / 1e9:.3f}",
            detector_dev_s=f"{dev_s['detector']:.4f}",
            pose_dev_s=f"{dev_s.get('pose', 0.0):.4f}",
            detector_tflops=f"{det_flops * len(st) / dev_s['detector'] / 1e12:.2f}",
            nets_tflops=f"{flops / busy / 1e12:.2f}",
            nets_share_of_peak=f"{flops / busy / peak:.4f}",
            peak_tflops=f"{peak / 1e12:.0f}")
        log("keypoints", run=tag, per_frame_s=",".join(
            f"{k}:{per_frame.get(k, 0.0):.4f}" for k in stages),
            per_frame_dev_s=",".join(f"{k}:{v / KP_FRAMES:.4f}"
                                     for k, v in dev_s.items()))

    # ---- information: the detector's forward with cuDNN's autotuner --
    det = TP.PersonDetector(det_sd, device=dev)
    timing = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        det.forward(batch)
        timing[bench] = event_ms(lambda: det.forward(batch))
    torch.backends.cudnn.benchmark = False
    log("keypoints", check="detector_forward_6_views",
        cudnn_default_ms=f"{timing[False]:.2f}",
        cudnn_benchmark_ms=f"{timing[True]:.2f}",
        tflops_default=f"{6 * det_flops / timing[False] / 1e9:.2f}",
        tflops_benchmark=f"{6 * det_flops / timing[True] / 1e9:.2f}")

    # ---- the card against the CPU, one view at full width ------------
    det_cuda = TP.PersonDetector(det_sd, device=dev)
    det_cpu = TP.PersonDetector(det_sd, device="cpu")
    b_cuda, r_cuda = det_cuda.letterbox_batch(dev_imgs[:1])
    b_cpu, r_cpu = det_cpu.letterbox_batch([torch.from_numpy(imgs[0])])
    assert r_cuda == r_cpu and torch.equal(b_cuda.cpu(), b_cpu)
    dec_cuda = det_cuda.forward(b_cuda).cpu()
    t0 = time.perf_counter()
    dec_cpu = det_cpu.forward(b_cpu)
    cpu_det_s = time.perf_counter() - t0
    torch.testing.assert_close(dec_cuda, dec_cpu, rtol=1e-3, atol=1e-3)
    det_abs = (dec_cuda - dec_cpu).abs().max().item()
    det_used = ((dec_cuda - dec_cpu).abs()
                / (1e-3 + 1e-3 * dec_cpu.abs())).max().item()
    boxes = det_cuda.select(dec_cuda.to(dev), r_cuda)[0][:KP_CHECK_CROPS]
    assert len(boxes) > 0, "no box on view 0"
    pose = {d: TP.PoseEstimator(pose_sd, device=d) for d in (dev, "cpu")}
    pose16 = TP.PoseEstimator(pose_sd, bf16=True, device=dev)
    c, s = bbox_to_center_scale(boxes[:, :4], 192 / 256)
    c_dev = torch.as_tensor(c, device=dev)
    s_dev = torch.as_tensor(s, device=dev)
    crops = crop_affine(TP.rgb01(dev_imgs[0]), c_dev, s_dev, (256, 192))
    hm_cuda = pose[dev].heatmaps(crops)
    hm_cpu = pose["cpu"].heatmaps(crops.cpu())
    hm_err = (hm_cuda.cpu() - hm_cpu).abs().max().item()
    assert hm_err <= 1e-4, f"heatmaps card vs CPU: {hm_err:.3e}"
    xy_cuda, _ = heatmap_to_coords(hm_cuda, c_dev, s_dev)
    xy_cpu, _ = heatmap_to_coords(hm_cpu, torch.as_tensor(c),
                                  torch.as_tensor(s))
    firm = (decode_margins(hm_cuda) > 1e-4).cpu()
    xy_diff = (xy_cuda.cpu() - xy_cpu).abs().amax(-1)
    assert (xy_diff[firm] <= 1e-3).all(), xy_diff[firm].max()
    # bfloat16 against fp32 on the same crops: JAX's 8 px bound
    # (`tests/test_detect.py:103-117`) on every joint whose fp32 peak
    # clears twice bfloat16's largest change to that heatmap (its argmax
    # cannot move; random weights give flat heatmaps whose near-ties
    # bfloat16 may reorder), bfloat16's heatmap change under 5% of each
    # heatmap's largest magnitude; the share of all joints within 8 px
    # is reported.
    hm16 = pose16.heatmaps(crops)
    xy16, _ = heatmap_to_coords(hm16, c_dev, s_dev)
    flat = hm_cuda.flatten(2)
    top2 = flat.topk(2, dim=-1).values
    change = (hm16 - hm_cuda).flatten(2).abs().amax(-1)
    rel16 = (change / flat.abs().amax(-1)).max().item()
    assert rel16 < 0.05, rel16
    clear = (top2[..., 0] - top2[..., 1]) > 2 * change
    err16 = (xy16 - xy_cuda).abs().amax(-1)
    assert clear.any(), "no joint clears bfloat16's change"
    assert (err16[clear] < 8.0).all(), err16[clear].max()
    within = (err16 < 8.0).float().mean().item()
    log("keypoints", check="card_vs_cpu", view=0,
        detector_max_abs_err=f"{det_abs:.3e}",
        detector_tolerance_used=f"{det_used:.3e}",
        detector_cpu_s=f"{cpu_det_s:.2f}", crops=len(boxes),
        heatmap_max_abs_err=f"{hm_err:.3e}",
        firm_joints=f"{int(firm.sum())}/{firm.numel()}",
        firm_xy_max_diff=f"{xy_diff[firm].max().item():.3e}",
        bf16_clear_joints=f"{int(clear.sum())}/{clear.numel()}",
        bf16_clear_max_px=f"{err16[clear].max().item():.3f}",
        bf16_heatmap_rel_change=f"{rel16:.3e}",
        bf16_within_8px_all=f"{within:.4f}", launches_b1_b4=0)


OVERLAY_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "overlay")
OV_FRAMES = 4          # [overlay]: frames of the demo config's CLI run
DRAW_OPS = ("line", "circle", "fill_convex_poly", "rectangle",
            "ellipse2poly", "add_weighted")


def _sha(a) -> str:
    import hashlib
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a).tobytes()
    return hashlib.sha256(a).hexdigest()


def _pattern(h: int, w: int, k: int = 0) -> np.ndarray:
    """`tools/make_overlay_fixtures.py:pattern`'s image."""
    y, x, c = np.meshgrid(np.arange(h), np.arange(w), np.arange(3),
                          indexing="ij")
    return ((x * 7 + y * 13 + c * 101 + (x * y) % 31 + 57 * k) % 256
            ).astype(np.uint8)


def _replay_primitives(golden: dict, draw) -> list:
    """The recorded cv2 calls through `viz/draw.py`, group by group on the
    patterned image (`make_overlay_fixtures.py:replay`); the names of the
    groups whose sha256 differs from OpenCV's."""
    h, w = golden["size"]
    img, other = _pattern(h, w), _pattern(h, w, 1)
    bad = []
    for group in golden["primitives"]:
        calls = group["calls"]
        if calls[0][0] == "ellipse2poly":
            digest = _sha(b"".join(draw.ellipse2poly(*c[1:]).tobytes()
                                   for c in calls))
        else:
            for op, *args in calls:
                if op == "add_weighted":
                    img = draw.add_weighted(img, args[0], other, *args[1:])
                else:
                    getattr(draw, op)(img, *args)
            digest = _sha(img)
        if digest != group["sha256"]:
            bad.append(group["name"])
    return bad


def _per_view(timer, name: str) -> str:
    v = timer.timings.get(name, [])
    return f"{sum(v) / len(v):.5f}" if v else "none"


def overlay_phase(dev, launches: dict) -> None:
    """[overlay]: the drawing primitives, the JPEG writer and the
    full-width render against OpenCV's and JAX's recorded results; the
    demo config's CLI with its overlays on fixture views; the adjustment
    GUI served in this process."""
    import argparse
    import base64
    import shutil
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from mvsmplfitting_tpu_torch.cli import adjust_gui as G
    from mvsmplfitting_tpu_torch.config import dump_config, load_config
    from mvsmplfitting_tpu_torch.data.images import encode_jpeg, read_image
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.synthetic import write_workspace
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer
    from mvsmplfitting_tpu_torch.viz import draw, overlay

    card = repr(card_line())
    with open(os.path.join(OVERLAY_FIXTURES, "golden.json")) as f:
        golden = json.load(f)
    views = os.path.join(ROOT, "tests", "fixtures", "images", "views")

    # ---- (a) the primitives and fill_faces against OpenCV's bytes ------
    t0 = time.perf_counter()
    bad = _replay_primitives(golden, draw)
    assert not bad, f"primitives differ from OpenCV's: {bad}"
    ff = golden["fill_faces"]
    layer = _pattern(200, 240)
    draw.fill_faces(layer, np.asarray(ff["pts"], np.int32),
                    np.asarray(ff["colors"], np.float64),
                    np.asarray(ff["order"], np.int64))
    assert _sha(layer) == ff["sha256"], "fill_faces differs from OpenCV's"
    log("overlay", part="primitives", groups=len(golden["primitives"]),
        calls=sum(len(g["calls"]) for g in golden["primitives"]),
        fill_faces_triangles=len(ff["order"]), equal="bitwise (sha256)",
        seconds=f"{time.perf_counter() - t0:.3f}", card=card)

    # ---- (b) the JPEG writer against cv2.imencode's bytes ----------------
    enc = {"95": [], "80": []}
    for name, qs in sorted(golden["jpeg"].items()):
        img = read_image(os.path.join(views, name))
        for q, digest in qs.items():
            t0 = time.perf_counter()
            data = encode_jpeg(img, int(q))
            enc[q].append(time.perf_counter() - t0)
            assert _sha(data) == digest, f"{name} q{q}: not cv2's bytes"
    log("overlay", part="jpeg", views=len(golden["jpeg"]), size="1920x1080",
        qualities="95,80", equal="bitwise (sha256)",
        encode_s_q95=f"{np.median(enc['95']):.5f}",
        encode_s_q80=f"{np.median(enc['80']):.5f}", card=card)

    # ---- (c) the full-width render against JAX's --------------------------
    ren = golden["render"]
    verts = np.load(os.path.join(OVERLAY_FIXTURES, "verts.npy"))
    order = np.load(os.path.join(OVERLAY_FIXTURES, "order.npy")).astype(
        np.int64)
    faces = synthetic_smpl("smpl", device="cpu").faces.numpy()
    R, tr, fo, ce = (np.asarray(ren["camera"][k], np.float32) for k in (
        "rotation", "translation", "focal", "center"))
    img = read_image(os.path.join(views, ren["image"]))
    pts, shade, _ = overlay.face_order(img.shape[:2], verts, faces, R, tr,
                                       fo, ce, order)
    base = np.tile(np.asarray((0.65, 0.74, 0.86)) * 255.0, (len(faces), 1))
    same_pts = _sha(pts) == ren["pts_sha256"]
    same_colors = _sha(base * shade[:, None]) == ren["colors_sha256"]
    ot = StageTimer()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = overlay.render_mesh_overlay(img, verts, faces, R, tr, fo, ce,
                                          order=order, timer=ot)
        reps.append(time.perf_counter() - t0)
    assert same_pts and same_colors, (
        "this host's numpy projects or shades the committed body "
        f"differently (corners equal: {same_pts}, colors equal: "
        f"{same_colors}): its BLAS rounds otherwise than the fixture's")
    assert _sha(out) == ren["sha256"], "render differs from JAX's"
    log("overlay", part="render", image=ren["image"], faces=len(faces),
        painted=int((out != img).any(-1).sum()), equal="bitwise (sha256)",
        render_s=f"{min(reps):.5f}",
        project_sort_s=_per_view(ot, "overlay.project"),
        fill_faces_s=_per_view(ot, "overlay.fill"),
        blend_s=_per_view(ot, "overlay.blend"),
        numpy=np.__version__, card=card)

    with tempfile.TemporaryDirectory(prefix="mvsf_overlay_") as tmp:
        # ---- (d) the demo config's CLI, overlays on ------------------------
        absent = os.path.join(tmp, "absent")
        ws = write_workspace(os.path.join(tmp, "ws"), num_frames=OV_FRAMES,
                             model_type="smpllsp", device=dev)
        for fr in ws["frames"]:
            for v in range(6):
                d = os.path.join(ws["data_folder"], "images", ws["serial"],
                                 f"Camera{v:02d}")
                os.remove(os.path.join(d, f"{fr}.png"))
                shutil.copyfile(os.path.join(views, f"Camera{v:02d}.jpg"),
                                os.path.join(d, f"{fr}.jpg"))
        config = os.path.join(ROOT, "cfg_files", "fit_smpl_demo.yaml")
        out = os.path.join(tmp, "demo")
        args = ["--config", config, "--data_folder", ws["data_folder"],
                "--cam_param", ws["cam_param"], "--output_folder", out,
                "--model_folder", absent, "--prior_folder", absent,
                "--device", dev.type]
        timer = StageTimer()
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        rc, printed = _run_cli(args, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches["overlay_cli"] = got
        assert rc == 0, printed
        assert load_config(config).save_images, "fit_smpl_demo.yaml changed"
        names = sorted(
            os.path.relpath(os.path.join(d, n), out)
            for d, _, ns in os.walk(os.path.join(out, "images")) for n in ns)
        want = sorted(os.path.join("images", ws["serial"], fr, f"{v:02d}.jpg")
                      for fr in ws["frames"] for v in range(6))
        assert names == want, names
        painted = []
        for name in names:
            v = int(os.path.basename(name)[:2])
            a = read_image(os.path.join(out, name)).astype(np.int16)
            b = read_image(os.path.join(views, f"Camera{v:02d}.jpg"))
            painted.append(int((np.abs(a - b).max(-1) > 32).sum()))
        assert min(painted) > 1000, painted
        assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
        spans = timer.totals()
        log("overlay", part="cli", config="fit_smpl_demo.yaml",
            frames=OV_FRAMES, views=6, overlays=len(names),
            wall_s=f"{wall:.3f}", fit_s=f"{spans['fit']:.3f}",
            images_s=f"{spans['images']:.3f}",
            images_share=f"{spans['images'] / wall:.4f}",
            per_view_read_s=_per_view(timer, "overlay.read"),
            per_view_project_sort_s=_per_view(timer, "overlay.project"),
            per_view_fill_faces_s=_per_view(timer, "overlay.fill"),
            per_view_blend_s=_per_view(timer, "overlay.blend"),
            per_view_encode_s=_per_view(timer, "overlay.encode"),
            painted_px_min=min(painted), painted_px_max=max(painted),
            launches=json.dumps(got).replace(" ", ""), card=card)

        # ---- (f) the adjustment GUI over HTTP ------------------------------
        cfg = load_config(config, data_folder=ws["data_folder"],
                          cam_param=ws["cam_param"],
                          output_folder=os.path.join(tmp, "gui"),
                          model_folder=absent, prior_folder=absent)
        gui_cfg = os.path.join(tmp, "gui.yaml")
        dump_config(cfg, gui_cfg)
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        app = G.build_app(argparse.Namespace(config=gui_cfg, frame=None,
                                             device=dev.type))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        server = ThreadingHTTPServer(("127.0.0.1", 0), G.make_handler(app))
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        # Only this process's server is asked; no proxy is consulted.
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def ask(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=None if body is None else json.dumps(body).encode(),
                method="GET" if body is None else "POST")
            with opener.open(req, timeout=600) as r:
                data = r.read()
            return json.loads(data) if path != "/" else data

        try:
            page = ask("/")
            assert b"/api/refit" in page
            t0 = time.perf_counter()
            st = ask("/api/state")
            state_s = time.perf_counter() - t0
            assert len(st["views"]) == 6, len(st["views"])
            for vw in st["views"]:
                assert (vw["width"], vw["height"]) == (640, 360), vw["width"]
                jpg = base64.b64decode(vw["img"])
                assert jpg[:2] == b"\xff\xd8", "not a JPEG"
            loss0 = st["loss"]
            x, y, _ = st["views"][0]["keypoints"][5]
            ask("/api/keypoint", {"view": 0, "joint": 5, "x": x + 8.0,
                                  "y": y})
            t0 = time.perf_counter()
            loss1 = ask("/api/refit", {})["loss"]
            torch.cuda.synchronize()
            refit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            st2 = ask("/api/state")
            state2_s = time.perf_counter() - t0
            saved = ask("/api/save", {})["path"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        got = read_launches(JK, VK, SK)
        launches["gui"] = got
        assert os.path.exists(saved), saved
        assert np.isfinite(loss0) and np.isfinite(loss1), (loss0, loss1)
        assert abs(st2["loss"] - loss1) <= 1e-6 * max(1.0, abs(loss1))
        assert got["joint_jacobian"] > 0 and got["vposer_tail"] > 0, got
        log("overlay", part="gui", frame=f"{ws['serial']}/{ws['frames'][0]}",
            fit_s=f"{fit_s:.3f}", state_s=f"{state_s:.3f}",
            state_after_refit_s=f"{state2_s:.3f}", refit_s=f"{refit_s:.3f}",
            loss_before=f"{loss0:.4f}", loss_after=f"{loss1:.4f}",
            moved="view 0 joint 5 +8 px (640-wide view)",
            launches=json.dumps(got).replace(" ", ""), card=card)

    # ---- (g) the GUI's state() on a 1280x720 view (an exact halving) ----
    gui_halving_check(dev, G, card)


def gui_halving_check(dev, G, card: str) -> None:
    """[overlay] (g): `AdjustApp.state()` on one 1280x720 view (the
    progressive fixture `gui_halving.json` names), its scale exactly 0.5.
    The app is built without a session, its body forward giving the
    committed overlay body, so that the served JPEG is the sha256
    `tools/make_image_fixtures.py` recorded from cv2: `imencode(q80)` of
    `cv2.resize(render, None, fx=0.5, fy=0.5)`."""
    import base64
    import threading
    import types

    from mvsmplfitting_tpu_torch.fitting.stages import FitResult
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams

    with open(os.path.join(IMAGE_FIXTURES, "gui_halving.json")) as f:
        rec = json.load(f)
    verts = np.load(os.path.join(OVERLAY_FIXTURES, "verts.npy"))
    app = G.AdjustApp.__new__(G.AdjustApp)
    cams = {k: torch.tensor([v], device=dev) for k, v in rec["camera"].items()}
    app.sess = types.SimpleNamespace(
        assets=synthetic_smpl("smpl", device=dev),
        cameras=types.SimpleNamespace(**cams))
    app.frame = types.SimpleNamespace(
        img_hw=(720, 1280),
        img_paths=[os.path.join(IMAGE_FIXTURES, rec["image"])])
    app.max_size, app.override = 640, None
    app.lock = threading.Lock()
    app.keypoints = np.zeros((1, 17, 3), np.float32)
    z = torch.zeros((1, 3), device=dev)
    app.result = FitResult(
        params=SMPLParams(betas=torch.zeros((1, 10), device=dev),
                          global_orient=z, body_pose=torch.zeros(
                              (1, 69), device=dev), transl=z,
                          scale=torch.ones(1, device=dev)),
        body_pose=torch.zeros((1, 69), device=dev),
        z=torch.zeros((1, 32), device=dev), loss=torch.ones(1, device=dev),
        stage_losses=torch.ones((1, 1), device=dev),
        lm_iters=torch.ones((1, 1), dtype=torch.int32, device=dev))
    forward = G.smpl_forward
    G.smpl_forward = lambda *a: (torch.from_numpy(verts)[None], None)
    try:
        t0 = time.perf_counter()
        view = app.state()["views"][0]
        state_s = time.perf_counter() - t0
    finally:
        G.smpl_forward = forward
    jpg = base64.b64decode(view["img"])
    assert (view["width"], view["height"]) == (640, 360), view["width"]
    assert _sha(jpg) == rec["sha256"], \
        "the 1280x720 view's JPEG is not cv2's halving of the render"
    log("overlay", part="gui_1280x720", image=rec["image"],
        served="640x360", equal="cv2 resize fx=fy=0.5 + imencode q80 "
        "(sha256)", state_s=f"{state_s:.3f}", card=card)


ST_FRAMES = 12         # [stream] (b): frames of the fixture clip
ST_CFG_FRAMES = 2      # [stream] (c): frames x the six views a config
ST_SMPL_FRAMES = 4     # [stream] (d): HybrIK's frames
ST_CHECK_CROPS = 8     # [stream]: crops of each card-vs-CPU check
HYBRIK_VERT_ATOL = 1e-4  # [stream] (d): IK vertices card vs CPU, meters

# The reference's config layout (`configs/halpe_26/resnet/
# 256x192_res50_lr1e-3_2x-dcn.yaml`, `configs/coco/hrnet/
# 256x192_w32_lr1e-3.yaml`, `configs/coco/hardnet/
# 256x192_hard68_lr1e-3_1x.yaml`), cut to the keys the readers see.
_CFG_HEAD = """\
DATASET:
  TRAIN:
    TYPE: '{dataset}'
    ROOT: './data/{root}/'
DATA_PRESET:
  TYPE: 'simple'
  SIGMA: 2
  NUM_JOINTS: {joints}
  IMAGE_SIZE:
  - 256
  - 192
  HEATMAP_SIZE:
  - 64
  - 48
"""
ST_CONFIGS = {
    "fastpose_dcn": ("Halpe_26", "halpe", 26, """\
MODEL:
  TYPE: 'FastPose'
  PRETRAINED: ''
  NUM_LAYERS: 50
  CONV_DIM: 256
  DCN:
    MODULATED: false
    DEFORM_GROUP: 1
    FALLBACK_ON_STRIDE: false
  STAGE_WITH_DCN:
  - false
  - true
  - true
  - true
"""),
    "hrnet_w32": ("Mscoco", "coco", 17, """\
MODEL:
  TYPE: 'PoseHighResolutionNet'
  PRETRAINED: ''
  NUM_LAYERS: 32
  FINAL_CONV_KERNEL: 1
  STAGE2:
    NUM_MODULES: 1
    NUM_BRANCHES: 2
    NUM_BLOCKS: [4, 4]
    NUM_CHANNELS: [32, 64]
    BLOCK: 'BASIC'
    FUSE_METHOD: 'SUM'
  STAGE3:
    NUM_MODULES: 4
    NUM_BRANCHES: 3
    NUM_BLOCKS: [4, 4, 4]
    NUM_CHANNELS: [32, 64, 128]
    BLOCK: 'BASIC'
    FUSE_METHOD: 'SUM'
  STAGE4:
    NUM_MODULES: 3
    NUM_BRANCHES: 4
    NUM_BLOCKS: [4, 4, 4, 4]
    NUM_CHANNELS: [32, 64, 128, 256]
    BLOCK: 'BASIC'
    FUSE_METHOD: 'SUM'
"""),
    "hardnet68": ("Mscoco", "coco", 17, """\
MODEL:
  TYPE: 'HarDNetPose'
  PRETRAINED: ''
  NUM_LAYERS: 68
  FINAL_CONV_KERNEL: 1
"""),
}
# Random weights as `keypoint_weights` makes them: HRNet's convolutions at
# half gain (at full gain its residual branches grow the heatmaps to ~2e4,
# where fp32 rounding alone passes 1e-4; at half ~5); the DCN offset
# convolutions at 3x gain, for offsets of a few pixels that send some
# taps out of the image.
ST_CONV_GAIN = {"hrnet_w32": 0.5}
ST_OFFSET_GAIN = 3.0


def _mux(path, jpegs, width, height, fps=30.0):
    from mvsmplfitting_tpu_torch.viz.video import AviWriter
    with open(path, "wb") as f:
        avi = AviWriter(f, width, height, fps)
        for j in jpegs:
            avi.write(j)
        avi.close()


def _strip_dht(data: bytes) -> bytes:
    """A JPEG's bytes without its DHT segments (Motion-JPEG cameras leave
    them out; decoders take the standard tables)."""
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
    return bytes(out)


def _offset_stats(net, x):
    """|offset| mean and max of every deformable conv2 of `net` on `x`,
    and the share of their sampling points outside the input (3x3 taps,
    padding 1)."""
    stats = []

    def hook(mod, args, out):
        inp = args[0]
        H, W = inp.shape[2:]
        stride = mod.stride[0]
        n, _, oh, ow = out.shape
        off = out.reshape(n, 9, 2, oh, ow).float()
        ty = torch.arange(3, device=out.device).repeat_interleave(3)
        tx = torch.arange(3, device=out.device).repeat(3)
        oy = torch.arange(oh, device=out.device) * stride - 1
        ox = torch.arange(ow, device=out.device) * stride - 1
        y = oy[None, :, None] + ty[:, None, None] + off[:, :, 0]
        xx = ox[None, None, :] + tx[:, None, None] + off[:, :, 1]
        outside = (y <= -1) | (y >= H) | (xx <= -1) | (xx >= W)
        stats.append((off.abs().mean().item(), off.abs().max().item(),
                      outside.float().mean().item()))

    hs = [m.conv2_offset.register_forward_hook(hook) for m in net.modules()
          if getattr(m, "dcn", False)]
    try:
        with torch.inference_mode():
            net(x)
    finally:
        for h in hs:
            h.remove()
    return (float(np.mean([s[0] for s in stats])),
            max(s[1] for s in stats), float(np.mean([s[2] for s in stats])))


def stream_phase(dev, launches: dict, weights) -> None:
    """[stream]: the keypoint CLI's streaming, config and SMPL modes at
    full width on the committed 1920x1080 views, with `keypoint_weights`'
    YOLOX-X and FastPose checkpoints."""
    import contextlib
    import hashlib
    import io
    import shutil
    import tempfile

    from mvsmplfitting_tpu_torch.cli import keypoints as kcli
    from mvsmplfitting_tpu_torch.data import video as V
    from mvsmplfitting_tpu_torch.data.images import decode_jpeg, read_image
    from mvsmplfitting_tpu_torch.data.keypoints import read_keypoints_json
    from mvsmplfitting_tpu_torch.detect import predictor as TP
    from mvsmplfitting_tpu_torch.detect.config import (
        estimator_kwargs_from_config, model_spec_from_config,
        pose_model_from_config)
    from mvsmplfitting_tpu_torch.detect.hybrik import (Simple3DPoseSMPLCam,
                                                       uvd_to_xyz)
    from mvsmplfitting_tpu_torch.detect.preprocess import (
        bbox_to_center_scale, crop_affine, normalize_crops)
    from mvsmplfitting_tpu_torch.detect.weights import random_state_dict
    from mvsmplfitting_tpu_torch.models import hybrik as HM
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer, conv_flops

    card = repr(card_line())
    views = [os.path.join(IMAGE_FIXTURES, "views", f"Camera0{v}.jpg")
             for v in range(6)]
    raw = []
    for p in views:
        with open(p, "rb") as f:
            raw.append(f.read())
    imgs = [read_image(p) for p in views]
    h, w = imgs[0].shape[:2]

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def run_cli(args, tag):
        timer = StageTimer()
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = kcli.main(args, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches[f"stream_{tag}"] = got
        assert rc == 0, buf.getvalue()
        assert not any(got.values()), f"[stream] {tag} launched {got}"
        return timer, wall

    def per_frame(timer, frames, names):
        t = timer.timings
        return ",".join(f"{k}:{sum(t.get(k, [])) / frames:.4f}"
                        for k in names)

    with tempfile.TemporaryDirectory(prefix="mvsf_stream_") as tmp:
        # ---- (a) the reader: the six views as MJPEG frames --------------
        want = [sha(i) for i in imgs]
        stripped = [_strip_dht(r) for r in raw]
        assert all(b"\xff\xc4" not in s[:s.index(b"\xff\xda")]
                   for s in stripped)
        times = {}
        for tag, frames in (("as_written", raw), ("dht_stripped",
                                                  stripped)):
            path = os.path.join(tmp, f"{tag}.avi")
            _mux(path, frames, w, h)
            info = V.avi_info(path)
            assert (info.width, info.height, info.fourcc) == (w, h, "MJPG")
            demux, decode, got = [], [], []
            it = V.avi_frames(path, info)
            while True:
                t0 = time.perf_counter()
                data = next(it, None)
                demux.append(time.perf_counter() - t0)
                if data is None:
                    break
                t0 = time.perf_counter()
                got.append(sha(decode_jpeg(data)))
                decode.append(time.perf_counter() - t0)
            assert got == want, f"{tag}: frames differ from read_image"
            times[tag] = (float(np.median(demux)), float(np.median(decode)))
        bad = os.path.join(tmp, "hevc.avi")
        with open(os.path.join(tmp, "as_written.avi"), "rb") as f:
            body = f.read()
        with open(bad, "wb") as f:
            f.write(body.replace(b"MJPG", b"HEVC"))
        try:
            V.avi_info(bad)
            raise AssertionError("an HEVC fourcc was not refused")
        except V.VideoError as e:
            assert bad in str(e) and "'HEVC'" in str(e), str(e)
        log("stream", part="reader", frames=6, size=f"{w}x{h}",
            equal="read_image sha256, as written and DHT-stripped",
            demux_ms=f"{1e3 * times['as_written'][0]:.3f}",
            decode_ms=f"{1e3 * times['as_written'][1]:.2f}",
            decode_ms_dht_stripped=f"{1e3 * times['dht_stripped'][1]:.2f}",
            refused="HEVC", card=card)

        # ---- weights and checkpoints ----------------------------------------
        dev_imgs = [torch.from_numpy(i).to(dev) for i in imgs]
        det_sd, pose_sd = weights[:2]
        yolox_ckpt = os.path.join(tmp, "bytetrack_x_mot17.pth.tar")
        pose_ckpt = os.path.join(tmp, "fast_res50_256x192.pth")
        torch.save({"model": det_sd}, yolox_ckpt)
        torch.save(pose_sd, pose_ckpt)
        det = TP.PersonDetector(det_sd, device=dev)
        boxes0 = det.detect_batch(dev_imgs[:1])[0][:ST_CHECK_CROPS]
        assert len(boxes0) > 0, "no box on view 0"

        # ---- (b) --video on ST_FRAMES frames --------------------------------
        clip = os.path.join(tmp, "clip.avi")
        _mux(clip, [raw[i % 6] for i in range(ST_FRAMES)], w, h)
        ws = os.path.join(tmp, "ws")
        # a name cv2's mp4v writer cannot open: Motion-JPEG at drawn.avi
        # (JAX's fallback), the writer (f) does not drive
        out_video = os.path.join(tmp, "drawn.webm")
        res = os.path.join(tmp, "results")
        timer, wall = run_cli([
            "--video", clip, "--out_video", out_video, "--results_dir", res,
            "--data_folder", ws, "--yolox_ckpt", yolox_ckpt, "--pose_ckpt",
            pose_ckpt, "--device", dev.type], "video")
        jsons = sorted(os.listdir(os.path.join(ws, "keypoints", "stream")))
        assert jsons == [f"{i:06d}_keypoints.json"
                         for i in range(ST_FRAMES)], jsons
        people = [len(read_keypoints_json(os.path.join(
            ws, "keypoints", "stream", n), 26)) for n in jsons]
        with open(os.path.join(res, "alphapose-results.json")) as f:
            results = json.load(f)
        assert len(results) == sum(people), (len(results), people)
        drawn_avi = os.path.join(tmp, "drawn.avi")
        assert V.avi_info(drawn_avi).codec == "mjpeg"
        drawn = list(V.read_video(drawn_avi))
        assert len(drawn) == ST_FRAMES and drawn[0][1].shape == (h, w, 3)
        dev_s = timer.device_totals()
        stages = ("demux", "decode", "letterbox", "detector", "nms", "crop",
                  "pose", "heatmap", "json", "draw", "encode", "results")
        loop = sum(sum(v) for v in timer.timings.values())
        log("stream", part="video", frames=ST_FRAMES, size=f"{w}x{h}",
            fps=f"{ST_FRAMES / wall:.3f}", wall_s=f"{wall:.3f}",
            loop_fps=f"{ST_FRAMES / loop:.3f}",
            people=",".join(map(str, people)), results=len(results),
            video_frames=len(drawn),
            per_frame_s=per_frame(timer, ST_FRAMES, stages),
            per_frame_dev_s=",".join(f"{k}:{v / ST_FRAMES:.4f}"
                                     for k, v in dev_s.items()),
            launches_b1_b4=0, card=card)

        # ---- (e) --video on a folder: baseline, progressive and BMP frames
        folder = os.path.join(tmp, "frames")
        os.makedirs(folder)
        shutil.copy(views[0], os.path.join(folder, "000000.jpg"))
        shutil.copy(os.path.join(IMAGE_FIXTURES, KP_PROGRESSIVE),
                    os.path.join(folder, "000001.jpg"))
        write_bmp24(os.path.join(folder, "000002.bmp"), imgs[2])
        want_frames = [sha(imgs[0]), sha(read_image(os.path.join(
            IMAGE_FIXTURES, KP_PROGRESSIVE))), sha(imgs[2])]
        from mvsmplfitting_tpu_torch.detect.stream import frame_source
        assert [sha(f) for _, f in frame_source(folder)] == want_frames
        folder_ws = os.path.join(tmp, "folder_ws")
        timer, wall = run_cli([
            "--video", folder, "--data_folder", folder_ws, "--yolox_ckpt",
            yolox_ckpt, "--pose_ckpt", pose_ckpt, "--device", dev.type],
            "folder")
        jsons = sorted(os.listdir(os.path.join(folder_ws, "keypoints",
                                               "stream")))
        assert jsons == [f"{i:06d}_keypoints.json" for i in range(3)], jsons
        log("stream", part="folder", frames=3,
            kinds="baseline_jpeg,progressive_jpeg,bmp24", size=f"{w}x{h}",
            equal="read_image sha256", wall_s=f"{wall:.3f}",
            decode_s_each=",".join(f"{v:.4f}"
                                   for v in timer.timings.get("decode", [])),
            launches_b1_b4=0, card=card)

        # ---- (f) MPEG-4: the committed clips, then --video clip.mp4 ----------
        from mvsmplfitting_tpu_torch.data import mpeg4 as E4
        with open(os.path.join(VIDEO_FIXTURES, "decoded.json")) as f:
            record = json.load(f)
        reset_launches(JK, VK, SK)
        t_clips = time.perf_counter()
        for name, rec in sorted(record.items()):
            got = [sha(f) for _, f in V.read_video(
                os.path.join(VIDEO_FIXTURES, name))]
            assert got == rec["bgr_sha256"], f"[stream] (f) {name} differs"
        t_clips = time.perf_counter() - t_clips
        big = os.path.join(VIDEO_FIXTURES, ST_MPEG4_CLIP)
        stream = V.open_video(big)
        # `frame_source`'s own demux and decode; a hook on the decoder
        # times its codec share, the rest of each frame is the BGR
        dec = stream.decoder()
        codec_s = []
        codec = dec.dec.decode

        def timed_codec(data):
            t0 = time.perf_counter()
            planes = codec(data)
            codec_s.append(time.perf_counter() - t0)
            return planes

        dec.dec.decode = timed_codec
        demux, whole, frames = [], [], []
        packets = stream.packets()
        while True:
            t0 = time.perf_counter()
            data = next(packets, None)
            if data is None:
                break
            demux.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            frames += dec.decode(data)
            whole.append(time.perf_counter() - t0)
        frames += dec.flush()
        decode, convert = codec_s, [a - b for a, b in zip(whole, codec_s)]
        assert [sha(f) for f in frames] == record[ST_MPEG4_CLIP]["bgr_sha256"]
        enc = E4.Mpeg4Encoder(stream.width, stream.height, 30.0)
        encode, sizes = [], []
        for f in frames[:ST_ENCODE_FRAMES]:
            t0 = time.perf_counter()
            data, _ = enc.encode(f)
            encode.append(time.perf_counter() - t0)
            sizes.append(len(data))
        got = read_launches(JK, VK, SK)
        launches["stream_mpeg4_codec"] = got
        assert not any(got.values()), f"[stream] (f) codec launched {got}"
        mp4_ws = os.path.join(tmp, "mp4_ws")
        drawn_mp4 = os.path.join(tmp, "drawn.mp4")
        timer, wall = run_cli([
            "--video", big, "--out_video", drawn_mp4, "--data_folder", mp4_ws,
            "--yolox_ckpt", yolox_ckpt, "--pose_ckpt", pose_ckpt, "--device",
            dev.type], "mp4")
        n_mp4 = len(record[ST_MPEG4_CLIP]["bgr_sha256"])
        jsons = sorted(os.listdir(os.path.join(mp4_ws, "keypoints", "stream")))
        assert jsons == [f"{i:06d}_keypoints.json" for i in range(n_mp4)]
        with open(drawn_mp4, "rb") as f:
            assert f.read(12)[4:12] == b"ftypisom", "drawn.mp4 is not MP4"
        drawn = list(V.read_video(drawn_mp4))
        assert len(drawn) == n_mp4 and drawn[0][1].shape == (
            stream.height, stream.width, 3), (len(drawn), drawn[0][1].shape)
        med = lambda v: f"{1e3 * float(np.median(v)):.3f}"
        log("stream", part="mpeg4", clips=len(record),
            equal="cv2 sha256 of every clip", clips_s=f"{t_clips:.3f}",
            size=f"{stream.width}x{stream.height}", frames=n_mp4,
            demux_ms=med(demux), decode_ms=med(decode),
            bgr_ms=med(convert), encode_ms=med(encode),
            encode_frames=len(encode), encode_bytes=",".join(map(str, sizes)),
            video_fps=f"{n_mp4 / wall:.3f}", wall_s=f"{wall:.3f}",
            loop_fps=f"{n_mp4 / sum(sum(v) for v in timer.timings.values()):.3f}",
            per_frame_s=per_frame(timer, n_mp4, (
                "demux", "decode", "letterbox", "detector", "nms", "crop",
                "pose", "heatmap", "json", "draw", "encode", "results")),
            drawn_frames=len(drawn), launches_b1_b4=0, card=card)

        # ---- (g) H.264: the committed clips, then --video clip.mp4 -----------
        with open(os.path.join(VIDEO_FIXTURES, "decoded_h264.json")) as f:
            record = json.load(f)
        reset_launches(JK, VK, SK)
        t_clips = time.perf_counter()
        for name, rec in sorted(record.items()):
            got = [sha(f) for _, f in V.read_video(
                os.path.join(VIDEO_FIXTURES, name))]
            assert got == rec["bgr_sha256"], f"[stream] (g) {name} differs"
        t_clips = time.perf_counter() - t_clips
        big = os.path.join(VIDEO_FIXTURES, ST_H264_CLIP)
        stream = V.open_video(big)
        dec = stream.decoder()
        codec_s = []
        codec = dec.dec.decode

        def timed_h264(data):
            t0 = time.perf_counter()
            pictures = codec(data)
            codec_s.append(time.perf_counter() - t0)
            return pictures

        dec.dec.decode = timed_h264
        demux, whole, frames = [], [], []
        packets = stream.packets()
        while True:
            t0 = time.perf_counter()
            data = next(packets, None)
            if data is None:
                break
            demux.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            frames += dec.decode(data)
            whole.append(time.perf_counter() - t0)
        frames += dec.flush()
        decode, convert = codec_s, [a - b for a, b in zip(whole, codec_s)]
        assert [sha(f) for f in frames] == record[ST_H264_CLIP]["bgr_sha256"]
        got = read_launches(JK, VK, SK)
        launches["stream_h264_codec"] = got
        assert not any(got.values()), f"[stream] (g) codec launched {got}"
        h264_ws = os.path.join(tmp, "h264_ws")
        drawn_h264 = os.path.join(tmp, "drawn_h264.mp4")
        timer, wall = run_cli([
            "--video", big, "--out_video", drawn_h264, "--data_folder",
            h264_ws, "--yolox_ckpt", yolox_ckpt, "--pose_ckpt", pose_ckpt,
            "--device", dev.type], "h264")
        n_h264 = len(record[ST_H264_CLIP]["bgr_sha256"])
        jsons = sorted(os.listdir(os.path.join(h264_ws, "keypoints",
                                               "stream")))
        assert jsons == [f"{i:06d}_keypoints.json" for i in range(n_h264)]
        drawn = list(V.read_video(drawn_h264))
        assert len(drawn) == n_h264 and drawn[0][1].shape == (
            stream.height, stream.width, 3), (len(drawn), drawn[0][1].shape)
        loop = sum(sum(v) for v in timer.timings.values())
        log("stream", part="h264", clips=len(record),
            equal="cv2 sha256 of every clip", clips_s=f"{t_clips:.3f}",
            size=f"{stream.width}x{stream.height}", frames=n_h264,
            demux_ms=med(demux), decode_ms=med(decode), bgr_ms=med(convert),
            host_ms=f"{1e3 * (sum(demux) + sum(whole)) / len(frames):.3f}",
            video_fps=f"{n_h264 / wall:.3f}", wall_s=f"{wall:.3f}",
            loop_fps=f"{n_h264 / loop:.3f}",
            per_frame_s=per_frame(timer, n_h264, (
                "demux", "decode", "letterbox", "detector", "nms", "crop",
                "pose", "heatmap", "json", "draw", "encode", "results")),
            drawn_frames=len(drawn), launches_b1_b4=0, card=card)

        # ---- (c) --pose_cfg: three reference configs ------------------------
        cfg_ws = os.path.join(tmp, "cfg_ws")
        for v, src in enumerate(views):
            d = os.path.join(cfg_ws, "images", "0000", f"Camera0{v}")
            os.makedirs(d)
            for fr in range(ST_CFG_FRAMES):
                shutil.copy(src, os.path.join(d, f"{fr:06d}.jpg"))
        image0 = TP.rgb01(dev_imgs[0])
        for name, (dataset, root, joints, model_text) in ST_CONFIGS.items():
            cfg_path = os.path.join(tmp, f"{name}.yaml")
            with open(cfg_path, "w") as f:
                f.write(_CFG_HEAD.format(dataset=dataset, root=root,
                                         joints=joints) + model_text)
            spec = model_spec_from_config(cfg_path)
            est = estimator_kwargs_from_config(cfg_path)
            net = est["model"]
            sd = random_state_dict(net, torch.Generator().manual_seed(0))
            gain = ST_CONV_GAIN.get(name, 1.0)
            for k, t in sd.items():
                if k.endswith("conv2_offset.weight"):
                    sd[k] = t * ST_OFFSET_GAIN
                elif k.endswith(".weight") and t.dim() == 4:
                    sd[k] = t * gain
            ckpt = os.path.join(tmp, f"{name}.pth")
            torch.save(sd, ckpt)
            folder = f"keypoints_{name}"
            timer, wall = run_cli([
                "--data_folder", cfg_ws, "--keyp_folder", folder,
                "--pose_cfg", cfg_path, "--pose_ckpt", ckpt, "--yolox_ckpt",
                yolox_ckpt, "--device", dev.type], f"cfg_{name}")
            for fr in range(ST_CFG_FRAMES):
                for v in range(6):
                    read_keypoints_json(os.path.join(
                        cfg_ws, folder, "0000", f"Camera0{v}",
                        f"{fr:06d}_keypoints.json"), joints)
            # view 0's heatmaps, the card against the CPU
            ih, iw = est["input_hw"]
            c, s = bbox_to_center_scale(boxes0[:, :4], iw / ih)
            crops = crop_affine(image0, torch.as_tensor(c, device=dev),
                                torch.as_tensor(s, device=dev), (ih, iw))
            pose = {d: TP.PoseEstimator(sd, num_joints=joints,
                                        input_hw=(ih, iw),
                                        model=pose_model_from_config(
                                            cfg_path), device=d)
                    for d in (dev, "cpu")}
            hm_dev = pose[dev].heatmaps(crops)
            t0 = time.perf_counter()
            hm_cpu = pose["cpu"].heatmaps(crops.cpu())
            cpu_s = time.perf_counter() - t0
            err = (hm_dev.cpu() - hm_cpu).abs().max().item()
            assert err <= 1e-4, f"{name}: heatmaps card vs CPU {err:.3e}"
            extra = {}
            if spec[1].get("stage_with_dcn"):
                mean, big, outside = _offset_stats(
                    pose[dev].model, normalize_crops(crops))
                assert outside > 0.0, "no deformable tap left the image"
                extra = dict(offset_abs_mean=f"{mean:.3f}",
                             offset_abs_max=f"{big:.3f}",
                             taps_outside=f"{outside:.4f}")
            flops = conv_flops(net.to("meta"),
                               torch.zeros(1, 3, ih, iw, device="meta"))
            people_n = sum(len(read_keypoints_json(os.path.join(
                cfg_ws, folder, "0000", f"Camera0{v}",
                f"{fr:06d}_keypoints.json"), joints))
                for fr in range(ST_CFG_FRAMES) for v in range(6))
            pose_dev = timer.device_totals().get("pose", 0.0)
            log("stream", part="pose_cfg", config=name, zoo=spec[0],
                input=f"{ih}x{iw}", joints=joints, frames=ST_CFG_FRAMES,
                views=6, wall_s=f"{wall:.3f}", crops=people_n,
                pose_dev_s_per_frame=f"{pose_dev / ST_CFG_FRAMES:.4f}",
                gflop_per_crop=f"{flops / 1e9:.3f}",
                share_of_fp32_peak=f"{flops * people_n / max(pose_dev, 1e-9) / PEAK_FP32_FLOPS:.4f}",
                heatmap_max_abs_err=f"{err:.3e}", check_crops=len(boxes0),
                cpu_check_s=f"{cpu_s:.2f}", **extra, card=card)

        # ---- (d) --video --smpl: HybrIK at 256x256 --------------------------
        smpl_net = Simple3DPoseSMPLCam(width_dim=64, height_dim=64)
        smpl_sd = random_state_dict(smpl_net, torch.Generator().manual_seed(0))
        smpl_ckpt = os.path.join(tmp, "hybrik.pth")
        torch.save(smpl_sd, smpl_ckpt)
        clip4 = os.path.join(tmp, "clip4.avi")
        _mux(clip4, raw[:ST_SMPL_FRAMES], w, h)
        smpl_ws = os.path.join(tmp, "smpl_ws")
        smpl_video = os.path.join(tmp, "smpl.avi")
        timer, wall = run_cli([
            "--video", clip4, "--smpl", "--smpl_ckpt", smpl_ckpt,
            "--out_video", smpl_video, "--data_folder", smpl_ws,
            "--yolox_ckpt", yolox_ckpt, "--device", dev.type], "smpl")
        with open(os.path.join(smpl_ws, "smpl-results.json")) as f:
            smpl_res = json.load(f)
        assert [r["imgname"] for r in smpl_res] == [
            f"{i:06d}.jpg" for i in range(ST_SMPL_FRAMES)]
        keys = {"keypoints", "pred_xyz_jts", "kp_score", "proposal_score",
                "bbox_score", "idx", "box", "crop_box"}
        persons = [p for r in smpl_res for p in r["result"]]
        assert persons and all(set(p) == keys for p in persons)
        assert all(np.isfinite(np.asarray(p["keypoints"])).all()
                   and np.asarray(p["pred_xyz_jts"]).shape == (24, 3)
                   for p in persons)
        assert len(list(V.read_video(smpl_video))) == ST_SMPL_FRAMES
        dev_s = timer.device_totals()
        # The crops of view 0 on the card against the CPU.
        est = {d: TP.SmplPoseEstimator(smpl_sd, device=d)
               for d in (dev, "cpu")}
        c, s = bbox_to_center_scale(boxes0[:, :4], 1.0)
        crops = crop_affine(image0, torch.as_tensor(c, device=dev),
                            torch.as_tensor(s, device=dev), (256, 256))
        out_dev = est[dev].regress(crops)
        out_cpu = est["cpu"].regress(crops.cpu())
        errs = {}
        for k in ("pred_uvd_jts", "pred_shape", "pred_phi", "pred_camera",
                  "maxvals"):
            torch.testing.assert_close(out_dev[k].cpu(), out_cpu[k],
                                       atol=2e-4, rtol=1e-3, msg=k)
            errs[k] = (out_dev[k].cpu() - out_cpu[k]).abs().max().item()
        # The IK on the same inputs on both: cuSOLVER's batched 3x3 SVD
        # (the root's Kabsch) against LAPACK's, and the meshes.
        same = {k: v.cpu() for k, v in out_dev.items()}
        verts_dev, _ = est[dev].bodies(out_dev)
        verts_cpu, _ = est["cpu"].bodies(same)
        assert torch.isfinite(verts_dev).all(), "non-finite mesh"
        cos = []
        xyz, _ = uvd_to_xyz(same["pred_uvd_jts"], same["pred_camera"],
                            1000.0, 256.0, 2.0)
        phis = same["pred_phi"] / same["pred_phi"].norm(
            dim=-1, keepdim=True).clamp_min(1e-8)
        rots_cpu = HM.hybrik_ik(est["cpu"].assets, xyz * 2.0,
                                same["pred_shape"], phis, swing_cos=cos)
        rots_dev = HM.hybrik_ik(est[dev].assets, (xyz * 2.0).to(dev),
                                same["pred_shape"].to(dev), phis.to(dev))
        # A swing whose bones are within ~0.8 degrees of antiparallel
        # (1 + cos < 1e-4) turns about an ill-conditioned axis.
        worst_cos = torch.stack(cos, 1).amin(1)          # (people,)
        swung = worst_cos < -0.9999
        root_err = (rots_dev[:, 0].cpu() - rots_cpu[:, 0]).abs().amax(
            (1, 2))
        vert_err = (verts_dev.cpu() - verts_cpu).abs().amax((1, 2))
        calm = ~swung
        assert (root_err <= 1e-5).all(), root_err
        assert (vert_err[calm] <= HYBRIK_VERT_ATOL).all(), vert_err
        log("stream", part="smpl", frames=ST_SMPL_FRAMES, input="256x256",
            wall_s=f"{wall:.3f}", fps=f"{ST_SMPL_FRAMES / wall:.3f}",
            people=len(persons), video_frames=ST_SMPL_FRAMES,
            net_dev_s_per_frame=f"{dev_s.get('smpl_net', 0.0) / ST_SMPL_FRAMES:.4f}",
            ik_s_each_frame=",".join(f"{v:.4f}"
                                     for v in timer.timings.get("ik", [])),
            ik_dev_s_per_frame=f"{dev_s.get('ik', 0.0) / ST_SMPL_FRAMES:.4f}",
            per_frame_s=per_frame(timer, ST_SMPL_FRAMES, (
                "demux", "decode", "letterbox", "detector", "nms", "crop",
                "smpl_net", "ik", "smpl_host", "draw", "encode", "results")),
            check_crops=len(boxes0),
            **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()},
            root_rotation_max_abs_err=f"{root_err.max().item():.3e}",
            verts_max_abs_err_m=f"{vert_err[calm].max().item():.3e}"
            if calm.any() else "none",
            verts_atol_m=HYBRIK_VERT_ATOL,
            worst_swing_cos=f"{worst_cos.min().item():.6f}",
            near_antiparallel_people=int(swung.sum()),
            near_antiparallel_verts_max_abs_err_m=f"{vert_err[swung].max().item():.3e}"
            if swung.any() else "none",
            launches_b1_b4=0, card=card)


TR_PER_VIEW = 32       # [train] (a): persons a fixture view (192: 6 batches of 32)
TR_POSE_STEPS = 6      # [train] (a)
TR_YOLOX_STEPS = 2     # [train] (b), mosaic and mixup; then one no-aug L1 step
# [train] (b): image entries over the six views, one epoch of mosaic steps
# at batch 8 (the second, `--no_aug_epochs 1`, gives the L1 step)
TR_DET_IMAGES = 8 * TR_YOLOX_STEPS
TR_HYBRIK_STEPS = 3    # [train] (c)
TR_HYBRIK_BATCH = 16   # [train] (c): crops a step
TR_RTOL, TR_ATOL = 1e-4, 1e-6    # [train] (d): card vs CPU, float64;
                                 # (f): the world of 2 vs one process
TR_POSE_ARGV = []      # [train] (a), (f): cli.train_pose's defaults
TR_YOLOX_ARGV = ["--depth", "1.33", "--width", "1.25", "--input_size",
                 "640x640", "--batch", "8", "--epochs", "2",
                 "--no_aug_epochs", "1"]   # [train] (b), (f): YOLOX-X
TR_DP_WORLD = 2        # [train] (f): gloo ranks sharing the card
TR_DP_TIMEOUT_S = 600  # [train] (f): a collective that waits longer fails


def _train_workspace(root: str, seed: int = 0) -> dict:
    """A synthetic COCO workspace over the six 1920x1080 fixture views:
    person-keypoint GT with `TR_PER_VIEW` persons a view (17 keypoints
    inside each box, ~85% visible) and instances GT of `TR_DET_IMAGES`
    image entries (view i % 6, 1-4 person boxes each)."""
    rng = np.random.default_rng(seed)
    H, W = 1080, 1920

    def box():
        w = float(rng.uniform(90, 320))
        h = float(min(w * rng.uniform(1.6, 2.8), H - 2))
        return [float(rng.uniform(0, W - w)), float(rng.uniform(0, H - h)),
                w, h]
    cats = [{"id": 1, "name": "person"}]
    images = [{"id": v, "file_name": f"Camera0{v}.jpg", "width": W,
               "height": H} for v in range(6)]
    anns = []
    for v in range(6):
        for _ in range(TR_PER_VIEW):
            x, y, w, h = box()
            kp = np.zeros((17, 3))
            kp[:, 0] = rng.uniform(x, x + w, 17)
            kp[:, 1] = rng.uniform(y, y + h, 17)
            kp[:, 2] = np.where(rng.uniform(0, 1, 17) > 0.15, 2, 0)
            anns.append({"id": len(anns), "image_id": v, "category_id": 1,
                         "bbox": [x, y, w, h], "iscrowd": 0,
                         "keypoints": kp.ravel().tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum())})
    out = {"img_root": os.path.join(IMAGE_FIXTURES, "views"),
           "pose": os.path.join(root, "person_keypoints.json"),
           "det": os.path.join(root, "instances.json")}
    with open(out["pose"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    images = [{"id": i, "file_name": f"Camera0{i % 6}.jpg", "width": W,
               "height": H} for i in range(TR_DET_IMAGES)]
    anns = []
    for i in range(TR_DET_IMAGES):
        for _ in range(int(rng.integers(1, 5))):
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": box(), "iscrowd": 0})
    with open(out["det"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return out


def _hybrik_batch(rng, imgs, n: int) -> dict:
    """`n` HybrIK training samples (256x256, `hybrik_train_sample`) on the
    fixture views: a synthetic person box, 17 + 29 image joints inside
    it, metric joints, SMPL beta/theta and twists."""
    from mvsmplfitting_tpu_torch.detect import augment3d as A3
    samples = []
    for i in range(n):
        src = imgs[i % len(imgs)]
        w = float(rng.uniform(200, 420))
        h = float(min(w * rng.uniform(1.5, 2.2), 1000.0))
        x0, y0 = float(rng.uniform(0, 1920 - w)), float(rng.uniform(0, 1080 - h))

        def joints(J):
            return np.concatenate([
                rng.uniform([x0, y0], [x0 + w, y0 + h], (J, 2)),
                rng.uniform(-600, 600, (J, 1))], 1)
        label = {"bbox": [x0, y0, x0 + w, y0 + h],
                 "joint_img_17": joints(17),
                 "joint_vis_17": np.ones((17, 3)),
                 "joint_relative_17": rng.normal(0, 300, (17, 3)),
                 "joint_img_29": joints(29),
                 "joint_vis_29": np.ones((29, 3)),
                 "joint_cam_29": rng.normal(0, 300, (29, 3)),
                 "beta": rng.normal(0, 1, 10),
                 "theta": rng.normal(0, 0.3, (24, 3)),
                 "twist_phi": rng.normal(0, 1, (23, 2)),
                 "twist_weight": np.ones((23, 2))}
        samples.append(A3.hybrik_train_sample(rng, src[..., ::-1], label))
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _card_vs_cpu(name, model, batch, make_step, dev) -> dict:
    """One SGD step (lr 1e-3, momentum 0.9, Nesterov, weight decay 5e-4)
    from the same weights on the card and on the CPU, in float64 (held at
    TR_RTOL / TR_ATOL) and in float32 (the card's and the CPU's float32
    steps against the CPU's float64 one, in units of TR_ATOL + TR_RTOL
    |p|: the card's may be at most 3x the CPU's, plus 1)."""
    import copy

    from mvsmplfitting_tpu_torch.detect import train as T

    def run(d, dtype):
        m = copy.deepcopy(model).to(device=d, dtype=dtype)
        opt = T.Optimizer("sgd", 1e-3, list(m.parameters()))
        st = T.init_train_state(m, opt)
        loss, _ = make_step()(st, {
            k: v.to(device=d, dtype=dtype if v.is_floating_point()
                    else v.dtype) for k, v in batch.items()})
        sd = {k: v.detach().to("cpu", torch.float64)
              for k, v in m.state_dict().items() if v.is_floating_point()}
        return float(loss), sd

    def worst(a, b):
        return max(float(((a[k] - b[k]).abs()
                          / (TR_ATOL + TR_RTOL * b[k].abs())).max())
                   for k in b)
    l64c, s64c = run(dev, torch.float64)
    l64h, s64h = run("cpu", torch.float64)
    l32c, s32c = run(dev, torch.float32)
    l32h, s32h = run("cpu", torch.float32)
    assert abs(l64c - l64h) <= TR_RTOL * abs(l64h), (name, l64c, l64h)
    assert abs(l32c - l32h) <= TR_RTOL * abs(l32h), (name, l32c, l32h)
    w64, w32c, w32h = worst(s64c, s64h), worst(s32c, s64h), worst(s32h, s64h)
    assert w64 <= 1.0, (name, w64)
    assert w32c <= 3.0 * w32h + 1.0, (name, w32c, w32h)
    return dict(net=name, loss64_rel=f"{abs(l64c - l64h) / abs(l64h):.3e}",
                loss32_rel=f"{abs(l32c - l32h) / abs(l32h):.3e}",
                params64_worst=f"{w64:.3e}", card32_vs_cpu64=f"{w32c:.3f}",
                cpu32_vs_cpu64=f"{w32h:.3f}",
                max_abs64=f"{max(float((s64c[k] - s64h[k]).abs().max()) for k in s64h):.3e}")


def train_phase(dev, launches: dict) -> None:
    """[train]: the training of the detector and the pose nets at full
    width on the card (no B1-B4 on this path)."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from mvsmplfitting_tpu_torch.cli import train_pose, train_yolox
    from mvsmplfitting_tpu_torch.data.images import read_image
    from mvsmplfitting_tpu_torch.detect import train as T
    from mvsmplfitting_tpu_torch.detect.hybrik import Simple3DPoseSMPLCam
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer

    card = repr(card_line())
    t_phase = time.perf_counter()
    one = {}               # (a)'s and (b)'s figures, for (f)

    def figures(tag, res, timer, wall, unit, per_step):
        steps = res["steps"]
        losses = res["losses"]
        assert np.isfinite(losses).all(), (tag, losses)
        t = timer.timings
        data_s = sum(t.get("data", []))
        ckpt_s = sum(t.get("checkpoint", []))
        loop_s = res["seconds"] - ckpt_s - sum(t.get("eval", []))
        dev_s = timer.device_totals().get("step", 0.0)
        return dict(steps=steps, steps_per_s=f"{steps / loop_s:.3f}",
                    **{f"{unit}_per_s": f"{steps * per_step / loop_s:.2f}"},
                    device_s_per_step=f"{dev_s / steps:.4f}",
                    host_data_s_per_step=f"{data_s / steps:.4f}",
                    loop_s=f"{loop_s:.3f}", checkpoint_s=f"{ckpt_s:.3f}",
                    wall_s=f"{wall:.3f}",
                    peak_gb=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
                    loss_first=f"{losses[0]:.6f}",
                    loss_last=f"{losses[-1]:.6f}")

    def run(tag, fn):
        timer = StageTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(JK, VK, SK)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(JK, VK, SK)
        launches[f"train_{tag}"] = got
        assert not any(got.values()), f"[train] {tag} launched {got}"
        return res, timer, wall, buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        ws = _train_workspace(tmp)

        # (a) the pose trainer at its defaults.
        out = os.path.join(tmp, "pose")
        res, timer, wall, text = run("pose", lambda timer: train_pose.main(
            TR_POSE_ARGV + ["--ann", ws["pose"], "--img_root",
                            ws["img_root"], "--max_steps", str(TR_POSE_STEPS),
                            "--out", out, "--device", "cuda"], timer=timer))
        assert res["steps"] == TR_POSE_STEPS, text
        for name in ("last.npz", "ema.npz"):
            with np.load(os.path.join(out, name)) as ck:
                assert "conv_out.weight" in ck.files, name
        with open(os.path.join(out, "train_metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        assert rows and rows[-1]["step"] == TR_POSE_STEPS, rows
        one["pose"] = dict(figures("pose", res, timer, wall, "crops", 32),
                           first_loss=res["losses"][0])
        log("train", run="a_pose", model="fastpose", input="256x192",
            heatmap="64x48", batch=32, optimizer="adam", persons=6 * TR_PER_VIEW,
            **figures("pose", res, timer, wall, "crops", 32),
            launches_b1_b4=0, card=card)

        # (b) YOLOX-X: mosaic + mixup steps, then one no-aug L1 step.
        out = os.path.join(tmp, "yolox")
        res, timer, wall, text = run("yolox", lambda timer: train_yolox.main(
            TR_YOLOX_ARGV + ["--ann", ws["det"], "--img_root", ws["img_root"],
                             "--max_steps", str(TR_YOLOX_STEPS + 1),
                             "--out", out, "--device", "cuda"], timer=timer))
        assert res["steps"] == TR_YOLOX_STEPS + 1, text
        l1 = [a["l1"] for a in res["aux"]]
        assert all(v == 0.0 for v in l1[:TR_YOLOX_STEPS]) and l1[-1] > 0, l1
        fg = [a["num_fg"] for a in res["aux"]]
        assert min(fg) >= 1, fg
        for name in ("last.npz", "ema.npz"):
            with np.load(os.path.join(out, name)) as ck:
                assert "head.obj_preds.0.bias" in ck.files, name
        one["yolox"] = dict(figures("yolox", res, timer, wall, "img", 8),
                            first_loss=res["losses"][0])
        log("train", run="b_yolox", model="yolox-x", input="640x640",
            batch=8, optimizer="sgd", mosaic_mixup_steps=TR_YOLOX_STEPS,
            l1_steps=1, l1_last=f"{l1[-1]:.4f}",
            num_fg=",".join(f"{v:.0f}" for v in fg),
            **figures("yolox", res, timer, wall, "img", 8),
            launches_b1_b4=0, card=card)

    # (c) HybrIK at its input size, theta through the analytic IK.
    imgs = [read_image(os.path.join(IMAGE_FIXTURES, "views",
                                    f"Camera0{v}.jpg")) for v in range(6)]
    rng = np.random.default_rng(3)
    net = Simple3DPoseSMPLCam(width_dim=64, height_dim=64)
    T.flax_init(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    state = T.init_train_state(net, T.Optimizer(
        "adam", 1e-3, list(net.parameters())))
    step = T.make_hybrik_train_step(assets=synthetic_smpl("smpl",
                                                          device=dev))

    def hybrik(timer):
        t0 = time.time()
        losses, auxes = [], []
        for _ in range(TR_HYBRIK_STEPS):
            with timer.time("data"):
                batch = T.batch_to(_hybrik_batch(rng, imgs, TR_HYBRIK_BATCH),
                                   dev)
            with timer.device("step", dev):
                loss, aux = step(state, batch)
            losses.append(loss)
            auxes.append(aux)
        return {"steps": TR_HYBRIK_STEPS,
                "losses": [float(v) for v in losses],
                "aux": [{k: float(v) for k, v in a.items()} for a in auxes],
                "seconds": time.time() - t0}
    res, timer, wall, _ = run("hybrik", hybrik)
    theta = [a["loss_theta"] for a in res["aux"]]
    assert np.isfinite(theta).all(), theta
    log("train", run="c_hybrik", input="256x256", heatmap="64x64",
        batch=TR_HYBRIK_BATCH, optimizer="adam",
        loss_theta_last=f"{theta[-1]:.6f}",
        **figures("hybrik", res, timer, wall, "crops", TR_HYBRIK_BATCH),
        launches_b1_b4=0, card=card)
    del state, net, step

    # (d) one SGD step on the card against the CPU, same weights.
    for name, model, batch, make_step in _check_nets():
        log("train", run="d_check", **_card_vs_cpu(
            name, model, batch, make_step, dev), card=card)

    # (e) the host routines against OpenCV's recorded results.
    spec = importlib.util.spec_from_file_location(
        "make_imgproc_fixtures",
        os.path.join(ROOT, "tools", "make_imgproc_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    fix = os.path.join(ROOT, "tests", "fixtures", "imgproc")
    with open(os.path.join(fix, "golden.json")) as f:
        golden = json.load(f)
    bounded = np.load(os.path.join(fix, "bounded.npz"))
    ms = []
    for case in golden["cases"]:
        t0 = time.perf_counter()
        out = fx.run_port(case)
        ms.append(f"{case['name']}:{(time.perf_counter() - t0) * 1e3:.2f}")
        if case.get("bounded"):
            ref = bounded[case["name"]]
            assert fx.sha(ref) == case["sha256"], case["name"]
            ulp = np.spacing(np.float32(np.abs(ref).max()))
            assert np.abs(out - ref).max() <= ulp, case["name"]
        else:
            assert fx.sha(out) == case["sha256"], case["name"]
    log("train", run="e_imgproc", cases=len(golden["cases"]),
        opencv=golden["opencv"], bitwise=sum(
            not c.get("bounded") for c in golden["cases"]),
        bounded_1ulp=sum(bool(c.get("bounded")) for c in golden["cases"]),
        ms=",".join(ms))
    # (f) data parallelism: a world of TR_DP_WORLD ranks on the card.
    train_dp_phase(dev, launches, one, card)
    log("train", seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches_b1_b4=0, card=card)


def _check_nets():
    """(d)'s and (f)'s nets from seeds: [(name, model, batch, make_step
    (**kw))]: a FastPose (128x96, batch 8) and a small YOLOX (0.33 /
    0.25, 128x128, batch 4, three boxes an image)."""
    from mvsmplfitting_tpu_torch.detect import train as T
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    gen = torch.Generator().manual_seed(4)
    rng = np.random.default_rng(4)
    fp = T.flax_init(FastPose(17), gen)
    n, hw = 8, (128, 96)
    pose_batch = {
        "image": torch.from_numpy(rng.uniform(0, 1, (n, *hw, 3)).astype(
            np.float32)),
        "target": torch.from_numpy((rng.uniform(0, 1, (
            n, hw[0] // 4, hw[1] // 4, 17)) ** 8).astype(np.float32)),
        "target_weight": torch.ones(n, 17)}
    yx = T.flax_init(YOLOX(1, 0.33, 0.25, train_outputs=True), gen)
    n, dhw = 4, (128, 128)
    labels = np.zeros((n, 20, 5), np.float32)
    for i in range(n):
        labels[i, :3] = np.concatenate(
            [np.zeros((3, 1)), rng.uniform(30, 100, (3, 2)),
             rng.uniform(15, 50, (3, 2))], 1)
    det_batch = {"image": torch.from_numpy(rng.uniform(
        0, 255, (n, *dhw, 3)).astype(np.float32)),
        "labels": torch.from_numpy(labels)}
    return [("fastpose_128x96_b8", fp, pose_batch, T.make_pose_train_step),
            ("yolox_s033_w025_128_b4", yx, det_batch,
             lambda **kw: T.make_yolox_train_step(dhw, **kw))]


def _dp_sgd_step(model, batch, make_step, dev, group) -> dict:
    """(d)'s SGD step in float64 on `dev`, data-parallel over `group`
    (None: one process on the whole `batch`): the loss and the state
    dict after it, on the CPU."""
    import copy

    from mvsmplfitting_tpu_torch.detect import train as T
    from mvsmplfitting_tpu_torch.parallel import batch_rows
    rows = batch_rows(batch["image"].shape[0], group)
    m = copy.deepcopy(model).to(device=dev, dtype=torch.float64)
    st = T.init_train_state(m, T.Optimizer("sgd", 1e-3, list(m.parameters())),
                            group=group)
    loss, _ = make_step(group=group)(st, {
        k: v[rows].to(device=dev, dtype=torch.float64 if v.is_floating_point()
                      else v.dtype) for k, v in batch.items()})
    return {"loss": float(loss), "rows": batch["image"].shape[0],
            "state": {k: v.detach().cpu()
                      for k, v in m.state_dict().items()}}


def train_dp_child(rank: int, world: int, port: int, device: str,
                   ws: dict, out_dir: str) -> None:
    """One spawned rank of [train] (f): a gloo world on one card; the
    float64 SGD steps of `_check_nets`, then both CLIs at full width on
    the world, with the collectives, host data seconds, peak memory and
    B1-B4 launches of each; writes ``out_dir/rank<rank>.pt``."""
    import contextlib
    import datetime
    import io
    import tempfile

    import torch.distributed as dist

    from mvsmplfitting_tpu_torch import parallel as P
    from mvsmplfitting_tpu_torch.cli import train_pose, train_yolox
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.data_parallel import COMM
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer
    dev = P.init_distributed(f"localhost:{port}", world, rank,
                             backend="gloo", device=torch.device(device),
                             timeout=datetime.timedelta(
                                 seconds=TR_DP_TIMEOUT_S))
    group = dist.group.WORLD
    got = {"steps": {name: _dp_sgd_step(model, batch, make_step, dev, group)
                     for name, model, batch, make_step in _check_nets()}}
    with tempfile.TemporaryDirectory(prefix="mvsf_train_dp_") as out:
        for tag, main, argv in (
                ("pose", train_pose.main, TR_POSE_ARGV + [
                    "--ann", ws["pose"], "--max_steps", str(TR_POSE_STEPS)]),
                ("yolox", train_yolox.main, TR_YOLOX_ARGV + [
                    "--ann", ws["det"],
                    "--max_steps", str(TR_YOLOX_STEPS + 1)])):
            timer = StageTimer()
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            reset_launches(JK, VK, SK)
            COMM.reset()
            COMM.timed = True
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = main(argv + ["--img_root", ws["img_root"], "--out",
                                   os.path.join(out, tag), "--device",
                                   device], timer=timer)
            _sync(dev)
            wall = time.perf_counter() - t0
            COMM.timed = False
            t = timer.timings
            got[tag] = dict(
                res=res, wall=wall, data_s=sum(t.get("data", [])),
                checkpoint_s=sum(t.get("checkpoint", [])),
                device_s=timer.device_totals().get("step", 0.0),
                comm_calls=dict(COMM.calls), comm_bytes=dict(COMM.bytes),
                comm_s=dict(COMM.seconds), text=buf.getvalue(),
                files=sorted(os.listdir(os.path.join(out, tag)))
                if os.path.isdir(os.path.join(out, tag)) else [],
                peak_gb=(torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else 0.0),
                launches=read_launches(JK, VK, SK))
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def train_dp_phase(dev, launches: dict, one: dict, card: str) -> None:
    """[train] (f): `TR_DP_WORLD` gloo ranks spawned on the card (NCCL
    refuses two ranks on one GPU): the float64 SGD steps against this
    process's step on the whole batch, then both CLIs at full width on
    the world, against (a)'s and (b)'s one-process figures."""
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    want = {name: _dp_sgd_step(model, batch, make_step, dev, None)
            for name, model, batch, make_step in _check_nets()}
    with tempfile.TemporaryDirectory() as tmp:
        ws = _train_workspace(tmp)
        out_dir = os.path.join(tmp, "ranks")
        os.makedirs(out_dir)
        mp.spawn(train_dp_child, args=(TR_DP_WORLD, _free_port(), str(dev),
                                       ws, out_dir),
                 nprocs=TR_DP_WORLD, join=True)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(TR_DP_WORLD)]
    spawn_s = time.perf_counter() - t0

    # The float64 steps: every rank's bytes the same, the one-process
    # step's numbers.
    for name, w in want.items():
        got = ranks[0]["steps"][name]
        for r in ranks[1:]:
            assert r["steps"][name]["loss"] == got["loss"], name
            for k, v in got["state"].items():
                assert torch.equal(r["steps"][name]["state"][k], v), (name, k)
        assert abs(got["loss"] - w["loss"]) <= TR_RTOL * abs(w["loss"]), (
            name, got["loss"], w["loss"])
        worst = 0.0
        for k, v in w["state"].items():
            g = got["state"][k]
            if not v.is_floating_point():
                assert torch.equal(g, v), (name, k)
                continue
            torch.testing.assert_close(g, v, rtol=TR_RTOL, atol=TR_ATOL,
                                       msg=f"{name} {k}")
            worst = max(worst, float(((g - v).abs()
                                      / (TR_ATOL + TR_RTOL * v.abs())).max()))
        log("train", run="f_step", net=name, world=TR_DP_WORLD,
            rows_per_rank=w["rows"] // TR_DP_WORLD,
            loss_rel=f"{abs(got['loss'] - w['loss']) / abs(w['loss']):.3e}",
            state_worst=f"{worst:.3e}", ranks_bitwise_equal=True,
            card=card)

    # The CLIs on the world.
    total = {}
    for tag, unit, per_step in (("pose", "crops", 32), ("yolox", "img", 8)):
        res = [r[tag]["res"] for r in ranks]
        for r in res[1:]:
            assert r == res[0], (tag, "ranks returned different results")
        steps, losses = res[0]["steps"], res[0]["losses"]
        assert steps == (TR_POSE_STEPS if tag == "pose"
                         else TR_YOLOX_STEPS + 1), (tag, steps)
        assert np.isfinite(losses).all(), (tag, losses)
        assert "data-parallel over 2 devices" in ranks[0][tag]["text"], tag
        assert ranks[0][tag]["files"] == ["ema.npz", "last.npz",
                                          "train_metrics.jsonl"], ranks[0]
        assert all(r[tag]["files"] == [] or r is ranks[0] for r in ranks)
        first_rel = abs(losses[0] - one[tag]["first_loss"]) / abs(
            one[tag]["first_loss"])
        assert first_rel <= 1e-3, (tag, losses[0], one[tag]["first_loss"])
        for rank, r in enumerate(ranks):
            f = r[tag]
            assert not any(f["launches"].values()), (tag, rank, f["launches"])
            for k, v in f["launches"].items():
                total[k] = total.get(k, 0) + v
            loop_s = f["wall"] - f["checkpoint_s"]
            cs, cb, cc = f["comm_s"], f["comm_bytes"], f["comm_calls"]
            log("train", run=f"f_{tag}", rank=rank, world=TR_DP_WORLD,
                steps=steps, steps_per_s=f"{steps / loop_s:.3f}",
                **{f"{unit}_per_s": f"{steps * per_step / loop_s:.2f}"},
                host_data_s_per_step=f"{f['data_s'] / steps:.4f}",
                one_process_host_data_s_per_step=one[tag][
                    "host_data_s_per_step"],
                one_process_steps_per_s=one[tag]["steps_per_s"],
                device_s_per_step=f"{f['device_s'] / steps:.4f}",
                allreduce_grads_s_per_step=f"{cs.get('grads', 0.0) / steps:.4f}",
                allreduce_bn_s_per_step=f"{cs.get('bn', 0.0) / steps:.4f}",
                allreduce_loss_s_per_step=f"{cs.get('loss', 0.0) / steps:.4f}",
                grads_mb_per_step=f"{cb.get('grads', 0) / steps / 2**20:.1f}",
                bn_mb_per_step=f"{cb.get('bn', 0) / steps / 2**20:.3f}",
                bn_calls_per_step=cc.get("bn", 0) // steps,
                peak_gb=f"{f['peak_gb']:.2f}",
                first_loss_rel_vs_one_process=f"{first_rel:.3e}",
                loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
                launches_b1_b4=0, card=card)
    launches["train_dp"] = total
    log("train", run="f", spawn_and_run_s=f"{spawn_s:.1f}", card=card)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 2

    from mvsmplfitting_tpu_torch.device import resolve_device
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    from mvsmplfitting_tpu_torch.ops import cuda_build
    from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ, make_problem

    # ---- 1. device and environment --------------------------------
    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    card = card_line()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), nvidia_smi=repr(card),
        tf32="off")

    # ---- 2. build --------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build.load(name)
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(cuda_build.KERNEL_SOURCES))
    for name, text in logs.items():
        for info in ptxas_summary(text):
            log("build", source=name, **info)

    # ---- 3. kernels against their plain versions, B=512, 8, 2 ----
    rng = np.random.default_rng(0)
    B = B_KERNEL
    kernels = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # B1 and B2 at the fit's batch (the JSON line's numbers) and at the
    # collision fits' batches.
    jj_err, jj_ms, jj_plain, jj_bound = 0.0, None, None, None
    for model_type in ("smpl", "smpllsp"):
        jm = with_joint_model(synthetic_smpl(model_type,
                                             device=dev)).joint_model
        for Bk in (B, B_COLLIDE, B_MULTI):
            theta = t(rng.normal(0, 0.4, (Bk, 72)))
            betas = t(rng.normal(0, 1.0, (Bk, 10)))
            scale = t(rng.uniform(0.7, 1.5, (Bk,)))
            gj, gb = JK.joint_jacobian_cuda(jm, theta, betas, scale)
            torch.cuda.synchronize()
            wj, wb = JK.joint_jacobian_plain(jm, theta, betas, scale)
            torch.testing.assert_close(gj, wj, rtol=3e-5, atol=1e-5)
            err = (gj - wj).abs().max().item()
            for k in wb:
                torch.testing.assert_close(gb[k], wb[k], rtol=3e-5,
                                           atol=1e-5,
                                           msg=f"{model_type} block {k}")
                err = max(err, (gb[k] - wb[k]).abs().max().item())
            ms = cuda_ms(lambda: JK.joint_jacobian_cuda(jm, theta, betas,
                                                        scale))
            plain = cuda_ms(lambda: JK.joint_jacobian_plain(
                jm, theta, betas, scale), reps=10)
            bnd, by = bound_ms(*joint_kernel_work(
                jm, JK.kernel_tables(jm, dev), Bk))
            log("kernel", name="joint_jacobian", model=model_type, B=Bk,
                max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
                plain_ms=f"{plain:.4f}", bound_ms=f"{bnd:.5f}", bound_by=by)
            jj_err = max(jj_err, err)
            if model_type == "smpl" and Bk == B:   # the main path's model
                jj_ms, jj_plain, jj_bound = ms, plain, (bnd, by)
    kernels["joint_jacobian"] = dict(
        name="joint_jacobian", route="cuda",
        source="mvsmplfitting_tpu_torch/csrc/joint_jacobian.cu",
        replaces="mvsmplfitting_tpu/ops/joint_kernel.py:503",
        max_abs_err=jj_err, ms=jj_ms, plain_ms=jj_plain,
        bound_ms=jj_bound[0], bound_by=jj_bound[1], library_ms=None)

    # Timed on both batches (the near-identity one takes one Shepperd
    # branch in every thread); the larger time is reported.
    w = V.load_npz(VPOSER_NPZ, device=dev)
    vt_err, vt_ms, vt_plain = 0.0, 0.0, 0.0
    vt_bound = bound_ms(*vposer_tail_work(B))
    for Bk in (B, B_COLLIDE, B_MULTI):
        bk_bound = bound_ms(*vposer_tail_work(Bk))
        for sigma in (0.6, 1e-3):
            z = t(rng.normal(0, sigma, (Bk, 32)))
            o, Do = V.mlp_head(w, z)
            o, Do = o.contiguous(), Do.contiguous()
            aa1, D1 = VK.tail_cuda(o, Do)
            torch.cuda.synchronize()
            aa0, D0 = VK.tail_plain(o, Do)
            torch.testing.assert_close(aa1, aa0, rtol=3e-5, atol=1e-5)
            sc = max(D0.abs().max().item(), 1.0)
            torch.testing.assert_close(D1, D0, rtol=3e-4, atol=3e-4 * sc)
            err = max((aa1 - aa0).abs().max().item(),
                      (D1 - D0).abs().max().item())
            ms = cuda_ms(lambda: VK.tail_cuda(o, Do))
            plain = cuda_ms(lambda: VK.tail_plain(o, Do), reps=10)
            log("kernel", name="vposer_tail", z_sigma=sigma, B=Bk,
                max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
                plain_ms=f"{plain:.4f}", bound_ms=f"{bk_bound[0]:.5f}",
                bound_by=bk_bound[1])
            vt_err = max(vt_err, err)
            if Bk == B:
                vt_ms, vt_plain = max(vt_ms, ms), max(vt_plain, plain)
    kernels["vposer_tail"] = dict(
        name="vposer_tail", route="cuda",
        source="mvsmplfitting_tpu_torch/csrc/vposer_tail.cu",
        replaces="mvsmplfitting_tpu/ops/vposer_kernel.py:181",
        max_abs_err=vt_err, ms=vt_ms, plain_ms=vt_plain,
        bound_ms=vt_bound[0], bound_by=vt_bound[1], library_ms=None)

    # ---- 4. short fit parity: card vs CPU plain path ----------------
    short = FitConfig(lm=LMOptions(max_iters=3, linsolve="chol",
                                   speculative=False))
    losses = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else "cpu"
        assets, vw, cam, obs = make_problem(6, 8, seed=1, device=d)
        batch = BatchedFitInputs(obs, torch.full((8,), 1080.0, device=d))
        res = batched_fit_frames(short, assets, cam, batch, vposer_w=vw,
                                 device=d)
        losses[name] = res.stage_losses.cpu()
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-3,
                               atol=0.0)
    rel = ((losses["cuda"] - losses["cpu"]).abs()
           / losses["cpu"].abs()).max().item()
    log("parity", frames=8, stage_losses_max_rel=f"{rel:.3e}",
        final_loss_mean=f"{losses['cuda'][:, -1].mean().item():.3f}")

    # ---- 5. the slice at full width ---------------------------------
    assets, vw, cam, obs = make_problem(6, B_FIT, seed=0, device=dev)
    batch = BatchedFitInputs(obs, torch.full((B_FIT,), 1080.0, device=dev))
    cfg = FitConfig(lm=LMOptions(max_iters=40))
    torch.cuda.synchronize()
    reset_launches(JK, VK, SK)
    t0 = time.perf_counter()
    res = batched_fit_frames(cfg, assets, cam, batch, vposer_w=vw,
                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(JK, VK, SK)
    assert res.stage_losses.shape == (B_FIT, 4)
    assert res.body_pose.shape == (B_FIT, 69)
    assert bool(torch.isfinite(res.stage_losses).all()), "non-finite loss"
    lm_iters = int(res.lm_iters.amax(dim=0).sum().item())
    for name in ("joint_jacobian", "vposer_tail"):
        n = launches[name]
        assert n >= lm_iters, f"{name}: {n} launches < {lm_iters} LM iters"
    losses_np = res.loss.cpu().numpy()
    assert len(np.unique(np.round(losses_np, 3))) > 1, \
        "distinct frames gave identical losses"
    log("fit", frames=B_FIT, views=6, model="smpl",
        fps=f"{B_FIT / wall:.1f}", wall_s=f"{wall:.3f}",
        lm_iterations=lm_iters,
        final_loss_mean=f"{float(losses_np.mean()):.3f}",
        launches=json.dumps(launches).replace(" ", ""))

    # ---- 6-10. the collision slice, the points engine, the fused loop --
    sdf_phase(dev, kernels)
    path = {"fit": launches}
    collide_phase(dev, path)
    multi_phase(dev, path)
    points_phase(dev, path)
    fused_phase(dev, path, res.loss)
    lbfgs_phase(dev, path)
    grad_phase(dev, path)
    gmm_phase(dev, path)
    seq_phase(dev, path)
    adjust_phase(dev, path, cfg, assets, vw, cam, obs, res)
    # JAX's own SMPL-X / SMPL-H fit tests' setups
    # (`tests/test_smplx_family.py:225-322`).
    family_phase(dev, path, "smplx", B_FIT,
                 dict(hand_dim=6, num_expr=10, opt_face=True), 40, 8.0)
    family_phase(dev, path, "smplh", B_SMPLH, dict(hand_dim=6), 30, 6.0)
    schur_phase(dev, path)
    shard_phase(dev, path)
    cli_phase(dev, path)
    kp_weights = keypoint_weights(dev)
    keypoints_phase(dev, path, kp_weights)
    overlay_phase(dev, path)
    stream_phase(dev, path, kp_weights)
    train_phase(dev, path)
    # Every kernel's launches summed over the fit paths.
    for name in kernels:
        kernels[name]["launches"] = sum(p.get(name, 0) for p in path.values())
    # The brute force is the two-phase kernels' yardstick, not on a fit.
    assert kernels["sdf_grid"]["launches"] == 0, path

    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kv[k] for k in keys}
                                  for kv in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
