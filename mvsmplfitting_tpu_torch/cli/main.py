"""Multi-view SMPL fitting CLI (port of `cli/main.py`).

Usage (mirrors the reference's `python code/main.py --config
cfg_files/fit_smpl.yaml`, `README.md:16`):

    python -m mvsmplfitting_tpu_torch.cli.main --config <yaml> \
        [--data_folder ...] [--output_folder ...] [--device cuda|cpu]

It takes the JAX CLI's configs and arguments and writes the same
outputs: `conf.yaml`, `results/<serial>/<frame>/000.pkl` (or
`<p:03d>.pkl` per person), `meshes/.../000.obj` and, with `save_images`,
the overlays `images/<serial>/<frame>/<view:02d>.jpg` (`viz/overlay.py`,
drawn and encoded without OpenCV).  Three modes, chosen
as in JAX: `num_people > 1` fits the people of each frame together
(`fit_people`), `batch_frames > 1` outside sequences fits frames in
batches (`batched_fit_frames`), anything else frame by frame, with the
sequence warm start under `is_seq` and `--resume`.  The fit runs on
`--device` (CUDA unless ``--device cpu``; no fall back to the CPU); the
overlays are drawn on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import dump_config, load_config
from ..data.dataset import FrameData, cat_observations, frame_to_observations
from ..data.results import FitOutputs, load_result_pkl, save_obj, \
    save_result_pkl
from ..fitting import energy as E
from ..fitting.initialize import init_guess, warm_start
from ..fitting.multi_person import fit_people
from ..fitting.stages import FitResult, fit_frame
from ..models.smpl import SMPLParams, smpl_forward
from ..parallel.batched import BatchedFitInputs, batched_fit_frames
from ..session import Session, build_session
from ..utils.profiling import StageTimer
from ..viz.overlay import save_overlays, save_overlays_multi


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Multi-view SMPL fitting on one GPU (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_folder", type=str, default=None)
    p.add_argument("--cam_param", type=str, default=None)
    p.add_argument("--output_folder", type=str, default=None)
    p.add_argument("--model_folder", type=str, default=None)
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--prior_folder", type=str, default=None)
    p.add_argument("--optim_type", type=str, default=None)
    p.add_argument("--maxiters", type=int, default=None)
    p.add_argument("--is_seq", action="store_true", default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip frames whose result pkl already exists")
    p.add_argument("--no_save_images", dest="save_images",
                   action="store_false", default=None,
                   help="skip the overlay images (images/<serial>/<frame>/"
                        "<view>.jpg)")
    p.add_argument("--no_save_meshes", dest="save_meshes",
                   action="store_false", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the fit (default cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    return p.parse_args(argv)


# (row of the fit's batch, frame, file stem) for each result to write.
Item = Tuple[int, FrameData, str]


def _save_outputs(cfg, sess: Session, result: FitResult,
                  items: Sequence[Item], result_root: str,
                  mesh_root: str) -> Optional[np.ndarray]:
    """The pkl of each item and, with `save_meshes`, its mesh: the body
    with the saved (extremity-zeroed) pose, as JAX's CLI writes it.
    Returns those bodies' vertices (one (V, 3) float32 array per item)
    when meshes or images are saved, else None."""
    rows = [r for r, _, _ in items]
    host = {k: t.detach()[rows].cpu().numpy() for k, t in (
        ("betas", result.params.betas),
        ("global_orient", result.params.global_orient),
        ("transl", result.params.transl), ("scale", result.params.scale),
        ("body_pose", result.body_pose), ("z", result.z),
        ("loss", result.loss))}
    saved = []
    for j, (_, frame, stem) in enumerate(items):
        out = FitOutputs(betas=host["betas"][j],
                         global_orient=host["global_orient"][j],
                         transl=host["transl"][j], scale=host["scale"][j],
                         body_pose=host["body_pose"][j],
                         pose_embedding=host["z"][j],
                         loss=float(host["loss"][j]))
        saved.append(save_result_pkl(os.path.join(
            result_root, frame.serial, frame.frame_name, f"{stem}.pkl"), out))
    if not (cfg.save_meshes or cfg.save_images):
        return None
    if not items:                       # a frame with no one in it
        return np.zeros((0, sess.assets.v_template.shape[0], 3), np.float32)
    dev = result.loss.device
    params = SMPLParams(**{
        f.name: (None if getattr(result.params, f.name) is None
                 else getattr(result.params, f.name)[rows])
        for f in dataclasses.fields(SMPLParams)})

    def stacked(key):
        return torch.as_tensor(np.concatenate([s[key] for s in saved]),
                               device=dev)

    params = dataclasses.replace(params, global_orient=stacked("pose")[:, :3],
                                 body_pose=stacked("body_pose"))
    verts, _ = smpl_forward(sess.assets, params)
    verts = verts.cpu().numpy()
    if cfg.save_meshes:
        faces = sess.assets.faces.cpu().numpy()
        for j, (_, frame, stem) in enumerate(items):
            save_obj(os.path.join(mesh_root, frame.serial, frame.frame_name,
                                  f"{stem}.obj"), verts[j], faces)
    return verts


def _save_images(cfg, sess: Session, frames: Sequence[FrameData],
                 verts: Optional[np.ndarray], image_root: str,
                 timer: StageTimer) -> None:
    """The overlays of each frame's views (JAX `main.py:70-85`)."""
    if not cfg.save_images:
        return
    faces = sess.assets.faces.cpu().numpy()
    with timer.time("images"):
        for frame, v in zip(frames, verts):
            save_overlays(os.path.join(image_root, frame.serial,
                                       frame.frame_name),
                          frame, sess.cameras, v, faces, timer=timer)


def run_multi_person(cfg, sess: Session, result_root: str, mesh_root: str,
                     image_root: str, timer: StageTimer) -> int:
    """Fit up to `num_people` per frame (solo fits, then the joint
    collision refinement when interpenetration is on).  The reference
    has no such path (its solver asserts batch 1,
    `non_linear_solver.py:56`); results land as <frame>/<p:03d>.pkl per
    person.

    People are index-matched across views (the data layer keeps each
    JSON's person order); cross-view identity association is the
    keypoint producer's job, as in the reference's file contract."""
    P = cfg.num_people
    dev = sess.device
    n_frames = 0
    for i in range(len(sess.dataset)):
        with timer.time("read"):
            frame = sess.dataset[i]
            obs = cat_observations([
                frame_to_observations(frame, sess.joint_weights, person=p,
                                      device=dev) for p in range(P)])
            # A person absent from a view has zero-confidence rows
            # already (padded people); mask the views as well.
            vm = frame.person_mask.T * frame.view_mask[None, :]
            obs = dataclasses.replace(obs, view_mask=torch.as_tensor(
                vm, device=dev))
            live = frame.person_mask.max(axis=0)     # (P,) person present?

        t0 = time.time()
        with timer.time("fit"):
            results, coll_sums = fit_people(
                sess.fit_config, sess.assets, sess.cameras, obs,
                vposer_w=sess.vposer, gmm=sess.gmm,
                img_height=float(frame.img_hw[0]),
                est_scale=not cfg.fix_scale, sdf_engine=cfg.sdf_engine,
                device=dev)
            losses = results.loss.cpu().numpy()
            coll = coll_sums.cpu().numpy()
        print(f"Processing: {frame.serial}/{frame.frame_name} — "
              f"{int(live.sum())} people, losses "
              f"{[round(float(l), 1) for l, m in zip(losses, live) if m]}"
              f" coll {np.round(coll, 3).tolist()} "
              f"in {time.time() - t0:.2f}s")
        with timer.time("write"):
            items = [(p, frame, f"{p:03d}") for p in range(P) if live[p]]
            verts = _save_outputs(cfg, sess, results, items, result_root,
                                  mesh_root)
        if cfg.save_images:
            # Every live person in one depth-sorted render per view
            # (JAX `main.py:130-170`).
            people = np.zeros((P, sess.assets.v_template.shape[0], 3),
                              np.float32)
            for j, (p, _, _) in enumerate(items):
                people[p] = verts[j]
            with timer.time("images"):
                save_overlays_multi(
                    os.path.join(image_root, frame.serial, frame.frame_name),
                    frame, sess.cameras, people,
                    sess.assets.faces.cpu().numpy(), live=live, timer=timer)
        n_frames += 1
    return n_frames


def run_batched(cfg, sess: Session, result_root: str, mesh_root: str,
                image_root: str, timer: StageTimer) -> int:
    """Batched mode: init and fit `batch_frames` frames per call, the
    last chunk padded with repeats of its last frame."""
    dev = sess.device
    with timer.time("read"):
        frames = list(sess.dataset)
    n_done = 0
    B = cfg.batch_frames
    for i in range(0, len(frames), B):
        chunk = frames[i:i + B]
        pad = B - len(chunk)
        with timer.time("read"):
            obs_list = [frame_to_observations(f, sess.joint_weights,
                                              device=dev) for f in chunk]
            obs_list += [obs_list[-1]] * pad          # pad with repeats
            heights = [float(f.img_hw[0]) for f in chunk]
            heights += [heights[-1]] * pad
            batch = BatchedFitInputs(
                obs=cat_observations(obs_list),
                img_height=torch.tensor(heights, dtype=torch.float32,
                                        device=dev))
        t0 = time.time()
        with timer.time("fit"):
            out = batched_fit_frames(
                sess.fit_config, sess.assets, sess.cameras, batch,
                vposer_w=sess.vposer, gmm=sess.gmm,
                est_scale=not cfg.fix_scale, device=dev)
            mean_loss = float(np.mean(out.loss.cpu().numpy()))
        print(f"  batch of {len(chunk)} fit in {time.time() - t0:.2f}s "
              f"(mean loss {mean_loss:.2f})")
        with timer.time("write"):
            verts = _save_outputs(cfg, sess, out,
                                  [(b, f, "000") for b, f in enumerate(chunk)],
                                  result_root, mesh_root)
        _save_images(cfg, sess, chunk, verts, image_root, timer)
        n_done += len(chunk)
    return n_done


def _resume_state(path: str, dev: torch.device):
    """(params, z, loss) of a saved result, a batch of one frame: the
    sequence's warm start after a skipped frame (results as checkpoints,
    like the reference's warm-start pkls, `utils.py:859-864`)."""
    d = load_result_pkl(path)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    params = SMPLParams(betas=t(d["betas"]),
                        global_orient=t(d["global_orient"]),
                        body_pose=t(d["body_pose"]), transl=t(d["transl"]),
                        scale=t(d["scale"][:, 0]))
    return params, t(d["pose_embedding"]), t([d["loss"]])


def run_frames(cfg, sess: Session, result_root: str, mesh_root: str,
               image_root: str, resume: bool, timer: StageTimer) -> int:
    """Frame by frame, each a batch of one; under `is_seq` every frame
    after the first warm-starts from the one before."""
    dev = sess.device
    spec = sess.fit_config.spec
    fixed_scale = cfg.scale if (cfg.fix_scale and cfg.scale) else 1.0
    prev = None  # (params, z, loss) of the previous frame for sequences
    n_frames = 0
    for i in range(len(sess.dataset)):
        with timer.time("read"):
            frame = sess.dataset[i]
        out_pkl = os.path.join(result_root, frame.serial,
                               frame.frame_name, "000.pkl")
        if resume and os.path.exists(out_pkl):
            prev = _resume_state(out_pkl, dev)
            print(f"Skipping (resume): {frame.serial}/{frame.frame_name}")
            n_frames += 1
            continue
        with timer.time("read"):
            obs = frame_to_observations(frame, sess.joint_weights,
                                        device=dev)
        print(f"Processing: {frame.serial}/{frame.frame_name} "
              f"({int(np.sum(frame.view_mask))} views)")

        t0 = time.time()
        with timer.time("fit"):
            guess = init_guess(
                sess.assets, sess.cameras, obs.gt2d, obs.conf,
                obs.view_mask, est_scale=not cfg.fix_scale,
                fixed_scale=fixed_scale,
                gt3d=obs.gt3d if cfg.use_3d else None)
            seq_start = prev is None or not cfg.is_seq
            if not seq_start:
                guess = warm_start(prev[0], prev[1], prev[2], guess)
            params, z = guess.params, guess.z
            if cfg.fix_shape and cfg.shape is not None:
                params = dataclasses.replace(params, betas=torch.tensor(
                    [cfg.shape], dtype=torch.float32, device=dev))
            if not cfg.use_vposer:
                # sic: the reference's fix_params (`init_guess.py:190-212`,
                # called every frame at `main.py:81`) resets body_pose to
                # [1]*6 + [0]*63; with VPoser the model pose is unused so
                # only the non-VPoser path sees it.
                params = dataclasses.replace(params, body_pose=torch.tensor(
                    [[1.0] * 6 + [0.0] * 63], device=dev))
            result = fit_frame(sess.fit_config, sess.assets, sess.cameras,
                               obs, params, z, vposer_w=sess.vposer,
                               gmm=sess.gmm,
                               img_height=float(frame.img_hw[0]),
                               seq_start=seq_start)
            err_px = float(E.reprojection_error_px(
                spec, sess.assets, sess.cameras, obs, sess.vposer,
                E.pack(spec, result.params, result.z))[0])
            stage_str = " ".join(f"{float(s):.1f}" for s in
                                 result.stage_losses[0].cpu().numpy())
        print(f"  stages [{stage_str}] final {float(result.loss[0]):.3f} "
              f"reproj {err_px:.2f}px in {time.time() - t0:.2f}s")
        prev = (result.params, result.z, result.loss)
        n_frames += 1
        with timer.time("write"):
            verts = _save_outputs(cfg, sess, result, [(0, frame, "000")],
                                  result_root, mesh_root)
        _save_images(cfg, sess, [frame], verts, image_root, timer)
    return n_frames


def main(argv: Optional[List[str]] = None,
         timer: Optional[StageTimer] = None) -> int:
    """Run the CLI; `timer` collects the seconds of the session build
    ("session") and the dataset reads ("read"), fits ("fit"), result
    writes ("write") and overlays ("images", and per view "overlay.read",
    ".project", ".fill", ".blend", ".encode") when given."""
    args = parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "resume", "device") and v is not None}
    cfg = load_config(args.config, **overrides)
    timer = StageTimer() if timer is None else timer
    with timer.time("session"):
        sess = build_session(cfg, device=args.device)

    out_root = cfg.output_folder
    result_root = os.path.join(out_root, cfg.result_folder)
    mesh_root = os.path.join(out_root, cfg.mesh_folder)
    image_root = os.path.join(out_root, "images")
    os.makedirs(out_root, exist_ok=True)
    dump_config(cfg, os.path.join(out_root, "conf.yaml"))

    if sess.synthetic_model:
        print("[warn] no SMPL pkl found under "
              f"{cfg.model_folder}; using the synthetic test model "
              "(fits run, parameters are not human-shaped)")

    start = time.time()
    if cfg.num_people > 1:
        n_frames = run_multi_person(cfg, sess, result_root, mesh_root,
                                    image_root, timer)
    elif cfg.batch_frames > 1 and not cfg.is_seq:
        n_frames = run_batched(cfg, sess, result_root, mesh_root,
                               image_root, timer)
    else:
        n_frames = run_frames(cfg, sess, result_root, mesh_root,
                              image_root, args.resume, timer)
    elapsed = time.time() - start
    print(f"Processed {n_frames} frame(s) in {elapsed:.2f}s "
          f"({n_frames / max(elapsed, 1e-9):.3f} frames/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
