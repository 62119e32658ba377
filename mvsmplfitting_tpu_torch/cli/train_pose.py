"""Pose-network training CLI (port of `cli/train_pose.py`; the
reference family's `scripts/train.py`, parameterized like its train
configs: `configs/halpe_26/resnet/256x192_res50_lr1e-3_1x.yaml` TRAIN).

COCO GT json -> host augmentation (`detect/augment.py`) -> Gaussian
heatmap targets (or integral-regression targets) -> one train step a
batch on `--device` (`detect/train.py`: forward in train mode, autograd,
optax's optimizer, EMA) -> `last.npz` / `ema.npz` checkpoints in the
reference's state-dict names and `train_metrics.jsonl`.

Under `torchrun` the step is data-parallel, one rank a card (JAX's
``("batch",)`` mesh): `--batch` is the global batch, each rank loads and
decodes its block of rows, and the step gives the one-device step's
numbers on the global batch (`parallel/data_parallel.py`).  A world that
does not divide `--batch` is refused.  Rank 0 alone writes files and
logs; every rank returns the same result.

    python -m mvsmplfitting_tpu_torch.cli.train_pose \\
        --ann annotations/person_keypoints_train.json --img_root images \\
        --model fastpose --num_joints 17 --epochs 2 --batch 32 [--device cpu]
    torchrun --nproc_per_node 4 -m mvsmplfitting_tpu_torch.cli.train_pose \\
        --ann ... --img_root ... --batch 128
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ann", required=True,
                   help="COCO person_keypoints GT json; comma-list "
                        "concatenates datasets (the reference's "
                        "ConcatDataset / halpe_coco_wholebody merges)")
    p.add_argument("--img_root", required=True,
                   help="image root; comma-list pairs with --ann")
    p.add_argument("--model", default="fastpose")
    p.add_argument("--num_joints", type=int, default=17)
    p.add_argument("--format", default=None,
                   help="keypoint format from the skeleton registry "
                        "(halpe26/halpe68/halpe136/coco_wholebody133/"
                        "mpii16/...) — sets the flip pairs and "
                        "half-body ids; default COCO-17 tables")
    p.add_argument("--input_size", default="256x192",
                   help="HxW crop size")
    p.add_argument("--heatmap_size", default="64x48")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd", "rmsprop"])
    p.add_argument("--lr_step", default="50,70",
                   help="epoch milestones (LR_STEP)")
    p.add_argument("--lr_factor", type=float, default=0.1)
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--loss_type", default="mse",
                   choices=["mse", "integral"],
                   help="MSELoss heatmap targets or L1JointRegression")
    p.add_argument("--norm_type", default="softmax",
                   choices=["softmax", "sigmoid"],
                   help="integral-loss heatmap normalization")
    p.add_argument("--out", default="pose_train_out")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (0 = run all epochs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deconv", default="",
                   help="simplepose deconv filters, e.g. 256,256,256")
    p.add_argument("--conv_dim", type=int, default=0,
                   help="fastpose DUC conv dim override")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, under torchrun "
                        "cuda:LOCAL_RANK; 'cpu' runs the plain path on the "
                        "CPU, over gloo under torchrun)")
    return p.parse_args(argv)


def aug_for_format(fmt, num_joints, input_hw):
    """PoseAugConfig for a named keypoint format: flip pairs from the
    skeleton registry; None -> the dataset's default (COCO-17 tables).
    The half-body split is always COCO-17's upper (0..10) / lower, as
    the reference's `CustomDataset.__init__` shadows the per-format ids
    (`datasets/custom.py:93-94`)."""
    if fmt is None:
        return None
    from ..detect.augment import PoseAugConfig
    from ..viz.skeletons import skeleton_for
    spec = skeleton_for(num_joints, fmt)
    if spec.num_joints != num_joints:
        raise SystemExit(
            f"--format {fmt} is a {spec.num_joints}-joint set, got "
            f"--num_joints {num_joints}")
    return PoseAugConfig(
        input_hw=input_hw, flip_pairs=spec.flip_pairs,
        upper_body_ids=tuple(range(11)))


def main(argv=None, timer=None):
    """Train; returns the run's steps, per-step losses (and loss parts)
    and seconds.  `timer` (a `utils.profiling.StageTimer`) gets the host
    seconds of each batch's loading ('data'), of the checkpoint writes
    ('checkpoint') and of validation ('eval'), and the device time of each
    step ('step', CUDA events)."""
    args = parse_args(argv)
    import torch

    from ..detect.dataset import CocoPoseTrainDataset
    from ..detect.train import (Optimizer, flax_init, init_train_state,
                                lr_schedule, make_integral_train_step,
                                make_pose_train_step)
    from ..detect.zoo import build_pose_model
    from ..parallel.data_parallel import (init_data_parallel, rank,
                                          world_size)

    device, group = init_data_parallel(args.device)
    if world_size(group) > 1 and rank(group) == 0:
        print(f"data-parallel over {world_size(group)} devices", flush=True)
    hw = tuple(int(v) for v in args.input_size.split("x"))
    hm = tuple(int(v) for v in args.heatmap_size.split("x"))
    integral = args.loss_type == "integral"
    anns = args.ann.split(",")
    roots = args.img_root.split(",")
    ds = CocoPoseTrainDataset(anns if len(anns) > 1 else args.ann,
                              roots if len(roots) > 1 else args.img_root,
                              hw, hm,
                              batch_size=args.batch, sigma=args.sigma,
                              seed=args.seed,
                              num_joints=args.num_joints,
                              aug=aug_for_format(args.format,
                                                 args.num_joints, hw),
                              loss_type=("integral" if integral
                                         else "heatmap"),
                              rank=rank(group), world=world_size(group))
    if len(ds) == 0:
        raise SystemExit("no full batches: fewer annotations than "
                         f"--batch {args.batch}")

    kw = {}
    if args.deconv:
        kw["deconv_filters"] = tuple(
            int(v) for v in args.deconv.split(","))
    if args.conv_dim:
        kw["conv_dim"] = args.conv_dim
    model = build_pose_model(args.model, args.num_joints, **kw)
    flax_init(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)

    milestones = [int(v) for v in args.lr_step.split(",") if v]
    sched = lr_schedule("multistep", args.lr, iters_per_epoch=len(ds),
                        total_epochs=args.epochs,
                        milestones=milestones, factor=args.lr_factor)
    tx = Optimizer(args.optimizer, sched, list(model.parameters()))
    state = init_train_state(model, tx, group=group)
    step_fn = (make_integral_train_step(norm_type=args.norm_type,
                                        group=group)
               if integral else make_pose_train_step(group=group))
    return train_loop(args, ds, state, step_fn, device, timer,
                      unit="crops", log_every=20)


def open_metrics(args, group):
    """`args.out` and its `train_metrics.jsonl` on rank 0; None on the
    other ranks, which write nothing."""
    from ..parallel.data_parallel import rank
    from ..utils.profiling import Metrics
    if rank(group) != 0:
        return None
    os.makedirs(args.out, exist_ok=True)
    return Metrics(os.path.join(args.out, "train_metrics.jsonl"))


def train_loop(args, ds, state, step_fn, device, timer, unit: str,
               log_every: int, per_epoch=None, on_epoch=None):
    """The epoch loop both training CLIs share: batches from `ds`, one
    `step_fn` each, a log line every `log_every` steps and at the last
    (`args.max_steps`), checkpoints after each epoch.  `per_epoch(epoch)`
    sets the epoch up and returns its step function (default `step_fn`);
    `on_epoch(epoch, step, done)` runs after its checkpoints.  Data
    parallel (`state.group`): the losses are global, the rates count the
    global batch, rank 0 alone logs and writes, and the seconds are rank
    0's, so that every rank returns the same result."""
    import contextlib

    from ..detect.train import batch_to, save_checkpoint
    from ..parallel.data_parallel import broadcast_object, rank

    lead = rank(state.group) == 0
    metrics = open_metrics(args, state.group)
    step = 0
    losses, auxes = [], []
    t0 = time.time()
    for epoch in range(args.epochs):
        fn = per_epoch(epoch) if per_epoch is not None else step_fn
        it = iter(ds)
        while True:
            with (timer.time("data") if timer is not None
                  else contextlib.nullcontext()):
                host = next(it, None)
                if host is not None:
                    batch = batch_to(host, device)
            if host is None:
                break
            with (timer.device("step", device) if timer is not None
                  else contextlib.nullcontext()):
                loss, aux = fn(state, batch)
            losses.append(loss)
            auxes.append(aux)
            step += 1
            if lead and (step % log_every == 1
                         or (args.max_steps and step >= args.max_steps)):
                loss = float(loss)
                # JAX's logs read the schedule at the step count.
                lr_now = state.optimizer.lr(step)
                rate = step * args.batch / (time.time() - t0)
                extra = {}
                if "num_fg" in aux:
                    extra["num_fg"] = float(aux["num_fg"])
                    print(f"epoch {epoch} step {step} loss {loss:.4f} "
                          f"num_fg {extra['num_fg']:.0f} lr {lr_now:.2e} "
                          f"({rate:.1f} {unit}/s)", flush=True)
                else:
                    print(f"epoch {epoch} step {step} loss {loss:.6f} "
                          f"lr {lr_now:.2e} ({rate:.1f} {unit}/s)",
                          flush=True)
                metrics.log(epoch=epoch, step=step, loss=loss, lr=lr_now,
                            **extra)
            if args.max_steps and step >= args.max_steps:
                break
        with (timer.time("checkpoint") if timer is not None
              else contextlib.nullcontext()):
            if lead:
                save_checkpoint(os.path.join(args.out, "last.npz"),
                                state.model.state_dict())
                save_checkpoint(os.path.join(args.out, "ema.npz"),
                                state.ema)
        done = bool(args.max_steps and step >= args.max_steps)
        if on_epoch is not None:
            with (timer.time("eval") if timer is not None
                  else contextlib.nullcontext()):
                on_epoch(epoch, step, done)
        if done:
            break
    losses = [float(v) for v in losses]
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    if lead:
        print(f"done: {step} steps, checkpoints in {args.out}")
    return {"steps": step, "losses": losses, "aux": auxes,
            "seconds": broadcast_object(time.time() - t0, state.group)}


if __name__ == "__main__":
    main()
