"""YOLOX detection training CLI (port of `cli/train_yolox.py`; the
reference family's `yolox/exp/yolox_base.py` recipe: mosaic + SimOTA +
SGD Nesterov + yoloxwarmcos LR + EMA, the last `no_aug_epochs` on plain
letterbox batches with the L1 loss, as the torch trainer does when it
closes mosaic).

COCO instances json -> host mosaic / affine / mixup / HSV
(`detect/augment.py`) -> one SimOTA train step a batch on `--device`
(`detect/train.py` + `detect/yolox_loss.py`) -> EMA, `last.npz` /
`ema.npz` in the reference's state-dict names, `train_metrics.jsonl`,
and with `--val_ann` the EMA net's box mAP.

Under `torchrun` the step is data-parallel, as `cli/train_pose.py`'s:
`--batch` is the global batch, SimOTA's foreground and gt counts are
summed over the ranks, rank 0 alone writes files and validates, and
every rank returns the same result.

    python -m mvsmplfitting_tpu_torch.cli.train_yolox \\
        --ann annotations/instances_train.json --img_root images \\
        --depth 0.33 --width 0.5 --input_size 640x640 --batch 8 [--device cpu]
    torchrun --nproc_per_node 8 -m mvsmplfitting_tpu_torch.cli.train_yolox \\
        --ann ... --img_root ... --batch 64
"""

from __future__ import annotations

import argparse
import copy
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ann", required=True,
                   help="COCO instances GT json")
    p.add_argument("--img_root", required=True)
    p.add_argument("--depth", type=float, default=1.33,
                   help="depth multiplier (X=1.33, s=0.33)")
    p.add_argument("--width", type=float, default=1.25,
                   help="width multiplier (X=1.25, s=0.5)")
    p.add_argument("--input_size", default="640x640", help="HxW")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--no_aug_epochs", type=int, default=15,
                   help="final epochs without mosaic/mixup, with L1 "
                        "loss")
    p.add_argument("--no_mixup", action="store_true",
                   help="disable MixUp (the reference trainer's "
                        "enable_mixup=True default otherwise, "
                        "mosaicdetection.py:148-160)")
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--basic_lr_per_img", type=float, default=0.01 / 64,
                   help="lr = basic_lr_per_img * batch (yolox_base)")
    p.add_argument("--min_lr_ratio", type=float, default=0.05)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--max_labels", type=int, default=100)
    p.add_argument("--out", default="yolox_train_out")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (0 = run all epochs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_ann", default=None,
                   help="COCO instances GT json for validation mAP")
    p.add_argument("--val_img_root", default=None,
                   help="validation image root (default: --img_root)")
    p.add_argument("--eval_interval", type=int, default=10,
                   help="evaluate every N epochs (and at the end)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, under torchrun "
                        "cuda:LOCAL_RANK; 'cpu' runs the plain path on the "
                        "CPU, over gloo under torchrun)")
    return p.parse_args(argv)


def evaluate_detection(model, ann: str, img_root: str, input_hw,
                       device, conf_thresh: float = 0.01,
                       nms_thresh: float = 0.65,
                       max_images: int = 0) -> float:
    """Validation box mAP (IoU 0.50:0.95), the reference trainer's
    `COCOEvaluator.evaluate` scored natively: each annotated image
    letterboxed (raw 0-255 BGR, as in training), the sigmoided decode of
    `model` (inference outputs), per-anchor argmax class, class-aware
    NMS, the inverse letterbox scale, `metrics.box_map`."""
    import json

    import numpy as np
    import torch

    from ..detect.dataset import _imread
    from ..detect.metrics import box_map
    from ..detect.preprocess import letterbox
    from ..detect.yolox import nms_xyxy

    with open(ann) as f:
        data = json.load(f)
    names = {int(im["id"]): im.get("file_name")
             for im in data.get("images", [])}
    cat_ids = sorted(c["id"] for c in data.get("categories", []))
    class_of = {cid: i for i, cid in enumerate(cat_ids)}
    gt_rows: dict = {}
    for a in data.get("annotations", []):
        if "bbox" not in a or a.get("iscrowd", 0):
            continue
        x, y, w, h = (float(v) for v in a["bbox"])
        if w <= 0 or h <= 0:
            continue
        cls = class_of.get(int(a.get("category_id", 1)), 0)
        gt_rows.setdefault(int(a["image_id"]), []).append(
            [x, y, x + w, y + h, cls])

    model.eval()
    preds, gts = [], []
    for n, (iid, rows) in enumerate(sorted(gt_rows.items())):
        if max_images and n >= max_images:
            break
        name = names.get(iid) or f"{iid:012d}.jpg"
        img = _imread(os.path.join(img_root, name))
        if img is None:
            continue
        inp, r = letterbox(torch.from_numpy(img).to(device), input_hw)
        with torch.no_grad():
            out = model(inp[None])[0].cpu().numpy()
        cls_sc = out[:, 5:]
        ci = cls_sc.argmax(-1)
        sc = out[:, 4] * cls_sc.max(-1)
        m = sc >= conf_thresh
        xy, wh = out[m, :2], out[m, 2:4]
        xyxy = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
        ci, sc = ci[m], sc[m]
        if len(sc):
            # class-aware NMS: offset boxes per class so that only
            # same-class boxes suppress each other.
            keep = nms_xyxy(xyxy + ci[:, None] * 1e5, sc, nms_thresh)
            xyxy, ci, sc = xyxy[keep], ci[keep], sc[keep]
        preds.append({"boxes": xyxy / r, "scores": sc, "classes": ci})
        g = np.asarray(rows, np.float32).reshape(-1, 5)
        gts.append({"boxes": g[:, :4],
                    "classes": g[:, 4].astype(np.int64)})
    return box_map(preds, gts)


def main(argv=None, timer=None):
    """Train; returns the run's steps, per-step losses and seconds (and
    the validation mAPs).  `timer`: as `train_pose.main`'s."""
    args = parse_args(argv)
    import torch

    from ..detect.dataset import CocoDetTrainDataset
    from ..detect.train import (Optimizer, flax_init, init_train_state,
                                lr_schedule, make_yolox_train_step)
    from ..detect.yolox import YOLOX
    from ..parallel.data_parallel import (broadcast_object,
                                          init_data_parallel, rank,
                                          world_size)
    from .train_pose import open_metrics, train_loop

    device, group = init_data_parallel(args.device)
    lead = rank(group) == 0
    if world_size(group) > 1 and lead:
        print(f"data-parallel over {world_size(group)} devices", flush=True)
    hw = tuple(int(v) for v in args.input_size.split("x"))
    ds = CocoDetTrainDataset(args.ann, args.img_root, hw,
                             batch_size=args.batch,
                             max_labels=args.max_labels,
                             seed=args.seed,
                             enable_mixup=not args.no_mixup,
                             rank=rank(group), world=world_size(group))
    if len(ds) == 0:
        raise SystemExit("no full batches: fewer annotated images "
                         f"than --batch {args.batch}")

    model = YOLOX(num_classes=ds.num_classes, depth_mul=args.depth,
                  width_mul=args.width, train_outputs=True)
    flax_init(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    lr = args.basic_lr_per_img * args.batch
    sched = lr_schedule("yoloxwarmcos", lr, iters_per_epoch=len(ds),
                        total_epochs=args.epochs,
                        warmup_epochs=args.warmup_epochs,
                        no_aug_epochs=args.no_aug_epochs,
                        min_lr_ratio=args.min_lr_ratio)
    tx = Optimizer("sgd", sched, list(model.parameters()),
                        weight_decay=args.weight_decay)
    state = init_train_state(model, tx, group=group)
    step_aug = make_yolox_train_step(hw, use_l1=False, group=group)
    step_l1 = make_yolox_train_step(hw, use_l1=True, group=group)

    def per_epoch(epoch):
        no_aug = epoch >= args.epochs - args.no_aug_epochs
        ds.mosaic = not no_aug
        return step_l1 if no_aug else step_aug

    val_maps = []

    def on_epoch(epoch, step, done):
        if args.val_ann and (
                done or epoch == args.epochs - 1
                or (args.eval_interval
                    and (epoch + 1) % args.eval_interval == 0)):
            m = None
            if lead:
                # The EMA net with the inference head, as the reference.
                ema_model = copy.deepcopy(state.model)
                ema_model.load_state_dict(state.ema)
                ema_model.train_outputs = False
                m = evaluate_detection(ema_model, args.val_ann,
                                       args.val_img_root or args.img_root,
                                       hw, device)
                print(f"epoch {epoch} val box mAP(0.50:0.95) {m:.4f}",
                      flush=True)
                open_metrics(args, group).log(epoch=epoch, step=step,
                                              val_box_map=m)
            val_maps.append(broadcast_object(m, group))

    out = train_loop(args, ds, state, step_aug, device, timer,
                     unit="img", log_every=10, per_epoch=per_epoch,
                     on_epoch=on_epoch)
    out["val_box_map"] = val_maps
    return out


if __name__ == "__main__":
    main()
