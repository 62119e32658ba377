"""One rank of a gloo world on the CPU for `tests/test_torch_train_dp.py`.

    python tests/torch_train_dp_worker.py RANK WORLD PORTS IN_DIR OUT_DIR

The parent writes ``IN_DIR/inputs.pt`` (JAX's toy net carried across,
the batches, the workspace's paths) before it starts the ranks.  Every
rank runs the data-parallel pieces on its block of rows
(`mvsmplfitting_tpu_torch.parallel`'s group) and saves what it got to
``OUT_DIR/rank<RANK>.pt``; a world of 2 then runs both training CLIs as
`torchrun` would start them (``env://``), each rank in a directory of
its own.  No JAX here.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
from torch import nn

LR, MOMENTUM, WD = 1e-2, 0.9, 1e-4       # JAX's `test_dp_step_...` step
TOY_N, TOY_HW, TOY_J = 8, (16, 12), 3
YOLOX_N, YOLOX_HW = 4, (64, 64)
YOLOX_BOXES = (3, 1, 0, 5)               # boxes of each image of the batch
HYB_N = 4
POSE_CLI = ["--model", "simplepose", "--deconv", "32,32,32",
            "--input_size", "128x96", "--heatmap_size", "32x24",
            "--batch", "2", "--max_steps", "2", "--optimizer", "sgd",
            "--lr", "0.01"]
YOLOX_CLI = ["--depth", "0.33", "--width", "0.125", "--input_size", "64x64",
             "--batch", "2", "--max_steps", "2"]


class ToyPose(nn.Module):
    """JAX's `_ToyPose` (`tests/test_train.py:478-489`) in the port's
    names: conv-BN-ReLU, a transposed conv, BN, ReLU, a 1x1 head."""

    def __init__(self, num_joints: int = TOY_J):
        super().__init__()
        from mvsmplfitting_tpu_torch.detect.blocks import BaseConv, BatchNorm2d
        self.c1 = BaseConv(3, 8, 3, 2, act="relu")
        self.up = nn.ConvTranspose2d(8, 8, 4, 2, 1)
        self.bn_up = BatchNorm2d(8, eps=1e-5)
        self.final = nn.Conv2d(8, num_joints, 1)

    def forward(self, x):
        return self.final(torch.relu(self.bn_up(self.up(self.c1(x)))))


def toy_state_from_flax(variables) -> dict:
    """JAX's toy tree -> `ToyPose`'s state dict (numpy)."""
    from mvsmplfitting_tpu_torch.detect.weights import _Inverse
    t = _Inverse(variables)
    t.convbn(("c1",), "c1")
    t.deconv(("up",), "up")
    t.sd["up.bias"] = np.asarray(variables["params"]["up"]["bias"])
    t.bn(("bn_up",), "bn_up")
    t.conv(("final",), "final", bias=True)
    return t.sd


def toy_batch(seed: int = 2) -> dict:
    """Images and heatmap targets of the toy step (numpy, NHWC)."""
    from mvsmplfitting_tpu_torch.detect.train import heatmap_targets_np
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (TOY_N, *TOY_HW, 3))
    targets, weights = [], []
    for _ in range(TOY_N):
        t, w = heatmap_targets_np(rng.uniform(0, TOY_HW[1], (TOY_J, 2)),
                                  np.ones(TOY_J), TOY_HW, TOY_HW, sigma=1.0)
        targets.append(np.transpose(t, (1, 2, 0)))
        weights.append(w[:, 0])
    return {"image": img, "target": np.stack(targets).astype(np.float64),
            "target_weight": np.stack(weights).astype(np.float64)}


def yolox_inputs(seed: int = 3) -> dict:
    """A small YOLOX batch whose images hold `YOLOX_BOXES` boxes, and
    decoded outputs with raw regressions for the loss-level check."""
    rng = np.random.default_rng(seed)
    h, w = YOLOX_HW
    labels = np.zeros((YOLOX_N, 6, 5))
    for i, k in enumerate(YOLOX_BOXES):
        wh = rng.uniform(8, 30, (k, 2))
        c = rng.uniform(wh / 2, [w, h] - wh / 2)
        labels[i, :k] = np.concatenate(
            [rng.integers(0, 2, (k, 1)), c, wh], 1)
    A = sum((h // s) * (w // s) for s in (8, 16, 32))
    decoded = np.concatenate([
        rng.uniform(0, w, (YOLOX_N, A, 2)), rng.uniform(6, 34, (YOLOX_N, A, 2)),
        rng.normal(0, 2, (YOLOX_N, A, 3))], -1)
    return {"image": rng.uniform(0, 255, (YOLOX_N, h, w, 3)),
            "labels": labels, "decoded": decoded,
            "origin_reg": rng.normal(0, 1, (YOLOX_N, A, 4))}


def hybrik_inputs(seed: int = 4):
    """HybrIK outputs and targets whose weight mass differs per row: the
    second row has no SMPL weight, the third a sparse uvd mask."""
    rng = np.random.default_rng(seed)
    N = HYB_N
    w29 = (rng.uniform(0, 1, (N, 87)) > 0.3).astype(np.float64)
    w29[2] *= rng.uniform(0, 1, 87) > 0.8
    batch = {"target_uvd_29": rng.uniform(-0.5, 0.5, (N, 87)),
             "target_weight_29": w29,
             "target_beta": rng.normal(0, 1, (N, 10)),
             "target_smpl_weight": np.array([[1.0], [0.0], [1.0], [1.0]]),
             "target_twist": rng.normal(0, 1, (N, 23, 2)),
             "target_twist_weight": (rng.uniform(0, 1, (N, 23, 2)) > 0.5
                                     ).astype(np.float64),
             "target_theta": rng.normal(0, 0.5, (N, 96)),
             "target_theta_weight": np.ones((N, 96))}
    out = {"pred_uvd_jts": rng.uniform(-0.3, 0.3, (N, 29, 3)),
           "pred_shape": rng.normal(0, 0.5, (N, 10)),
           "pred_phi": rng.normal(0, 1, (N, 23, 2)),
           "pred_camera": np.array([0.9, 0.0, 0.0]) + rng.normal(
               0, 0.05, (N, 3))}
    return out, batch


def smpl64():
    """The synthetic SMPL in float64 (integer tables as they are)."""
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    a = synthetic_smpl("smpl", device="cpu")
    kw = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    for k, v in kw.items():
        if torch.is_tensor(v) and v.is_floating_point():
            kw[k] = v.double()
    kw["joint_model"] = None
    return type(a)(**kw)


def bn_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.3, 1.2, (8, 3, 5, 4)), rng.uniform(0.5, 1.5, 3),
            rng.normal(0, 0.1, 3), rng.normal(0, 1, (8, 3, 5, 4)))


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float64).copy())


# ---------------------------------------------------------------------------
# The pieces, each on this rank's rows (group None: one process)

def run_bn(group, rows):
    """A port BatchNorm2d in train mode: output, running statistics and
    the input gradient of sum(y * gy), on this rank's rows."""
    from mvsmplfitting_tpu_torch.detect.blocks import (BatchNorm2d,
                                                       set_batchnorm_group)
    x, w, b, gy = bn_inputs()
    bn = BatchNorm2d(3, eps=1e-5).double()
    with torch.no_grad():
        bn.weight.copy_(t64(w))
        bn.bias.copy_(t64(b))
    set_batchnorm_group(bn, group)
    bn.train()
    xt = t64(x[rows]).requires_grad_(True)
    y = bn(xt)
    (gx,) = torch.autograd.grad((y * t64(gy[rows])).sum(), xt)
    return {"y": y.detach(), "gx": gx, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(),
            "tracked": int(bn.num_batches_tracked)}


def _grab_grads(state):
    """Record the gradients the optimizer is given."""
    got = {}
    inner = state.optimizer.step

    def step(params, grads):
        got["grads"] = [g.detach().clone() for g in grads]
        return inner(params, grads)
    state.optimizer.step = step
    return got


def _step_result(state, loss, aux, got):
    names = [n for n, _ in state.model.named_parameters()]
    return {"loss": loss, "aux": aux,
            "grads": dict(zip(names, got["grads"])),
            "state": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}


def run_toy(toy_sd, group, rows):
    """One SGD step of the toy net (float64) on this rank's rows."""
    from mvsmplfitting_tpu_torch.detect import train as T
    model = ToyPose()
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in toy_sd.items()})
    model = model.double()
    opt = T.Optimizer("sgd", LR, list(model.parameters()),
                      momentum=MOMENTUM, weight_decay=WD)
    state = T.init_train_state(model, opt, group=group)
    got = _grab_grads(state)
    batch = {k: t64(v[rows]) for k, v in toy_batch().items()}
    loss, aux = T.make_pose_train_step(group=group)(state, batch)
    return _step_result(state, loss, aux, got)


def yolox_model():
    from mvsmplfitting_tpu_torch.detect.train import flax_init
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    m = YOLOX(num_classes=2, depth_mul=0.33, width_mul=0.125,
              train_outputs=True)
    return flax_init(m, torch.Generator().manual_seed(5)).double()


def run_yolox(group, rows):
    """One SGD step of a small YOLOX (float64, the L1 branch on) on this
    rank's rows, and the losses of fixed decoded outputs."""
    from mvsmplfitting_tpu_torch.detect import train as T
    from mvsmplfitting_tpu_torch.detect.yolox_loss import yolox_losses
    from mvsmplfitting_tpu_torch.parallel import all_reduce_grads
    inp = yolox_inputs()
    model = yolox_model()
    opt = T.Optimizer("sgd", LR, list(model.parameters()),
                      momentum=MOMENTUM, weight_decay=WD)
    state = T.init_train_state(model, opt, group=group)
    got = _grab_grads(state)
    batch = {"image": t64(inp["image"][rows]),
             "labels": t64(inp["labels"][rows])}
    loss, aux = T.make_yolox_train_step(YOLOX_HW, use_l1=True,
                                        group=group)(state, batch)
    out = _step_result(state, loss, aux, got)
    parts = yolox_losses(t64(inp["decoded"][rows]), t64(inp["labels"][rows]),
                         YOLOX_HW, origin_reg=t64(inp["origin_reg"][rows]),
                         use_l1=True, group=group)
    keys = ("total", "iou", "obj", "cls", "l1")
    summed = all_reduce_grads([parts[k] for k in keys], group)
    out["losses"] = {**dict(zip(keys, summed)),
                     "num_fg": parts["num_fg"], "fg_ratio": parts["fg_ratio"]}
    return out


def run_hybrik(group, rows):
    """`hybrik_smpl_loss` with theta through the IK on this rank's rows:
    the global loss and parts, and the gradient of the rank's share
    with respect to its rows' outputs."""
    from mvsmplfitting_tpu_torch.detect.train import hybrik_smpl_loss
    from mvsmplfitting_tpu_torch.parallel import all_reduce_grads
    out, batch = hybrik_inputs()
    keys = sorted(out)
    tv = [t64(out[k][rows]).requires_grad_(True) for k in keys]
    loss, aux = hybrik_smpl_loss(
        dict(zip(keys, tv)), {k: t64(v[rows]) for k, v in batch.items()},
        assets=smpl64(), group=group)
    grads = torch.autograd.grad(loss, tv)
    names = sorted(aux)
    summed = all_reduce_grads([loss.detach()] + [aux[k].detach()
                                                 for k in names], group)
    return {"loss": summed[0], "aux": dict(zip(names, summed[1:])),
            "grads": {k: g for k, g in zip(keys, grads)}}


class ReadLog:
    """`data.images.read_image` counted, per batch yielded."""

    def __init__(self):
        from mvsmplfitting_tpu_torch.data import images
        self.images, self.inner = images, images.read_image
        self.paths = []

        def read(path):
            self.paths.append(os.path.basename(path))
            return self.inner(path)
        images.read_image = read

    def batches(self, ds, epochs: int = 2):
        """Every batch of `epochs` epochs with the reads made for it."""
        out = []
        for _ in range(epochs):
            for b in ds:
                out.append((b, list(self.paths)))
                self.paths.clear()
        return out

    def close(self):
        self.images.read_image = self.inner


def run_data(ws, rank, world):
    """Both train datasets' batches over two epochs (detection with
    mosaic and without), and this rank's reads per batch."""
    from mvsmplfitting_tpu_torch.detect.dataset import (CocoDetTrainDataset,
                                                        CocoPoseTrainDataset)
    log = ReadLog()
    try:
        pose = log.batches(CocoPoseTrainDataset(
            ws["pose"], ws["img_root"], (64, 48), (16, 12), batch_size=4,
            seed=0, rank=rank, world=world))
        got = {"pose": pose}
        for mosaic in (True, False):
            got[f"det_mosaic{int(mosaic)}"] = log.batches(
                CocoDetTrainDataset(ws["det"], ws["img_root"], (64, 64),
                                    batch_size=4, max_labels=20, seed=0,
                                    mosaic=mosaic, rank=rank, world=world))
    finally:
        log.close()
    return got


def run_clis(ws, rank, world, ports, out_dir):
    """Both CLIs as `torchrun` starts a rank (``env://``), with a relative
    `--out` from a directory of this rank's own; an indivisible batch."""
    import torch.distributed as dist

    from mvsmplfitting_tpu_torch.cli import train_pose, train_yolox
    here = os.path.join(out_dir, f"cwd{rank}")
    os.makedirs(here)
    os.chdir(here)
    got = {}
    for i, (name, main, argv) in enumerate((
            ("pose", train_pose.main, ["--ann", ws["pose"]] + POSE_CLI),
            ("yolox", train_yolox.main, ["--ann", ws["det"]] + YOLOX_CLI))):
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(ports[i]))
        got[name] = main(argv + ["--img_root", ws["img_root"],
                                 "--out", f"out_{name}", "--device", "cpu"])
        if name == "pose":
            bad = list(argv)
            bad[bad.index("--batch") + 1] = "3"
            try:
                main(bad + ["--img_root", ws["img_root"], "--out", "bad",
                            "--device", "cpu"])
            except ValueError as e:
                got["indivisible"] = str(e)
        dist.destroy_process_group()
    got["files"] = sorted(
        os.path.relpath(os.path.join(d, f), here)
        for d, _, fs in os.walk(here) for f in fs)
    return got


def main(rank: int, world: int, ports: str, in_dir: str, out_dir: str):
    """`ports`: three free ports, "a,b,c" (the world, then each CLI's)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mvsmplfitting_tpu_torch import parallel as P
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"), weights_only=False)
    ports = [int(p) for p in ports.split(",")]
    P.init_distributed(f"localhost:{ports[0]}", world, rank, device="cpu")
    group = dist.group.WORLD
    rows = P.batch_rows(TOY_N, group)
    got = {"rows": (rows.start, rows.stop),
           "bn": run_bn(group, rows),
           "toy": run_toy(inputs["toy_sd"], group, rows),
           "yolox": run_yolox(group, P.batch_rows(YOLOX_N, group)),
           "hybrik": run_hybrik(group, P.batch_rows(HYB_N, group)),
           "data": run_data(inputs["ws"], rank, world)}
    dist.destroy_process_group()
    if world == 2:
        got["cli"] = run_clis(inputs["ws"], rank, world, ports[1:], out_dir)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
