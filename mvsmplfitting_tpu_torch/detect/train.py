"""Training of the detection and pose nets (port of `detect/train.py`).

The same scaffolding as JAX's, over an `nn.Module` and its tensors:

- EMA of every float tensor of the state dict, parameters and BatchNorm
  buffers (`yolox/utils/ema.py:29-69`: decay ramped as ``decay * (1 -
  exp(-updates / 2000))``); `num_batches_tracked` is not averaged.
- LR schedules (`yolox/utils/lr_scheduler.py:97-150`): `cos`, `warmcos`,
  `yoloxwarmcos` and AlphaPose's epoch-milestone `multistep`, evaluated
  in float32 as JAX's jnp expressions are.
- Optimizers with optax 0.2.6's equations (`fitting/gradient.py`'s
  `_update`, shared with the fitting solvers): adam (float32 bias
  correction), rmsprop (decay 0.9, eps inside the root), sgd (Nesterov
  trace) with weight decay added to the gradient of tensors of ndim >= 2
  first, as `optax.masked(add_decayed_weights)` chained before `sgd`.
  Step n (from 0) takes ``lr(n)``, as optax's ``count``.
- Heatmap targets (host numpy, AlphaPose's `_target_generator`), the
  masked MSE criterion, and integral regression (`L1JointRegression`)
  with the reference's +-2 surrogate backward as a
  `torch.autograd.Function`.
- One train step: a forward in train mode (BatchNorm on the batch's
  statistics, flax's running-average update: `blocks.BatchNorm2d`),
  autograd, the optimizer, the EMA.  Batches keep JAX's layouts (NHWC
  images and heatmap targets); the step hands the nets NCHW.
- Checkpoints: `.npz` files keyed by the reference's state-dict names
  (`detect/weights.py`), not by flax `keystr` paths as JAX's are.
- Initial weights drawn as flax's defaults (`flax_init`).
- Data parallelism (JAX's ``("batch",)`` mesh, under which XLA runs the
  one-device step on the global batch): with a process group every rank
  runs the step on its block of rows (`parallel.batch_rows`), with
  BatchNorm statistics over the global batch (`blocks.
  set_batchnorm_group`), losses that are the rank's share of the global
  loss (their batch normalizers summed over the ranks:
  `parallel.global_sum`), and the ranks' gradients summed in one flat
  buffer (`parallel.all_reduce_grads`).  Every rank ends the step with
  the same parameters, optimizer state, statistics and EMA, and returns
  the global loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..fitting.gradient import GradientOptions, _update
from ..parallel.data_parallel import (all_reduce_grads, broadcast_state,
                                      global_sum, world_size)
from .yolox_loss import yolox_losses


# ---------------------------------------------------------------------------
# EMA (`yolox/utils/ema.py:29-69`)

def ema_decay(updates, base_decay: float = 0.9999) -> torch.Tensor:
    """Ramped decay ``d = decay * (1 - exp(-updates / 2000))`` in float32."""
    u = torch.as_tensor(updates, dtype=torch.float32)
    return base_decay * (1.0 - torch.exp(-u / 2000.0))


def ema_update(ema: Dict[str, torch.Tensor],
               new: Mapping[str, torch.Tensor], updates,
               base_decay: float = 0.9999) -> None:
    """One EMA step, in place, over every float tensor of `ema`;
    integer state (`num_batches_tracked`) is left as it is (`ema.py:66`)."""
    d = ema_decay(updates, base_decay)
    for k, e in ema.items():
        if e.is_floating_point():
            dk = d.to(e.device)
            e.copy_(dk * e + (1.0 - dk) * new[k].detach())


# ---------------------------------------------------------------------------
# LR schedules (`yolox/utils/lr_scheduler.py:97-150`), float32 as JAX's

def _it(iters) -> torch.Tensor:
    return torch.as_tensor(iters, dtype=torch.int32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cos rounded from float64: torch's float32 CPU cos is off by
    an ulp where XLA's is not, and 1 + cos cancels near the schedule's
    end."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def cos_lr(lr: float, total_iters: int, iters) -> torch.Tensor:
    it = _it(iters)
    return lr * 0.5 * (1.0 + _cos(math.pi * it / total_iters))


def warm_cos_lr(lr: float, total_iters: int, warmup_total_iters: int,
                warmup_lr_start: float, iters) -> torch.Tensor:
    it = _it(iters)
    warm = ((lr - warmup_lr_start) * it / float(warmup_total_iters)
            + warmup_lr_start)
    cos = lr * 0.5 * (1.0 + _cos(
        math.pi * (it - warmup_total_iters)
        / (total_iters - warmup_total_iters)))
    return torch.where(it <= warmup_total_iters, warm, cos)


def yolox_warm_cos_lr(lr: float, min_lr_ratio: float, total_iters: int,
                      warmup_total_iters: int, warmup_lr_start: float,
                      no_aug_iter: int, iters) -> torch.Tensor:
    """Quadratic warmup -> cosine -> flat ``min_lr`` tail."""
    it = _it(iters)
    min_lr = lr * min_lr_ratio
    warm = ((lr - warmup_lr_start)
            * (it / float(warmup_total_iters)) ** 2 + warmup_lr_start)
    cos = min_lr + 0.5 * (lr - min_lr) * (1.0 + _cos(
        math.pi * (it - warmup_total_iters)
        / (total_iters - warmup_total_iters - no_aug_iter)))
    out = torch.where(it <= warmup_total_iters, warm, cos)
    return torch.where(it >= total_iters - no_aug_iter,
                       torch.tensor(min_lr, dtype=torch.float32), out)


def multistep_lr(lr: float, milestones: Sequence[int], factor: float,
                 iters) -> torch.Tensor:
    """AlphaPose epoch-step decay: ``lr * factor**(#milestones passed)``."""
    ms = torch.as_tensor(list(milestones), dtype=torch.int32)
    n = (_it(iters)[..., None] >= ms).sum(-1).to(torch.float32)
    return lr * torch.pow(torch.tensor(factor, dtype=torch.float32), n)


def lr_schedule(name: str, lr: float, iters_per_epoch: int,
                total_epochs: int, *, warmup_epochs: int = 5,
                warmup_lr_start: Optional[float] = None,
                no_aug_epochs: int = 15, min_lr_ratio: float = 0.2,
                milestones: Sequence[int] = (50, 70),
                factor: float = 0.1) -> Callable[[Any], torch.Tensor]:
    """Schedule factory (`LRScheduler._get_lr_func`,
    `lr_scheduler.py:36-95`): ``iters -> lr`` (a float32 tensor)."""
    total = iters_per_epoch * total_epochs
    if name == "cos":
        return lambda it: cos_lr(lr, total, it)
    if name == "warmcos":
        start = 1e-6 if warmup_lr_start is None else warmup_lr_start
        return lambda it: warm_cos_lr(
            lr, total, iters_per_epoch * warmup_epochs, start, it)
    if name == "yoloxwarmcos":
        start = 0.0 if warmup_lr_start is None else warmup_lr_start
        return lambda it: yolox_warm_cos_lr(
            lr, min_lr_ratio, total, iters_per_epoch * warmup_epochs,
            start, iters_per_epoch * no_aug_epochs, it)
    if name == "multistep":
        ms = [m * iters_per_epoch for m in milestones]
        return lambda it: multistep_lr(lr, ms, factor, it)
    raise ValueError(f"unknown lr schedule {name!r}")


# ---------------------------------------------------------------------------
# Optimizers (optax's equations)

class Optimizer:
    """'sgd' (YOLOX: momentum 0.9, Nesterov, weight decay on tensors of
    ndim >= 2 only, the torch param-group split), 'adam' (AlphaPose's
    default) or 'rmsprop' over a list of parameters; `learning_rate` is
    a float or a schedule of the step count (0 first)."""

    def __init__(self, name: str, learning_rate, params: Sequence[
            torch.Tensor], *, momentum: float = 0.9,
                 weight_decay: float = 5e-4, nesterov: bool = True):
        if name not in ("sgd", "adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _c, lr=learning_rate: lr))
        # lr 1 in the shared update; the schedule's lr multiplies after.
        if name == "sgd":
            self.opts = GradientOptions(optim_type="sgd", lr=1.0,
                                        momentum=momentum,
                                        use_nesterov=nesterov)
            keys = ("trace",)
        elif name == "adam":
            self.opts = GradientOptions(optim_type="adam", lr=1.0)
            keys = ("mu", "nu")
        else:       # optax.rmsprop: decay 0.9, eps 1e-8, no momentum
            self.opts = GradientOptions(optim_type="rmsprop", lr=1.0,
                                        rmsprop_alpha=0.9, momentum=0.0)
            keys = ("nu", "trace")
        self.weight_decay = weight_decay if name == "sgd" else 0.0
        self.state = [{k: torch.zeros_like(p) for k in keys}
                      for p in params]
        self.count = 0

    def lr(self, count: Optional[int] = None) -> float:
        c = self.count if count is None else count
        return float(self.schedule(c))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        lr = self.lr()
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.weight_decay and p.ndim >= 2:
                g = g + self.weight_decay * p
            u, st = _update(self.opts, g, self.state[i], self.count + 1)
            self.state[i] = {k: st[k] for k in self.state[i]}
            p.add_(u * lr)
        self.count += 1


# ---------------------------------------------------------------------------
# Initial weights (flax's defaults)

def flax_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights drawn as flax's defaults, in place: conv, transposed
    conv and dense kernels lecun-normal (truncated at 2 sigma, variance
    1/fan_in with fan_in = kernel area x input features, as flax counts
    it), biases 0, BatchNorm scale 1 and offset 0, running mean 0 and
    variance 1.  `torch.nn`'s kaiming-uniform default has a third of
    that variance.  The draws are not flax's: tests carry JAX's tree
    across with `weights.*_state_from_flax`."""
    g = generator
    std_of_unit_trunc = 0.87962566103423978   # std of N(0,1) cut at +-2
    with torch.no_grad():
        for mod in model.modules():
            w = getattr(mod, "weight", None)
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.zero_()
                continue
            if not isinstance(w, nn.Parameter) or w.ndim < 2:
                continue
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            std = (1.0 / fan_in) ** 0.5 / std_of_unit_trunc
            t = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            w.copy_(t * std)
            b = getattr(mod, "bias", None)
            if isinstance(b, nn.Parameter):
                b.zero_()
    return model


# ---------------------------------------------------------------------------
# Heatmap targets + criterion (AlphaPose)

def heatmap_targets_np(joints_xy, joints_vis, heatmap_hw, input_hw,
                       sigma: float = 2.0):
    """Gaussian heatmap targets on the host (`simple_transform.py:
    126-164`): target (J, H, W) and target_weight (J, 1), the truncating
    ``int(x/stride + 0.5)`` centre and the out-of-window weight-zero
    rule; the same numpy as JAX's `heatmap_targets_np`."""
    H, W = heatmap_hw
    stride_x = input_hw[1] / W
    stride_y = input_hw[0] / H
    tmp = int(sigma * 3)
    joints_xy = np.asarray(joints_xy, np.float32)
    joints_vis = np.asarray(joints_vis, np.float32)

    mu_x = np.trunc(joints_xy[:, 0] / stride_x + 0.5)
    mu_y = np.trunc(joints_xy[:, 1] / stride_y + 0.5)
    ul_x, ul_y = mu_x - tmp, mu_y - tmp
    br_x, br_y = mu_x + tmp + 1, mu_y + tmp + 1
    oob = (ul_x >= W) | (ul_y >= H) | (br_x < 0) | (br_y < 0)
    w = np.where(oob, 0.0, joints_vis).astype(np.float32)

    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)
    gx = np.exp(-((xs[None, :] - mu_x[:, None]) ** 2)
                / (2.0 * sigma ** 2))
    gy = np.exp(-((ys[None, :] - mu_y[:, None]) ** 2)
                / (2.0 * sigma ** 2))
    in_x = (xs[None, :] >= ul_x[:, None]) & (xs[None, :] < br_x[:, None])
    in_y = (ys[None, :] >= ul_y[:, None]) & (ys[None, :] < br_y[:, None])
    g = (gy * in_y)[:, :, None] * (gx * in_x)[:, None, :]
    target = np.where((w > 0.5)[:, None, None], g, 0.0
                      ).astype(np.float32)
    return target, w[:, None]


def integral_targets_np(joints_xy, joints_vis, input_hw):
    """``_integral_target_generator`` (`simple_transform.py:165-182`):
    ``x/w - 0.5, y/h - 0.5`` interleaved per joint, visibility
    duplicated per coordinate."""
    joints_xy = np.asarray(joints_xy, np.float32)
    t = np.stack([joints_xy[:, 0] / input_hw[1] - 0.5,
                  joints_xy[:, 1] / input_hw[0] - 0.5], axis=-1)
    w = np.repeat(np.asarray(joints_vis, np.float32)[:, None], 2,
                  axis=1)
    return t.reshape(-1), w.reshape(-1)


def pose_heatmap_loss(pred: torch.Tensor, target: torch.Tensor,
                      target_weight: torch.Tensor, group=None
                      ) -> torch.Tensor:
    """``0.5 * MSELoss(pred * mask, target * mask)``, the mean over all
    elements.  pred/target: (N, J, H, W); target_weight: (N, J).  With a
    process group, this rank's share of the global batch's mean (the
    ranks hold equal blocks)."""
    m = target_weight[:, :, None, None]
    if group is None:
        return 0.5 * torch.mean((pred * m - target * m) ** 2)
    d = pred * m - target * m
    return 0.5 * torch.sum(d ** 2) / (d.numel() * world_size(group))


class _IntegralMul(torch.autograd.Function):
    """``p * arange(L)`` whose backward is the reference's SURROGATE
    (`IngetralCoordinate`, `criterion.py:13-44`): ``g * 2 * mask``, mask
    -1 for bins left of the expected coordinate and +1 at or right of
    it (+1 everywhere when the coordinate passes the axis's length)."""

    @staticmethod
    def forward(ctx, p):
        out = p * torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        ctx.save_for_backward(out.sum(-1, keepdim=True))
        return out

    @staticmethod
    def backward(ctx, g):
        (coord,) = ctx.saved_tensors
        L = g.shape[-1]
        w = torch.arange(L, dtype=g.dtype, device=g.device)
        mask = torch.where(w < coord, -1.0, 1.0)
        mask = torch.where(coord > L, 1.0, mask)
        return g * mask * 2.0


def integral_coords(hms: torch.Tensor, num_joints: int,
                    norm_type: str = "softmax", output_3d: bool = False):
    """`_integral_tensor` (`transforms.py:651-689`) over (N, C, H, W)
    heatmaps, C = J (2D) or J*D: per-joint softmax (or sigmoid then
    sum-normalized), marginal expectations through the surrogate
    multiply, coords in [-0.5, 0.5] interleaved per joint.  Returns
    (coords (N, J*dims), scores (N, J, 1))."""
    N, C, H, W = hms.shape
    J = num_joints
    D = C // J if output_3d else 1
    flat = hms.reshape(N, J, -1)
    if norm_type == "softmax":
        norm = torch.softmax(flat, dim=-1)
        scores = torch.ones((N, J, 1), dtype=hms.dtype, device=hms.device)
    else:
        norm = torch.sigmoid(flat)
        scores = norm.amax(dim=-1, keepdim=True)
    p = norm / torch.clamp_min(norm.sum(-1, keepdim=True), 1e-12)
    vol = p.reshape(N, J, D, H, W)
    mul = _IntegralMul.apply
    cx = mul(vol.sum((2, 3))).sum(-1, keepdim=True) / W - 0.5
    cy = mul(vol.sum((2, 4))).sum(-1, keepdim=True) / H - 0.5
    if output_3d:
        cz = mul(vol.sum((3, 4))).sum(-1, keepdim=True) / D - 0.5
        jts = torch.cat([cx, cy, cz], dim=-1)
    else:
        jts = torch.cat([cx, cy], dim=-1)
    return jts.reshape(N, -1), scores


def integral_l1_loss(pred_hms: torch.Tensor, target: torch.Tensor,
                     target_weight: torch.Tensor,
                     norm_type: str = "softmax", output_3d: bool = False,
                     size_average: bool = True, group=None) -> torch.Tensor:
    """``weighted_l1_loss`` (`criterion.py:85-97`): masked |pred - gt|
    summed, / N when size_average; target/target_weight (N, J*dims).
    With a process group, this rank's share (N: the global batch)."""
    dims = 3 if output_3d else 2
    J = target.shape[-1] // dims
    jts, _ = integral_coords(pred_hms, J, norm_type, output_3d)
    total = (torch.abs(jts - target) * target_weight).sum()
    n = pred_hms.shape[0] * world_size(group)
    return total / n if size_average else total


# ---------------------------------------------------------------------------
# Train state + steps

@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema: Dict[str, torch.Tensor]      # the state dict's names
    step: int = 0
    group: Any = None                 # the data-parallel process group


def init_train_state(model: nn.Module, optimizer: Optimizer,
                     group=None) -> TrainState:
    """The state of step 0.  With a process group, rank 0's parameters
    and buffers go to every rank first (so that no seed or device
    difference splits the ranks), and the model's BatchNorms take their
    statistics over the group."""
    from .blocks import set_batchnorm_group
    if group is not None:
        broadcast_state(model, group)
        set_batchnorm_group(model, group)
    ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return TrainState(model, optimizer, ema, 0, group)


def nchw(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) batch images -> (N, C, H, W), contiguous."""
    return images.permute(0, 3, 1, 2).contiguous()


def make_train_step(loss_fn: Callable, ema_base_decay: float = 0.9999,
                    group=None, global_aux: Sequence[str] = ()) -> Callable:
    """``step(state, batch) -> (loss, aux)``: one forward of
    ``state.model`` in train mode on ``nchw(batch['image'])``,
    ``loss_fn(outputs, batch)`` -> scalar or (scalar, aux dict), the
    gradient of every parameter, the optimizer, then the EMA over the new
    parameters and BatchNorm statistics (updates = the new step count).

    With a process group (`init_train_state`'s), `batch` is this rank's
    block of the global batch and `loss_fn` returns this rank's share of
    the global loss and of each aux entry, but for those named in
    `global_aux`, which it computes over the ranks itself.  The ranks'
    gradients, loss and aux shares are then summed in one all_reduce, so
    the step returns the global loss and aux on every rank."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.group is not group:
            raise ValueError("the train state and the step were made for "
                             "different process groups")
        model = state.model
        model.train()
        out = model(nchw(batch["image"]))
        res = loss_fn(out, batch)
        loss, aux = res if isinstance(res, tuple) else (res, {})
        params = [p for p in model.parameters()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if group is not None:
            shares = [k for k, v in aux.items()
                      if torch.is_tensor(v) and k not in global_aux]
            summed = all_reduce_grads(
                grads + [loss.detach().to(grads[0].dtype)]
                + [aux[k].detach().to(grads[0].dtype) for k in shares],
                group)
            n = len(grads)
            grads, loss = summed[:n], summed[n]
            aux = {**aux, **dict(zip(shares, summed[n + 1:]))}
        state.optimizer.step(params, grads)
        state.step += 1
        with torch.no_grad():
            ema_update(state.ema, model.state_dict(), state.step,
                       ema_base_decay)
        return loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                               for k, v in aux.items()}
    return step


def make_pose_train_step(group=None, **kw) -> Callable:
    """Heatmap-MSE step (batch: 'image' (N, h, w, 3), 'target' (N, H, W,
    J), 'target_weight' (N, J))."""
    def loss_fn(out, batch):
        return pose_heatmap_loss(out, nchw(batch["target"]),
                                 batch["target_weight"], group=group)
    return make_train_step(loss_fn, group=group, **kw)


def make_integral_train_step(norm_type: str = "softmax",
                             output_3d: bool = False, group=None,
                             **kw) -> Callable:
    """L1JointRegression step (batch: 'image', 'target' (N, J*dims),
    'target_weight' (N, J*dims))."""
    def loss_fn(out, batch):
        return integral_l1_loss(out, batch["target"],
                                batch["target_weight"],
                                norm_type=norm_type, output_3d=output_3d,
                                group=group)
    return make_train_step(loss_fn, group=group, **kw)


def make_yolox_train_step(input_hw, use_l1: bool = False, group=None,
                          **kw) -> Callable:
    """SimOTA step (batch: 'image' (N, h, w, 3), 'labels' (N, MAXG, 5));
    the model has ``train_outputs`` set."""
    def loss_fn(out, batch):
        decoded, origin_reg = out
        losses = yolox_losses(decoded, batch["labels"], input_hw,
                              origin_reg=origin_reg, use_l1=use_l1,
                              group=group)
        return losses["total"], losses
    return make_train_step(loss_fn, group=group,
                           global_aux=("fg_ratio", "num_fg"), **kw)


def hybrik_smpl_loss(out, batch, assets=None, depth_factor: float = 2.0,
                     w_uvd: float = 1.0, w_beta: float = 1.0,
                     w_twist: float = 0.01, w_theta: float = 0.01,
                     group=None):
    """HybrIK SMPL criterion over the `3d_data_w_smpl` targets
    (`augment3d.hybrik_train_sample`): weighted L1 on the 29-joint
    integral uvd, on beta (gated by smpl_weight), on the 23 (cos, sin)
    twists, and with SMPL ``assets`` on the 24 joint quaternions of the
    analytic IK (`models/hybrik.py`) run on the predicted skeleton, each
    in the target's hemisphere.  Weighted terms divide by the live
    weight mass (at least 1).  With a process group the masses are the
    global batch's (one all_reduce) and every term is this rank's share."""
    from .hybrik import uvd_to_xyz

    N = out["pred_uvd_jts"].shape[0]
    weights = [batch["target_weight_29"], batch["target_smpl_weight"],
               batch["target_twist_weight"]]
    if assets is not None:
        weights.append(batch["target_theta_weight"]
                       * batch["target_smpl_weight"])
    masses = global_sum(torch.stack([torch.sum(w) for w in weights]),
                        group)

    def wl1(pred, target, i):
        return (torch.sum(torch.abs(pred - target) * weights[i])
                / torch.clamp_min(masses[i], 1.0))

    l_uvd = wl1(out["pred_uvd_jts"].reshape(N, -1),
                batch["target_uvd_29"], 0)
    l_beta = wl1(out["pred_shape"], batch["target_beta"], 1)
    l_twist = wl1(out["pred_phi"], batch["target_twist"], 2)
    total = w_uvd * l_uvd + w_beta * l_beta + w_twist * l_twist
    aux = {"loss_uvd": l_uvd, "loss_beta": l_beta, "loss_twist": l_twist}

    if assets is not None:
        from ..models.hybrik import hybrik_ik
        from ..ops.rotations import matrix_to_quaternion

        xyz, _ = uvd_to_xyz(out["pred_uvd_jts"], out["pred_camera"],
                            depth_factor=depth_factor)
        skel = xyz[:, :24] * depth_factor               # metres
        rots = hybrik_ik(assets, skel, out["pred_shape"], out["pred_phi"])
        quat = matrix_to_quaternion(rots).reshape(N, 24, 4)
        tgt = batch["target_theta"]
        # q and -q are the same rotation: compare in the target's
        # hemisphere per joint.
        sign = torch.sign(torch.sum(quat * tgt.reshape(N, 24, 4), dim=-1,
                                    keepdim=True))
        quat = (quat * torch.where(sign == 0, 1.0, sign)).reshape(N, 96)
        l_theta = wl1(quat, tgt, 3)
        total = total + w_theta * l_theta
        aux["loss_theta"] = l_theta
    return total, aux


def make_hybrik_train_step(assets=None, depth_factor: float = 2.0,
                           group=None, **kw) -> Callable:
    """HybrIK step (batch: stacked `hybrik_train_sample` dicts, 'image'
    (N, h, w, 3)); SMPL ``assets`` add theta-through-IK supervision."""
    def loss_fn(out, batch):
        return hybrik_smpl_loss(out, batch, assets=assets,
                                depth_factor=depth_factor, group=group)
    return make_train_step(loss_fn, group=group, **kw)


# ---------------------------------------------------------------------------
# Checkpoints (`yolox/utils/checkpoint.py` surface)

def save_checkpoint(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """An .npz of a state dict, keyed by its (the reference's) names."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An .npz written by `save_checkpoint` as CPU tensors."""
    with np.load(path, allow_pickle=False) as data:
        return {k: torch.from_numpy(data[k].copy()) for k in data.files}


def batch_to(batch: Mapping[str, np.ndarray], device) -> Dict[
        str, torch.Tensor]:
    """A host batch of numpy arrays as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}

