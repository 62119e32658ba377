"""Staged annealing fit over a batch of frames (port of
`fitting/stages.py`).

The reference's 4 weight stages (`cfg_files/fit_smpl.yaml:40-59`) run in
order on the same parameter vector.  Each is one batched solve: `lm_fit`
(the primary solver), the strong-Wolfe L-BFGS parity solver
(`lbfgs_fit`) or a first-order one (`gradient_fit`); with
`FitConfig.fused` the LM stages run in one loop (`lm_fit_staged`) where
each frame moves to the next stage on its own.  The L-BFGS and
first-order solvers minimize `total_energy`, with the gradient from one
reverse pass over the frames' energies summed (the frames are
independent, so this is JAX's per-frame `value_and_grad`).  In sequence
mode (`is_seq`) a frame after the first skips stages 0-1.

A stage with the collision term on takes the AD Jacobian, as in JAX
(`stages.py:116-117`).  The voxelizer is a ctypes kernel on the card and
cannot take the wrapped tensors of a `torch.func` transform, so the
stage's Jacobian voxelizes each frame's body at x first and then
differentiates the residuals with those grids held fixed.  phi carries
no derivative, so this is JAX's linearization exactly; the residual
function itself voxelizes at its own argument.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..models.camera import Camera
from ..models.smpl import SMPLAssets, SMPLParams
from ..models.vposer import VPoserWeights
from . import energy as E
from .energy import EnergySpec, Observations, StageWeights
from .gradient import GradientOptions, gradient_fit
from .lbfgs import LBFGSOptions, lbfgs_fit
from .lm import LMOptions, ad_jacobian, lm_fit, lm_fit_staged, stack_stages

# Demo schedule: per-stage (body_pose_weight, shape_weight,
# coll_loss_weight); data weight 500 / image_height for every stage and
# bending = 3.17 * pose.
DEFAULT_POSE_WEIGHTS = (404.0, 404.0, 57.4, 4.78)
DEFAULT_SHAPE_WEIGHTS = (100.0, 50.0, 10.0, 5.0)
DEFAULT_COLL_WEIGHTS = (0.0, 0.0, 1000.0, 4500.0)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    spec: EnergySpec = EnergySpec()
    solver: str = "lm"
    pose_weights: Tuple[float, ...] = DEFAULT_POSE_WEIGHTS
    shape_weights: Tuple[float, ...] = DEFAULT_SHAPE_WEIGHTS
    coll_weights: Tuple[float, ...] = DEFAULT_COLL_WEIGHTS
    lm: LMOptions = LMOptions()
    lbfgs: LBFGSOptions = LBFGSOptions()
    grad: GradientOptions = GradientOptions()
    # All stages in one LM loop (`lm_fit_staged`); the same math as the
    # stage-by-stage loops (JAX `stages.py:66-71`).  Off by default, as
    # in JAX; it falls back to the stage loops where stages mix collision
    # on and off, and is LM only.
    fused: bool = False
    # Sequence mode: non-start frames skip stages 0-1 and run stage 2 at
    # 0.15x the pose weight (`non_linear_solver.py:156-162`).
    is_seq: bool = False


@dataclasses.dataclass
class FitResult:
    params: SMPLParams
    z: torch.Tensor             # (B, 32) pose embedding (zeros w/o VPoser)
    body_pose: torch.Tensor     # (B, 69) decoded / direct body pose
    loss: torch.Tensor          # (B,) final energy
    stage_losses: torch.Tensor  # (B, num_stages)
    # (B, num_stages) the solver's iterations per stage, whichever solver
    # ran it: LM iterations, L-BFGS iterations or first-order steps.
    lm_iters: torch.Tensor


def frame_heights(img_height, x: torch.Tensor) -> torch.Tensor:
    """The image height per frame (B,) of x (B, n), from a scalar or (B,)."""
    h = torch.as_tensor(img_height, dtype=torch.float32, device=x.device)
    return h.expand(x.shape[0]) if h.dim() == 0 else h


def default_stages(cfg: FitConfig, img_height: torch.Tensor,
                   seq_start: bool = True) -> Sequence[StageWeights]:
    """Per-stage weights; img_height (B,) gives the per-frame data weight.
    In sequence mode a frame after the first (``seq_start=False``) skips
    stages 0-1 and runs stage 2 at 0.15x the pose weight."""
    data_w = 500.0 / img_height.to(torch.float32)
    stages = []
    for i, (pw, sw, cw) in enumerate(zip(cfg.pose_weights,
                                         cfg.shape_weights,
                                         cfg.coll_weights)):
        if cfg.is_seq and not seq_start:
            if i < 2:
                continue
            if i == 2:
                pw = pw * 0.15
        stages.append(StageWeights.make(data=data_w, pose=pw, shape=sw,
                                        coll=cw, device=img_height.device))
    return stages


def stage_jacobian(cfg: FitConfig, assets: SMPLAssets, cam: Camera,
                   obs: Observations, weights: StageWeights,
                   vposer_w: Optional[VPoserWeights], gmm
                   ) -> Optional[Callable]:
    """The stage's x -> (r, J), or None for forward-mode AD of the
    residuals: with the collision term on, AD with each frame's grids
    voxelized at x and held fixed; else the closed form where it covers
    the energy."""
    spec = cfg.spec
    if spec.interpenetration and weights.coll_on:
        def jac_fn(xv):
            grids = E.collision_grids(spec, assets, vposer_w, xv)
            return ad_jacobian(
                lambda v: E.residuals(spec, assets, cam, obs, weights,
                                      vposer_w, gmm, v, grids=grids), xv)
        return jac_fn
    if cfg.lm.jac == "analytic" and E.analytic_jac_ok(spec, assets):
        def jac_fn(xv):
            return E.residual_jacobian(spec, assets, cam, obs, weights,
                                       vposer_w, gmm, xv)
        return jac_fn
    return None


def run_stage(cfg: FitConfig, assets: SMPLAssets, cam: Camera,
              obs: Observations, weights: StageWeights,
              vposer_w: Optional[VPoserWeights], gmm, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing stage from x; returns (x_new, energy, the solver's
    iterations) per frame."""
    spec = cfg.spec
    mask = E.free_mask(spec, x.device)

    if cfg.solver == "lm":
        def res_fn(xv):
            return E.residuals(spec, assets, cam, obs, weights, vposer_w,
                               gmm, xv)

        jac_fn = stage_jacobian(cfg, assets, cam, obs, weights, vposer_w,
                                gmm)
        x_new, _, iters = lm_fit(res_fn, x, mask, cfg.lm, jac_fn=jac_fn)
        # The scalar energy (with non-LSQ constants such as the GMM's
        # -log w offset), comparable across solvers.
        loss = E.total_energy(spec, assets, cam, obs, weights, vposer_w,
                              gmm, x_new)
        return x_new, loss, iters

    def fg(xv):
        xv = xv.detach().requires_grad_(True)
        with torch.enable_grad():
            e = E.total_energy(spec, assets, cam, obs, weights, vposer_w,
                               gmm, xv)
            (g,) = torch.autograd.grad(e.sum(), xv)
        return e.detach(), g

    if cfg.solver in ("adam", "rmsprop", "sgd"):
        opts = dataclasses.replace(cfg.grad, optim_type=cfg.solver)
        return gradient_fit(fg, x, mask, opts)
    if cfg.solver in ("lbfgs", "lbfgsls"):
        x_new, loss, iters, _ = lbfgs_fit(fg, x, mask, cfg.lbfgs)
        return x_new, loss, iters
    raise ValueError(f"unknown solver {cfg.solver!r}")


def _fit_fused(cfg: FitConfig, assets: SMPLAssets, cam: Camera,
               obs: Observations, stages: Sequence[StageWeights],
               vposer_w: Optional[VPoserWeights], gmm, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All stages in one `lm_fit_staged` loop (JAX `stages.py:171-185`);
    returns (x, stage losses (B, S), LM iterations (B, S)).  Each stage's
    Jacobian is `stage_jacobian`'s at the frame's weights: closed form
    only when no stage has the collision term on."""
    spec = cfg.spec

    def res(xv, w):
        return E.residuals(spec, assets, cam, obs, w, vposer_w, gmm, xv)

    def jac_fn(xv, w):
        f = stage_jacobian(cfg, assets, cam, obs, w, vposer_w, gmm)
        return f(xv) if f is not None else ad_jacobian(
            lambda v: res(v, w), xv)

    x, losses, iters = lm_fit_staged(res, x, E.free_mask(spec, x.device),
                                     stack_stages(stages), len(stages),
                                     cfg.lm, jac_fn=jac_fn)
    # The last stage reports the scalar energy, as the stage loops do.
    losses[:, -1] = E.total_energy(spec, assets, cam, obs, stages[-1],
                                   vposer_w, gmm, x)
    return x, losses, iters


def fit_frame(cfg: FitConfig, assets: SMPLAssets, cam: Camera,
              obs: Observations, init_params: SMPLParams,
              init_z: torch.Tensor,
              vposer_w: Optional[VPoserWeights] = None, gmm=None,
              img_height=1080.0, seq_start: bool = True) -> FitResult:
    """Fit a batch of frames through the full annealing schedule (the
    sequence schedule for ``seq_start=False`` under `FitConfig.is_seq`)."""
    spec = cfg.spec
    x = E.pack(spec, init_params, init_z if spec.use_vposer else None)
    B = x.shape[0]
    stages = default_stages(cfg, frame_heights(img_height, x), seq_start)
    # With the collision term off, coll_on is dead and must not block
    # fusing (JAX `stages.py:161-170`).
    use_fused = (cfg.fused and cfg.solver == "lm"
                 and (not spec.interpenetration
                      or len({w.coll_on for w in stages}) == 1))
    if use_fused:
        if not spec.interpenetration:
            stages = [dataclasses.replace(w, coll_on=False) for w in stages]
        x, stage_losses, lm_iters = _fit_fused(cfg, assets, cam, obs, stages,
                                               vposer_w, gmm, x)
    else:
        losses: List[torch.Tensor] = []
        iters: List[torch.Tensor] = []
        for weights in stages:
            x, loss, it = run_stage(cfg, assets, cam, obs, weights, vposer_w,
                                    gmm, x)
            losses.append(loss)
            iters.append(it)
        stage_losses = torch.stack(losses, 1)
        lm_iters = torch.stack(iters, 1)

    params, z = E.unpack(spec, x)
    if spec.use_vposer:
        from ..models import vposer as vposer_lib
        body_pose = vposer_lib.decode(vposer_w, z)
    else:
        body_pose = params.body_pose
        z = torch.zeros((B, E.LATENT_DIM), dtype=x.dtype, device=x.device)
    return FitResult(params=params, z=z, body_pose=body_pose,
                     loss=stage_losses[:, -1], stage_losses=stage_losses,
                     lm_iters=lm_iters)
