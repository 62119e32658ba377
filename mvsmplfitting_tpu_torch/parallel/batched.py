"""Frame-batched fitting on one card (port of `parallel/batched.py`
without a mesh): frames are the batch dimension of every tensor.

This is the slice's public entry point.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike, resolve_device
from ..fitting.energy import Observations
from ..fitting.initialize import init_guess
from ..fitting.stages import FitConfig, FitResult, fit_frame
from ..models.camera import Camera


@dataclasses.dataclass
class BatchedFitInputs:
    """Stacked per-frame inputs (leading axis = frames)."""

    obs: Observations        # arrays (B, V, ...)
    img_height: torch.Tensor  # (B,)


def batched_fit_frames(cfg: FitConfig, assets, cam: Camera,
                       batch: BatchedFitInputs, vposer_w=None, gmm=None,
                       est_scale: bool = True,
                       device: DeviceLike = None) -> FitResult:
    """Initialize and fit a whole batch of frames on `device` (CUDA
    unless ``device="cpu"``): triangulation + umeyama (or the annotated
    3D joints, with `spec.use_3d`), then the staged anneal, all batched
    over frames."""
    dev = resolve_device(device)
    assets = assets.to(dev)
    cam = cam.to(dev)
    obs = batch.obs.to(dev)
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    gmm = None if gmm is None else gmm.to(dev)
    img_height = batch.img_height.to(dev)
    guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask,
                       est_scale=est_scale,
                       gt3d=obs.gt3d if cfg.spec.use_3d else None)
    return fit_frame(cfg, assets, cam, obs, guess.params, guess.z,
                     vposer_w=vposer_w, gmm=gmm, img_height=img_height)
