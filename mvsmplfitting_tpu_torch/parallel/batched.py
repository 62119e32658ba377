"""Frame-batched fitting (port of `parallel/batched.py`): frames are the
batch dimension of every tensor, on one card or split over the `frames`
axis of a mesh.

This is the slice's public entry point.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..fitting.energy import Observations
from ..fitting.initialize import init_guess
from ..fitting.stages import FitConfig, FitResult, fit_frame
from ..models.camera import Camera
from ..models.smpl import SMPLParams
from .mesh import frames_slice, gather_frames


@dataclasses.dataclass
class BatchedFitInputs:
    """Stacked per-frame inputs (leading axis = frames)."""

    obs: Observations        # arrays (B, V, ...)
    img_height: torch.Tensor  # (B,)


def _gather_result(mesh, res: FitResult, batch: int) -> FitResult:
    """Every field of each rank's `FitResult` gathered over `frames`, in
    the dataclasses' field order (absent SMPL-H/X blocks stay None)."""
    def g(t):
        return None if t is None else gather_frames(mesh, t, batch)
    params = SMPLParams(**{f.name: g(getattr(res.params, f.name))
                           for f in dataclasses.fields(SMPLParams)})
    return FitResult(params=params, **{
        f.name: g(getattr(res, f.name)) for f in dataclasses.fields(res)
        if f.name != "params"})


def batched_fit_frames(cfg: FitConfig, assets, cam: Camera,
                       batch: BatchedFitInputs, vposer_w=None, gmm=None,
                       mesh=None, est_scale: bool = True,
                       device: DeviceLike = None) -> FitResult:
    """Initialize and fit a whole batch of frames on `device` (CUDA
    unless ``device="cpu"``): triangulation + umeyama (or the annotated
    3D joints, with `spec.use_3d`), then the staged anneal, all batched
    over frames.

    With a (frames, cameras) `mesh` (`mesh.make_mesh`) every rank passes
    the whole batch, fits the frames of its `frames` coordinate with no
    communication (ranks that differ only in `cameras` repeat the same
    work), and gets the whole `FitResult` back, gathered over `frames`.
    """
    dev = resolve_device(device)
    B = batch.obs.gt2d.shape[0]
    fs = slice(None) if mesh is None else frames_slice(mesh, B)
    assets = assets.to(dev)
    cam = cam.to(dev)
    obs = Observations(*(None if t is None else t[fs].to(dev)
                         for t in (getattr(batch.obs, f.name)
                                   for f in dataclasses.fields(Observations))))
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    gmm = None if gmm is None else gmm.to(dev)
    img_height = batch.img_height[fs].to(dev)
    guess = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask,
                       est_scale=est_scale,
                       gt3d=obs.gt3d if cfg.spec.use_3d else None)
    res = fit_frame(cfg, assets, cam, obs, guess.params, guess.z,
                    vposer_w=vposer_w, gmm=gmm, img_height=img_height)
    return res if mesh is None else _gather_result(mesh, res, B)
