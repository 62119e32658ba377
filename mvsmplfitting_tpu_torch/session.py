"""Session assembly: config -> model assets, cameras, priors, dataset
(port of `session.py`).

The analogue of the reference's `init()` (`code/init.py:23-205`): the
model, cameras and priors are placed on one device, the dataset stays on
the host, and `fit_config` maps the config onto the fit's options as the
JAX package does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import Config
from .data.dataset import FittingDataset
from .device import DeviceLike, resolve_device
from .fitting.energy import EnergySpec
from .fitting.gradient import GradientOptions
from .fitting.lbfgs import LBFGSOptions
from .fitting.lm import LMOptions
from .fitting.stages import FitConfig
from .models import joints as J
from .models import vposer as vposer_lib
from .models.assets import load_smpl, synthetic_smpl
from .models.camera import Camera, load_cameras_txt
from .models.joint_model import with_joint_model
from .models.priors import GMMPrior, load_gmm, random_gmm

BUNDLED_VPOSER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "vposer_weights.npz")


@dataclass
class Session:
    cfg: Config
    assets: object                      # SMPLAssets
    cameras: Camera
    dataset: FittingDataset
    joint_weights: np.ndarray
    vposer: Optional[vposer_lib.VPoserWeights]
    gmm: Optional[GMMPrior]
    fit_config: FitConfig
    pose_format: str
    synthetic_model: bool
    device: torch.device


def _find_lsp_regressor(cfg: Config) -> Optional[str]:
    if cfg.lsp_regressor and os.path.exists(cfg.lsp_regressor):
        return cfg.lsp_regressor
    cand = os.path.join(cfg.data_folder, "J_regressor_lsp.npz")
    return cand if os.path.exists(cand) else None


def build_session(cfg: Config, device: DeviceLike = None) -> Session:
    """Everything a fit of `cfg` needs, on `device` (CUDA unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    pose_format = J.pose_format_for_model(cfg.model_type)

    # Body model: real pkl when available, synthetic fallback for
    # environments without the (license-gated) SMPL download.
    synthetic = False
    try:
        assets = load_smpl(cfg.model_folder, cfg.model_type, cfg.gender,
                           lsp_regressor_path=_find_lsp_regressor(cfg),
                           device=dev)
    except (FileNotFoundError, ValueError):
        if not cfg.allow_synthetic_model:
            raise
        assets = synthetic_smpl(cfg.model_type, device=dev)
        synthetic = True
    assets = with_joint_model(assets)

    cameras = load_cameras_txt(cfg.cam_param, device=dev)

    vposer = None
    if cfg.use_vposer:
        npz = os.path.join(cfg.prior_folder, "vposer_weights.npz")
        if os.path.exists(npz):
            vposer = vposer_lib.load_npz(npz, device=dev)
        elif os.path.exists(BUNDLED_VPOSER):
            # Pre-converted copy of the reference's bundled snapshot.
            vposer = vposer_lib.load_npz(BUNDLED_VPOSER, device=dev)
        else:
            vposer = vposer_lib.load_vposer(cfg.prior_folder, device=dev)

    gmm = None
    if not cfg.use_vposer and cfg.body_prior_type == "gmm":
        if cfg.gmm_path and os.path.exists(cfg.gmm_path):
            gmm = load_gmm(cfg.gmm_path, device=dev)
        else:
            gmm = random_gmm(device=dev)

    dataset = FittingDataset(cfg.data_folder, cfg.img_folder,
                             cfg.keyp_folder, use_3d=cfg.use_3d,
                             max_people=cfg.num_people)

    num_joints = int(assets.joint_map.shape[0])
    joint_weights = J.default_joint_weights(num_joints, pose_format,
                                            cfg.use_hip)

    # `cfg.use_pallas_sdf` has no counterpart: the voxelizer launches
    # its kernels on CUDA and takes the plain version on the CPU.
    spec = EnergySpec(
        use_vposer=cfg.use_vposer,
        fix_shape=cfg.fix_shape,
        fix_scale=cfg.fix_scale,
        use_3d=cfg.use_3d,
        use_joints_conf=cfg.use_joints_conf,
        prior_type=cfg.body_prior_type,
        rho=cfg.rho,
        interpenetration=cfg.interpenetration,
        coll_grid_size=cfg.coll_grid_size,
    )
    # The factory's surface (`optim_factory.py:27-65`): lm (primary),
    # lbfgs/lbfgsls (parity), adam/rmsprop/sgd (first-order).
    if cfg.optim_type in ("lbfgs", "lbfgsls"):
        solver = "lbfgs"
    elif cfg.optim_type in ("adam", "rmsprop", "sgd"):
        solver = cfg.optim_type
    else:
        solver = "lm"
    # The reference's budget is maxiters(30) outer x 30 L-BFGS iterations
    # with ftol cutting early; one bounded loop with the same tolerances
    # covers it.  LM runs the library defaults (Newton-Schulz,
    # speculative, the analytic Jacobian); `MVSF_LM_JAC=ad` takes the AD
    # Jacobian instead, for A/B measurement.
    fit_config = FitConfig(
        spec=spec, solver=solver,
        pose_weights=tuple(cfg.body_pose_prior_weights),
        shape_weights=tuple(cfg.shape_weights),
        coll_weights=tuple(cfg.coll_loss_weights),
        lm=LMOptions(max_iters=max(60, cfg.maxiters * 2),
                     ftol=cfg.ftol, gtol=cfg.gtol,
                     jac=os.environ.get("MVSF_LM_JAC", "analytic")),
        lbfgs=LBFGSOptions(max_iters=cfg.maxiters * 4, lr=cfg.lr,
                           ftol=cfg.ftol, gtol=cfg.gtol),
        grad=GradientOptions(optim_type=solver if solver in
                             ("adam", "rmsprop", "sgd") else "adam",
                             lr=(cfg.lr if cfg.lr < 1.0 else 1e-2),
                             max_iters=cfg.maxiters * 30,
                             ftol=cfg.ftol, gtol=cfg.gtol),
        is_seq=cfg.is_seq,
    )
    return Session(cfg=cfg, assets=assets, cameras=cameras,
                   dataset=dataset, joint_weights=joint_weights,
                   vposer=vposer, gmm=gmm, fit_config=fit_config,
                   pose_format=pose_format, synthetic_model=synthetic,
                   device=dev)
