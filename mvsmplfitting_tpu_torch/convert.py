"""Carry parameters across from the JAX package.

Each function takes what the JAX package holds, as a dict of numpy
arrays keyed by the JAX dataclass's field names, and returns the port's
object on `device`.  Frame-batched objects (`Observations`,
`SMPLParams`) take arrays with a leading frame axis.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .fitting.energy import Observations
from .models.camera import Camera
from .models.joint_model import JointModel
from .models.priors import GMMPrior
from .models.smpl import TAIL_FIELDS, SMPLAssets, SMPLParams
from .models.vposer import VPoserWeights

Arrays = Mapping[str, Optional[np.ndarray]]


def _f32(a, dev):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32)),
                           device=dev)


def _opt_f32(arrays: Arrays, name: str, dev):
    a = arrays.get(name)
    return None if a is None else _f32(a, dev)


def _i64(a, dev):
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def smpl_assets(arrays: Arrays, parents: Tuple[int, ...], model_type: str,
                gender: str = "neutral",
                device: DeviceLike = None) -> SMPLAssets:
    """`SMPLAssets` from the JAX `SMPLAssets` arrays, with the SMPL-H/X
    hand PCA and expression blend shapes where given (joint model not
    included: build it with `joint_model.with_joint_model` or
    `convert.joint_model`)."""
    dev = resolve_device(device)
    lsp = arrays.get("lsp_regressor")
    return SMPLAssets(
        hand_components=_opt_f32(arrays, "hand_components", dev),
        hand_means=_opt_f32(arrays, "hand_means", dev),
        expr_dirs=_opt_f32(arrays, "expr_dirs", dev),
        v_template=_f32(arrays["v_template"], dev),
        shapedirs=_f32(arrays["shapedirs"], dev),
        posedirs=_f32(arrays["posedirs"], dev),
        j_regressor=_f32(arrays["j_regressor"], dev),
        lbs_weights=_f32(arrays["lbs_weights"], dev),
        faces=_i64(arrays["faces"], dev),
        extra_joint_ids=_i64(arrays["extra_joint_ids"], dev),
        joint_map=_i64(arrays["joint_map"], dev),
        lsp_regressor=None if lsp is None else _f32(lsp, dev),
        parents=tuple(int(p) for p in parents), model_type=model_type,
        gender=gender)


def joint_model(arrays: Arrays, parents: Tuple[int, ...], model_type: str,
                device: DeviceLike = None) -> JointModel:
    """`JointModel` from the JAX `JointModel` arrays (fold required; the
    SMPL-X expression fold and hand PCA where given)."""
    dev = resolve_device(device)
    return JointModel(
        He=_opt_f32(arrays, "He", dev), JE=_opt_f32(arrays, "JE", dev),
        hand_components=_opt_f32(arrays, "hand_components", dev),
        hand_means=_opt_f32(arrays, "hand_means", dev),
        H0=_f32(arrays["H0"], dev), Hb=_f32(arrays["Hb"], dev),
        Hp=_f32(arrays["Hp"], dev), j0=_f32(arrays["j0"], dev),
        JB=_f32(arrays["JB"], dev),
        chain_idx=_i64(arrays["chain_idx"], dev),
        chain_mask=_f32(arrays["chain_mask"], dev),
        fold=_f32(arrays["fold"], dev),
        parents=tuple(int(p) for p in parents), model_type=model_type)


def vposer_weights(arrays: Arrays, device: DeviceLike = None
                   ) -> VPoserWeights:
    dev = resolve_device(device)
    return VPoserWeights(**{k: _f32(v, dev) for k, v in arrays.items()
                            if v is not None})


def camera(arrays: Arrays, device: DeviceLike = None) -> Camera:
    dev = resolve_device(device)
    return Camera(rotation=_f32(arrays["rotation"], dev),
                  translation=_f32(arrays["translation"], dev),
                  focal=_f32(arrays["focal"], dev),
                  center=_f32(arrays["center"], dev))


def observations(arrays: Arrays, device: DeviceLike = None) -> Observations:
    """Frame-batched `Observations`: gt2d (B, V, K, 2), conf (B, V, K),
    view_mask (B, V), joint_weights (B, K), and the optional 3D joints
    gt3d (B, K, 3) with conf3d (B, K)."""
    dev = resolve_device(device)
    return Observations(gt2d=_f32(arrays["gt2d"], dev),
                        conf=_f32(arrays["conf"], dev),
                        view_mask=_f32(arrays["view_mask"], dev),
                        joint_weights=_f32(arrays["joint_weights"], dev),
                        gt3d=_opt_f32(arrays, "gt3d", dev),
                        conf3d=_opt_f32(arrays, "conf3d", dev))


def gmm(arrays: Arrays, device: DeviceLike = None) -> GMMPrior:
    """`GMMPrior` from the JAX `GMMPrior` arrays (already float32)."""
    dev = resolve_device(device)
    return GMMPrior(means=_f32(arrays["means"], dev),
                    precisions=_f32(arrays["precisions"], dev),
                    prec_chol=_f32(arrays["prec_chol"], dev),
                    nll_weights=_f32(arrays["nll_weights"], dev))


def smpl_params(arrays: Arrays, device: DeviceLike = None) -> SMPLParams:
    """Frame-batched `SMPLParams` (scale as (B,)), with whichever SMPL-H/X
    blocks are given."""
    dev = resolve_device(device)
    return SMPLParams(betas=_f32(arrays["betas"], dev),
                      global_orient=_f32(arrays["global_orient"], dev),
                      body_pose=_f32(arrays["body_pose"], dev),
                      transl=_f32(arrays["transl"], dev),
                      scale=_f32(arrays["scale"], dev).reshape(-1),
                      **{k: _opt_f32(arrays, k, dev) for k in TAIL_FIELDS})
