"""Pose-model factory (port of `detect/zoo.py`): the reference's
`MODEL.TYPE` registry as one function.  Extra keyword arguments go to
the module (conv_dim, deconv_filters, se, width, stage_with_dcn, ...)."""

from __future__ import annotations

from .fastpose import FastPose
from .fastpose_duc import FastPoseDUC, FastPoseDUCDense
from .hardnet import HarDNetPose
from .hrnet import PoseHRNet
from .simplepose import SimplePose

POSE_MODELS = {
    "fastpose": FastPose,
    "simplepose": SimplePose,
    "hrnet": PoseHRNet,
    "hardnet": HarDNetPose,
    "fastpose_duc": FastPoseDUC,
    "fastpose_duc_dense": FastPoseDUCDense,
}


def zoo_key(name: str) -> str:
    return name.lower().replace("-", "_")


def build_pose_model(name: str, num_joints: int = 17, **kwargs):
    """'fastpose' | 'simplepose' | 'hrnet' | 'hardnet' | 'fastpose_duc' |
    'fastpose_duc_dense' -> `nn.Module` (on the CPU, random default
    init)."""
    key = zoo_key(name)
    if key not in POSE_MODELS:
        raise ValueError(f"unknown pose model {name!r}; one of "
                         f"{sorted(POSE_MODELS)}")
    return POSE_MODELS[key](num_joints=num_joints, **kwargs)
