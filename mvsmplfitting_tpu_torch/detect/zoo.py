"""Pose-model factory (port of `detect/zoo.py`): the reference's
`MODEL.TYPE` registry as one function.  Extra keyword arguments go to
the module (conv_dim, deconv_filters, se, ...)."""

from __future__ import annotations

from .fastpose import FastPose
from .fastpose_duc import FastPoseDUC, FastPoseDUCDense
from .simplepose import SimplePose

POSE_MODELS = {
    "fastpose": FastPose,
    "simplepose": SimplePose,
    "fastpose_duc": FastPoseDUC,
    "fastpose_duc_dense": FastPoseDUCDense,
}
# In JAX's zoo, not ported yet.
PENDING = ("hrnet", "hardnet")


def zoo_key(name: str) -> str:
    return name.lower().replace("-", "_")


def build_pose_model(name: str, num_joints: int = 17, **kwargs):
    """'fastpose' | 'simplepose' | 'fastpose_duc' | 'fastpose_duc_dense'
    -> `nn.Module` (on the CPU, random default init)."""
    key = zoo_key(name)
    if key in PENDING:
        raise NotImplementedError(
            f"pose model {name!r} is not ported yet (ROADMAP queue A item "
            "11b)")
    if key not in POSE_MODELS:
        raise ValueError(f"unknown pose model {name!r}; one of "
                         f"{sorted(POSE_MODELS) + list(PENDING)}")
    return POSE_MODELS[key](num_joints=num_joints, **kwargs)
