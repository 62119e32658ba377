"""Keypoint-adjustment re-optimization, batched over frames (port of
`fitting/adjust.py`).

The reference's `adjustment: true` lets a user hand-edit the 2D
keypoints (and nudge the pose), then reruns one optimization round with
the final stage's weights (`non_linear_solver.py:213-270`).  Here that
round is an API: edited observations (and optionally nudged parameters)
in, a fit warm-started from the previous one out.
"""

from __future__ import annotations

from typing import Optional

from ..models.camera import Camera
from ..models.smpl import SMPLParams
from . import energy as E
from .energy import Observations
from .stages import (FitConfig, FitResult, default_stages, frame_heights,
                     run_stage)


def refit_with_observations(cfg: FitConfig, assets, cam: Camera,
                            new_obs: Observations, prev: FitResult,
                            vposer_w=None, gmm=None, img_height=1080.0,
                            params_override: Optional[SMPLParams] = None
                            ) -> FitResult:
    """One more solve against edited keypoints: the final stage's weights
    only, from the previous result (`non_linear_solver.py:219-270`);
    `params_override` stands for the GUI's direct pose/shape nudges."""
    spec = cfg.spec
    params = params_override if params_override is not None else \
        prev.params
    x = E.pack(spec, params, prev.z if spec.use_vposer else None)
    weights = default_stages(cfg, frame_heights(img_height, x))[-1]
    x, loss, iters = run_stage(cfg, assets, cam, new_obs, weights, vposer_w,
                               gmm, x)

    params, z = E.unpack(spec, x)
    if spec.use_vposer:
        from ..models import vposer as vposer_lib
        body_pose = vposer_lib.decode(vposer_w, z)
    else:
        body_pose = params.body_pose
        z = prev.z
    return FitResult(params=params, z=z, body_pose=body_pose, loss=loss,
                     stage_losses=loss[:, None], lm_iters=iters[:, None])
