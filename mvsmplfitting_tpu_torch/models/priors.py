"""Pose/shape priors: L2 and angle (bending), port of `models/priors.py`.

The GMM max-mixture prior is not ported yet (`prior_type` defaults to
"l2", and the fit uses VPoser).
"""

from __future__ import annotations

import torch

# Axis-angle components of the 69-D body pose penalized by the bending
# prior: left/right elbow and knee bend (`prior.py:53-89`).
ANGLE_IDXS = (52, 55, 9, 12)
ANGLE_SIGNS = (1.0, -1.0, -1.0, -1.0)


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis (`prior.py:92-97`)."""
    return torch.sum(x * x, dim=-1)


def angle_prior_terms(body_pose: torch.Tensor) -> torch.Tensor:
    """Per-term bending penalties exp(s * theta)^2, shape (..., 4)."""
    theta = body_pose[..., list(ANGLE_IDXS)]
    signs = torch.tensor(ANGLE_SIGNS, dtype=body_pose.dtype,
                         device=body_pose.device)
    return torch.exp(theta * signs) ** 2
