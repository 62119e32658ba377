"""Confidence-weighted linear triangulation (port of `ops/triangulate.py`).

Per joint, the point-to-ray normal equations summed over views

    AtA_i = sum_v (conf_vi + 1e-6) R_v^T (I - n n^T) R_v
    Atb_i = sum_v (conf_vi + 1e-6) (-R_v^T (I - n n^T) t_v)

with n the unit back-projected pixel ray, then one batched 3x3 solve.
Frames are the leading batch dimension.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.camera import Camera


def backproject_rays(cam: Camera, pixels: torch.Tensor) -> torch.Tensor:
    """Unit camera-space rays for pixels (..., V, K, 2) -> (..., V, K, 3)."""
    xy = (pixels - cam.center[:, None, :]) / cam.focal[:, None, :]
    rays = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def triangulate(cam: Camera, pixels: torch.Tensor, conf: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None,
                conf_eps: float = 1e-6) -> torch.Tensor:
    """Triangulate K joints seen in V views, for a batch of frames.

    Args:
      pixels: (B, V, K, 2) detections; conf: (B, V, K) ray weights;
      view_mask: optional (B, V) 0/1 mask of live views.

    Returns:
      (B, K, 3) world-space points.
    """
    n = backproject_rays(cam, pixels)                        # (B, V, K, 3)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    nmat = eye - torch.einsum("zvka,zvkc->zvkac", n, n)
    rn = torch.einsum("vba,zvkbc->zvkac", cam.rotation, nmat)  # R^T nmat
    w = conf + conf_eps
    if view_mask is not None:
        w = w * view_mask[:, :, None]
    AtA = torch.einsum("zvk,zvkac,vcd->zkad", w, rn, cam.rotation)
    Atb = torch.einsum("zvk,zvkac,vc->zka", -w, rn, cam.translation)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]
