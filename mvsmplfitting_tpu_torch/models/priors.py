"""Pose/shape priors: L2, angle (bending) and the GMM max-mixture, port of
`models/priors.py` with a leading frame axis on every pose.

Behaviour mirrors the reference's `code/prior.py:36-231`.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

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


@dataclasses.dataclass
class GMMPrior:
    """Max-mixture Gaussian pose prior over the 69-D body pose."""

    means: torch.Tensor        # (M, 69)
    precisions: torch.Tensor   # (M, 69, 69)
    prec_chol: torch.Tensor    # (M, 69, 69) upper factors U, P = U^T U
    nll_weights: torch.Tensor  # (M,) weights / (const * reldet)

    def to(self, device) -> "GMMPrior":
        return GMMPrior(*(t.to(device) for t in dataclasses.astuple(self)))

    def _diff_quad(self, pose: torch.Tensor):
        """pose (B, 69) -> diff (B, M, 69), quad (B, M)."""
        diff = pose[:, None, :] - self.means
        quad = torch.einsum("bmi,mij,bmj->bm", diff, self.precisions, diff)
        return diff, quad

    def merged_nll(self, pose: torch.Tensor) -> torch.Tensor:
        """(B,) min-over-components NLL (`prior.py:181-196`)."""
        _, quad = self._diff_quad(pose)
        return torch.amin(0.5 * quad - torch.log(self.nll_weights), dim=-1)

    def log_likelihood(self, pose: torch.Tensor,
                       epsilon: float = 1e-16) -> torch.Tensor:
        """(B,) non-merged NLL (`prior.py:201-226`, `use_merged=False`)
        with the reference's quirks: the quadratic is not halved, and the
        chosen component's -log(nll_weight) is added at the end."""
        _, quad = self._diff_quad(pose)
        d = self.means.shape[1]
        cov_term = -2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(
            self.prec_chol, dim1=1, dim2=2))), dim=1)
        ll = quad + 0.5 * (cov_term + d * float(np.log(2 * np.pi)))
        best = torch.argmin(ll, dim=-1)
        rows = torch.arange(pose.shape[0], device=pose.device)
        return -torch.log(self.nll_weights[best]) + ll[rows, best]

    def residuals(self, pose: torch.Tensor) -> torch.Tensor:
        """(B, 69) rows whose squares sum to the argmin component's
        quadratic term; the -log w offset is locally constant and enters
        the scalar energy only."""
        diff, quad = self._diff_quad(pose)
        best = torch.argmin(0.5 * quad - torch.log(self.nll_weights), dim=-1)
        rows = torch.arange(pose.shape[0], device=pose.device)
        u = self.prec_chol[best]                           # (B, 69, 69)
        return float(np.sqrt(0.5)) * (u @ diff[rows, best][..., None])[..., 0]


def gmm_from_arrays(means: np.ndarray, covs: np.ndarray,
                    weights: np.ndarray,
                    device: DeviceLike = None) -> GMMPrior:
    """The prior from raw mixture parameters (`prior.py:126-176`), built
    in float64 on the host and cast to float32 on `device`."""
    dev = resolve_device(device)
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    weights = np.asarray(weights, np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (means.shape[1] / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))
    chol = np.stack([np.linalg.cholesky(p).T for p in precisions])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)
    return GMMPrior(means=t(means), precisions=t(precisions),
                    prec_chol=t(chol), nll_weights=t(nll_weights))


def load_gmm(path: str, device: DeviceLike = None) -> GMMPrior:
    """Load a smplify GMM pickle: a dict with means/covars/weights, or an
    sklearn-style object with `means_`/`covars_`/`weights_`."""
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        return gmm_from_arrays(gmm["means"], gmm["covars"], gmm["weights"],
                               device)
    return gmm_from_arrays(gmm.means_, gmm.covars_, gmm.weights_, device)


def random_gmm(num_components: int = 8, dim: int = 69, seed: int = 0,
               device: DeviceLike = None) -> GMMPrior:
    """Deterministic synthetic GMM (the real pickle is external): the
    JAX function's draws in its order, so the arrays are equal."""
    rng = np.random.default_rng(seed)
    means = 0.3 * rng.standard_normal((num_components, dim))
    covs = []
    for _ in range(num_components):
        a = rng.standard_normal((dim, dim)) * 0.05
        covs.append(a @ a.T + 0.5 * np.eye(dim))
    weights = rng.dirichlet(np.ones(num_components))
    return gmm_from_arrays(means, np.stack(covs), weights, device)
