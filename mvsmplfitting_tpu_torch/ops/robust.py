"""Robustifiers for the fitting energy (port of `ops/robust.py`)."""

from __future__ import annotations

import torch


def gmof(residual: torch.Tensor, rho: float) -> torch.Tensor:
    """Geman-McClure ``rho^2 r^2 / (r^2 + rho^2)``, elementwise."""
    sq = residual * residual
    return rho * rho * sq / (sq + rho * rho)


def gmof_residual(residual: torch.Tensor, rho: float) -> torch.Tensor:
    """Smooth residual ``e = rho r / sqrt(r^2 + rho^2)``, ``e^2 == gmof``."""
    return rho * residual * (residual * residual + rho * rho) ** -0.5
