"""Forward-mode Jacobians of row-wise functions."""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp, vmap


def jacobian_columns(fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Per-row Jacobian of a row-wise `fn`: x (N, d) -> (N, *out, d).

    One `jvp` per input column, batched by `vmap` over the basis.  Used
    in place of ``vmap(jacfwd(fn))`` over rows, whose 0-d per-row values
    combined with Python scalars can promote the tangents to float64.
    """
    N, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def column(e):
        return jvp(fn, (x,), (e.expand(N, d),))[1]

    return vmap(column, out_dims=-1)(eye)
