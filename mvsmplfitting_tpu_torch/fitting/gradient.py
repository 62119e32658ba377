"""First-order solvers (adam / rmsprop / sgd) for a stage, batched over
frames (port of `fitting/gradient.py`).

JAX builds the update from optax 0.2.6; these are its equations, not
`torch.optim`'s:
- adam: bias-corrected moments, ``-lr * m_hat / (sqrt(v_hat) + eps)``;
- rmsprop: ``scale_by_rms(eps_in_sqrt=True)``, i.e. ``g / sqrt(nu +
  eps)`` with nu from 0, then ``-lr``, then ``trace(momentum)`` (no
  Nesterov); `torch.optim.RMSprop` adds eps outside the root;
- sgd: ``trace(momentum, nesterov=True)``, then ``-lr``.
The stage stops a frame on the reference monitor's rules (ftol, gtol,
non-finite loss: `fitting.py:99-117`); the step that stops it keeps x.
Frozen entries are masked out of the gradient and the update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

Objective = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GradientOptions:
    optim_type: str = "adam"
    lr: float = 1e-3
    max_iters: int = 300
    ftol: float = 1e-9
    gtol: float = 1e-7
    # Factory defaults (`optim_factory.py:29-39`).
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    rmsprop_alpha: float = 0.99
    use_nesterov: bool = True


def _update(opts: GradientOptions, g: torch.Tensor, state: dict,
            count: int) -> Tuple[torch.Tensor, dict]:
    """One optax update of the gradient g (B, n) from the moments in
    `state` at the 1-based step `count`: (update, new moments)."""
    t = opts.optim_type
    if t == "adam":
        b1, b2 = opts.beta1, opts.beta2
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * g ** 2 + b2 * state["nu"]
        # 1 - b**count in float32, as optax rounds it.
        c = torch.tensor(count, dtype=torch.float32, device=g.device)
        u = (mu / (1 - b1 ** c)) / (torch.sqrt(nu / (1 - b2 ** c))
                                    + opts.epsilon)
        return -opts.lr * u, dict(state, mu=mu, nu=nu)
    if t == "rmsprop":
        a = opts.rmsprop_alpha
        nu = (1 - a) * g ** 2 + a * state["nu"]
        u = -opts.lr * (torch.rsqrt(nu + opts.epsilon) * g)
        trace = u + opts.momentum * state["trace"]
        return trace, dict(state, nu=nu, trace=trace)
    if t == "sgd":
        trace = g + opts.momentum * state["trace"]
        u = g + opts.momentum * trace if opts.use_nesterov else trace
        return -opts.lr * u, dict(state, trace=trace)
    raise ValueError(f"Optimizer {t} not supported!")


def gradient_fit(fg: Objective, x0: torch.Tensor, mask: torch.Tensor,
                 opts: GradientOptions = GradientOptions()
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize a per-frame scalar energy with a first-order optimizer.

    Args:
      fg: x (B, n) -> (loss (B,), grad (B, n)); frames are independent.
      mask: (n,) 1.0 free / 0.0 frozen entries.

    Returns:
      (x_final (B, n), loss at x_final (B,), steps per frame (B,)).
    """
    B = x0.shape[0]
    device = x0.device
    x = x0
    state = {k: torch.zeros_like(x0) for k in ("mu", "nu", "trace")}
    prev_loss = torch.full((B,), float("inf"), dtype=x0.dtype,
                           device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for step in range(opts.max_iters):
        active = ~done                  # every live frame has it == step
        if not bool(active.any()):
            break
        loss, g = fg(x)
        g = g * mask
        u, new_state = _update(opts, g, state, step + 1)
        new_x = x + u * mask
        rel = torch.abs(prev_loss - loss) / torch.clamp_min(
            torch.maximum(torch.abs(prev_loss), torch.abs(loss)), 1.0)
        step_done = ((rel <= opts.ftol)
                     | (torch.amax(torch.abs(g), dim=-1) < opts.gtol)
                     | ~torch.isfinite(loss))
        a = active[:, None]
        x = torch.where(a & ~step_done[:, None], new_x, x)
        state = {k: torch.where(a, new_state[k], state[k]) for k in state}
        prev_loss = torch.where(active, loss, prev_loss)
        done = step_done & active | done
        it = it + active.to(it.dtype)
    loss, _ = fg(x)
    return x, loss, it
