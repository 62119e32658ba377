"""Levenberg-Marquardt over the least-squares energy, batched over frames
(port of `fitting/lm.py`: `lm_fit` classic and speculative, and the
fused all-stages loop `lm_fit_staged`).

JAX runs one `lax.while_loop` per frame under `vmap`: the body runs for
every frame and a frame whose condition ``it < max_iters & ~done`` is
already false keeps its old state.  Here the state is (B, n) with a
per-frame `it`/`done`, the loop runs while any frame is active, and each
iteration commits only the active frames' new state, so a frame's result
equals that frame fitted alone.  The residual and Jacobian are evaluated
for the whole batch every iteration, as the vmapped loop does.

Frozen parameters (fix_scale / fix_shape) are handled by masking their
Jacobian columns and pinning the diagonal.

`aux_fn` is JAX's lagged-SDF hook: a per-iteration state (the collision
grids) computed once from the iterate without a derivative and held
fixed through that iteration's Jacobian and trial evaluation.  As in
JAX it does not combine with `jac_fn`; here it runs on the classic path
only (the multi-person refinement, its one user, is never speculative).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..ops.forward_mode import jacobian_columns


@dataclasses.dataclass(frozen=True)
class LMOptions:
    max_iters: int = 60
    ftol: float = 1e-9
    gtol: float = 1e-9
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.2
    max_lambda: float = 1e10
    min_lambda: float = 1e-10
    # One residual evaluation per iteration: the step taken at iteration
    # k is judged by iteration k+1's linearization primal, and a worse
    # step rolls back.  Exactness tests pin speculative=False.
    speculative: bool = True
    # Normal-equation solver: "lu", "chol" or "schulz" (Jacobi-
    # preconditioned Newton-Schulz, `schulz_iters` iterations).
    linsolve: str = "schulz"
    schulz_iters: int = 12
    # "analytic" (closed-form deep blocks, `energy.residual_jacobian`)
    # or "ad" (forward mode over all n columns of the residuals).
    jac: str = "analytic"


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of (..., n, n); NaN where a matrix is not
    positive definite in fp32 (as XLA's, so the step is rejected rather
    than raising)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _solve_spd(A: torch.Tensor, b: torch.Tensor, method: str,
               schulz_iters: int = 12) -> torch.Tensor:
    """Solve A x = b for damped-SPD A (B, n, n), b (B, n)."""
    if method == "chol":
        L = _cholesky(A)
        y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                             upper=True)[..., 0]
    if method == "schulz":
        # Jacobi-preconditioned Newton-Schulz: A~ = D^-1/2 A D^-1/2, then
        # X <- X (2I - A~ X) from X0 = I / ||A~||_1 (lines 80-110).
        n = A.shape[-1]
        d = torch.sqrt(torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1),
                                       1e-30))
        At = A / (d[..., :, None] * d[..., None, :])
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        norm1 = torch.sum(torch.abs(At), dim=-2).amax(dim=-1)
        X = eye / torch.clamp_min(norm1, 1e-30)[..., None, None]
        I2 = 2.0 * eye
        for _ in range(schulz_iters):
            X = X @ (I2 - At @ X)
        return (X @ (b / d)[..., None])[..., 0] / d
    if method == "lu":
        return torch.linalg.solve(A, b)
    raise ValueError(f"unknown linsolve {method!r}")


def _spd_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of damped-SPD matrices (..., n, n) through Cholesky."""
    L = _cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    y = torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def _normal_step(r, J, lam, mask, opts: LMOptions):
    """Gradient g = J^T r and the damped step dx for each frame."""
    n = J.shape[-1]
    g = (J.transpose(1, 2) @ r[..., None])[..., 0]
    JtJ = J.transpose(1, 2) @ J
    diag = torch.clamp_min(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-8)
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    A = JtJ + lam[:, None, None] * torch.diag_embed(diag) + 1e-12 * eye
    dx = -_solve_spd(A, g, opts.linsolve, opts.schulz_iters) * mask
    return g, dx


def ad_jacobian(res: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r (B, m), J (B, m, n)) by forward mode over the n columns."""
    return res(x), jacobian_columns(res, x)


def lm_fit(residual_fn: Callable[[torch.Tensor], torch.Tensor],
           x0: torch.Tensor, mask: torch.Tensor,
           opts: LMOptions = LMOptions(),
           jac_fn: Optional[Callable[[torch.Tensor],
                                     Tuple[torch.Tensor, torch.Tensor]]]
           = None,
           aux_fn: Optional[Callable[[torch.Tensor], Any]] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize ``sum(residual_fn(x)**2, -1)`` per frame from x0 (B, n).

    Args:
      residual_fn: x (B, n) -> r (B, m); ``residual_fn(x, aux)`` with
        `aux_fn`.
      mask: (n,) 1.0 for free parameters, 0.0 for frozen.
      jac_fn: optional x -> (r, J (B, m, n)); else forward-mode AD.
      aux_fn: optional x -> state, computed once per iteration from the
        iterate under `torch.no_grad` and on plain tensors (it may launch
        kernels), then held fixed through the Jacobian and the trial
        step.  Classic LM only; not with `jac_fn`.

    Returns:
      (x_final (B, n), final loss (B,), LM iterations run per frame (B,)).
    """
    if aux_fn is not None:
        if jac_fn is not None:
            raise ValueError("jac_fn (analytic Jacobian) does not cover "
                             "aux-state residuals (lagged SDF)")
        if opts.speculative:
            raise ValueError("aux_fn (lagged SDF) runs on the classic LM "
                             "path only: pass speculative=False")
        res = residual_fn

        def make_aux(x):
            with torch.no_grad():
                return aux_fn(x.detach())
    else:
        def res(x, aux):
            return residual_fn(x)

        def make_aux(x):
            return None

    def r_and_J(x, aux=None):
        if jac_fn is not None:
            r, J = jac_fn(x)
        else:
            r, J = ad_jacobian(lambda v: res(v, aux), x)
        return r, J * mask

    if opts.speculative:
        return _lm_fit_speculative(residual_fn, r_and_J, x0, mask, opts)

    B = x0.shape[0]
    device = x0.device
    x = x0
    r0 = res(x0, make_aux(x0))
    loss = torch.sum(r0 * r0, dim=-1)
    lam = torch.full((B,), opts.init_lambda, dtype=x0.dtype, device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)

    while True:
        active = (it < opts.max_iters) & ~done
        if not bool(active.any()):
            break
        aux = make_aux(x)
        r, J = r_and_J(x, aux)
        g, dx = _normal_step(r, J, lam, mask, opts)
        new_x = x + dx
        r_new = res(new_x, aux)
        new_loss = torch.sum(r_new * r_new, dim=-1)
        loss_here = torch.sum(r * r, dim=-1)
        accept = torch.isfinite(new_loss) & (new_loss < loss_here)

        step_x = torch.where(accept[:, None], new_x, x)
        step_loss = torch.where(accept, new_loss, loss_here)
        step_lam = torch.clamp(
            torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
            opts.min_lambda, opts.max_lambda)
        rel = torch.abs(loss_here - new_loss) / torch.clamp_min(
            torch.maximum(torch.abs(loss_here), torch.abs(new_loss)), 1.0)
        small_f = accept & (rel <= opts.ftol)
        small_g = torch.amax(torch.abs(g), dim=-1) < opts.gtol
        bad = ~torch.isfinite(new_loss) & ~torch.isfinite(loss_here)

        x = torch.where(active[:, None], step_x, x)
        loss = torch.where(active, step_loss, loss)
        lam = torch.where(active, step_lam, lam)
        done = torch.where(active, done | small_f | small_g | bad, done)
        it = it + active.to(it.dtype)
    return x, loss, it


def _lm_fit_speculative(residual_fn, r_and_J, x0, mask, opts: LMOptions):
    """One residual evaluation per iteration (see LMOptions.speculative).

    Per frame: (x, x_prev, f_prev, lam, it, done, moved).  `x` may hold a
    pending step that the next iteration's primal judges: worse -> roll
    back to x_prev and raise lambda; better -> lower lambda and solve the
    next step from the linearization already computed.
    """
    B = x0.shape[0]
    device, dtype = x0.device, x0.dtype
    x, x_prev = x0, x0
    f_prev = torch.full((B,), float("inf"), dtype=dtype, device=device)
    lam = torch.full((B,), opts.init_lambda, dtype=dtype, device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    moved = torch.zeros((B,), dtype=torch.bool, device=device)

    while True:
        active = (it < opts.max_iters) & ~done
        if not bool(active.any()):
            break
        r, J = r_and_J(x)
        f = torch.sum(r * r, dim=-1)
        worse = moved & ((f >= f_prev) | ~torch.isfinite(f))
        rel = torch.abs(f_prev - f) / torch.clamp_min(
            torch.maximum(torch.abs(f_prev), torch.abs(f)), 1.0)
        small_f = moved & ~worse & (rel <= opts.ftol)

        step_lam = torch.clamp(
            torch.where(worse, lam * opts.lambda_up,
                        torch.where(moved, lam * opts.lambda_down, lam)),
            opts.min_lambda, opts.max_lambda)
        g, dx = _normal_step(r, J, step_lam, mask, opts)
        small_g = ~worse & (torch.amax(torch.abs(g), dim=-1) < opts.gtol)
        step_done = done | small_f | small_g

        hold = torch.where(worse[:, None], x_prev, x)
        new_x = torch.where((worse | step_done)[:, None], hold, x + dx)
        ref_f = torch.where(worse, f_prev, f)

        a = active[:, None]
        x_prev = torch.where(a, hold, x_prev)
        x = torch.where(a, new_x, x)
        f_prev = torch.where(active, ref_f, f_prev)
        lam = torch.where(active, step_lam, lam)
        moved = torch.where(active, ~worse & ~step_done, moved)
        done = torch.where(active, step_done, done)
        it = it + active.to(it.dtype)

    # The final x may hold an unjudged pending step: settle it with one
    # more evaluation (once per fit).
    r_fin = residual_fn(x)
    f_fin = torch.sum(r_fin * r_fin, dim=-1)
    better = torch.isfinite(f_fin) & (f_fin <= f_prev)
    return (torch.where(better[:, None], x, x_prev),
            torch.where(better, f_fin, f_prev), it)


def stack_stages(stages: Sequence[Any]) -> Any:
    """Per-stage weights (dataclasses of tensors with one Python flag,
    `coll_on`, that must agree) stacked on a leading stage axis."""
    first = stages[0]
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(st, f.name) for st in stages]
        if isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        else:
            if len(set(vals)) != 1:
                raise ValueError(f"stages disagree on {f.name}: {vals}")
            fields[f.name] = vals[0]
    return dataclasses.replace(first, **fields)


def _stage_at(table: Any, stage: torch.Tensor) -> Any:
    """Each frame's weights at its stage (B,): a field stacked (S, B) per
    frame gives (B,) by frame, one stacked (S,) gives (B,) too."""
    B = stage.shape[0]
    rows = torch.arange(B, device=stage.device)
    fields = {}
    for f in dataclasses.fields(table):
        v = getattr(table, f.name)
        if isinstance(v, torch.Tensor):
            fields[f.name] = v[stage, rows] if v.dim() == 2 else v[stage]
    return dataclasses.replace(table, **fields)


def lm_fit_staged(residual_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                  x0: torch.Tensor, mask: torch.Tensor, weights_table: Any,
                  num_stages: int, opts: LMOptions = LMOptions(),
                  jac_fn: Optional[Callable[[torch.Tensor, Any],
                                            Tuple[torch.Tensor,
                                                  torch.Tensor]]] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All annealing stages in one loop (JAX `lm.py:313-401`), batched.

    Each frame carries its stage index, its iteration count within the
    stage and its lambda; every iteration gathers each frame's weights
    from `weights_table` (`stack_stages` of the stages) at its stage, so
    frames at different stages share one batch.  A step is accepted when
    the new loss is below sum(r^2) of the primal residual of this
    iteration's Jacobian; a stage ends on a small relative improvement
    of an accepted step, a small gradient, its iteration budget or a
    non-finite trial loss, and lambda restarts at `init_lambda`.  The
    loop runs until every frame has passed the last stage.

    Args:
      residual_fn: (x (B, n), weights) -> r (B, m), weights per frame.
      jac_fn: optional (x, weights) -> (r, J (B, m, n)); else forward-mode
        AD of residual_fn.

    Returns:
      (x_final (B, n), per-stage final losses (B, S), LM iterations per
      stage (B, S)).
    """
    B = x0.shape[0]
    device, dtype = x0.device, x0.dtype
    S = num_stages
    x = x0
    lam = torch.full((B,), opts.init_lambda, dtype=dtype, device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    stage = torch.zeros((B,), dtype=torch.int64, device=device)
    stage_losses = torch.full((B, S), float("inf"), dtype=dtype,
                              device=device)
    iters = torch.zeros((B, S), dtype=torch.int32, device=device)
    rows = torch.arange(B, device=device)

    while True:
        active = stage < S
        if not bool(active.any()):
            break
        at = torch.clamp_max(stage, S - 1)
        w = _stage_at(weights_table, at)
        if jac_fn is not None:
            r, J = jac_fn(x, w)
        else:
            r, J = ad_jacobian(lambda v: residual_fn(v, w), x)
        J = J * mask
        loss_old = torch.sum(r * r, dim=-1)
        g, dx = _normal_step(r, J, lam, mask, opts)
        new_x = x + dx
        r_new = residual_fn(new_x, w)
        new_loss = torch.sum(r_new * r_new, dim=-1)
        accept = torch.isfinite(new_loss) & (new_loss < loss_old)

        step_lam = torch.clamp(
            torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
            opts.min_lambda, opts.max_lambda)
        rel = torch.abs(loss_old - new_loss) / torch.clamp_min(
            torch.maximum(torch.abs(loss_old), torch.abs(new_loss)), 1.0)
        cur_loss = torch.where(accept, new_loss, loss_old)
        stage_done = ((accept & (rel <= opts.ftol))
                      | (torch.amax(torch.abs(g), dim=-1) < opts.gtol)
                      | (it + 1 >= opts.max_iters)
                      | ~torch.isfinite(new_loss))

        x = torch.where((active & accept)[:, None], new_x, x)
        stage_losses[rows, at] = torch.where(active, cur_loss,
                                             stage_losses[rows, at])
        iters[rows, at] += active.to(iters.dtype)
        lam = torch.where(active, torch.where(
            stage_done, torch.full_like(lam, opts.init_lambda), step_lam),
            lam)
        it = torch.where(active, torch.where(stage_done, 0, it + 1), it)
        stage = stage + (active & stage_done).to(stage.dtype)
    return x, stage_losses, iters
