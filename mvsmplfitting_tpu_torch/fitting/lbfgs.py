"""L-BFGS with a strong-Wolfe line search, batched over frames (port of
`fitting/lbfgs.py`, the reference's parity solver).

JAX runs one `lax.while_loop` per frame under `vmap`, with the line
search (Nocedal & Wright Alg. 3.5/3.6: bracketing, then zoom) a nested
`while_loop`.  Here every quantity carries a leading frame axis; each
loop runs while any frame is live and commits only the live frames' new
state, so each frame follows the trajectory it has fitted alone.  One
line-search step evaluates the objective once for the whole batch, each
frame at its own step length; a bracketing step that hands over to zoom
still takes its step and counts it, as JAX's does (`max_ls` counts
steps).  The gradient is masked by the free mask.  Not
`torch.optim.LBFGS`: its line search, first step and stop rules differ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

Objective = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    max_iters: int = 120
    history: int = 16
    lr: float = 1.0
    ftol: float = 1e-9
    gtol: float = 1e-9
    tol_change: float = 1e-9
    max_ls: int = 25
    c1: float = 1e-4
    c2: float = 0.9


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2), clamped
    to [lo, hi]; the bisection midpoint where the cubic is degenerate or
    not finite (the root is taken of a clamped argument: both branches
    of `where` are evaluated)."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_sq = d1 * d1 - g1 * g2
    ok = d2_sq >= 0
    d2 = torch.sqrt(torch.clamp_min(d2_sq, 0.0)) * torch.sign(x2 - x1)
    t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
    t = torch.where(ok & torch.isfinite(t), t, 0.5 * (lo + hi))
    return torch.minimum(torch.maximum(t, lo), hi)


def _pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=-1)


def _strong_wolfe(vg: Objective, x: torch.Tensor, d: torch.Tensor,
                  f0: torch.Tensor, gtd0: torch.Tensor, t0: torch.Tensor,
                  live: torch.Tensor, opts: LBFGSOptions):
    """Per frame, a step t along d from x meeting the strong Wolfe
    conditions (JAX `lbfgs.py:71-198`).  Frames where `live` is false
    are carried along unchanged.  Returns (t, f, grad, line-search
    evaluations) per frame."""
    c1, c2 = opts.c1, opts.c2

    def eval_t(t):
        f, g = vg(x + t[:, None] * d)
        return f, g, _dot(g, d)

    f_t, g_t, gtd_t = eval_t(t0)
    s = dict(phase=torch.zeros_like(t0, dtype=torch.int32),
             it=torch.ones_like(t0, dtype=torch.int32),
             t=t0, f_t=f_t, g_t=g_t, gtd_t=gtd_t,
             t_prev=torch.zeros_like(t0), f_prev=f0, gtd_prev=gtd0,
             bt=torch.zeros_like(t0)[:, None].expand(-1, 2),
             bf=torch.zeros_like(t0)[:, None].expand(-1, 2),
             bg=torch.zeros_like(t0)[:, None].expand(-1, 2),
             insuf=torch.zeros_like(t0, dtype=torch.bool))

    while True:
        active = live & (s["phase"] != 2) & (s["it"] < opts.max_ls)
        if not bool(active.any()):
            break
        t, f_t, gtd_t = s["t"], s["f_t"], s["gtd_t"]
        t_prev, f_prev, gtd_prev = s["t_prev"], s["f_prev"], s["gtd_prev"]
        bt, bf, bg = s["bt"], s["bf"], s["bg"]
        bracket = s["phase"] == 0

        # Bracketing (phase 0): judge the point already evaluated, then
        # extrapolate by the cubic on (t_prev, t) within
        # [t + 0.01 (t - t_prev), 10 t].
        a_fail = (f_t > f0 + c1 * t * gtd0) | ((s["it"] > 1)
                                               & (f_t >= f_prev))
        wolfe = torch.abs(gtd_t) <= -c2 * gtd0
        to_zoom = a_fail | (~wolfe & (gtd_t >= 0))
        b_done = ~a_fail & wolfe
        t_ext = _cubic_min(t_prev, f_prev, gtd_prev, t, f_t, gtd_t,
                           t + 0.01 * (t - t_prev), t * 10.0)

        # Zoom (phase 1): the cubic inside the bracket, nudged 0.1 width
        # off an edge it keeps sticking to.
        lo_t, hi_t = bt[:, 0], bt[:, 1]
        left, right = torch.minimum(lo_t, hi_t), torch.maximum(lo_t, hi_t)
        eps = 0.1 * (right - left)
        t_zoom = _cubic_min(lo_t, bf[:, 0], bg[:, 0], hi_t, bf[:, 1],
                            bg[:, 1], left, right)
        close = torch.minimum(right - t_zoom, t_zoom - left) < eps
        nudged = torch.where(t_zoom > 0.5 * (left + right), right - eps,
                             left + eps)
        t_zoom = torch.where(s["insuf"] & close, nudged, t_zoom)

        t_new = torch.where(bracket, t_ext, t_zoom)
        f_new, g_new, gtd_new = eval_t(t_new)

        # Bracketing's next state.
        cont = ~to_zoom & ~b_done
        nb = dict(
            phase=torch.where(b_done, 2, torch.where(to_zoom, 1, 0)),
            t=torch.where(cont, t_new, t), f_t=torch.where(cont, f_new, f_t),
            g_t=torch.where(cont[:, None], g_new, s["g_t"]),
            gtd_t=torch.where(cont, gtd_new, gtd_t),
            t_prev=torch.where(cont, t, t_prev),
            f_prev=torch.where(cont, f_t, f_prev),
            gtd_prev=torch.where(cont, gtd_t, gtd_prev),
            bt=torch.where(a_fail[:, None], _pair(t_prev, t),
                           _pair(t, t_prev)),
            bf=torch.where(a_fail[:, None], _pair(f_prev, f_t),
                           _pair(f_t, f_prev)),
            bg=torch.where(a_fail[:, None], _pair(gtd_prev, gtd_t),
                           _pair(gtd_t, gtd_prev)),
            insuf=s["insuf"])

        # Zoom's next state (Alg. 3.6): on an Armijo failure hi <- t_new,
        # else lo <- t_new (and hi <- old lo where the slope says the
        # minimum lies on the other side); the lo point is the answer.
        z_fail = (f_new > f0 + c1 * t_new * gtd0) | (f_new >= bf[:, 0])
        z_done = ~z_fail & (torch.abs(gtd_new) <= -c2 * gtd0)
        flip = ~z_fail & (gtd_new * (hi_t - lo_t) >= 0)

        def hi(new, lo_v, hi_v):
            return torch.where(z_fail, new, torch.where(flip, lo_v, hi_v))

        take = z_done | ~z_fail
        nz = dict(
            phase=torch.where(z_done, 2, 1),
            t=torch.where(take, t_new, t), f_t=torch.where(take, f_new, f_t),
            g_t=torch.where(take[:, None], g_new, s["g_t"]),
            gtd_t=torch.where(take, gtd_new, gtd_t),
            t_prev=t_prev, f_prev=f_prev, gtd_prev=gtd_prev,
            bt=_pair(torch.where(z_fail, lo_t, t_new), hi(t_new, lo_t, hi_t)),
            bf=_pair(torch.where(z_fail, bf[:, 0], f_new),
                     hi(f_new, bf[:, 0], bf[:, 1])),
            bg=_pair(torch.where(z_fail, bg[:, 0], gtd_new),
                     hi(gtd_new, bg[:, 0], bg[:, 1])),
            insuf=close & ~s["insuf"])

        for k in nb:
            sel = bracket if nb[k].dim() == 1 else bracket[:, None]
            new = torch.where(sel, nb[k], nz[k])
            a = active if new.dim() == 1 else active[:, None]
            s[k] = torch.where(a, new.to(s[k].dtype), s[k])
        s["it"] = s["it"] + active.to(torch.int32)
    return s["t"], s["f_t"], s["g_t"], s["it"]


def _direction(g: torch.Tensor, S: torch.Tensor, Y: torch.Tensor,
               rho: torch.Tensor, count: torch.Tensor, m: int,
               bound: int) -> torch.Tensor:
    """-H g by the two-loop recursion over each frame's ring buffer,
    newest first.  `bound` >= every frame's count of pairs used (history
    slots k >= bound are empty for every frame and add exactly 0)."""
    rows = torch.arange(g.shape[0], device=g.device)
    used = torch.clamp_max(count, m)

    def slot(k):
        return torch.remainder(count - 1 - k, m)

    q = g
    alpha = [None] * m
    for k in range(bound):
        i = slot(k)
        a = torch.where(k < used, rho[rows, i] * _dot(S[rows, i], q), 0.0)
        q = q - a[:, None] * Y[rows, i]
        alpha[k] = a
    newest = slot(0)
    s_n, y_n = S[rows, newest], Y[rows, newest]
    gamma = torch.where(count > 0,
                        _dot(s_n, y_n) / torch.clamp_min(_dot(y_n, y_n),
                                                         1e-20), 1.0)
    r = gamma[:, None] * q
    for kk in reversed(range(bound)):                 # oldest first
        i = slot(kk)
        b = torch.where(kk < used, rho[rows, i] * _dot(Y[rows, i], r), 0.0)
        r = r + (alpha[kk] - b)[:, None] * S[rows, i]
    return -r


def lbfgs_fit(value_and_grad_fn: Objective, x0: torch.Tensor,
              mask: torch.Tensor, opts: LBFGSOptions = LBFGSOptions()
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Minimize f per frame from x0 (B, n) with strong-Wolfe L-BFGS.

    Args:
      value_and_grad_fn: x (B, n) -> (f (B,), df/dx (B, n)); frames are
        independent.
      mask: (n,) 1.0 free / 0.0 frozen entries.

    Returns:
      (x_final (B, n), f_final (B,), iterations per frame (B,),
      objective evaluations per frame (B,)).
    """
    B, n = x0.shape
    m = opts.history
    device, dtype = x0.device, x0.dtype

    def vg(x):
        f, g = value_and_grad_fn(x)
        return f, g * mask

    x = x0
    f, g = vg(x0)
    S = torch.zeros((B, m, n), dtype=dtype, device=device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((B, m), dtype=dtype, device=device)
    count = torch.zeros((B,), dtype=torch.int64, device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    evals = torch.ones((B,), dtype=torch.int32, device=device)
    done = torch.amax(torch.abs(g), dim=-1) <= opts.gtol
    slots = torch.arange(m, device=device)

    for step in range(opts.max_iters):
        active = ~done                  # every live frame has it == step
        if not bool(active.any()):
            break
        d = _direction(g, S, Y, rho, count, m, min(step, m))
        gtd = _dot(g, d)
        # Steepest descent where the direction does not descend.
        bad = gtd > -1e-20
        d = torch.where(bad[:, None], -g, d)
        gtd = torch.where(bad, -_dot(g, g), gtd)
        # First step min(1, 1/|g|_1) * lr, like the reference.
        t0 = torch.where(
            it == 0, torch.clamp_max(1.0 / torch.clamp_min(
                torch.sum(torch.abs(g), dim=-1), 1e-20), 1.0) * opts.lr,
            torch.full_like(f, opts.lr))
        t, f_new, g_new, ls_evals = _strong_wolfe(vg, x, d, f, gtd, t0,
                                                  active, opts)

        x_new = x + t[:, None] * d
        sk, yk = x_new - x, g_new - g
        ys = _dot(yk, sk)
        write = (slots == torch.remainder(count, m)[:, None]) \
            & (ys > 1e-10)[:, None]
        rel = torch.abs(f - f_new) / torch.clamp_min(
            torch.maximum(torch.abs(f), torch.abs(f_new)), 1.0)
        step_done = ((torch.amax(torch.abs(g_new), dim=-1) <= opts.gtol)
                     | (torch.amax(torch.abs(t[:, None] * d), dim=-1)
                        <= opts.tol_change)
                     | (rel <= opts.ftol) | ~torch.isfinite(f_new))

        a = active[:, None]
        w = write & a
        S = torch.where(w[..., None], sk[:, None], S)
        Y = torch.where(w[..., None], yk[:, None], Y)
        rho = torch.where(w, (1.0 / ys)[:, None], rho)
        count = count + w.any(-1).to(count.dtype)
        x = torch.where(a, x_new, x)
        f = torch.where(active, f_new, f)
        g = torch.where(a, g_new, g)
        done = torch.where(active, step_done, done)
        it = it + active.to(it.dtype)
        evals = evals + torch.where(active, ls_evals, 0)
    return x, f, it, evals
