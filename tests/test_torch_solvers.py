"""The port's L-BFGS and first-order solvers against the JAX package and
optax, on the CPU.

Tolerances and why:
- L-BFGS iterates after k = 1..8 iterations: rtol 1e-4 (fp32; the port
  sums dot products in another order than XLA, and the line search's
  cubic steps amplify that a little); the final x at atol 1e-3 (JAX's
  own convergence test, `tests/test_fitting.py:136-148`);
- a frame of a batch against that frame fitted alone: rtol 1e-5 (the
  same arithmetic on another batch size); the batch against JAX's
  `vmap`: rtol 1e-4, as above;
- adam / rmsprop / sgd against optax, step by step for 50 steps:
  rtol 1e-5 (the same update equations in fp32);
- staged fits at B=2 against JAX's `vmap(fit_frame)`: stage losses at
  rtol 1e-3 (the fit-level tolerance of `test_torch_fit.py`).

The JAX staged fits dominate this module's time: the L-BFGS one (a
line search per stage, each step evaluating the energy's gradient)
takes ~11 s of XLA compile a stage, so the staged fits run one stage
(the library schedule's last).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.fitting.gradient import GradientOptions as JGradOpts
from mvsmplfitting_tpu.fitting.gradient import gradient_fit as jgradient_fit
from mvsmplfitting_tpu.fitting.gradient import make_transform
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.lbfgs import LBFGSOptions as JLBFGSOpts
from mvsmplfitting_tpu.fitting.lbfgs import lbfgs_fit as jlbfgs_fit
from mvsmplfitting_tpu.fitting.stages import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting.stages import fit_frame as jfit_frame
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting.gradient import (GradientOptions,
                                                      gradient_fit)
from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
from mvsmplfitting_tpu_torch.fitting.lbfgs import LBFGSOptions, lbfgs_fit
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig, default_stages
from mvsmplfitting_tpu_torch.parallel.batched import (BatchedFitInputs,
                                                      batched_fit_frames)

from torch_port_helpers import fit_problem


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _torch_fg(f):
    """A per-frame objective f (B, n) -> (B,) as (value, gradient)."""
    def fg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g
    return fg


def _rosenbrock(x):
    return 100.0 * (x[..., 1] - x[..., 0] ** 2) ** 2 + (1 - x[..., 0]) ** 2


TARGET = np.array([1.0, 2.0, 3.0], np.float32)


def _quadratic(x):
    return ((x - (jnp.asarray(TARGET) if isinstance(x, jax.Array)
                  else torch.from_numpy(TARGET))) ** 2).sum(-1)


# (objective, x0, mask, the minimum under the mask): JAX's L-BFGS tests,
# `tests/test_fitting.py:136-148` and `:219-227`.
PROBLEMS = {
    "rosenbrock": (_rosenbrock, [-1.2, 1.0], [1.0, 1.0], [1.0, 1.0]),
    "masked_quadratic": (_quadratic, [0.0, 0.0, 0.0], [1.0, 0.0, 1.0],
                         [1.0, 0.0, 3.0]),
}


def _jax_lbfgs(f, x0, mask, max_iters):
    """JAX's (x, f) and its objective evaluations, counted by a host
    callback (unbatched, each line-search step runs only its branch)."""
    opts = JLBFGSOpts(max_iters=max_iters)
    count = [0]

    def fg(x):
        jax.debug.callback(lambda _: count.__setitem__(0, count[0] + 1),
                           x[0])
        return jax.value_and_grad(f)(x)
    xj, fj = jax.jit(lambda x: jlbfgs_fit(fg, x, jnp.asarray(mask), opts))(
        jnp.asarray(x0, jnp.float32))
    jax.block_until_ready(xj)
    return xj, fj, count[0]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lbfgs_iterates_match_jax(name):
    f, x0, mask, xmin = PROBLEMS[name]
    x0t = torch.tensor([x0], dtype=torch.float32)
    for k in range(1, 9):
        xj, fj, evj = _jax_lbfgs(f, x0, mask, k)
        xt, ft, it, ev = lbfgs_fit(_torch_fg(f), x0t, torch.tensor(mask),
                                   LBFGSOptions(max_iters=k))
        np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), rtol=1e-4,
                                   atol=1e-7, err_msg=f"k={k}")
        np.testing.assert_allclose(ft.item(), float(fj), rtol=1e-4,
                                   atol=1e-7)
        # The evaluations count as JAX's, its discarded ones included.
        assert it.item() <= k and ev.item() == evj, (k, ev.item(), evj)
    xj, _, evj = _jax_lbfgs(f, x0, mask, 200)
    xt, _, _, ev = lbfgs_fit(_torch_fg(f), x0t, torch.tensor(mask),
                             LBFGSOptions(max_iters=200))
    assert ev.item() == evj
    np.testing.assert_allclose(xt[0].numpy(), xmin, atol=1e-3)
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), atol=1e-3)


# Four Rosenbrock starts.  The last one is chaotic: at iteration 4 the
# line search of JAX's B=1 run and of its vmapped run take different
# branches on round-off (x 0.35 apart), and the port there follows the
# vmapped path to 1.6e-5, a gap that grows to ~1e-2 by iteration 10.
STARTS = np.array([[-1.2, 1.0], [0.5, 0.5], [2.0, -1.0], [-0.5, 2.0]],
                  np.float32)


def _jax_lbfgs_vmap(x0, max_iters):
    opts = JLBFGSOpts(max_iters=max_iters)
    return jax.jit(jax.vmap(lambda x: jlbfgs_fit(
        jax.value_and_grad(_rosenbrock), x, jnp.ones(2), opts)))(
            jnp.asarray(x0))


@pytest.mark.parametrize("max_iters", [6, 200])
def test_lbfgs_frames_independent(max_iters):
    """Each frame of the B=4 batch equals its own B=1 run, and JAX's
    `vmap` (the chaotic start only once converged)."""
    mask = torch.ones(2)
    opts = LBFGSOptions(max_iters=max_iters)
    xb, fb, itb, evb = lbfgs_fit(_torch_fg(_rosenbrock),
                                 torch.from_numpy(STARTS), mask, opts)
    if max_iters == 200:
        assert len(set(itb.tolist())) > 1, itb    # frames stop apart
    for i in range(4):
        xi, fi, iti, evi = lbfgs_fit(_torch_fg(_rosenbrock),
                                     torch.from_numpy(STARTS[i:i + 1]),
                                     mask, opts)
        assert (iti.item(), evi.item()) == (itb[i].item(), evb[i].item())
        np.testing.assert_allclose(xi[0].numpy(), xb[i].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(fi.item(), fb[i].item(), rtol=1e-5,
                                   atol=1e-9)
    xj, fj = _jax_lbfgs_vmap(STARTS, max_iters)
    n = 4 if max_iters == 200 else 3
    np.testing.assert_allclose(xb.numpy()[:n], np.asarray(xj)[:n],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fb.numpy()[:n], np.asarray(fj)[:n],
                               rtol=1e-4, atol=1e-7)


def test_lbfgs_chaotic_start_flips_within_jax():
    """The pinned chaotic start after 4 iterations: JAX's own B=1 and
    vmapped runs part (a line-search branch flip on round-off); the
    port's batch stays on the vmapped path."""
    xv, _ = _jax_lbfgs_vmap(STARTS, 4)
    xs, _, _ = _jax_lbfgs(_rosenbrock, STARTS[3], [1.0, 1.0], 4)
    assert np.abs(np.asarray(xs) - np.asarray(xv[3])).max() > 0.1
    xb, _, _, _ = lbfgs_fit(_torch_fg(_rosenbrock), torch.from_numpy(STARTS),
                            torch.ones(2), LBFGSOptions(max_iters=4))
    np.testing.assert_allclose(xb.numpy(), np.asarray(xv), rtol=1e-4,
                               atol=1e-6)


def _random_quadratic(seed, B=3, n=6):
    """Per-frame f = 0.5 x^T A x - b^T x, A SPD; a mask freezing entry 2."""
    rng = np.random.default_rng(seed)
    M = rng.normal(0, 0.5, (B, n, n))
    A = (np.einsum("bij,bkj->bik", M, M) + np.eye(n)).astype(np.float32)
    b = rng.normal(0, 1, (B, n)).astype(np.float32)
    x0 = rng.normal(0, 1, (B, n)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[2] = 0.0
    return A, b, x0, mask


@pytest.mark.parametrize("optim_type", ["adam", "rmsprop", "sgd"])
def test_first_order_steps_match_optax(optim_type):
    """50 steps on a masked quadratic: the port's iterates against
    optax's updates (JAX `make_transform`), step by step."""
    A, b, x0, mask = _random_quadratic(3)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    seen = []

    def fg(x):
        seen.append(x.clone())
        Ax = torch.einsum("bij,bj->bi", At, x)
        return 0.5 * (x * Ax).sum(-1) - (bt * x).sum(-1), Ax - bt

    opts = GradientOptions(optim_type=optim_type, lr=1e-2, max_iters=50,
                           ftol=0.0, gtol=0.0)
    x, loss, it = gradient_fit(fg, torch.from_numpy(x0),
                               torch.from_numpy(mask), opts)
    assert it.tolist() == [50] * 3
    got = torch.stack(seen[:50] + [x]).numpy()          # x_0 .. x_50

    tx = make_transform(JGradOpts(optim_type=optim_type, lr=1e-2))
    xs = [jnp.asarray(x0)]
    state = jax.vmap(tx.init)(xs[0])
    for _ in range(50):
        xk = xs[-1]
        g = (jnp.einsum("bij,bj->bi", A, xk) - b) * mask
        upd, state = jax.vmap(tx.update)(g, state, xk)
        xs.append(xk + upd * mask)
    want = np.asarray(jnp.stack(xs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[:, :, 2] == x0[None, :, 2])       # frozen entry
    np.testing.assert_allclose(
        loss.numpy(), 0.5 * np.einsum("bi,bij,bj->b", want[-1], A, want[-1])
        - (b * want[-1]).sum(-1), rtol=1e-5)


@pytest.mark.parametrize("optim_type", ["adam", "rmsprop", "sgd"])
def test_first_order_converges_with_mask(optim_type):
    """JAX's factory test (`tests/test_fitting.py:229-246`) on the port,
    and against JAX's `gradient_fit` at the same budget."""
    opts = GradientOptions(optim_type=optim_type, lr=0.05, max_iters=2000,
                           ftol=0.0)
    mask = [1.0, 0.0, 1.0]
    x, loss, _ = gradient_fit(_torch_fg(_quadratic), torch.zeros(1, 3),
                              torch.tensor(mask), opts)
    np.testing.assert_allclose(x[0].numpy(), [1.0, 0.0, 3.0], atol=2e-2)
    jopts = JGradOpts(optim_type=optim_type, lr=0.05, max_iters=2000,
                      ftol=0.0)
    xj, _ = jax.jit(lambda x0: jgradient_fit(
        jax.value_and_grad(_quadratic), x0, jnp.asarray(mask), jopts))(
            jnp.zeros(3))
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), atol=1e-3)


# --- staged fits against JAX's vmap(fit_frame) ----------------------------

B = 2
# The library schedule's last stage (pose, shape weights).
STAGES = dict(pose_weights=(4.78,), shape_weights=(5.0,),
              coll_weights=(0.0,))
SOLVERS = {
    "lbfgs": (dict(lbfgs=LBFGSOptions(max_iters=3)),
              dict(lbfgs=JLBFGSOpts(max_iters=3))),
    "adam": (dict(grad=GradientOptions(lr=1e-2, max_iters=10)),
             dict(grad=JGradOpts(lr=1e-2, max_iters=10))),
}


@pytest.fixture(scope="module")
def problem():
    return fit_problem(B)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_staged_fit_matches_jax(problem, solver):
    p = problem
    kw, jkw = SOLVERS[solver]
    jcfg = JFitConfig(solver=solver, **STAGES, **jkw)

    def one(o):
        g = jinit_guess(p["ja"], p["jc"], o.gt2d, o.conf, o.view_mask)
        return jfit_frame(jcfg, p["ja"], p["jc"], o, g.params, g.z,
                          vposer_w=p["jw"], img_height=1080.0)
    want = np.asarray(jax.jit(jax.vmap(one))(p["jo"]).stage_losses)

    cfg = FitConfig(solver=solver, **STAGES, **kw)
    h = torch.full((B,), 1080.0)
    got = batched_fit_frames(cfg, p["ta"], p["tc"],
                             BatchedFitInputs(p["to"], h),
                             vposer_w=p["tw"], device="cpu")
    assert want.shape == (B, 1)
    np.testing.assert_allclose(got.stage_losses.numpy(), want, rtol=1e-3)
    budget = 3 if solver == "lbfgs" else 10
    assert (got.lm_iters >= 1).all() and (got.lm_iters <= budget).all()

    # The first-order fit's own gate (`tests/test_fitting.py:248-266`):
    # the final loss is below the last stage's energy at the start.
    o = p["to"]
    guess = init_guess(p["ta"], p["tc"], o.gt2d, o.conf, o.view_mask)
    x0 = TE.pack(cfg.spec, guess.params, guess.z)
    e0 = TE.total_energy(cfg.spec, p["ta"], p["tc"], o,
                         default_stages(cfg, h)[-1], p["tw"], None, x0)
    assert bool((got.loss < e0).all()), (got.loss, e0)
