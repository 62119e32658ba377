"""The port's energy, LM solver and batched staged fit against the JAX
package, on the CPU.

Tolerances and why:
- residuals / Jacobian vs JAX: rtol 1e-5, atol 1e-5 max|.| (fp32; the
  joints feed pixels of ~500, so absolute error scales with the values);
- Jacobian vs forward-mode AD of the port's own residuals: rtol 1e-4,
  atol 1e-4 max|J| (closed form vs AD through rodrigues, the chain and
  the VPoser tail: fp32 reassociation along a deep graph);
- sum(r^2) vs total_energy: rtol 1e-5 (the same terms, summed apart);
- linear solves: rtol 1e-4 / atol 1e-5 max|x| against JAX (Cholesky and
  12 Newton-Schulz iterations in fp32 on a cond ~1e3 system);
- the staged fit: stage losses at rtol 1e-3 (the issue's fit-level
  tolerance: LM steps amplify fp32 differences between the packages);
- batch vs single frame on a row-independent problem: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.stages import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting.stages import fit_frame as jfit_frame
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
from mvsmplfitting_tpu_torch.parallel.batched import (BatchedFitInputs,
                                                      batched_fit_frames)

from torch_port_helpers import fit_problem

B = 2


@pytest.fixture(scope="module")
def problem():
    """Two distinct synthetic frames seen by 6 views, in both packages."""
    return fit_problem(B)


def _x(rng):
    x = rng.normal(0, 0.1, (B, 49)).astype(np.float32)
    x[:, 48] = 1.0 + 0.1 * rng.uniform(-1, 1, B)      # scale
    return x


def _weights():
    jw = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0)
    tw = TE.StageWeights.make(data=torch.full((B,), 500 / 1080.0),
                              pose=57.4, shape=10.0)
    return jw, tw


def test_residual_jacobian_matches_jax_and_ad(problem):
    p = problem
    x = _x(np.random.default_rng(0))
    jweights, tweights = _weights()
    spec, tspec = JE.EnergySpec(), TE.EnergySpec()

    def one(xx, o):
        return JE.residual_jacobian(spec, p["ja"], p["jc"], o, jweights,
                                    p["jw"], None, xx)
    r0, J0 = jax.jit(jax.vmap(one))(jnp.asarray(x), p["jo"])
    xt = torch.from_numpy(x)
    r1, J1 = TE.residual_jacobian(tspec, p["ta"], p["tc"], p["to"],
                                  tweights, p["tw"], None, xt)
    r0, J0 = np.asarray(r0), np.asarray(J0)
    np.testing.assert_allclose(r1.numpy(), r0, rtol=1e-5,
                               atol=1e-5 * np.abs(r0).max())
    np.testing.assert_allclose(J1.numpy(), J0, rtol=1e-5,
                               atol=1e-5 * np.abs(J0).max())

    def res(xx):
        return TE.residuals(tspec, p["ta"], p["tc"], p["to"], tweights,
                            p["tw"], None, xx)
    full = jacfwd(res)(xt)                               # (B, m, B, n)
    J_ad = torch.stack([full[b, :, b] for b in range(B)])
    np.testing.assert_allclose(r1.numpy(), res(xt).numpy(), rtol=1e-6,
                               atol=1e-6 * np.abs(r0).max())
    np.testing.assert_allclose(J1.numpy(), J_ad.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(J0).max())


def test_sum_of_squares_is_total_energy(problem):
    p = problem
    _, tweights = _weights()
    xt = torch.from_numpy(_x(np.random.default_rng(1)))
    for spec in (TE.EnergySpec(), TE.EnergySpec(use_vposer=False)):
        if not spec.use_vposer:
            xt = torch.cat([xt[:, :32], torch.zeros(B, 37), xt[:, 32:]], 1)
        r = TE.residuals(spec, p["ta"], p["tc"], p["to"], tweights,
                         p["tw"], None, xt)
        e = TE.total_energy(spec, p["ta"], p["tc"], p["to"], tweights,
                            p["tw"], None, xt)
        np.testing.assert_allclose((r * r).sum(-1).numpy(), e.numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("method", ["lu", "chol", "schulz"])
def test_solve_spd(method):
    rng = np.random.default_rng(2)
    n = 49
    M = rng.normal(0, 1, (3, 2 * n, n)) * rng.uniform(0.1, 10, (3, 1, n))
    A = (np.einsum("bmi,bmj->bij", M, M) + 1e-3 * np.eye(n)
         ).astype(np.float32)
    b = rng.normal(0, 1, (3, n)).astype(np.float32)
    got = TLM._solve_spd(torch.from_numpy(A), torch.from_numpy(b), method)
    want = jax.vmap(lambda a, v: JLM._solve_spd(a, v, method))(
        jnp.asarray(A), jnp.asarray(b))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_batched_fit_matches_jax(problem):
    """Init + 4 stages (chol, classic LM, 3 iterations) on 2 distinct
    frames: the port's batched fit against the vmapped JAX fit."""
    p = problem
    jcfg = JFitConfig(lm=JLM.LMOptions(max_iters=3, linsolve="chol",
                                       speculative=False))

    def one(o):
        g = jinit_guess(p["ja"], p["jc"], o.gt2d, o.conf, o.view_mask)
        return jfit_frame(jcfg, p["ja"], p["jc"], o, g.params, g.z,
                          vposer_w=p["jw"], img_height=1080.0)
    want = jax.jit(jax.vmap(one))(p["jo"])

    cfg = FitConfig(lm=TLM.LMOptions(max_iters=3, linsolve="chol",
                                     speculative=False))
    got = batched_fit_frames(cfg, p["ta"], p["tc"],
                             BatchedFitInputs(p["to"],
                                              torch.full((B,), 1080.0)),
                             vposer_w=p["tw"], device="cpu")
    want_losses = np.asarray(want.stage_losses)
    assert want_losses.shape == (B, 4)
    assert not np.allclose(want_losses[0], want_losses[1])   # distinct
    np.testing.assert_allclose(got.stage_losses.numpy(), want_losses,
                               rtol=1e-3)
    assert got.lm_iters.tolist() == [[3] * 4] * B


# --- per-frame masking of the batched LM loop ---------------------------

def _rosenbrock_torch(c):
    def res(x):
        return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0],
                            c * (x[:, 2] - 0.5 * x[:, 1])], dim=-1)
    return res


def _rosenbrock_jax(c):
    def res(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0],
                          c * (x[2] - 0.5 * x[1])])
    return res


@pytest.mark.parametrize("speculative", [False, True])
def test_lm_frames_converge_independently(speculative):
    """Frames that stop at different iterations: each frame of the B=3
    batch equals that frame fitted alone, and the vmapped JAX loop."""
    x0 = np.array([[-1.2, 1.0, 0.0], [0.5, 0.5, 2.0], [3.0, -2.0, 1.0]],
                  np.float32)
    c = np.array([1.0, 3.0, 0.3], np.float32)
    opts = TLM.LMOptions(max_iters=30, ftol=1e-6, linsolve="chol",
                         speculative=speculative)
    mask = torch.ones(3)
    xb, lb, itb = TLM.lm_fit(_rosenbrock_torch(torch.from_numpy(c)),
                             torch.from_numpy(x0), mask, opts)
    assert len(set(itb.tolist())) > 1, itb      # frames stop apart
    for i in range(3):
        xi, li, iti = TLM.lm_fit(
            _rosenbrock_torch(torch.from_numpy(c[i:i + 1])),
            torch.from_numpy(x0[i:i + 1]), mask, opts)
        assert iti.item() == itb[i].item()
        np.testing.assert_allclose(xi[0].numpy(), xb[i].numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(li.item(), lb[i].item(), rtol=1e-6,
                                   atol=1e-9)

    jopts = JLM.LMOptions(max_iters=30, ftol=1e-6, linsolve="chol",
                          speculative=speculative)
    xj, lj = jax.vmap(lambda x, cc: JLM.lm_fit(
        _rosenbrock_jax(cc), x, jnp.ones(3), jopts))(jnp.asarray(x0),
                                                     jnp.asarray(c))
    np.testing.assert_allclose(xb.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lb.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-8)
