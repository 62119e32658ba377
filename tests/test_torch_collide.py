"""The port's collision fits against the JAX package, on the CPU: the
collision rows of the single-person energy, the lagged-SDF LM hook, the
multi-person grid-engine refinement forms and `fit_people` itself.

Inputs come from the port's synthetic fixtures (numpy seeds) and are
handed to JAX as arrays.  On the CPU the voxelizer is the plain
`sdf_grid`.

Tolerances and why:
- residual rows: rtol 1e-5, atol 1e-5 max|r| (fp32; the collision rows
  are sums over 6890 or 13780 trilinear samples);
- Jacobians against JAX's forward mode (`jax.jvp` / `jax.linearize`):
  rtol 1e-4, atol 1e-4 max|J v| (AD through LBS, VPoser and the sampler
  in another order);
- LM with `aux_fn` on a small problem: x rtol 1e-5, loss rtol 1e-5 (chol,
  classic LM: the same steps);
- `fit_people`: per-person losses rtol 1e-2 and collision sums rtol 5e-2.
  The joint refinement is chaotic on the deep-overlap fixture
  (`multi_person.py:145-152`): its first normal equations at the default
  init_lambda 1e-3 are so ill-conditioned in fp32 that the two packages'
  Cholesky steps differ and land in different basins (measured at G=16:
  sums [3.57, 5.82] vs [3.71, 4.10]).  With init_lambda 1.0, one stage
  of 3 classic chol iterations at the first stage's prior weights (pose
  404, shape 100) and coll weight 1000, then 1 lagged and 1 exact
  refinement iteration, both land in one basin (measured 2.6e-6 on the
  losses and 2e-4 on the sums at G=8, 0.8% on the sums at G=16).  At the
  last stage's prior weights (57.4, 10) one stage lands in different
  basins (sums 3.6% apart at G=8); one stage instead of two saves ~12 s
  of XLA compile.

The JAX programs are compiled once per module (the linearizations in
one program at G=8, `fit_people` once): their XLA compile is most of
this module's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.fitting import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.multi_person import fit_people as jfit_people
from mvsmplfitting_tpu.fitting.stages import default_stages as jdefault_stages
from mvsmplfitting_tpu.models import vposer as jvposer
from mvsmplfitting_tpu.models.camera import Camera as JCamera
from mvsmplfitting_tpu.models.smpl import smpl_forward as jsmpl_forward
from mvsmplfitting_tpu.ops import sdf as JS
from mvsmplfitting_tpu_torch import synthetic
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting import multi_person as TM
from mvsmplfitting_tpu_torch.fitting import stages as TS

from torch_port_helpers import jax_assets, vposer_pair

G_LIN = 8       # the grid of the linearization checks


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Each test worker shares the CPU with others: a torch op spread
    over every core stalls on the busiest one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_inputs(tc, to):
    cam = JCamera(**{f: jnp.asarray(getattr(tc, f).numpy())
                     for f in ("rotation", "translation", "focal",
                               "center")})
    obs = JE.Observations(**{f: jnp.asarray(getattr(to, f).numpy())
                             for f in ("gt2d", "conf", "view_mask",
                                       "joint_weights")})
    return cam, obs


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def people():
    """The two-person deep-overlap fixture (dx0 = 0.2) in both packages,
    a parameter vector near the truth (1, 2 * 49), a second one near it
    and a random tangent direction."""
    ta, tw, tc, to = synthetic.make_people_problem(0.2, device="cpu")
    jc, jo = _jax_inputs(tc, to)
    rng = np.random.default_rng(7)          # the fixture's own draws
    zs, betas = [], []
    for _ in range(2):
        zs.append(0.2 * rng.standard_normal(32))
        betas.append(0.3 * rng.standard_normal(10))
    x = np.concatenate([np.array(zs), np.array(betas),
                        [[0.1, 0.2, 0.0]] * 2,
                        [[-0.2, -0.1, 0.2], [0.2, -0.1, 0.2]],
                        [[1.0], [1.0]]], 1)
    x = x + np.random.default_rng(0).normal(0, 0.02, x.shape)
    flat = x.reshape(1, -1).astype(np.float32)
    rng = np.random.default_rng(3)
    return dict(ta=ta, tw=tw, tc=tc, to=to, ja=jax_assets("smpl"),
                jw=vposer_pair()[0], jc=jc, jo=jo, flat=flat,
                flat_b=(flat + rng.normal(0, 0.01, flat.shape)).astype(
                    np.float32),
                dir=rng.normal(0, 1.0, flat.shape).astype(np.float32))


def test_collision_term_is_ported():
    spec = TE.EnergySpec(interpenetration=True)
    assert spec.coll_grid_size == JE.EnergySpec().coll_grid_size == 32
    jspec = JE.EnergySpec(interpenetration=True)
    assert TE.num_unknowns(spec) == JE.num_unknowns(jspec) == 49
    np.testing.assert_array_equal(TE.free_mask(spec).numpy(),
                                  np.asarray(JE.free_mask(jspec)))


def test_single_person_collision_rows_match_jax(people, linearized):
    """The energy's collision row (each person alone, as a frame, sampled
    in its own field: `energy.py:439-447` with P = 1) and the collision
    stage's Jacobian (grids voxelized at x and held fixed) against JAX's
    residuals and forward mode; `sum(r^2) == total_energy` with the term
    on."""
    p, want = people, linearized
    ta, tw, tc, to = p["ta"], p["tw"], p["tc"], p["to"]
    cfg = TS.FitConfig(spec=TE.EnergySpec(interpenetration=True,
                                          coll_grid_size=G_LIN))
    weights = TE.StageWeights.make(data=torch.full((2,), 500 / 1080.0),
                                   pose=57.4, shape=10.0, coll=1000.0)
    xt = torch.from_numpy(p["flat"].reshape(2, 49))
    r1 = TE.residuals(cfg.spec, ta, tc, to, weights, tw, None, xt)
    jac_fn = TS.stage_jacobian(cfg, ta, tc, to, weights, tw, None)
    r2, J = jac_fn(xt)
    r0 = want["single"]
    assert r1.shape == r0.shape and r0[:, -1].min() > 1.0
    _close(r1.numpy(), r0, 1e-5)
    np.testing.assert_array_equal(r2.numpy(), r1.numpy())
    v = torch.from_numpy(p["dir"].reshape(2, 49))
    _close(torch.einsum("bmn,bn->bm", J, v).numpy(), want["single_t"], 1e-4)
    e = TE.total_energy(cfg.spec, ta, tc, to, weights, tw, None, xt)
    np.testing.assert_allclose(e.numpy(), (r1 * r1).sum(-1).numpy(),
                               rtol=1e-5)
    with pytest.raises(ValueError):
        TE.residual_jacobian(cfg.spec, ta, tc, to, weights, tw, None, xt)


def _toy_torch(x, aux):
    A = torch.tensor([[2.0, 0.5, 0.0], [0.3, 1.5, -0.2], [0.0, 0.4, 1.0]])
    return torch.cat([x @ A.T - 1.0, 3.0 * (x - aux), 0.5 * x ** 2], -1)


def _toy_jax(x, aux):
    A = jnp.asarray([[2.0, 0.5, 0.0], [0.3, 1.5, -0.2], [0.0, 0.4, 1.0]])
    return jnp.concatenate([A @ x - 1.0, 3.0 * (x - aux), 0.5 * x ** 2])


def test_lm_aux_fn_matches_jax():
    """The lagged hook: aux = 0.5 sin(x) at each iterate, held through
    the Jacobian and the trial step (chol, classic LM)."""
    x0 = np.array([[0.8, -1.2, 2.0]], np.float32)
    opts = TLM.LMOptions(max_iters=6, linsolve="chol", speculative=False)
    calls = []

    def aux(x):
        calls.append(x.requires_grad)
        return 0.5 * torch.sin(x)
    x1, l1, it = TLM.lm_fit(_toy_torch, torch.from_numpy(x0),
                            torch.ones(3), opts, aux_fn=aux)
    jopts = JLM.LMOptions(max_iters=6, linsolve="chol", speculative=False)
    x2, l2 = JLM.lm_fit(_toy_jax, jnp.asarray(x0[0]), jnp.ones(3), jopts,
                        aux_fn=lambda x: 0.5 * jnp.sin(x))
    np.testing.assert_allclose(x1[0].numpy(), np.asarray(x2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(l1.item(), float(l2), rtol=1e-5)
    assert it.item() == 6 and len(calls) == 7 and not any(calls)
    for bad in (dict(opts=TLM.LMOptions()),
                dict(opts=opts, jac_fn=lambda x: None)):
        with pytest.raises(ValueError):
            TLM.lm_fit(_toy_torch, torch.from_numpy(x0), torch.ones(3),
                       bad.pop("opts"), aux_fn=aux, **bad)


def _jax_forms(p, G):
    """JAX `fit_people`'s grid-engine closures (`multi_person.py:
    250-289`), rebuilt from its public functions, and the single-person
    residuals with the collision term on (each person as a frame)."""
    ja, jw, jc, jo = p["ja"], p["jw"], p["jc"], p["jo"]
    spec = JE.EnergySpec(interpenetration=True, coll_grid_size=G)
    cfg = JFitConfig(spec=spec, pose_weights=(404.0, 57.4),
                     shape_weights=(100.0, 10.0), coll_weights=(0.0, 1000.0))
    weights = jdefault_stages(cfg, jnp.asarray(1080.0, jnp.float32))[-1]
    solo = JE.EnergySpec(coll_grid_size=G)
    P, n = 2, 49

    def all_verts(xs):
        def one(x):
            params, z = JE.unpack(solo, x)
            return jsmpl_forward(ja, params, jvposer.decode(jw, z))[0]
        return jax.vmap(one)(xs)

    def rows(xs, spec=solo):
        return jax.vmap(lambda x, o: JE.residuals(
            spec, ja, jc, o, weights, jw, None, x))(xs, jo)

    def grids_of(f):
        return JS.person_grids(all_verts(f.reshape(P, n)), ja.faces, G)

    def lagged(f, grids):
        xs = f.reshape(P, n)
        s = JS.collision_sums_sampled(*grids, all_verts(xs))
        return jnp.concatenate([rows(xs).reshape(-1), weights.coll * s / P])

    def exact(f):
        xs = f.reshape(P, n)
        s = JS.collision_sums(all_verts(xs), ja.faces, G)
        return jnp.concatenate([rows(xs).reshape(-1), weights.coll * s / P])

    def single(f):
        return rows(f.reshape(P, n), spec)
    return grids_of, lagged, exact, single


@pytest.fixture(scope="module")
def linearized(people):
    """JAX's values and tangents at G_LIN, in one compiled program (its
    XLA compile is most of this module's time): the single-person rows
    at xa; the lagged form at xb with the grids of xa; the exact form at
    xb through `jax.linearize`; each tangent along one random direction
    (a wrong column shows in it)."""
    grids_of, lagged, exact, single = _jax_forms(people, G_LIN)

    @jax.jit
    def jax_side(fa, fb, d):
        grids = grids_of(fa)
        r_s, t_s = jax.jvp(single, (fa,), (d,))
        r_l, t_l = jax.jvp(lambda f: lagged(f, grids), (fb,), (d,))
        r_e, lin = jax.linearize(exact, fb)
        return dict(single=r_s, single_t=t_s, lagged=r_l, lagged_t=t_l,
                    exact=r_e, exact_t=lin(d))
    out = jax_side(*(jnp.asarray(people[k][0])
                     for k in ("flat", "flat_b", "dir")))
    return {k: np.asarray(v) for k, v in out.items()}


def test_refinement_forms_match_jax(people, linearized):
    """At a fixed x near the deep-overlap truth: the lagged form with
    grids from another point, and the exact form with its Jacobian
    (fields held fixed, live box frame), against JAX's residuals, its
    forward mode and `jax.linearize`."""
    p, want, G = people, linearized, G_LIN
    ta, tw, tc, to = p["ta"], p["tw"], p["tc"], p["to"]
    cfg = TS.FitConfig(spec=TE.EnergySpec(interpenetration=True,
                                          coll_grid_size=G),
                       pose_weights=(404.0, 57.4),
                       shape_weights=(100.0, 10.0),
                       coll_weights=(0.0, 1000.0))
    weights = TS.default_stages(cfg, torch.full((2,), 1080.0))[-1]
    forms = TM.make_grid_forms(TE.EnergySpec(coll_grid_size=G), ta, tc, to,
                               tw, None, weights, 2, 49, G)
    tb = torch.from_numpy(p["flat_b"])
    grids = forms.grids_of(torch.from_numpy(p["flat"]))
    r_lag, J_lag = TLM.ad_jacobian(lambda f: forms.joint_residual(f, grids),
                                   tb)
    r_ex, J_ex = forms.jac_exact(tb)
    tv = torch.from_numpy(p["dir"][0])
    _close(r_lag[0].numpy(), want["lagged"], 1e-5)
    _close((J_lag[0] @ tv).numpy(), want["lagged_t"], 1e-4)
    _close(r_ex[0].numpy(), want["exact"], 1e-5)
    _close((J_ex[0] @ tv).numpy(), want["exact_t"], 1e-4)
    np.testing.assert_array_equal(forms.residual_exact(tb).numpy(),
                                  r_ex.numpy())
    assert want["exact"][-2:].min() > 1e3       # the bodies overlap


def test_fit_people_grid_matches_jax(people):
    """`fit_people` with the grid engine, hybrid schedule (1 lagged + 1
    exact refinement iteration) at G=8, against the JAX call; the
    weights, budget and init_lambda 1.0 are ones where both land in one
    basin (see the module docstring)."""
    p, G = people, 8
    kw = dict(pose_weights=(404.0,), shape_weights=(100.0,),
              coll_weights=(1000.0,))
    jcfg = JFitConfig(
        spec=JE.EnergySpec(interpenetration=True, coll_grid_size=G),
        lm=JLM.LMOptions(max_iters=3, linsolve="chol", speculative=False,
                         init_lambda=1.0), **kw)
    want, want_s = jax.jit(lambda o: jfit_people(
        jcfg, p["ja"], p["jc"], o, vposer_w=p["jw"], sdf_engine="grid",
        refine_iters=1, polish_iters=1))(p["jo"])
    cfg = TS.FitConfig(
        spec=TE.EnergySpec(interpenetration=True, coll_grid_size=G),
        lm=TLM.LMOptions(max_iters=3, linsolve="chol", speculative=False,
                         init_lambda=1.0), **kw)
    got, got_s = TM.fit_people(cfg, p["ta"], p["tc"], p["to"],
                               vposer_w=p["tw"], sdf_engine="grid",
                               refine_iters=1, polish_iters=1,
                               device="cpu")
    assert got.loss.shape == (2,) and got_s.shape == (2,)
    assert got.lm_iters.tolist() == [[2], [2]]
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-2)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=5e-2)
    np.testing.assert_allclose(got.params.transl.numpy(),
                               np.asarray(want.params.transl), atol=1e-2)


@pytest.mark.parametrize("mode,want", [
    ("hybrid", [("aux", 4), ("jac", 2)]),
    ("lagged", [("aux", 15)]), (True, [("aux", 15)]),
    ("exact", [("jac", 15)]), (False, [("jac", 15)])])
def test_fit_people_refinement_schedules(people, monkeypatch, mode, want):
    """Which LM solves each `lagged_sdf` mode runs (JAX `multi_person.py:
    311-323`): the lagged ones with the grids as aux state, the exact
    ones with the held-grid Jacobian; never speculative."""
    calls = []

    def fake_lm(res, x, mask, opts, jac_fn=None, aux_fn=None):
        assert not opts.speculative
        assert (aux_fn is None) != (jac_fn is None)
        calls.append(("aux" if aux_fn else "jac", opts.max_iters))
        return x, torch.zeros(1), torch.full((1,), opts.max_iters,
                                             dtype=torch.int32)
    monkeypatch.setattr(TM, "lm_fit", fake_lm)
    p = people
    cfg = TS.FitConfig(spec=TE.EnergySpec(interpenetration=True,
                                          coll_grid_size=8),
                       lm=TLM.LMOptions(max_iters=1), pose_weights=(57.4,),
                       shape_weights=(10.0,), coll_weights=(1000.0,))
    res, sums = TM.fit_people(cfg, p["ta"], p["tc"], p["to"],
                              vposer_w=p["tw"], sdf_engine="grid",
                              lagged_sdf=mode, refine_iters=4,
                              polish_iters=2, device="cpu")
    assert calls == want
    assert res.lm_iters.tolist() == [[sum(n for _, n in want)]] * 2
    assert sums.shape == (2,) and bool(torch.isfinite(sums).all())
