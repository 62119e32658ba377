"""The port's points collision engine and fused staged LM loop against the
JAX package, on the CPU: the gridless field (`ops/sdf.py:
_sdf_at_points_impl`) and its derivative, `collision_sums_points`,
`make_points_forms`, `fit_people(sdf_engine="points")`, `lm_fit_staged`
and `fit_frame` with `FitConfig.fused`.

Inputs are made by numpy from seeds and handed to both packages.  The
JAX references of the field, its JVP, the sums, the forms and
`fit_people` run in one jitted program (one XLA compile, ~10 s less
than one per reference); that compile and the fused fit's are most of
this module's time.

Tolerances and why:
- the field against JAX: the same inside set; phi atol 1e-5, closest
  atol 1e-5 on the inside set (XLA contracts the pair arithmetic into
  FMAs on the CPU, the port rounds every operation: ROADMAP section C),
  except at near ties of two faces (at most 1 in 1000 inside points;
  measured 0-1 of ~1400 per body, depending on the last bits of the
  vertices), where the roundings pick different faces and JAX's closest
  point must lie at the port's phi from the point (atol 1e-6);
- the port's culled field against its full evaluation, and the field at
  voxel centers against the port's `sdf_grid`: bitwise (the same
  operations per point);
- the JVP against `jax.jvp`: rtol 1e-4 / atol 1e-5 (the direction
  (p - closest) / phi inherits the closest points' few-ulp differences);
- `collision_sums_points`: rtol 1e-5 / atol 1e-6 (sums of a few hundred
  fp32 terms);
- `make_points_forms` against JAX's `jac_fn` and against the port's own
  forward mode: rtol 3e-4 / atol 3e-4 max|J| (`tests/test_multi_person.
  py:316-322`: the closed-form base rows reassociate the chain);
- the mean reprojection error in pixels: rtol 1e-5;
- `fit_people(sdf_engine="points")`: per-person losses rtol 1e-2, sums
  rtol 5e-2, at a budget where both land in one basin (one solo stage,
  chol, classic LM, init_lambda 1.0, `points_iters=2`, `restarts=2`;
  see `tests/test_torch_collide.py`'s docstring);
- `lm_fit_staged` on a toy problem: x rtol 1e-5 / atol 1e-5, stage
  losses rtol 1e-4 (the same steps; `tests/test_torch_fit.py`'s LM
  tolerances); the fused fit against JAX's: stage losses rtol 1e-3 (the
  fit-level tolerance of `tests/test_torch_fit.py`); fused against the
  stage loops: final loss rtol 0.1 (`tests/test_fitting.py:340-351`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, jvp

from mvsmplfitting_tpu.fitting import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.multi_person import fit_people as jfit_people
from mvsmplfitting_tpu.fitting.multi_person import (
    make_points_forms as jmake_points_forms)
from mvsmplfitting_tpu.fitting.stages import default_stages as jdefault_stages
from mvsmplfitting_tpu.fitting.stages import fit_frame as jfit_frame
from mvsmplfitting_tpu.models.camera import Camera as JCamera
from mvsmplfitting_tpu.ops import sdf as J
from mvsmplfitting_tpu_torch import synthetic
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting import multi_person as TM
from mvsmplfitting_tpu_torch.fitting import stages as TS
from mvsmplfitting_tpu_torch.ops import sdf as S
from mvsmplfitting_tpu_torch.ops.forward_mode import jacobian_columns
from mvsmplfitting_tpu_torch.parallel.batched import (BatchedFitInputs,
                                                      batched_fit_frames)

from torch_port_helpers import (icosphere, jax_assets, port_assets,
                                posed_bodies, vposer_pair)

SUMS_CASES = [(2, False), (2, True), (3, False), (3, True)]


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


def _spheres(P):
    """P overlapping tilted UV spheres of 400 vertices and 800 faces (two
    512-face chunks, the second padded) along x."""
    verts, faces = icosphere(radius=0.3, n=20)
    rows = [verts * (1.0 + 0.1 * i) + np.float32([0.35 * i, 0.02 * i, 0.0])
            for i in range(P)]
    return np.stack(rows).astype(np.float32), faces


@pytest.fixture(scope="module")
def field_inputs():
    """The fixtures of the field tests: the icosphere with 5000 uniform
    points (`tests/test_sdf.py:354-384`), two posed full-width bodies
    (each queried with the other's vertices), JVP tangents and the
    spheres of the sums."""
    verts, faces = icosphere(radius=0.55, n=14)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.95, 0.95, (5000, 3)).astype(np.float32)
    local, bfaces = posed_bodies()
    bodies = local.numpy()
    return dict(ico=(pts, verts, faces),
                bodies=[(bodies[1 - i], bodies[i], bfaces.numpy())
                        for i in range(2)],
                tp=rng.normal(0, 1, pts.shape).astype(np.float32),
                tv=rng.normal(0, 1, verts.shape).astype(np.float32),
                spheres={P: _spheres(P) for P in (2, 3)})


@pytest.fixture(scope="module")
def port_field(field_inputs):
    """The port's culled field on the icosphere and both body queries."""
    fi = field_inputs

    def run(p, v, f):
        return [t.numpy() for t in S._sdf_at_points_impl(
            *(torch.from_numpy(a) for a in (p, v, f)))]
    return {"ico": run(*fi["ico"]),
            "bodies": [run(*b) for b in fi["bodies"]]}


@pytest.fixture(scope="module")
def people():
    """The two-person deep-overlap fixture (dx0 = 0.2) in both packages,
    and the refinement state of `tests/test_multi_person.py:300-313`
    (both bodies overlapping, seed 11) as a flat (1, 98) vector."""
    ta, tw, tc, to = synthetic.make_people_problem(0.2, device="cpu")
    jc, jo = _jax_inputs(tc, to)
    P, n = 2, 49
    rng = np.random.default_rng(11)
    base = np.zeros((P, n), np.float32)
    base[0, 45:48] = [-0.1, -0.1, 0.2]
    base[1, 45:48] = [0.1, -0.1, 0.2]
    base[:, 48] = 1.0
    flat = (base + 0.03 * rng.standard_normal((P, n))).reshape(1, -1)
    return dict(ta=ta, tw=tw, tc=tc, to=to, ja=jax_assets("smpl"),
                jw=vposer_pair()[0], jc=jc, jo=jo,
                flat=flat.astype(np.float32))


def _short_fit_cfg(fit_config, energy_spec, lm_options):
    """The points fit's budget where both packages land in one basin, in
    either package: one solo stage (pose 404, shape 100, coll 1000), 3
    classic chol iterations at init_lambda 1.0."""
    return fit_config(spec=energy_spec(interpenetration=True),
                      lm=lm_options(max_iters=3, linsolve="chol",
                                    speculative=False, init_lambda=1.0),
                      pose_weights=(404.0,), shape_weights=(100.0,),
                      coll_weights=(1000.0,))


@pytest.fixture(scope="module")
def jax_refs(field_inputs, people):
    """Every JAX reference of the field, the sums, the forms and
    `fit_people` in one jitted program (one XLA compile: the field's
    scans are shared)."""
    fi, p = field_inputs, people
    P, n = 2, 49
    spec = JE.EnergySpec(interpenetration=True)
    solo = spec.replace(interpenetration=False)
    weights = jdefault_stages(JFitConfig(spec=spec),
                              jnp.asarray(1080.0))[-1]
    _, jac_fn = jmake_points_forms(solo, p["ja"], p["jc"], p["jo"], p["jw"],
                                   None, weights, P, n)
    fit_cfg = _short_fit_cfg(JFitConfig, JE.EnergySpec, JLM.LMOptions)

    @jax.jit
    def refs(ico, bodies, tp, tv, spheres, flat, obs):
        out = {"ico": J._sdf_at_points_impl(*ico),
               "bodies": [J._sdf_at_points_impl(*b) for b in bodies]}
        out["jvp"] = jax.jvp(lambda pp, vv: J.sdf_at_points(pp, vv, ico[2]),
                             (ico[0], ico[1]), (tp, tv))
        out["sums"] = [J.collision_sums_points(spheres[k][0], spheres[k][1],
                                               include_self=inc)
                       for k, inc in SUMS_CASES]
        out["forms"] = jac_fn(flat)
        out["px"] = jax.vmap(lambda x, o: JE.reprojection_error_px(
            solo, p["ja"], p["jc"], o, p["jw"], x))(flat.reshape(P, n), obs)
        res, sums = jfit_people(fit_cfg, p["ja"], p["jc"], obs,
                                vposer_w=p["jw"], points_iters=2)
        out["fit"] = (res.loss, sums, res.params.transl)
        return out
    out = refs(fi["ico"], fi["bodies"], fi["tp"], fi["tv"], fi["spheres"],
               jnp.asarray(p["flat"][0]), p["jo"])
    return jax.tree.map(np.asarray, out)


def _check_field(points, got, want):
    phi, closest, inside = got
    assert inside.sum() > 100 and np.array_equal(inside, want[2])
    np.testing.assert_allclose(phi, want[0], rtol=0.0, atol=1e-5)
    assert not closest[~inside].any() and not phi[~inside].any()
    # Where two faces are nearly equally near, the packages' roundings
    # can pick different ones (a few points in thousands): there JAX's
    # closest point must be as near as the port's.
    cl, cl0, p = closest[inside], want[1][inside], points[inside]
    tie = np.abs(cl - cl0).max(-1) > 1e-5
    assert tie.sum() <= inside.sum() // 1000, tie.sum()
    np.testing.assert_allclose(cl[~tie], cl0[~tie], rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(p[tie] - cl0[tie], axis=-1),
                               phi[inside][tie], rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("case", ["ico", "bodies"])
def test_field_matches_jax(field_inputs, jax_refs, port_field, case):
    """phi, closest and inside against JAX `_sdf_at_points_impl` (the
    bodies: each one's vertices in the other's field)."""
    if case == "ico":
        _check_field(field_inputs["ico"][0], port_field["ico"],
                     jax_refs["ico"])
    else:
        for b, got, want in zip(field_inputs["bodies"], port_field["bodies"],
                                jax_refs["bodies"]):
            _check_field(b[0], got, want)


@pytest.mark.parametrize("case", ["ico", "bodies"])
def test_culled_field_equals_full_bitwise(field_inputs, port_field, case):
    """The candidate and inside culls leave every point's arithmetic as it
    is: the culled result equals the full evaluation bitwise (on the
    bodies with every fourth query vertex, to keep the full pass short)."""
    p, v, f = (field_inputs["ico"] if case == "ico"
               else field_inputs["bodies"][0])
    step = 1 if case == "ico" else 4
    culled = port_field[case] if case == "ico" else port_field["bodies"][0]
    full = S._sdf_at_points_impl(torch.from_numpy(p[::step]),
                                 torch.from_numpy(v), torch.from_numpy(f),
                                 _full=True)
    phi, closest, inside = (t.numpy() for t in full)
    np.testing.assert_array_equal(inside, culled[2][::step])
    np.testing.assert_array_equal(phi, culled[0][::step])
    np.testing.assert_array_equal(closest[inside],
                                  culled[1][::step][inside])


def test_field_at_voxel_centers_equals_sdf_grid():
    """At G=12 voxel centers the point field is the port's `sdf_grid`,
    bitwise (`tests/test_sdf.py:386-397`)."""
    verts, faces = (torch.from_numpy(a) for a in icosphere(radius=0.55,
                                                            n=10))
    grid = S.sdf_grid(verts, faces, 12).reshape(-1)
    assert int((grid > 0).sum()) > 50
    assert torch.equal(S.sdf_at_points(S.voxel_centers(12), verts, faces),
                       grid)


def test_field_jvp_matches_jax(field_inputs, jax_refs):
    """`torch.func.jvp` of `sdf_at_points` against `jax.jvp` of JAX's; a
    tangent in the vertices alone gives 0; `jacrev` equals the Jacobian
    by forward mode over the tangent basis (`jacobian_columns`)."""
    fi = field_inputs
    p, v, f = (torch.from_numpy(a) for a in fi["ico"])
    tp, tv = torch.from_numpy(fi["tp"]), torch.from_numpy(fi["tv"])
    phi, t = jvp(lambda pp, vv: S.sdf_at_points(pp, vv, f), (p, v), (tp, tv))
    want_phi, want_t = jax_refs["jvp"]
    assert np.abs(want_t).max() > 1.0
    np.testing.assert_allclose(phi.numpy(), want_phi, rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-4, atol=1e-5)
    _, t_v = jvp(lambda vv: S.sdf_at_points(p, vv, f), (v,), (tv,))
    assert not t_v.any()

    sub = p[:300].reshape(1, -1)                       # 300 points

    def field(flat):
        return S.sdf_at_points(flat.reshape(-1, 3), v, f)[None]
    J_fwd = jacobian_columns(field, sub)               # (1, 300, 900)
    J_rev = jacrev(field)(sub)                         # (1, 300, 1, 900)
    assert J_fwd.abs().sum() > 10.0
    torch.testing.assert_close(J_rev[:, :, 0], J_fwd, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("P,include_self", SUMS_CASES)
def test_collision_sums_points_match_jax(field_inputs, jax_refs, P,
                                         include_self):
    """Per-person sums of the exact field (detached field frame, live
    query frame; self queries both ways) against JAX's; P = 1 gives 0."""
    verts, faces = field_inputs["spheres"][P]
    got = S.collision_sums_points(torch.from_numpy(verts),
                                  torch.from_numpy(faces),
                                  include_self=include_self)
    want = jax_refs["sums"][SUMS_CASES.index((P, include_self))]
    assert got.shape == (P,) and want.min() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    one = S.collision_sums_points(torch.from_numpy(verts[0]),
                                  torch.from_numpy(faces))
    assert one.shape == (1,) and one.item() == 0.0


def test_points_forms_match_jax(people, jax_refs):
    """`make_points_forms`' (r, J) against JAX's `jac_fn` at the state of
    `tests/test_multi_person.py:300-313` (both bodies overlapping), and
    the port's analytic form against its forward mode of `residual_fn`;
    the mean reprojection error in pixels (`energy.reprojection_error_px`,
    the quality measure of `chip_smoke.py` [points]) against JAX's."""
    p = people
    P, n = 2, 49
    r0, J0 = jax_refs["forms"]
    tcfg = TS.FitConfig(spec=TE.EnergySpec(interpenetration=True))
    tw = TS.default_stages(tcfg, torch.full((P,), 1080.0))[-1]
    res_fn, tjac_fn = TM.make_points_forms(TE.EnergySpec(), p["ta"], p["tc"],
                                           p["to"], p["tw"], None, tw, P, n)
    ft = torch.from_numpy(p["flat"])
    r1, J1 = tjac_fn(ft)
    r2, J2 = TLM.ad_jacobian(res_fn, ft)
    assert r0[-P:].min() > 1e3                 # the collision rows are live
    sc = 3e-4 * np.abs(J0).max()
    np.testing.assert_allclose(r1[0].numpy(), r0, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(J1[0].numpy(), J0, rtol=3e-4, atol=sc)
    np.testing.assert_allclose(r2[0].numpy(), r1[0].numpy(), rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(J2[0].numpy(), J1[0].numpy(), rtol=3e-4,
                               atol=sc)
    px = TE.reprojection_error_px(TE.EnergySpec(), p["ta"], p["tc"], p["to"],
                                  p["tw"], ft.reshape(P, n))
    assert jax_refs["px"].min() > 1.0
    np.testing.assert_allclose(px.numpy(), jax_refs["px"], rtol=1e-5)


def test_fit_people_points_matches_jax(people, jax_refs):
    """`fit_people` with its defaults (the points engine, both starts,
    the forward-mode Jacobian) against the JAX call, at a budget where
    both land in one basin."""
    p = people
    cfg = _short_fit_cfg(TS.FitConfig, TE.EnergySpec, TLM.LMOptions)
    got, got_s = TM.fit_people(cfg, p["ta"], p["tc"], p["to"],
                               vposer_w=p["tw"], points_iters=2,
                               device="cpu")
    loss, sums, transl = jax_refs["fit"]
    assert got.loss.shape == (2,) and got_s.shape == (2,)
    assert got.lm_iters.tolist() == [[4], [4]]     # 2 iterations x 2 starts
    np.testing.assert_allclose(got.loss.numpy(), loss, rtol=1e-2)
    np.testing.assert_allclose(got_s.numpy(), sums, rtol=5e-2)
    np.testing.assert_allclose(got.params.transl.numpy(), transl, atol=1e-2)


@pytest.mark.parametrize("anneal,restarts,jac,want", [
    (True, 2, "ad", [(2, 7, "ad"), (3, 8, "ad")] * 2),
    (False, 1, "analytic", [(3, 15, "analytic")])])
def test_points_schedule(people, monkeypatch, anneal, restarts, jac, want):
    """Which LM solves the points refinement runs (JAX `multi_person.py:
    254-310`): the collision-active stages in order with `points_iters`
    split across them (or the last stage alone), each start in turn;
    the Jacobian form; never speculative; the informed restart moves
    each body 1.5 cm away from the other along the line of centers."""
    calls, starts = [], []

    def fake_lm(res, x, mask, opts, jac_fn=None, aux_fn=None):
        assert not opts.speculative and aux_fn is None
        w = res.__defaults__[0]
        sid = [1000.0, 4500.0].index(float(w.coll)) + 2
        calls.append((sid, opts.max_iters, "ad" if jac_fn is None
                      else "analytic"))
        if not starts or not torch.equal(starts[-1], x):
            starts.append(x.clone())
        return x, torch.zeros(1), torch.full((1,), opts.max_iters,
                                             dtype=torch.int32)
    monkeypatch.setattr(TM, "lm_fit", fake_lm)
    p = people
    cfg = TS.FitConfig(spec=TE.EnergySpec(interpenetration=True),
                       lm=TLM.LMOptions(max_iters=1))
    res, sums = TM.fit_people(cfg, p["ta"], p["tc"], p["to"],
                              vposer_w=p["tw"], points_iters=15,
                              points_anneal=anneal, restarts=restarts,
                              points_jac=jac, device="cpu")
    assert calls == want
    assert res.lm_iters.tolist() == [[sum(c[1] for c in want)]] * 2
    assert sums.shape == (2,) and bool(torch.isfinite(sums).all())
    if restarts == 2:
        a, b = (s.reshape(2, 49)[:, 45:48] for s in starts[:2])
        step = b - a
        np.testing.assert_allclose(step.norm(dim=-1).numpy(), [0.015] * 2,
                                   rtol=1e-3)
        d = a[0] - a[1]
        assert float(step[0] @ d) > 0 and float(step[1] @ d) < 0


def _toy_torch(x, w):
    return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0],
                        w.pose * (x[:, 2] - 0.5 * x[:, 1]),
                        w.data * x[:, 2]], dim=-1)


def _toy_jax(x, w):
    return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0],
                      w.pose * (x[2] - 0.5 * x[1]), w.data * x[2]])


def test_lm_fit_staged_matches_jax():
    """The fused loop on a 3-frame toy whose frames leave their stages at
    different iterations (so frames at different stages share batches),
    with a per-frame weight (`data`) and per-stage ones, against the
    vmapped JAX `lm_fit_staged` (chol, classic acceptance)."""
    x0 = np.array([[-1.2, 1.0, 0.0], [0.5, 0.5, 2.0], [3.0, -2.0, 1.0]],
                  np.float32)
    data = np.array([0.5, 1.0, 2.0], np.float32)
    stages = [TE.StageWeights.make(data=torch.from_numpy(data) * k, pose=pw,
                                   shape=1.0)
              for k, pw in ((1.0, 3.0), (0.5, 1.0), (0.1, 0.3))]
    opts = TLM.LMOptions(max_iters=12, ftol=1e-6, linsolve="chol",
                         speculative=False)
    x, losses, iters = TLM.lm_fit_staged(
        _toy_torch, torch.from_numpy(x0), torch.ones(3),
        TLM.stack_stages(stages), 3, opts)
    assert len({tuple(r) for r in iters.tolist()}) > 1, iters

    jtab = JE.StageWeights(
        data=jnp.asarray(np.stack([data * k for k in (1.0, 0.5, 0.1)], 1)),
        pose=jnp.asarray([[3.0, 1.0, 0.3]] * 3),
        shape=jnp.ones((3, 3)), bending=jnp.ones((3, 3)),
        coll=jnp.zeros((3, 3)))
    jopts = JLM.LMOptions(max_iters=12, ftol=1e-6, linsolve="chol",
                          speculative=False)
    xj, lj = jax.vmap(lambda xx, tab: JLM.lm_fit_staged(
        _toy_jax, xx, jnp.ones(3), tab, 3, jopts))(jnp.asarray(x0), jtab)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-8)


def test_fused_fit_matches_jax():
    """`fit_frame` with `fused=True` (init + 4 stages in one loop, chol,
    classic LM, 3 iterations per stage) on 2 frames against JAX's fused
    fit; and the port's fused fit against its stage loops."""
    _, _, tc, to = synthetic.make_problem(6, 2, seed=0, device="cpu")
    ja, (jw, tw) = jax_assets("smpl"), vposer_pair()
    jc, jo = _jax_inputs(tc, to)
    lm = dict(max_iters=3, linsolve="chol", speculative=False)
    jcfg = JFitConfig(lm=JLM.LMOptions(**lm), fused=True)

    def one(o):
        g = jinit_guess(ja, jc, o.gt2d, o.conf, o.view_mask)
        return jfit_frame(jcfg, ja, jc, o, g.params, g.z, vposer_w=jw,
                          img_height=1080.0)
    want = np.asarray(jax.jit(jax.vmap(one))(jo).stage_losses)

    ta = port_assets("smpl")
    batch = BatchedFitInputs(to, torch.full((2,), 1080.0))
    cfg = TS.FitConfig(lm=TLM.LMOptions(**lm), fused=True)
    got = batched_fit_frames(cfg, ta, tc, batch, vposer_w=tw, device="cpu")
    assert want.shape == (2, 4) and not np.allclose(want[0], want[1])
    np.testing.assert_allclose(got.stage_losses.numpy(), want, rtol=1e-3)
    assert got.lm_iters.tolist() == [[3] * 4] * 2
    assert torch.equal(got.loss, got.stage_losses[:, -1])
    loops = batched_fit_frames(dataclasses.replace(cfg, fused=False), ta,
                               tc, batch, vposer_w=tw, device="cpu")
    np.testing.assert_allclose(got.loss.numpy(), loops.loss.numpy(),
                               rtol=0.1)
