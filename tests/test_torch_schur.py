"""The port's shared-shape Schur sequence fit against JAX's
`schur_sequence_fit(mesh=None)`, on the CPU.

Tolerances and why:
- the split, the assembled layout and the one-person sequence generator's
  truth: exact; its pixels rtol 1e-5 (fp32 forwards of two packages);
- `_spd_inv`: rtol 1e-4, atol 1e-5 max|A^-1| (Cholesky in fp32 on a
  cond ~1e3 system, as `test_torch_fit.py:test_solve_spd`);
- the fits (one stage, 6 LM iterations, B=4): the shared block and the
  per-frame losses at rtol 1e-3 (the fit-level tolerance of
  `test_torch_fit.py`; the sequence shares one lambda and one accept,
  so the frames' fp32 differences add up in the accept test).

Each JAX fit is jitted once (with the initialization); the analytic and
AD branches differ only in whether the assets carry the joint model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.stages import FitConfig as JFitConfig
from mvsmplfitting_tpu.models.camera import Camera as JCamera
from mvsmplfitting_tpu.models.smpl import SMPLParams as JParams
from mvsmplfitting_tpu.parallel import schur as JS
from mvsmplfitting_tpu_torch import synthetic
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
from mvsmplfitting_tpu_torch.parallel import schur as TS

from torch_port_helpers import jax_assets, jax_observations, vposer_pair

B = 4
OPTS = dict(max_iters=6, linsolve="chol", speculative=False)
ONE_STAGE = dict(pose_weights=(57.4,), shape_weights=(10.0,),
                 coll_weights=(0.0,))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seq():
    """One person over B frames with one shape, in both packages (the
    JAX assets carry the port-built joint model)."""
    ta, tw, tc, to, cols = synthetic.make_person_sequence(B, seed=0,
                                                          device="cpu")
    jw, _ = vposer_pair()
    jc = JCamera(**{f: jnp.asarray(getattr(tc, f).numpy())
                    for f in ("rotation", "translation", "focal", "center")})
    return dict(ta=ta, tw=tw, tc=tc, to=to, cols=cols, ja=jax_assets("smpl"),
                jw=jw, jc=jc, jo=jax_observations(to))


def _jax_fit(s, jcfg, ja):
    def run(o):
        g = jax.vmap(lambda oo: jinit_guess(ja, s["jc"], oo.gt2d, oo.conf,
                                            oo.view_mask))(o)
        _, _, losses, shared = JS.schur_sequence_fit(
            jcfg, ja, s["jc"], o, g.params, g.z, vposer_w=s["jw"],
            img_height=1080.0)
        return losses, shared
    losses, shared = jax.jit(run)(s["jo"])
    return np.asarray(losses), np.asarray(shared)


def _port_fit(s, cfg, ta):
    g = init_guess(ta, s["tc"], s["to"].gt2d, s["to"].conf,
                   s["to"].view_mask)
    return TS.schur_sequence_fit(cfg, ta, s["tc"], s["to"], g.params, g.z,
                                 vposer_w=s["tw"], device="cpu")


def test_split_and_assemble_match_jax():
    for kw in ({}, dict(use_vposer=False)):
        tspec, jspec = TE.EnergySpec(**kw), JE.EnergySpec(**kw)
        assert TS.split_dims(tspec) == JS.split_dims(jspec)
        nf, ns = TS.split_dims(tspec)
        rng = np.random.default_rng(1)
        xf = rng.normal(size=(3, nf)).astype(np.float32)
        xs = rng.normal(size=ns).astype(np.float32)
        got = TS._assemble_x(tspec, torch.from_numpy(xf), torch.from_numpy(xs))
        for b in range(3):
            want = JS._assemble_x(jspec, jnp.asarray(xf[b]), jnp.asarray(xs))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_spd_inv_matches_jax():
    rng = np.random.default_rng(2)
    n = 38
    M = rng.normal(0, 1, (3, 2 * n, n)) * rng.uniform(0.1, 10, (3, 1, n))
    A = (np.einsum("bmi,bmj->bij", M, M) + 1e-3 * np.eye(n)
         ).astype(np.float32)
    got = TLM._spd_inv(torch.from_numpy(A)).numpy()
    want = np.asarray(jax.vmap(JLM._spd_inv)(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_person_sequence_matches_jax_fixture(seq):
    """The generator's truth follows the draws of JAX's Schur test fixture
    (`tests/test_schur.py:31-63`: shared betas, then one latent per
    frame, orientation 0.1 f and translation 0.05 f) for the first 16
    frames, and its pixels are JAX's forward and projection of it."""
    from mvsmplfitting_tpu.models import vposer as jvp
    from mvsmplfitting_tpu.models.camera import project_points as jproject
    from mvsmplfitting_tpu.models.smpl import smpl_forward as jsmpl_forward
    rng = np.random.default_rng(0)
    betas = 0.5 * rng.standard_normal(10)
    zs = np.stack([0.3 * rng.standard_normal(32) for _ in range(B)])
    cols = seq["cols"]
    np.testing.assert_array_equal(cols["betas"], np.tile(
        betas.astype(np.float32), (B, 1)))
    np.testing.assert_array_equal(cols["scale"], np.full(B, np.float32(1.15)))
    f = np.arange(B, dtype=np.float32)
    np.testing.assert_allclose(cols["global_orient"], np.stack(
        [0.1 * f, np.full(B, 0.3), np.full(B, -0.1)], -1), rtol=1e-6)
    np.testing.assert_allclose(cols["transl"], np.stack(
        [0.05 * f, np.full(B, -0.2), np.full(B, 0.3)], -1), rtol=1e-6)

    ja = seq["ja"]

    def one(c, z):
        params = JParams(body_pose=jnp.zeros(69), **c)
        _, joints = jsmpl_forward(ja, params, jvp.decode(seq["jw"], z))
        return jproject(seq["jc"], joints)
    want = jax.jit(jax.vmap(one))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        jnp.asarray(zs.astype(np.float32)))
    np.testing.assert_allclose(seq["to"].gt2d.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)
    # Past 16 frames the drift turns back (triangle wave of period 32).
    _, long_cols = synthetic.person_sequence_truth(40, seed=0)
    assert long_cols["transl"][:, 0].max() == np.float32(0.05 * 16)
    np.testing.assert_array_equal(long_cols["transl"][20],
                                  long_cols["transl"][12])


@pytest.mark.parametrize("branch", ["analytic", "ad"])
def test_schur_matches_jax(seq, branch):
    """The whole sequence's shared block and per-frame losses against JAX
    through the closed-form Jacobian (joint model attached) and the AD
    one (no joint model, so both packages differentiate the full
    forward)."""
    ta, ja = seq["ta"], seq["ja"]
    if branch == "ad":
        ta = dataclasses.replace(ta, joint_model=None)
        ja = ja.replace(joint_model=None)
    jcfg = JFitConfig(lm=JLM.LMOptions(**OPTS), **ONE_STAGE)
    cfg = FitConfig(lm=TLM.LMOptions(**OPTS), **ONE_STAGE)
    assert TE.analytic_jac_ok(cfg.spec, ta) == (branch == "analytic")
    want_losses, want_shared = _jax_fit(seq, jcfg, ja)
    params, z, losses, shared, iters = _port_fit(seq, cfg, ta)
    assert iters == [OPTS["max_iters"]]
    np.testing.assert_allclose(shared.numpy(), want_shared, rtol=1e-3)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-3)
    # One shape and scale for every frame.
    assert torch.equal(params.betas, shared[:10].expand(B, 10))
    assert torch.equal(params.scale, shared[10].expand(B))
    assert z.shape == (B, 32)


def test_schur_fix_shape_and_scale(seq):
    """fix_shape / fix_scale keep the shared block at frame 0's start."""
    g = init_guess(seq["ta"], seq["tc"], seq["to"].gt2d, seq["to"].conf,
                   seq["to"].view_mask)
    start = torch.cat([g.params.betas[0], g.params.scale[:1]])
    for kw, frozen in ((dict(fix_scale=True), slice(10, 11)),
                       (dict(fix_shape=True), slice(0, 10))):
        cfg = FitConfig(spec=TE.EnergySpec(**kw),
                        lm=TLM.LMOptions(**dict(OPTS, max_iters=2)),
                        **ONE_STAGE)
        _, _, _, shared, _ = _port_fit(seq, cfg, seq["ta"])
        assert torch.equal(shared[frozen], start[frozen]), kw
        free = torch.ones(11, dtype=torch.bool)
        free[frozen] = False
        assert not torch.equal(shared[free], start[free]), kw


def test_collision_gate_differs_from_jax(seq):
    """On a stage with the collision term on, the port linearizes the
    residuals with their collision row: `stage_jacobian` gates the
    closed form off, as the batched fit does (`fitting/stages.py:116`).
    JAX's `use_analytic` (`schur.py:100`) ignores that gate: with the
    joint model attached it linearizes `residual_jacobian`, which is the
    residual vector without the collision row, while its trial loss
    (`residuals`) keeps the row.  That is where the two fits part."""
    from mvsmplfitting_tpu_torch.fitting.stages import stage_jacobian
    spec_kw = dict(interpenetration=True, coll_grid_size=8)
    jspec, tspec = JE.EnergySpec(**spec_kw), TE.EnergySpec(**spec_kw)
    jw = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0,
                              coll=1000.0)
    tw = TE.StageWeights.make(data=torch.full((2,), 500 / 1080.0),
                              pose=57.4, shape=10.0, coll=1000.0)
    g = init_guess(seq["ta"], seq["tc"], seq["to"].gt2d, seq["to"].conf,
                   seq["to"].view_mask)
    x = TE.pack(tspec, g.params, g.z)[:2]
    obs = TE.Observations(*(None if t is None else t[:2]
                            for t in dataclasses.astuple(seq["to"])))
    jo = jax.tree.map(lambda t: t[0], seq["jo"])
    assert JE.analytic_jac_ok(jspec, seq["ja"])

    def jax_rows(xx):
        r_lin, _ = JE.residual_jacobian(jspec, seq["ja"], seq["jc"], jo, jw,
                                        seq["jw"], None, xx)
        return r_lin, JE.residuals(jspec, seq["ja"], seq["jc"], jo, jw,
                                   seq["jw"], None, xx)
    r_lin, r_full = jax.jit(jax_rows)(jnp.asarray(x[0].numpy()))
    r_lin, r_full = np.asarray(r_lin), np.asarray(r_full)
    assert r_full.shape[0] == r_lin.shape[0] + 1
    np.testing.assert_allclose(r_lin, r_full[:-1], rtol=1e-5,
                               atol=1e-5 * np.abs(r_full).max())
    assert abs(r_full[-1]) > 1.0          # the row JAX leaves out

    cfg = FitConfig(spec=tspec, lm=TLM.LMOptions(**OPTS), **ONE_STAGE)
    jac = stage_jacobian(cfg, seq["ta"], seq["tc"], obs, tw, seq["tw"],
                         None)
    r, J = jac(x)
    want = TE.residuals(tspec, seq["ta"], seq["tc"], obs, tw, seq["tw"],
                        None, x)
    assert r.shape == want.shape == (2, r_full.shape[0])
    torch.testing.assert_close(r, want)
    assert J.shape == (2, r_full.shape[0], x.shape[1])
    assert float(J[:, -1].abs().max()) > 0.0   # the collision row moves
    np.testing.assert_allclose(r[0, -1].item(), r_full[-1], rtol=1e-3)

    # The Schur fit runs such a stage end to end on the port.
    sched = dict(pose_weights=(57.4,), shape_weights=(10.0,),
                 coll_weights=(1000.0,))
    cfg = FitConfig(spec=tspec, lm=TLM.LMOptions(**dict(OPTS, max_iters=2)),
                    **sched)
    _, _, losses, shared, iters = TS.schur_sequence_fit(
        cfg, seq["ta"], seq["tc"], obs,
        TE.unpack(tspec, x)[0], g.z[:2], vposer_w=seq["tw"], device="cpu")
    assert torch.isfinite(losses).all() and torch.isfinite(shared).all()
    assert iters == [2]


def test_tail_blocks_refused(seq):
    """The port refuses SMPL-H/X tail blocks; JAX's split leaves them out
    and its fit runs as if they were absent: the hands stay at the mean,
    no tail block comes back, and the losses equal those of the spec
    without them."""
    spec_kw = dict(hand_dim=6)
    with pytest.raises(ValueError, match="tail blocks"):
        TS.split_dims(TE.EnergySpec(**spec_kw))
    cfg = FitConfig(spec=TE.EnergySpec(**spec_kw), lm=TLM.LMOptions(**OPTS),
                    **ONE_STAGE)
    g = init_guess(seq["ta"], seq["tc"], seq["to"].gt2d, seq["to"].conf,
                   seq["to"].view_mask)
    with pytest.raises(ValueError):
        TS.schur_sequence_fit(cfg, seq["ta"], seq["tc"], seq["to"],
                              g.params, g.z, vposer_w=seq["tw"],
                              device="cpu")

    # JAX: the split and the assembled vector leave the tail out, so the
    # residuals read the tail blocks past its end as empty blocks: the
    # hands sit at the mean and the objective is the plain spec's.  The
    # fit's params are built without tail blocks (`schur.py:254-263`).
    ja = jax_assets("smplh")
    jspec = JE.EnergySpec(**spec_kw)
    assert JS.split_dims(jspec) == JS.split_dims(JE.EnergySpec())
    nf, ns = JS.split_dims(jspec)
    rng = np.random.default_rng(3)
    xf = jnp.asarray(rng.normal(0, 0.1, nf).astype(np.float32))
    xs = jnp.asarray(np.r_[rng.normal(0, 0.1, 10), 1.0].astype(np.float32))
    x = JS._assemble_x(jspec, xf, xs)
    assert x.shape[0] == JE.num_unknowns(jspec) - 12
    params, _ = JE.unpack(jspec, x)
    assert params.left_hand_pose.shape == (0,)
    K = int(ja.joint_map.shape[0])
    o = jax.tree.map(lambda t: t[0], seq["jo"])
    o = o.replace(gt2d=o.gt2d[:, :K], conf=o.conf[:, :K],
                  joint_weights=o.joint_weights[:K])
    w = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0)

    def rows(spec):
        return JE.residuals(spec, ja, seq["jc"], o, w, seq["jw"], None, x)
    r_tail, r_plain = jax.jit(lambda: (rows(jspec),
                                       rows(JE.EnergySpec())))()
    np.testing.assert_array_equal(np.asarray(r_tail), np.asarray(r_plain))
