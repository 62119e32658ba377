"""The port's GMM prior, 3D-joint term, sequence warm start, adjustment
refit and SMPL loaders against the JAX package, on the CPU.

Tolerances and why:
- GMM `merged_nll` / `log_likelihood` / `residuals`: rtol 1e-5 (fp32
  einsums over 69x69 precisions in another order); `random_gmm` and
  `load_gmm`: bitwise (the same float64 numpy build, one cast);
- energy rows rtol 1e-5, atol 1e-5 max|r|; the Jacobian at
  `tests/test_joint_jac.py:_tol` (rtol 2e-4, atol 2e-4 max|J|);
  sum(r^2) == total_energy at rtol 1e-5 where no GMM offset enters;
- staged fits (chol, classic LM) at B=2: stage losses rtol 1e-3 (the
  fit-level tolerance of `test_torch_fit.py`);
- the warm start's per-frame choice and the loaders: exact.

The JAX fits are compiled once per module: the GMM fit in one program,
the sequence steps and the refit in another.
"""

import dataclasses
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.adjust import \
    refit_with_observations as jrefit
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.initialize import warm_start as jwarm_start
from mvsmplfitting_tpu.fitting.stages import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting.stages import fit_frame as jfit_frame
from mvsmplfitting_tpu.models import assets as JA
from mvsmplfitting_tpu.models import priors as JP
from mvsmplfitting_tpu.models.camera import project_points as jproject
from mvsmplfitting_tpu.models.smpl import SMPLParams as JParams
from mvsmplfitting_tpu.models.smpl import smpl_forward as jsmpl_forward
from mvsmplfitting_tpu_torch import convert
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting.adjust import refit_with_observations
from mvsmplfitting_tpu_torch.fitting.initialize import init_guess, warm_start
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig, fit_frame
from mvsmplfitting_tpu_torch.models import assets as TA
from mvsmplfitting_tpu_torch.models import priors as TP
from mvsmplfitting_tpu_torch.models.camera import project_points
from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward

from torch_port_helpers import arrays, fit_problem, jax_observations


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def gmms():
    return JP.random_gmm(), TP.random_gmm(device="cpu")


# --- the GMM prior ---------------------------------------------------------

def test_random_gmm_bitwise(gmms):
    jg, tg = gmms
    for f in ("means", "precisions", "prec_chol", "nll_weights"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    assert tg.means.shape == (8, 69)


def test_gmm_functions_match_jax(gmms):
    jg, tg = gmms
    pose = np.random.default_rng(0).normal(0, 0.6, (16, 69)).astype(
        np.float32)
    jpose = jnp.asarray(pose)
    for name in ("merged_nll", "log_likelihood", "residuals"):
        want = np.asarray(jax.vmap(getattr(jg, name))(jpose))
        got = getattr(tg, name)(torch.from_numpy(pose)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


class _SklearnLike:
    """An object pickle with sklearn's GMM field names."""


@pytest.mark.parametrize("form", ["dict", "object"])
def test_load_gmm(tmp_path, form):
    rng = np.random.default_rng(1)
    means = rng.normal(0, 0.3, (3, 69))
    a = rng.normal(0, 0.05, (3, 69, 69))
    covs = np.einsum("mij,mkj->mik", a, a) + 0.5 * np.eye(69)
    weights = np.array([0.2, 0.3, 0.5])
    if form == "dict":
        obj = {"means": means, "covars": covs, "weights": weights}
    else:
        obj = _SklearnLike()
        obj.means_, obj.covars_, obj.weights_ = means, covs, weights
    path = tmp_path / "gmm_08.pkl"
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    got = TP.load_gmm(str(path), device="cpu")
    want = JP.load_gmm(str(path))
    for f in ("means", "precisions", "prec_chol", "nll_weights"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    got_c = convert.gmm(arrays(want), device="cpu")
    assert torch.equal(got_c.prec_chol, got.prec_chol)


# --- the energy with the GMM prior and the 3D-joint term -------------------

B4 = 4
POSE_W, SHAPE_W = 4.78, 5.0          # the last stage: the GMM gate open


@pytest.fixture(scope="module")
def problem4():
    p = fit_problem(B4, seed=2)
    rng = np.random.default_rng(3)
    K = p["to"].gt2d.shape[2]
    gt3d = rng.normal(0, 0.4, (B4, K, 3)).astype(np.float32)
    conf3d = rng.uniform(0.3, 1.0, (B4, K)).astype(np.float32)
    p["to3"] = dataclasses.replace(p["to"], gt3d=torch.from_numpy(gt3d),
                                   conf3d=torch.from_numpy(conf3d))
    p["jo3"] = jax_observations(p["to3"])
    return p


def _gmm_x(rng):
    """Four no-VPoser frames (86 unknowns): 0 neither gate, 1 both gates
    (the pose far from every component), 2 the angle gate only (one
    elbow bent to 3.5), 3 the GMM gate only (far, elbows and knees
    relaxed)."""
    pose = rng.normal(0, 0.3, (B4, 69))
    pose[1] = 8.0
    pose[2, 52] = 3.5
    pose[3] = 8.0
    pose[3, [52, 55, 9, 12]] = [-1.0, 1.0, 1.0, 1.0]
    rest = rng.normal(0, 0.1, (B4, 17))
    rest[:, 16] = 1.0                                    # scale
    return np.concatenate([pose, rest], 1).astype(np.float32)


def _vposer_x(rng):
    x = rng.normal(0, 0.1, (B4, 49)).astype(np.float32)
    x[:, 48] = 1.0
    return x


CASES = {
    "gmm": (TE.EnergySpec(use_vposer=False, prior_type="gmm"),
            JE.EnergySpec(use_vposer=False, prior_type="gmm"), _gmm_x),
    "use_3d": (TE.EnergySpec(use_3d=True), JE.EnergySpec(use_3d=True),
               _vposer_x),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_energy_matches_jax(problem4, gmms, case):
    p = problem4
    jg, tg = gmms
    tspec, jspec, make_x = CASES[case]
    x = make_x(np.random.default_rng(4))
    jw = JE.StageWeights.make(data=500 / 1080.0, pose=POSE_W, shape=SHAPE_W)
    tw = TE.StageWeights.make(data=torch.full((B4,), 500 / 1080.0),
                              pose=POSE_W, shape=SHAPE_W)
    args = (p["ja"], p["jc"])

    def one(xx, o):
        r = JE.residuals(jspec, *args, o, jw, p["jw"], jg, xx)
        e = JE.total_energy(jspec, *args, o, jw, p["jw"], jg, xx)
        rj, J = JE.residual_jacobian(jspec, *args, o, jw, p["jw"], jg, xx)
        t = JE.energy_terms(jspec, *args, o, jw, p["jw"], jg, xx)
        return r, e, rj, J, t["pose_prior"], t["angle_prior"], t["joint3d"]
    want = [np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(x), p["jo3"])]
    r0, e0, _, J0, pp0, ang0, j3d0 = want

    targs = (tspec, p["ta"], p["tc"], p["to3"], tw, p["tw"], tg)
    xt = torch.from_numpy(x)
    r1 = TE.residuals(*targs, xt)
    e1 = TE.total_energy(*targs, xt)
    rj1, J1 = TE.residual_jacobian(*targs, xt)
    t1 = TE.energy_terms(*targs, xt)
    np.testing.assert_allclose(r1.numpy(), r0, rtol=1e-5,
                               atol=1e-5 * np.abs(r0).max())
    np.testing.assert_allclose(rj1.numpy(), r0, rtol=1e-5,
                               atol=1e-5 * np.abs(r0).max())
    np.testing.assert_allclose(e1.numpy(), e0, rtol=1e-5)
    for k, w in (("pose_prior", pp0), ("angle_prior", ang0),
                 ("joint3d", j3d0)):
        np.testing.assert_allclose(t1[k].numpy(), w, rtol=1e-5, atol=1e-3,
                                   err_msg=k)
    scale = max(np.abs(J0).max(), 1e-3)
    np.testing.assert_allclose(J1.numpy(), J0, rtol=2e-4, atol=2e-4 * scale)

    sq = (r1 * r1).sum(-1).numpy()
    if case == "use_3d":
        assert (j3d0 > 0).all()
        np.testing.assert_allclose(sq, e1.numpy(), rtol=1e-5)
    else:
        # Which gates tripped: angle (1e4) on frames 1, 2; GMM (5e4) on
        # frames 1, 3.  Where the GMM term is dropped no -log w offset
        # enters, so the two forms agree; where it is kept they differ
        # by exactly w^2 * (-log w_best) (the offset the rows omit).
        assert (ang0 == 0).tolist() == [False, True, True, False]
        base = tg.merged_nll(xt[:, :69]) * POSE_W ** 2
        assert (base > 5e4).tolist() == [False, True, False, True]
        l2 = (xt[:, :69] ** 2).sum(-1) * (4 * POSE_W) ** 2
        np.testing.assert_allclose(pp0[[1, 3]], l2[[1, 3]].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(sq[[1, 3]], e1.numpy()[[1, 3]],
                                   rtol=1e-5)
        offset = e1.numpy() - sq
        assert (offset[[0, 2]] > 0).all()


def test_joints3d_residuals_match_jax(problem4):
    p = problem4
    x = _vposer_x(np.random.default_rng(5))
    spec = TE.EnergySpec(use_3d=True)
    tw = TE.StageWeights.make(data=torch.full((B4,), 0.5), pose=1.0,
                              shape=1.0)
    jw = JE.StageWeights.make(data=0.5, pose=1.0, shape=1.0)
    want = np.asarray(jax.jit(jax.vmap(lambda xx, o: JE.joints3d_residuals(
        JE.EnergySpec(use_3d=True), p["ja"], o, jw, p["jw"], xx)))(
            jnp.asarray(x), p["jo3"]))
    got = TE.joints3d_residuals(spec, p["ta"], p["to3"], tw, p["tw"],
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    off = TE.joints3d_residuals(TE.EnergySpec(), p["ta"], p["to3"], tw,
                                p["tw"], torch.from_numpy(x))
    assert off.shape == (B4, 0)


# --- staged fits against JAX's vmap(fit_frame) -----------------------------

B = 2
CHOL = dict(max_iters=3, linsolve="chol", speculative=False)
BENT = np.concatenate([np.ones(6), np.zeros(63)]).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    return fit_problem(B, seed=0)


def test_gmm_fit_matches_jax(problem, gmms):
    """No VPoser, the GMM prior, chol classic LM at the last two library
    stages (the GMM term gated off at pose weight 57.4, on at 4.78);
    body_pose starts at [1]*6 + [0]*63 as `cli/main.py:293-298` does."""
    p = problem
    jg, tg = gmms
    stages = dict(pose_weights=(57.4, 4.78), shape_weights=(10.0, 5.0),
                  coll_weights=(0.0, 0.0))
    jcfg = JFitConfig(spec=JE.EnergySpec(use_vposer=False, prior_type="gmm"),
                      lm=JLM.LMOptions(**CHOL), **stages)

    def one(o):
        g = jinit_guess(p["ja"], p["jc"], o.gt2d, o.conf, o.view_mask)
        params = g.params.replace(body_pose=jnp.asarray(BENT))
        return jfit_frame(jcfg, p["ja"], p["jc"], o, params, g.z,
                          gmm=jg, img_height=1080.0)
    want = np.asarray(jax.jit(jax.vmap(one))(p["jo"]).stage_losses)

    cfg = FitConfig(spec=TE.EnergySpec(use_vposer=False, prior_type="gmm"),
                    lm=TLM.LMOptions(**CHOL), **stages)
    o = p["to"]
    g = init_guess(p["ta"], p["tc"], o.gt2d, o.conf, o.view_mask)
    params = dataclasses.replace(
        g.params, body_pose=torch.from_numpy(BENT).expand(B, 69))
    got = fit_frame(cfg, p["ta"], p["tc"], o, params, g.z, gmm=tg,
                    img_height=1080.0)
    np.testing.assert_allclose(got.stage_losses.numpy(), want, rtol=1e-3)
    assert got.lm_iters.tolist() == [[3, 3]] * B


# `cfg_files/fit_seq.yaml`'s settings (smpllsp, VPoser, is_seq, no
# collision) with its stages 0, 2 and 3 only (two stages less to
# compile): a later frame skips the first two and runs the last at 0.15x
# its pose weight.
SEQ = dict(pose_weights=(404.0, 57.4, 4.78),
           shape_weights=(100.0, 10.0, 5.0),
           coll_weights=(0.0, 0.0, 0.0), is_seq=True)
SHIFT = np.array([0.08, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def sequence():
    """Two steps of two sequences (smpllsp) and the JAX results of the
    whole chain in one program: step 0 from scratch, step 1 warm-started
    with `seq_start=False`, and the refit of step 0 against keypoints of
    its body moved +8 cm in x (`tests/test_misc.py:51-79`)."""
    from mvsmplfitting_tpu_torch import synthetic
    a, _, _, steps = synthetic.make_sequence(6, B, 2, seed=0, device="cpu",
                                             model_type="smpllsp")
    p = fit_problem(B, seed=0, model_type="smpllsp")
    steps = [steps[0], steps[1]]
    jsteps = [jax_observations(o) for o in steps]
    jcfg = JFitConfig(lm=JLM.LMOptions(**CHOL), **SEQ)
    ja, jc, jw = p["ja"], p["jc"], p["jw"]

    def chain(o0, o1):
        g0 = jinit_guess(ja, jc, o0.gt2d, o0.conf, o0.view_mask)
        f0 = jfit_frame(jcfg, ja, jc, o0, g0.params, g0.z, vposer_w=jw,
                        img_height=1080.0)
        g1 = jinit_guess(ja, jc, o1.gt2d, o1.conf, o1.view_mask)
        w1 = jwarm_start(f0.params, f0.z, f0.loss, g1)
        f1 = jfit_frame(jcfg, ja, jc, o1, w1.params, w1.z, vposer_w=jw,
                        img_height=1080.0, seq_start=False)
        moved = f0.params.replace(transl=f0.params.transl + SHIFT)
        _, joints = jsmpl_forward(ja, moved, f0.body_pose)
        edited = o0.replace(gt2d=jproject(jc, joints))
        r = jrefit(jcfg, ja, jc, edited, f0, vposer_w=jw, img_height=1080.0)
        return f0, f1, r
    want = jax.jit(jax.vmap(chain))(*jsteps)
    return p, steps, want


def test_sequence_matches_jax(sequence):
    p, steps, (f0, f1, _) = sequence
    cfg = FitConfig(lm=TLM.LMOptions(**CHOL), **SEQ)
    ta, tc, tw = p["ta"], p["tc"], p["tw"]
    o0, o1 = steps
    g0 = init_guess(ta, tc, o0.gt2d, o0.conf, o0.view_mask)
    r0 = fit_frame(cfg, ta, tc, o0, g0.params, g0.z, vposer_w=tw)
    g1 = init_guess(ta, tc, o1.gt2d, o1.conf, o1.view_mask)
    w1 = warm_start(r0.params, r0.z, r0.loss, g1)
    r1 = fit_frame(cfg, ta, tc, o1, w1.params, w1.z, vposer_w=tw,
                   seq_start=False)
    np.testing.assert_allclose(r0.stage_losses.numpy(),
                               np.asarray(f0.stage_losses), rtol=1e-3)
    assert r1.stage_losses.shape == (B, 1)           # the last only
    np.testing.assert_allclose(r1.stage_losses.numpy(),
                               np.asarray(f1.stage_losses), rtol=1e-3)
    assert (r0.loss < 5000).all()                    # both warm-started
    torch.testing.assert_close(w1.z, r0.z)


def test_refit_matches_jax(sequence):
    p, steps, (f0, _, want) = sequence
    cfg = FitConfig(lm=TLM.LMOptions(**CHOL), **SEQ)
    ta, tc, tw = p["ta"], p["tc"], p["tw"]
    o0 = steps[0]
    g0 = init_guess(ta, tc, o0.gt2d, o0.conf, o0.view_mask)
    first = fit_frame(cfg, ta, tc, o0, g0.params, g0.z, vposer_w=tw)
    moved = dataclasses.replace(
        first.params, transl=first.params.transl + torch.from_numpy(SHIFT))
    _, joints = smpl_forward(ta, moved, first.body_pose)
    edited = dataclasses.replace(
        o0, gt2d=project_points(tc, joints).transpose(0, 1).contiguous())
    got = refit_with_observations(cfg, ta, tc, edited, first, vposer_w=tw)
    assert got.stage_losses.shape == (B, 1)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-3)
    np.testing.assert_allclose(got.params.transl.numpy(),
                               np.asarray(want.params.transl), rtol=1e-3,
                               atol=1e-4)


def test_warm_start_picks_per_frame():
    """prev_loss straddling the 5000 threshold: each frame picks the
    previous solution or the fresh guess on its own, as JAX does."""
    rng = np.random.default_rng(6)
    n = 5
    prev_loss = np.array([100.0, 6000.0, 5000.0, 5000.5, np.inf],
                         np.float32)

    def params(seed):
        r = np.random.default_rng(seed)
        return {k: r.normal(0, 1, (n,) + s).astype(np.float32)
                for k, s in (("betas", (10,)), ("global_orient", (3,)),
                             ("body_pose", (69,)), ("transl", (3,)),
                             ("scale", ()))}
    prev, fresh = params(7), params(8)
    zp, zf = (rng.normal(0, 1, (n, 32)).astype(np.float32) for _ in range(2))
    j3 = rng.normal(0, 1, (n, 17, 3)).astype(np.float32)

    from mvsmplfitting_tpu.fitting.initialize import InitGuess as JGuess
    from mvsmplfitting_tpu_torch.fitting.initialize import InitGuess
    got = warm_start(
        SMPLParams(**{k: torch.from_numpy(v) for k, v in prev.items()}),
        torch.from_numpy(zp), torch.from_numpy(prev_loss),
        InitGuess(SMPLParams(**{k: torch.from_numpy(v)
                                for k, v in fresh.items()}),
                  torch.from_numpy(zf), torch.from_numpy(j3)))
    want = jax.vmap(jwarm_start)(
        JParams(**{k: jnp.asarray(v) for k, v in prev.items()}),
        jnp.asarray(zp), jnp.asarray(prev_loss),
        JGuess(JParams(**{k: jnp.asarray(v) for k, v in fresh.items()}),
               jnp.asarray(zf), jnp.asarray(j3)))
    use_prev = [True, False, True, False, False]
    for k in prev:
        g = getattr(got.params, k).numpy()
        assert np.array_equal(g, np.asarray(getattr(want.params, k))), k
        for i, u in enumerate(use_prev):
            assert np.array_equal(g[i], (prev if u else fresh)[k][i]), k
    assert np.array_equal(got.z.numpy(), np.asarray(want.z))


# --- the SMPL loaders -------------------------------------------------------

def _chumpy_pickle(path, raw, monkeypatch):
    """Pickle `raw` with v_template and shapedirs as chumpy-like objects
    (class `chumpy.ch.Ch`, state {"x": array}) and J_regressor as a
    scipy sparse matrix, as the official SMPL files hold them."""
    import scipy.sparse

    mod = types.ModuleType("chumpy.ch")

    class Ch:
        pass
    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    mod.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", mod)
    data = dict(raw)
    for k in ("v_template", "shapedirs"):
        c = Ch()
        c.x = raw[k]
        data[k] = c
    data["J_regressor"] = scipy.sparse.csc_matrix(raw["J_regressor"])
    data["bs_style"] = "lbs"
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)


@pytest.mark.parametrize("layout", ["folder", "pkl", "npz", "smpllsp"])
def test_load_smpl_matches_jax(tmp_path, monkeypatch, layout):
    from mvsmplfitting_tpu_torch.models import joints as TJ
    rng = np.random.default_rng(9)
    nv, nj = 64, 24
    raw = {
        "v_template": rng.standard_normal((nv, 3)),
        "shapedirs": rng.standard_normal((nv, 3, 16)),
        "posedirs": rng.standard_normal((nv, 3, 9 * (nj - 1))),
        "J_regressor": rng.random((nj, nv)) * (rng.random((nj, nv)) < 0.2),
        "weights": rng.random((nv, nj)),
        "f": rng.integers(0, nv, (50, 3)),
        "kintree_table": np.stack([np.asarray(TJ.SMPL_PARENTS),
                                   np.arange(nj)]),
    }
    d = tmp_path / "models" / "smpl"
    d.mkdir(parents=True)
    pkl = d / "SMPL_NEUTRAL.pkl"
    _chumpy_pickle(pkl, raw, monkeypatch)
    loaded = TA.load_smpl_pkl(str(pkl))
    assert loaded["bs_style"] == "lbs"
    np.testing.assert_array_equal(loaded["v_template"], raw["v_template"])
    np.testing.assert_array_equal(loaded["J_regressor"], raw["J_regressor"])

    model_type, kw, jkw = "smpl", {}, {}
    where = str(tmp_path / "models")
    if layout == "pkl":
        where = str(pkl)
    elif layout == "npz":
        where = str(tmp_path / "SMPL_NEUTRAL.npz")
        np.savez(where, **raw)
    elif layout == "smpllsp":
        reg = str(tmp_path / "lsp.npz")
        np.savez(reg, joint_regressor=rng.random((14, nv)))
        model_type = "smpllsp"
        kw = jkw = dict(lsp_regressor_path=reg)
    got = TA.load_smpl(where, model_type, device="cpu", **kw)
    want = JA.load_smpl(where, model_type, **jkw)
    assert got.parents == want.parents and got.model_type == model_type
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights", "faces", "extra_joint_ids", "joint_map",
              "lsp_regressor"):
        w = getattr(want, f)
        g = getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        assert np.array_equal(g.numpy(), np.asarray(w)), f
    # The same file read as SMPL-H gives JAX's assets; a folder without
    # an smplh model raises as JAX does.
    try:
        want = JA.load_smpl(where, "smplh")
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            TA.load_smpl(where, "smplh", device="cpu")
        return
    got = TA.load_smpl(where, "smplh", device="cpu")
    assert got.parents == want.parents and got.model_type == "smplh"
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights", "faces", "extra_joint_ids", "joint_map"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert got.hand_components is None and want.hand_components is None
