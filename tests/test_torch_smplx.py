"""The port's SMPL-H / SMPL-X family against the JAX package, on the CPU:
kinematic tables, synthetic assets and loaders, the hand-PCA pose
assembly, the full and reduced forwards, the energy with the tail
blocks, the 80-column AD Jacobian and one fit stage.

Tolerances and why:
- joint tables, annotation maps, synthetic assets and loaded assets:
  exact (the same numpy build, one cast to float32);
- hand PCA and the assembled chain pose: atol 1e-6 (one fp32 product of
  6 components);
- `smpl_forward` verts and joints: rtol and atol 1e-5 (fp32 LBS over
  10475 vertices with the sums in another order);
- `joint_forward` against JAX's on the same constants: atol 1e-5; against
  the full forward: atol 5e-4 (JAX's own bound,
  `tests/test_smplx_family.py:52`: the fold reassociates the skinning);
- residuals and `total_energy`: rtol 1e-5, atol 1e-5 max|r| (pixels of
  ~500 feed the rows); sum(r^2) == total_energy at rtol 1e-5;
- the AD Jacobian against `jax.jacfwd`: rtol 1e-4, atol 1e-5 max|J|
  (forward mode through rodrigues and the 55-joint chain in fp32);
- one fit stage (chol, classic LM, 6 iterations, B=2) with the
  initialization: stage losses rtol 1e-3, x rtol 1e-3 with atol 1e-4
  (the fit-level tolerance of `test_torch_fit.py`; x entries near zero
  need the absolute part).

The JAX references that compile (the residuals, the Jacobian and the
fit) are jitted once per model type, the forwards too (op by op, JAX
compiles each primitive on its first call, which is slower here).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.fitting import lm as JLM
from mvsmplfitting_tpu.fitting.initialize import init_guess as jinit_guess
from mvsmplfitting_tpu.fitting.initialize import torso_indices as jtorso
from mvsmplfitting_tpu.fitting.initialize import warm_start as jwarm_start
from mvsmplfitting_tpu.fitting.stages import FitConfig as JFitConfig
from mvsmplfitting_tpu.fitting.stages import fit_frame as jfit_frame
from mvsmplfitting_tpu.models import assets as JA
from mvsmplfitting_tpu.models import joints as JJ
from mvsmplfitting_tpu.models.camera import Camera as JCamera
from mvsmplfitting_tpu.models.camera import project_points as jproject
from mvsmplfitting_tpu.models.joint_model import \
    joint_forward as jjoint_forward
from mvsmplfitting_tpu.models.smpl import SMPLParams as JParams
from mvsmplfitting_tpu.models.smpl import \
    assemble_chain_pose as jassemble
from mvsmplfitting_tpu.models.smpl import smpl_forward as jsmpl_forward
from mvsmplfitting_tpu_torch import synthetic
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting import lm as TLM
from mvsmplfitting_tpu_torch.fitting.initialize import (InitGuess,
                                                        torso_indices,
                                                        warm_start)
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
from mvsmplfitting_tpu_torch.models import assets as TA
from mvsmplfitting_tpu_torch.models import joints as TJ
from mvsmplfitting_tpu_torch.models.joint_model import joint_forward
from mvsmplfitting_tpu_torch.models.smpl import (TAIL_FIELDS, SMPLParams,
                                                 assemble_chain_pose,
                                                 smpl_forward)
from mvsmplfitting_tpu_torch.parallel.batched import (BatchedFitInputs,
                                                      batched_fit_frames)

from torch_port_helpers import (jax_assets, jax_observations, port_assets,
                                vposer_pair)

B = 2
FAMILY = ["smplh", "smplx"]
TAIL = TAIL_FIELDS
ASSET_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
                "lbs_weights", "faces", "extra_joint_ids", "joint_map",
                "lsp_regressor", "hand_components", "hand_means",
                "expr_dirs")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _spec_kw(model_type):
    if model_type == "smplx":
        return dict(hand_dim=6, num_expr=10, opt_face=True)
    return dict(hand_dim=6)


def _random_params(model_type, seed=0, batch=B):
    """Every block of the model type set, as numpy (B, ...) arrays."""
    rng = np.random.default_rng(seed)

    def n(s, *shape):
        return (s * rng.standard_normal((batch,) + shape)).astype(np.float32)
    out = dict(betas=n(0.3, 10), global_orient=n(0.2, 3),
               body_pose=n(0.2, 69), transl=n(0.1, 3),
               scale=(1.0 + n(0.05)).astype(np.float32),
               left_hand_pose=n(0.5, 6), right_hand_pose=n(0.5, 6))
    if model_type == "smplx":
        out.update(expression=n(0.8, 10), jaw_pose=n(0.15, 3),
                   leye_pose=n(0.1, 3), reye_pose=n(0.1, 3))
    return out


def _tparams(d):
    return SMPLParams(**{k: torch.from_numpy(v) for k, v in d.items()})


def _jparams(d, b=None):
    """JAX params of frame b, or of all frames (for `jax.vmap`)."""
    return JParams(**{k: jnp.asarray(v if b is None else v[b])
                      for k, v in d.items()})


@pytest.fixture(scope="module", params=FAMILY)
def problem(request):
    """B frames of the model type seen by 6 views: the port's assets and
    observations (from `synthetic`, the truth with tail blocks), and the
    JAX structs holding the same values (its assets carry the port-built
    joint model)."""
    mt = request.param
    ta = port_assets(mt)
    ja = jax_assets(mt)
    jw, tw = vposer_pair()
    tc = synthetic.orbit_cameras(6, torch.device("cpu"))
    z, cols = synthetic.true_params(B, 0)
    cols.update(synthetic.true_tail(B, 0, mt))
    to = synthetic.observe(ta, tw, tc, z, cols)
    jc = JCamera(**{f: jnp.asarray(getattr(tc, f).numpy())
                    for f in ("rotation", "translation", "focal", "center")})
    return dict(mt=mt, ta=ta, ja=ja, tw=tw, jw=jw, tc=tc, jc=jc, to=to,
                jo=jax_observations(to), z=z, cols=cols)


# --- tables and assets -----------------------------------------------------

@pytest.mark.parametrize("model_type", ["smpl", "smpllsp", "smplh", "smplx"])
def test_kinematic_tables_match_jax(model_type):
    assert TJ.parents_for_model(model_type) == JJ.parents_for_model(
        model_type)
    assert TJ.VERTEX_IDS == JJ.VERTEX_IDS
    for vset in ("smplh", "smplx"):
        for feet in (False, True):
            for hands in (False, True):
                np.testing.assert_array_equal(
                    TJ.extra_joint_ids(vset, feet, hands),
                    JJ.extra_joint_ids(vset, feet, hands))
    for fmt in ("coco17", "lsp14", "coco25"):
        try:
            want = JJ.model_to_annotation(model_type, fmt)
        except ValueError:
            with pytest.raises(ValueError):
                TJ.model_to_annotation(model_type, fmt)
            continue
        np.testing.assert_array_equal(
            TJ.model_to_annotation(model_type, fmt), want)
    assert TJ.pose_format_for_model(model_type) == \
        JJ.pose_format_for_model(model_type)
    np.testing.assert_array_equal(torso_indices(model_type),
                                  jtorso(model_type))


@pytest.mark.parametrize("model_type,flat", [("smplh", False),
                                             ("smplx", False),
                                             ("smplh", True)])
def test_synthetic_assets_match_jax(model_type, flat):
    if flat:
        got = TA.synthetic_smpl(model_type, flat_hand_mean=True,
                                device="cpu")
        want = JA.synthetic_smpl(model_type, flat_hand_mean=True)
        assert float(got.hand_means.abs().max()) == 0.0
    else:
        got, want = port_assets(model_type), jax_assets(model_type)
    assert got.parents == want.parents
    assert got.model_type == want.model_type
    assert got.num_expr == want.num_expr
    for f in ASSET_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        assert np.array_equal(g.numpy(), np.asarray(w)), f


# --- the forward -----------------------------------------------------------

def test_hand_pca_and_chain_pose(problem):
    ta, ja = problem["ta"], problem["ja"]
    d = _random_params(problem["mt"], seed=1)
    got = assemble_chain_pose(ta, _tparams(d),
                              torch.from_numpy(d["body_pose"]))
    for b in range(B):
        want = jassemble(ja, _jparams(d, b), jnp.asarray(d["body_pose"][b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-6)
    # PCA decode + mean (`body_models.py:593-608`), at the chain's tail.
    lh = (torch.from_numpy(d["left_hand_pose"]) @ ta.hand_components[0, :6]
          + ta.hand_means[0])
    np.testing.assert_allclose(got[:, -90:-45].numpy(), lh.numpy(),
                               atol=1e-6)
    # A pose of chain length passes through untouched.
    full = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.2, (B, 3 * (len(ta.parents) - 1))).astype(np.float32))
    assert torch.equal(assemble_chain_pose(ta, _tparams(d), full), full)


def test_smpl_forward_matches_jax(problem):
    ta, ja = problem["ta"], problem["ja"]
    d = _random_params(problem["mt"], seed=3)
    verts, joints = smpl_forward(ta, _tparams(d))
    fwd = jax.jit(jax.vmap(lambda q: jsmpl_forward(ja, q)))
    wv, wj = fwd(_jparams(d))
    np.testing.assert_allclose(verts.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(joints.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-5)
    K = 25 if problem["mt"] == "smplx" else 17
    assert joints.shape == (B, K, 3)
    # Each tail block moves the vertices.
    base, _ = smpl_forward(ta, _tparams({k: v for k, v in d.items()
                                         if k not in TAIL}))
    for name in [k for k in TAIL if k in d]:
        solo = {k: v for k, v in d.items() if k not in TAIL or k == name}
        moved, _ = smpl_forward(ta, _tparams(solo))
        assert float((moved - base).abs().max()) > 1e-6, name


def test_joint_forward_matches_jax(problem):
    ta, ja = problem["ta"], problem["ja"]
    d = _random_params(problem["mt"], seed=4)
    got = joint_forward(ta.joint_model, _tparams(d))
    want = jax.jit(jax.vmap(lambda q: jjoint_forward(ja.joint_model, q)))(
        _jparams(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    _, full = smpl_forward(ta, _tparams(d))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=5e-4)


def test_make_problem_observes_the_tail_truth(problem):
    """`synthetic.observe` projects the truth with its tail blocks as
    JAX's forward and projection do."""
    p = problem
    jw, cols = p["jw"], p["cols"]
    from mvsmplfitting_tpu.models import vposer as jvp

    def one(params, z):
        _, joints = jsmpl_forward(p["ja"], params, jvp.decode(jw, z))
        return jproject(p["jc"], joints)
    want = jax.jit(jax.vmap(one))(_jparams(dict(cols, body_pose=np.zeros(
        (B, 69), np.float32))), jnp.asarray(p["z"]))
    np.testing.assert_allclose(p["to"].gt2d.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)
    assert set(synthetic.true_tail(B, 0, p["mt"])) <= set(TAIL)


# --- the energy ------------------------------------------------------------

def _x(mt, seed):
    n = TE.num_unknowns(TE.EnergySpec(**_spec_kw(mt)))
    x = np.random.default_rng(seed).normal(0, 0.1, (B, n)).astype(np.float32)
    x[:, 48] = 1.0 + 0.05 * x[:, 48]
    return x


def _weights():
    jw = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0)
    tw = TE.StageWeights.make(data=torch.full((B,), 500 / 1080.0),
                              pose=57.4, shape=10.0)
    return jw, tw


@pytest.fixture(scope="module")
def jax_energy(problem):
    """JAX's residuals, scalar energy and forward-mode Jacobian of the
    problem's model type, vmapped over frames and jitted once."""
    p = problem
    spec = JE.EnergySpec(**_spec_kw(p["mt"]))
    jweights, _ = _weights()

    def res(xx, o):
        return JE.residuals(spec, p["ja"], p["jc"], o, jweights, p["jw"],
                            None, xx)

    def one(xx, o):
        return (res(xx, o),
                JE.total_energy(spec, p["ja"], p["jc"], o, jweights,
                                p["jw"], None, xx),
                jax.jacfwd(lambda v: res(v, o))(xx))
    return jax.jit(jax.vmap(one))


def test_energy_matches_jax(problem, jax_energy):
    p = problem
    spec = TE.EnergySpec(**_spec_kw(p["mt"]))
    n = TE.num_unknowns(spec)
    assert n == JE.num_unknowns(JE.EnergySpec(**_spec_kw(p["mt"])))
    np.testing.assert_array_equal(
        TE.free_mask(spec).numpy(),
        np.asarray(JE.free_mask(JE.EnergySpec(**_spec_kw(p["mt"])))))
    x = _x(p["mt"], 5)
    xt = torch.from_numpy(x)
    params, z = TE.unpack(spec, xt)
    assert params.left_hand_pose.shape == (B, 6)
    assert torch.equal(TE.pack(spec, params, z), xt)

    r0, e0, _ = jax_energy(jnp.asarray(x), p["jo"])
    r0, e0 = np.asarray(r0), np.asarray(e0)
    _, tweights = _weights()
    r1 = TE.residuals(spec, p["ta"], p["tc"], p["to"], tweights, p["tw"],
                      None, xt)
    e1 = TE.total_energy(spec, p["ta"], p["tc"], p["to"], tweights, p["tw"],
                         None, xt)
    np.testing.assert_allclose(r1.numpy(), r0, rtol=1e-5,
                               atol=1e-5 * np.abs(r0).max())
    np.testing.assert_allclose(e1.numpy(), e0, rtol=1e-5)
    np.testing.assert_allclose((r1 * r1).sum(-1).numpy(), e1.numpy(),
                               rtol=1e-5)


def test_ad_jacobian_matches_jacfwd(problem, jax_energy):
    p = problem
    spec = TE.EnergySpec(**_spec_kw(p["mt"]))
    assert not TE.analytic_jac_ok(spec, p["ta"])   # AD, as in JAX
    x = _x(p["mt"], 6)
    _, tweights = _weights()
    r1, J1 = TLM.ad_jacobian(
        lambda v: TE.residuals(spec, p["ta"], p["tc"], p["to"], tweights,
                               p["tw"], None, v), torch.from_numpy(x))
    _, _, J0 = jax_energy(jnp.asarray(x), p["jo"])
    J0 = np.asarray(J0)
    assert J1.dtype == torch.float32
    # smplx: 32 + 10 + 7 + 12 + 10 + 9 columns.
    assert J1.shape[-1] == (80 if p["mt"] == "smplx" else 61)
    np.testing.assert_allclose(J1.numpy(), J0, rtol=1e-4,
                               atol=1e-5 * np.abs(J0).max())


# --- fits ------------------------------------------------------------------

def test_fit_matches_jax(problem):
    """`batched_fit_frames` (init + one stage, chol, classic LM, 6
    iterations) against JAX's `vmap(init_guess + fit_frame)`."""
    p = problem
    opts = dict(max_iters=6, linsolve="chol", speculative=False)
    sched = dict(pose_weights=(57.4,), shape_weights=(10.0,),
                 coll_weights=(0.0,))
    jspec = JE.EnergySpec(**_spec_kw(p["mt"]))
    jcfg = JFitConfig(spec=jspec, lm=JLM.LMOptions(**opts), **sched)

    def one(o):
        g = jinit_guess(p["ja"], p["jc"], o.gt2d, o.conf, o.view_mask)
        r = jfit_frame(jcfg, p["ja"], p["jc"], o, g.params, g.z,
                       vposer_w=p["jw"], img_height=1080.0)
        return r.stage_losses, JE.pack(jspec, r.params, r.z)
    want_losses, want_x = jax.jit(jax.vmap(one))(p["jo"])

    spec = TE.EnergySpec(**_spec_kw(p["mt"]))
    cfg = FitConfig(spec=spec, lm=TLM.LMOptions(**opts), **sched)
    got = batched_fit_frames(cfg, p["ta"], p["tc"],
                             BatchedFitInputs(p["to"],
                                              torch.full((B,), 1080.0)),
                             vposer_w=p["tw"], device="cpu")
    assert got.params.left_hand_pose.shape == (B, 6)
    np.testing.assert_allclose(got.stage_losses.numpy(),
                               np.asarray(want_losses), rtol=1e-3)
    np.testing.assert_allclose(TE.pack(spec, got.params, got.z).numpy(),
                               np.asarray(want_x), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("model_type", FAMILY)
def test_warm_start_aligns_tail_blocks(model_type):
    """A fitted previous frame carries tail blocks, a fresh guess none:
    the missing side is zeros, per frame, as in JAX."""
    d = _random_params(model_type, seed=7)
    fresh = {k: v + 1.0 for k, v in d.items() if k not in TAIL}
    loss = np.asarray([10.0, 9e3], np.float32)
    prev_z = np.random.default_rng(8).normal(0, 1, (B, 32)).astype(
        np.float32)
    got = warm_start(_tparams(d), torch.from_numpy(prev_z),
                     torch.from_numpy(loss),
                     InitGuess(_tparams(fresh), torch.zeros(B, 32),
                               torch.zeros(B, 17, 3)))
    from mvsmplfitting_tpu.fitting.initialize import InitGuess as JInit
    for b in range(B):
        want = jwarm_start(_jparams(d, b), jnp.asarray(prev_z[b]),
                           jnp.asarray(loss[b]),
                           JInit(_jparams(fresh, b), jnp.zeros(32),
                                 jnp.zeros((17, 3))))
        for k in d:
            np.testing.assert_array_equal(
                getattr(got.params, k)[b].numpy(),
                np.asarray(getattr(want.params, k)), err_msg=k)
        np.testing.assert_array_equal(got.z[b].numpy(), np.asarray(want.z))


def _family_raw(model_type, rng):
    """A small model file in the official key layout of the family."""
    nv = 64
    parents = np.asarray(TJ.parents_for_model(model_type))
    nj = len(parents)
    raw = {
        "v_template": rng.standard_normal((nv, 3)).astype(np.float32),
        "shapedirs": rng.standard_normal((nv, 3, 20)).astype(np.float32),
        "posedirs": rng.standard_normal(
            (nv, 3, 9 * (nj - 1))).astype(np.float32),
        "J_regressor": rng.random((nj, nv)).astype(np.float32),
        "weights": rng.random((nv, nj)).astype(np.float32),
        "f": rng.integers(0, nv, (100, 3)).astype(np.int64),
        "kintree_table": np.stack([np.maximum(parents, 0), np.arange(nj)]),
    }
    for side in "lr":
        raw["hands_components" + side] = rng.standard_normal(
            (45, 45)).astype(np.float32)
        raw["hands_mean" + side] = rng.standard_normal(45).astype(np.float32)
    return raw


@pytest.mark.parametrize("model_type,ext", [("smplh", "pkl"),
                                            ("smplx", "npz")])
def test_loaders_match_jax(tmp_path, model_type, ext):
    """`load_smpl` reads the official layouts (smplh pkl, smplx npz) as
    JAX does, with and without flat_hand_mean (as in
    `tests/test_smplx_family.py:181-222`)."""
    raw = _family_raw(model_type, np.random.default_rng(11))
    d = tmp_path / "models" / model_type
    d.mkdir(parents=True)
    path = d / f"{model_type.upper()}_NEUTRAL.{ext}"
    if ext == "pkl":
        with open(path, "wb") as f:
            pickle.dump(raw, f)
    else:
        np.savez(path, **raw)
    for flat in (False, True):
        got = TA.load_smpl(str(tmp_path / "models"), model_type,
                           flat_hand_mean=flat, device="cpu")
        want = JA.load_smpl(str(tmp_path / "models"), model_type,
                            flat_hand_mean=flat)
        assert got.parents == want.parents
        assert got.num_expr == want.num_expr
        for f in ASSET_FIELDS:
            w, g = getattr(want, f), getattr(got, f)
            if w is None:
                assert g is None, f
                continue
            assert np.array_equal(g.numpy(), np.asarray(w)), f
    assert got.shapedirs.shape[-1] == 10
    assert float(got.hand_means.abs().max()) == 0.0
