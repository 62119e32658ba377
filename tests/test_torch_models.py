"""The PyTorch port's body model, joint model, VPoser and priors against
the JAX package, on the CPU.

Tolerances and why:
- synthetic assets: exactly equal (both are numpy seeded with 0);
- reduced joint model: rtol 1e-6 plus atol 1e-6 * max|ref|: the port
  builds it in float64 BLAS products, the reference in float32 einsums,
  so entries that cancel to ~0 differ by float32 accumulation error.
  Both builds run on the synthetic assets cut to every 10th vertex (plus
  the extra joints' vertices): the reference's einsums take ~13 s per
  model at full width, and the build is the same function at any size;
- forwards: rtol = atol = 1e-5 (fp32, reassociated contractions);
- VPoser: aa at rtol 3e-5 / atol 1e-5, D at rtol 3e-4 / atol 3e-4 max|D|
  (the kernel-test tolerances, `tests/test_joint_kernel.py:203-246`).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.models import priors as jpri
from mvsmplfitting_tpu.models import smpl as jsmpl
from mvsmplfitting_tpu.models import vposer as jvp
from mvsmplfitting_tpu.models.assets import synthetic_smpl as jsynthetic
from mvsmplfitting_tpu.models import joint_model as jjm
from mvsmplfitting_tpu.models.joint_model import (
    build_joint_model as jbuild_joint_model, joint_forward as jjoint_forward)
from mvsmplfitting_tpu_torch import convert, synthetic
from mvsmplfitting_tpu_torch.models import priors as tpri
from mvsmplfitting_tpu_torch.models import smpl as tsmpl
from mvsmplfitting_tpu_torch.models import vposer as tvp
from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl as tsynthetic
from mvsmplfitting_tpu_torch.models.joint_model import (build_joint_model,
                                                       joint_forward)

from torch_port_helpers import (arrays, jax_assets, port_assets,
                                vposer_pair)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ASSET_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
                "lbs_weights", "faces", "extra_joint_ids", "joint_map",
                "lsp_regressor")
JM_FIELDS = ("H0", "Hb", "Hp", "j0", "JB", "fold", "chain_idx",
             "chain_mask")


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX synthetic problem.  Its pixels come from the full LBS
    (`smpl_forward`); the joint model its assets carry is the port-built
    one (see torch_port_helpers), which spares the reference's slow
    float32 build."""
    from __graft_entry__ import _make_problem
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jjm, "with_joint_model",
                   lambda a: a.replace(joint_model=jax_assets(
                       a.model_type).joint_model))
        return _make_problem(num_views=6, num_frames=3, seed=0)


@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_synthetic_smpl_arrays_equal(model_type):
    ja = jsynthetic(model_type)
    ta = tsynthetic(model_type, device="cpu")
    assert ta.parents == ja.parents and ta.model_type == ja.model_type
    for f in ASSET_FIELDS:
        a, b = getattr(ja, f), getattr(ta, f)
        if a is None:
            assert b is None, f
            continue
        assert np.array_equal(np.asarray(a), b.numpy()), f


def _vertex_subset(model_type, step=10):
    """The synthetic assets' arrays cut to every `step`-th vertex plus the
    extra joints' vertices (re-indexed), as numpy."""
    ja = jsynthetic(model_type)
    a = arrays(ja)
    V = a["v_template"].shape[0]
    keep = np.union1d(np.arange(0, V, step), a["extra_joint_ids"])
    a.update(
        v_template=a["v_template"][keep], shapedirs=a["shapedirs"][keep],
        posedirs=a["posedirs"].reshape(-1, V, 3)[:, keep].reshape(
            -1, 3 * len(keep)),
        j_regressor=a["j_regressor"][:, keep],
        lbs_weights=a["lbs_weights"][keep],
        faces=np.zeros((0, 3), np.int32),
        extra_joint_ids=np.searchsorted(keep, a["extra_joint_ids"]
                                        ).astype(np.int32))
    if a["lsp_regressor"] is not None:
        a["lsp_regressor"] = a["lsp_regressor"][:, keep]
    return ja, a


def _check_build_joint_model(model_type):
    ja, a = _vertex_subset(model_type)
    jm_jax = jbuild_joint_model(jsmpl.SMPLAssets(
        **{k: None if v is None else jnp.asarray(v) for k, v in a.items()},
        parents=ja.parents, model_type=ja.model_type))
    jm_port = build_joint_model(convert.smpl_assets(
        a, ja.parents, ja.model_type, device="cpu"))
    assert jm_port.parents == jm_jax.parents
    assert int(jm_port.chain_mask.sum()) == int(np.sum(jm_jax.chain_mask))
    for f in JM_FIELDS:
        want = np.asarray(getattr(jm_jax, f))
        got = getattr(jm_port, f).numpy()
        np.testing.assert_allclose(
            got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1e-30),
            err_msg=f)


def test_build_joint_model_smpl():
    _check_build_joint_model("smpl")


def test_build_joint_model_smpllsp():
    _check_build_joint_model("smpllsp")


def _params(rng, B):
    return dict(
        betas=rng.normal(0, 1.0, (B, 10)).astype(np.float32),
        global_orient=rng.normal(0, 0.4, (B, 3)).astype(np.float32),
        body_pose=rng.normal(0, 0.4, (B, 69)).astype(np.float32),
        transl=rng.normal(0, 0.3, (B, 3)).astype(np.float32),
        scale=rng.uniform(0.7, 1.5, (B,)).astype(np.float32))


@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_forwards_match_jax(model_type):
    """smpl_forward and joint_forward agree with JAX, and joint_forward
    equals the mapped joints of smpl_forward."""
    rng = np.random.default_rng(0)
    B = 3
    p = _params(rng, B)
    tp = convert.smpl_params(p, device="cpu")
    ta, ja = port_assets(model_type), jax_assets(model_type)
    verts, joints = tsmpl.smpl_forward(ta, tp)
    jf = joint_forward(ta.joint_model, tp)
    for b in range(B):
        jp = jsmpl.SMPLParams(**{k: jnp.asarray(v[b]) for k, v in p.items()})
        wv, wj = jsmpl.smpl_forward(ja, jp)
        np.testing.assert_allclose(verts[b].numpy(), np.asarray(wv),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(joints[b].numpy(), np.asarray(wj),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            jf[b].numpy(), np.asarray(jjoint_forward(ja.joint_model, jp)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jf.numpy(), joints.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tsmpl.rest_joints(ta).numpy(), np.asarray(jsmpl.rest_joints(ja)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.6, 1e-3])
def test_vposer_decode_and_jacobian(sigma):
    jw, tw = vposer_pair()
    z = np.random.default_rng(2).normal(0, sigma, (5, 32)).astype(np.float32)
    aa = tvp.decode(tw, torch.from_numpy(z))
    np.testing.assert_allclose(aa.numpy(),
                               np.asarray(jvp.decode(jw, jnp.asarray(z))),
                               rtol=3e-5, atol=1e-5)
    aa1, D1 = tvp.decode_jac(tw, torch.from_numpy(z))
    aa0, D0 = jax.jit(jax.vmap(lambda zi: jvp.decode_jac(jw, zi)))(
        jnp.asarray(z))
    np.testing.assert_allclose(aa1.numpy(), np.asarray(aa0), rtol=3e-5,
                               atol=1e-5)
    sc = max(float(np.abs(np.asarray(D0)).max()), 1.0)
    np.testing.assert_allclose(D1.numpy(), np.asarray(D0), rtol=3e-4,
                               atol=3e-4 * sc)


@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_joint_sets(model_type):
    from mvsmplfitting_tpu.models import joints as jj
    from mvsmplfitting_tpu_torch.models import joints as tj
    fmt = tj.pose_format_for_model(model_type)
    assert fmt == jj.pose_format_for_model(model_type)
    assert tj.parents_for_model(model_type) == jj.parents_for_model(
        model_type)
    np.testing.assert_array_equal(tj.model_to_annotation(model_type, fmt),
                                  jj.model_to_annotation(model_type, fmt))
    for feet in (False, True):
        np.testing.assert_array_equal(tj.extra_joint_ids("smplh", feet),
                                      jj.extra_joint_ids("smplh", feet))
    for use_hip in (False, True):
        np.testing.assert_array_equal(
            tj.default_joint_weights(17, fmt, use_hip),
            jj.default_joint_weights(17, fmt, use_hip))
    for family in ("smplh", "smplx"):
        assert tj.parents_for_model(family) == jj.parents_for_model(family)


def test_priors():
    pose = np.random.default_rng(3).normal(0, 0.5, (4, 69)).astype(np.float32)
    tp = torch.from_numpy(pose)
    for b in range(4):
        np.testing.assert_allclose(
            tpri.angle_prior_terms(tp)[b].numpy(),
            np.asarray(jpri.angle_prior_terms(jnp.asarray(pose[b]))),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tpri.l2_prior(tp)[b].item(),
            float(jpri.l2_prior(jnp.asarray(pose[b]))), rtol=1e-5)


def test_synthetic_problem_matches_jax(jax_problem):
    """synthetic.make_problem draws the same frames as `_make_problem`."""
    ja, jw, jc, jo = jax_problem
    ta, tw, tc, to = synthetic.make_problem(6, 3, seed=0, device="cpu")
    for f in ("rotation", "translation", "focal", "center"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6,
                                   atol=1e-6)
    # pixels ~500: 1e-5 relative is ~5e-3 px
    np.testing.assert_allclose(to.gt2d.numpy(), np.asarray(jo.gt2d),
                               rtol=1e-5, atol=1e-3)
    for f in ("conf", "view_mask", "joint_weights"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)))
    # distinct frames
    assert not np.allclose(to.gt2d[0].numpy(), to.gt2d[1].numpy())
