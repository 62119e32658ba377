"""The port's parallel layer (`mvsmplfitting_tpu_torch.parallel`) on gloo
worlds of CPU processes, against JAX and against the port's one-card
fits.

A world of 2 ranks and a world of 4 are started once for the module
(`tests/torch_parallel_worker.py`, subprocesses with
``init_distributed("localhost:<port>", ...)``); each rank saves what it
got.  JAX's whole sharded fit does not compile within a test's time on
the 8-device CPU mesh, so the sharded fits are held piece by piece
against JAX and as a whole against the port's one-card
`batched_fit_frames`, which `tests/test_torch_fit.py` holds against JAX.

Tolerances and why:
- `sharded_triangulate` against JAX's under `shard_map` on 2 of the 8
  CPU devices and against JAX's `triangulate`: rtol 1e-5, atol 1e-5
  (fp32; the ranks sum the views in another order);
- the normal equations as `_lm_sharded` assembles them (the summed
  per-camera data blocks plus the prior blocks) against J^T J and J^T r
  of JAX's full `residual_jacobian`: rtol 1e-5, atol 1e-5 max|.| (as
  `test_torch_fit.py`);
- `data_residuals` / `prior_residuals` against JAX's: rtol 1e-5, atol
  1e-5 max|.|; `residuals` bitwise equal to their concatenation and to
  the rows it gave before the split;
- the camera-sharded fits (1x2, 2x2; one stage, 5 chol / classic LM
  iterations) against one-card `batched_fit_frames`: losses rtol 5e-3,
  x atol 5e-2 (JAX's `tests/test_parallel.py:123-127`: the classic loops
  differ in which loss a step is judged against, and the views are
  summed in another order);
- analytic against forward-mode Jacobian, sharded: losses rtol 1e-3
  (`tests/test_parallel.py:150`);
- the stacked-stage form against the unrolled one: equal (in PyTorch
  both are the same loop over the same tensors; JAX allows rtol 1e-3
  for XLA's per-loop-form contraction), and a cap of 1 iteration must
  change the losses (`tests/test_parallel.py:179-185`);
- the frames-sharded batched fit against one-card: losses rtol 1e-2
  (`tests/test_parallel.py:74-76`); the frames-sharded Schur fit against
  one-card: shared block atol 0.15, losses rtol 0.3
  (`tests/test_schur.py:110-113`);
- ranks that hold the same result hold it bitwise.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as PS

from mvsmplfitting_tpu.fitting import energy as JE
from mvsmplfitting_tpu.models.camera import Camera as JCamera
from mvsmplfitting_tpu.ops.triangulate import triangulate as jtriangulate
from mvsmplfitting_tpu.parallel import camera_shard as JCS
from mvsmplfitting_tpu.parallel.mesh import MeshLayout as JLayout
from mvsmplfitting_tpu.parallel.mesh import make_mesh as jmake_mesh
from mvsmplfitting_tpu_torch import parallel as P
from mvsmplfitting_tpu_torch import synthetic
from mvsmplfitting_tpu_torch.fitting import energy as TE
from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
from mvsmplfitting_tpu_torch.fitting.stages import FitConfig

import torch_parallel_worker as W
from torch_port_helpers import fit_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = W.B


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{2: [rank results], 4: [...]}: both worlds run at once."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs, dirs = [], {}
    for world in (2, 4):
        dirs[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        port = _free_port()
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests",
                                              "torch_parallel_worker.py"),
                 str(rank), str(world), str(port), dirs[world]],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {world: [torch.load(os.path.join(dirs[world], f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
            for world in (2, 4)}


@pytest.fixture(scope="module")
def problem():
    return fit_problem(B)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    else:
        assert a == b, (a, b)


def _same_on_ranks(ranks, key):
    """rank 0's result, after checking every rank holds the same."""
    for r in ranks[1:]:
        _equal(ranks[0][key], r[key])
    return ranks[0][key]


def _one_card(cfg):
    """The port's one-card fit of the workers' problem: packed x, loss."""
    assets, vw, cam, obs = synthetic.make_problem(6, B, seed=0, device="cpu")
    res = P.batched_fit_frames(
        cfg, assets, cam, P.BatchedFitInputs(obs, torch.full((B,), 1080.0)),
        vposer_w=vw, device="cpu")
    return TE.pack(cfg.spec, res.params, res.z), res


def test_sharded_triangulate_matches_jax(worlds, problem):
    p = problem
    jmesh = jmake_mesh(JLayout(frames=1, cameras=2),
                       devices=jax.devices()[:2])
    cam_spec = JCamera(rotation=PS("cameras"), translation=PS("cameras"),
                       focal=PS("cameras"), center=PS("cameras"))
    views = PS(None, "cameras")

    @functools.partial(shard_map, mesh=jmesh,
                       in_specs=(cam_spec, views, views, views),
                       out_specs=PS(), check_vma=False)
    def sharded(c, g, cf, vm):
        return jax.vmap(lambda a, b, d: JCS.sharded_triangulate(
            c, a, b, d))(g, cf, vm)

    o = p["jo"]
    want_sharded = np.asarray(jax.jit(sharded)(p["jc"], o.gt2d, o.conf,
                                               o.view_mask))
    want = np.asarray(jax.jit(jax.vmap(
        lambda g, c, m: jtriangulate(p["jc"], g, c, m)))(o.gt2d, o.conf,
                                                         o.view_mask))
    got2 = _same_on_ranks(worlds[2], "triangulate").numpy()
    for ref in (want_sharded, want):
        np.testing.assert_allclose(got2, ref, rtol=1e-5, atol=1e-5)
    # 2x2: each frames block triangulates its own frames.
    for rank in worlds[4]:
        lo, hi = rank["frames"]
        np.testing.assert_allclose(rank["triangulate"].numpy(),
                                   want[lo:hi], rtol=1e-5, atol=1e-5)


def test_shard_blocks_match_jax_normal_equations(worlds, problem):
    p = problem
    jweights = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0)

    def one(xx, o):
        return JE.residual_jacobian(JE.EnergySpec(), p["ja"], p["jc"], o,
                                    jweights, p["jw"], None, xx)
    r, J = jax.jit(jax.vmap(one))(jnp.asarray(W.block_x()), p["jo"])
    r, J = np.asarray(r, np.float64), np.asarray(J, np.float64)
    JtJ = np.einsum("bmi,bmj->bij", J, J)
    g = np.einsum("bmi,bm->bi", J, r)
    got_JtJ, got_g = (t.numpy() for t in _same_on_ranks(worlds[2],
                                                         "blocks"))
    np.testing.assert_allclose(got_JtJ, JtJ, rtol=1e-5,
                               atol=1e-5 * np.abs(JtJ).max())
    np.testing.assert_allclose(got_g, g, rtol=1e-5,
                               atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("kind", ["vposer_3d", "no_vposer", "smplx_tail"])
def test_data_and_prior_residuals_match_jax(problem, kind):
    p = problem
    rng = np.random.default_rng(5)
    kw = {"vposer_3d": dict(use_3d=True),
          "no_vposer": dict(use_vposer=False),
          "smplx_tail": dict(hand_dim=6, num_expr=10, opt_face=True)}[kind]
    tspec, jspec = TE.EnergySpec(**kw), JE.EnergySpec(**kw)
    n = TE.num_unknowns(tspec)
    x = rng.normal(0, 0.1, (B, n)).astype(np.float32)
    x[:, TE.pose_dim(tspec) + 16] = 1.0          # scale
    gt3d = rng.normal(0, 0.5, (B, 17, 3)).astype(np.float32)
    conf3d = rng.uniform(0.5, 1.0, (B, 17)).astype(np.float32)
    to, jo = p["to"], p["jo"]
    if kind == "vposer_3d":
        to = TE.Observations(to.gt2d, to.conf, to.view_mask,
                             to.joint_weights, torch.from_numpy(gt3d),
                             torch.from_numpy(conf3d))
        jo = JE.Observations(jo.gt2d, jo.conf, jo.view_mask,
                             jo.joint_weights, jnp.asarray(gt3d),
                             jnp.asarray(conf3d))
    jweights = JE.StageWeights.make(data=500 / 1080.0, pose=57.4, shape=10.0)
    tweights = TE.StageWeights.make(data=torch.full((B,), 500 / 1080.0),
                                    pose=57.4, shape=10.0)
    xt = torch.from_numpy(x)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    prior = TE.prior_residuals(tspec, tweights, None, p["tw"], xt)
    close(prior, jax.jit(jax.vmap(lambda xx: JE.prior_residuals(
        jspec, jweights, None, p["jw"], xx)))(jnp.asarray(x)))
    if kind == "smplx_tail":      # the tail rows need no body model
        return
    for include_3d in (True, False):
        data = TE.data_residuals(tspec, p["ta"], p["tc"], to, tweights,
                                 p["tw"], xt, include_3d=include_3d)
        close(data, jax.jit(jax.vmap(lambda xx, o: JE.data_residuals(
            jspec, p["ja"], p["jc"], o, jweights, p["jw"], xx,
            include_3d=include_3d)))(jnp.asarray(x), jo))

    # The split leaves `residuals` as it was, bit for bit.
    res = TE.residuals(tspec, p["ta"], p["tc"], to, tweights, p["tw"],
                       None, xt)
    data = TE.data_residuals(tspec, p["ta"], p["tc"], to, tweights,
                             p["tw"], xt)
    torch.testing.assert_close(res, torch.cat([data, prior], -1), rtol=0,
                               atol=0)
    params, z, body_pose, _, joints = TE._forward(tspec, p["ta"], p["tw"],
                                                  xt)
    before = torch.cat([
        TE._data_rows_from_joints(tspec, p["tc"], to, tweights, joints),
        TE._prior_rows_core(tspec, tweights, None, z, body_pose,
                            params.betas),
        TE._tail_prior_rows(tspec, tweights, params)], dim=-1)
    torch.testing.assert_close(res, before, rtol=0, atol=0)


@pytest.mark.parametrize("world,key", [(2, "fit_1x2"), (4, "fit_2x2")])
def test_camera_sharded_fit_matches_one_card(worlds, world, key):
    cfg = FitConfig(lm=LMOptions(max_iters=5, linsolve="chol",
                                 speculative=False), **W.ONE_STAGE)
    x1, res = _one_card(cfg)
    got = _same_on_ranks(worlds[world], key)
    assert got.shape == (B, x1.shape[1] + 1)
    np.testing.assert_allclose(got[:, -1].numpy(), res.loss.numpy(),
                               rtol=5e-3)
    np.testing.assert_allclose(got[:, :-1].numpy(), x1.numpy(), atol=5e-2)
    assert len(np.unique(np.round(got[:, -1].numpy(), 3))) == B


def test_analytic_jacobian_matches_ad_sharded(worlds):
    ad = _same_on_ranks(worlds[4], "jac_ad")
    analytic = _same_on_ranks(worlds[4], "jac_analytic")
    np.testing.assert_allclose(analytic[:, -1].numpy(), ad[:, -1].numpy(),
                               rtol=1e-3)


def test_scan_stages_and_cap_match_unrolled(worlds):
    ranks = worlds[4]
    unrolled = _same_on_ranks(ranks, "unrolled")
    scan = _same_on_ranks(ranks, "scan")
    capped = _same_on_ranks(ranks, "capped")
    torch.testing.assert_close(scan, unrolled, rtol=0, atol=0)
    assert not np.allclose(capped[:, -1].numpy(), scan[:, -1].numpy(),
                           rtol=1e-6)


def test_frames_sharded_batched_fit_matches_one_card(worlds):
    cfg = FitConfig(lm=LMOptions(max_iters=5), **W.ONE_STAGE)
    _, res = _one_card(cfg)
    loss, iters, transl = _same_on_ranks(worlds[2], "batched")
    assert loss.shape == (B,) and iters.shape == (B, 1)
    assert transl.shape == (B, 3)
    np.testing.assert_allclose(loss.numpy(), res.loss.numpy(), rtol=1e-2)


def test_frames_sharded_schur_matches_one_card(worlds):
    from mvsmplfitting_tpu_torch.parallel.schur import schur_sequence_fit
    sa, sw, sc, so, _ = synthetic.make_person_sequence(W.SEQ, seed=0,
                                                       device="cpu")
    g = init_guess(sa, sc, so.gt2d, so.conf, so.view_mask)
    _, _, losses, shared, iters = schur_sequence_fit(
        FitConfig(lm=LMOptions(max_iters=6), **W.ONE_STAGE), sa, sc, so,
        g.params, g.z, vposer_w=sw, device="cpu")
    got_losses, got_shared, got_iters = _same_on_ranks(worlds[2], "schur")
    np.testing.assert_allclose(got_shared.numpy(), shared.numpy(), atol=0.15)
    np.testing.assert_allclose(got_losses.numpy(), losses.numpy(), rtol=0.3)
    assert len(got_iters) == len(iters) == 1


def test_local_batch_slices_and_layout_errors(worlds):
    assert [r["slice"] for r in worlds[2]] == [slice(0, 5), slice(5, 10)]
    assert [r["slice"] for r in worlds[4]] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert [r["frames"] for r in worlds[4]] == [(0, 2), (0, 2), (2, 4),
                                                (2, 4)]
    errors = _same_on_ranks(worlds[2], "errors")
    assert errors == {
        "layout": "mesh layout MeshLayout(frames=2, cameras=2) needs 4 "
                  "devices, got 2",
        "cameras_axis": "2 devices not divisible by cameras axis 3",
        "views": "5 items not divisible by the cameras axis (2)",
        "frames": "3 items not divisible by the frames axis (2)"}
    with pytest.raises(RuntimeError, match="init_distributed"):
        P.make_mesh()
    assert P.process_local_batch_slice(10) == slice(0, 10)
