"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Needs a CUDA card and imports neither JAX nor the JAX package, so it
also runs where JAX is not installed (the conftest, which imports JAX,
can be left out):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py -q

Without a GPU every test skips.  Tolerances are the kernel ones: RTOL
3e-5 / ATOL 1e-5 (fp32 reassociation); the VPoser D block at rtol 3e-4 /
atol 3e-4 max|D|.  The joint-Jacobian and tail kernels run at B=1, 130
(not a multiple of the joint kernel's 8-frame tiles, so its ragged last
tile is covered) and 512 (the batched fit's batch).  The SDF
voxelizers are compared bitwise (see `test_sdf_kernels_on_card`).  The
points engine's field (plain PyTorch on both devices) holds the CPU's
inside set at atol 1e-5, and the fused fit and an L-BFGS stage the
CPU's stage losses at rtol 1e-3.  The no-VPoser `residual_jacobian`
(GMM prior, 86 columns) holds its plain-kernel twin at RTOL and the
joint-Jacobian test's rtol 2e-4 on J.  SMPL-H/X fit stages and the
Schur sequence fit hold the CPU's losses at rtol 1e-3 (the Schur shared
block at rtol 1e-3 and atol 1e-4: its betas are near 0).
"""

import numpy as np
import pytest
import torch

from mvsmplfitting_tpu_torch.models import vposer as V
from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
from mvsmplfitting_tpu_torch.ops import sdf as sdf_ops
from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK
from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ

from torch_port_helpers import port_assets, posed_bodies, rand_joint_inputs

RTOL = 3e-5
ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 130, 512])
@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_joint_jacobian_kernel_on_card(cuda_device, model_type, B):
    jm = port_assets(model_type).joint_model.to(cuda_device)
    theta, betas, scale = (torch.from_numpy(a).to(cuda_device)
                           for a in rand_joint_inputs(
                               np.random.default_rng(4), B))
    before = JK.LAUNCHES
    gj, gb = JK.joint_jacobian_batched(jm, theta, betas, scale)
    torch.cuda.synchronize()
    assert JK.LAUNCHES == before + 1
    wj, wb = JK.joint_jacobian_plain(jm, theta, betas, scale)
    torch.testing.assert_close(gj, wj, rtol=RTOL, atol=ATOL)
    for k in wb:
        torch.testing.assert_close(gb[k], wb[k], rtol=RTOL, atol=ATOL,
                                   msg=f"{model_type} block {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 130, 512])
@pytest.mark.parametrize("sigma", [0.6, 1e-3])
def test_vposer_tail_kernel_on_card(cuda_device, sigma, B):
    w = V.load_npz(VPOSER_NPZ, device=cuda_device)
    z = torch.from_numpy(np.random.default_rng(5).normal(
        0, sigma, (B, 32)).astype(np.float32)).to(cuda_device)
    before = VK.LAUNCHES
    aa1, D1 = VK.decode_jac_batched(w, z)
    torch.cuda.synchronize()
    assert VK.LAUNCHES == before + 1
    aa0, D0 = V.decode_jac(w, z)
    torch.testing.assert_close(aa1, aa0, rtol=RTOL, atol=ATOL)
    sc = max(D0.abs().max().item(), 1.0)
    torch.testing.assert_close(D1, D0, rtol=3e-4, atol=3e-4 * sc)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda_device, monkeypatch):
    """On the card the wrappers launch the kernels: the plain versions
    must not be reached."""
    def refuse(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(JK, "joint_jacobian_plain", refuse)
    monkeypatch.setattr(VK, "tail_plain", refuse)
    monkeypatch.setattr(SK, "sdf_grid", refuse)
    jm = port_assets("smpl").joint_model.to(cuda_device)
    theta, betas, scale = (torch.from_numpy(a).to(cuda_device)
                           for a in rand_joint_inputs(
                               np.random.default_rng(6), 4))
    JK.joint_jacobian_batched(jm, theta, betas, scale)
    w = V.load_npz(VPOSER_NPZ, device=cuda_device)
    VK.decode_jac_batched(w, torch.zeros((4, 32), device=cuda_device))
    verts, faces = posed_bodies()
    SK.sdf_grid_fast(verts.to(cuda_device), faces, 16)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sdf_kernels_on_card(cuda_device):
    """Both voxelizers on two posed bodies at G=32 (one launch per
    wrapper for the pair): bitwise equal to each other and to the plain
    version, which runs the same IEEE operations (`csrc/sdf_common.cuh`);
    each one's work list holds exactly the inside voxels."""
    verts, faces = posed_bodies()
    verts, faces = verts.to(cuda_device), faces.to(cuda_device)
    tri = sdf_ops.triangles(verts, faces)
    before = dict(SK.LAUNCHES)
    b3, work3 = SK.sdf_grid_cuda(tri, 32, with_work=True)
    b4 = SK.sdf_grid_fast(verts, faces, 32)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["sdf_grid"] == before["sdf_grid"] + 1
    assert SK.LAUNCHES["sdf_cross"] == before["sdf_cross"] + 1
    assert SK.LAUNCHES["sdf_dist"] == before["sdf_dist"] + 1
    plain = sdf_ops.sdf_grid(verts, faces, 32)
    assert int((plain > 0).sum()) > 100
    assert torch.equal(b4, b3)
    assert torch.equal(b3, plain)
    # Phase A's work list holds each inside voxel once; every group of
    # phase B visited a chunk.
    _, work = SK.sdf_grid_fast_cuda(tri, 32, with_work=True)
    n = int(work["counts"][0])
    listed = work["work"][:n * SK.GROUP]
    listed = listed[listed >= 0].long()
    inside = torch.zeros(b3.numel(), dtype=torch.bool, device=cuda_device)
    inside[listed] = True
    assert listed.numel() == int(inside.sum())
    assert torch.equal(inside.reshape(b3.shape), b3 > 0)
    assert bool((work["visits"][:n] > 0).all())
    # The brute force's lists (mesh m's in row m) hold the same voxels.
    listed3 = torch.cat([work3["work"][m, :int(work3["counts"][m])].long()
                         + m * 32 ** 3 for m in range(tri.shape[0])])
    assert torch.equal(torch.sort(listed3).values,
                       torch.sort(listed).values)


@pytest.mark.cuda
def test_point_field_on_card(cuda_device):
    """The points engine's field on the card against the CPU: each posed
    body's vertices in the other's field."""
    verts, faces = posed_bodies()
    before = sdf_ops.FIELD_EVALS
    for i in range(2):
        q, mesh = verts[1 - i], verts[i]
        card = sdf_ops._sdf_at_points_impl(q.to(cuda_device),
                                           mesh.to(cuda_device),
                                           faces.to(cuda_device))
        cpu = sdf_ops._sdf_at_points_impl(q, mesh, faces)
        phi, closest, inside = (t.cpu() for t in card)
        assert int(cpu[2].sum()) > 100
        assert torch.equal(inside, cpu[2])
        torch.testing.assert_close(phi, cpu[0], rtol=0.0, atol=1e-5)
        torch.testing.assert_close(closest[inside], cpu[1][cpu[2]],
                                   rtol=0.0, atol=1e-5)
    assert sdf_ops.FIELD_EVALS == before + 4


@pytest.mark.cuda
def test_fused_fit_on_card(cuda_device):
    """`FitConfig.fused` (all stages in one LM loop, chol, classic LM, 3
    iterations per stage) on 2 frames: the card against the CPU."""
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    cfg = FitConfig(lm=LMOptions(max_iters=3, linsolve="chol",
                                 speculative=False), fused=True)
    losses = []
    for d in (cuda_device, torch.device("cpu")):
        assets, vw, cam, obs = make_problem(6, 2, seed=1, device=d)
        res = batched_fit_frames(
            cfg, assets, cam, BatchedFitInputs(obs, torch.full(
                (2,), 1080.0, device=d)), vposer_w=vw, device=d)
        assert res.lm_iters.tolist() == [[3] * 4] * 2
        losses.append(res.stage_losses.cpu())
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-3, atol=0.0)


@pytest.mark.cuda
def test_no_vposer_residual_jacobian_on_card(cuda_device, monkeypatch):
    """The GMM-prior energy without VPoser (86 unknowns: the joint
    kernel's pose columns unchained): `residual_jacobian` with the kernel
    against the same call with the kernel's plain version, on the card,
    at the kernel tolerances scaled to the largest entry."""
    from mvsmplfitting_tpu_torch.fitting import energy as E
    from mvsmplfitting_tpu_torch.models.priors import random_gmm
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    assets, vw, cam, obs = make_problem(6, 4, seed=2, device=cuda_device)
    gmm = random_gmm(device=cuda_device)
    spec = E.EnergySpec(use_vposer=False, prior_type="gmm")
    w = E.StageWeights.make(data=torch.full((4,), 500 / 1080.0,
                                            device=cuda_device),
                            pose=4.78, shape=5.0, device=cuda_device)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 0.2, (4, 86)).astype(np.float32)
    x[:, 85] = 1.0
    x = torch.from_numpy(x).to(cuda_device)
    jb, vb = JK.LAUNCHES, VK.LAUNCHES
    r1, J1 = E.residual_jacobian(spec, assets, cam, obs, w, None, gmm, x)
    torch.cuda.synchronize()
    assert (JK.LAUNCHES - jb, VK.LAUNCHES - vb) == (1, 0)
    assert J1.shape[-1] == 86
    monkeypatch.setattr(JK, "joint_jacobian_batched",
                        JK.joint_jacobian_plain)
    r0, J0 = E.residual_jacobian(spec, assets, cam, obs, w, None, gmm, x)
    torch.testing.assert_close(r1, r0, rtol=RTOL,
                               atol=ATOL * r0.abs().max().item())
    torch.testing.assert_close(J1, J0, rtol=2e-4,
                               atol=2e-4 * J0.abs().max().item())


@pytest.mark.cuda
def test_lbfgs_stage_on_card(cuda_device):
    """One strong-Wolfe L-BFGS stage (3 iterations) on 2 frames: the card
    against the CPU, stage losses at rtol 1e-3; no kernel launches (the
    gradient is one reverse pass through the plain joint model)."""
    from mvsmplfitting_tpu_torch.fitting.lbfgs import LBFGSOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    cfg = FitConfig(solver="lbfgs", pose_weights=(57.4,),
                    shape_weights=(10.0,), coll_weights=(0.0,),
                    lbfgs=LBFGSOptions(max_iters=3))
    losses = []
    for d in (cuda_device, torch.device("cpu")):
        assets, vw, cam, obs = make_problem(6, 2, seed=1, device=d,
                                            model_type="smpllsp")
        jb, vb = JK.LAUNCHES, VK.LAUNCHES
        res = batched_fit_frames(
            cfg, assets, cam, BatchedFitInputs(obs, torch.full(
                (2,), 1080.0, device=d)), vposer_w=vw, device=d)
        assert (JK.LAUNCHES, VK.LAUNCHES) == (jb, vb)
        assert res.lm_iters.tolist() == [[3]] * 2
        losses.append(res.stage_losses.cpu())
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-3, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["smplh", "smplx"])
def test_family_fit_on_card(cuda_device, model_type):
    """One LM stage (chol, classic, 3 iterations) of SMPL-H / SMPL-X with
    every tail block on 2 frames: the card against the CPU, stage losses
    at rtol 1e-3; no kernel launches (the AD Jacobian, as in JAX)."""
    from mvsmplfitting_tpu_torch.fitting.energy import EnergySpec
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel.batched import (
        BatchedFitInputs, batched_fit_frames)
    from mvsmplfitting_tpu_torch.synthetic import make_problem

    spec = (EnergySpec(hand_dim=6, num_expr=10, opt_face=True)
            if model_type == "smplx" else EnergySpec(hand_dim=6))
    cfg = FitConfig(spec=spec, pose_weights=(57.4,), shape_weights=(10.0,),
                    coll_weights=(0.0,),
                    lm=LMOptions(max_iters=3, linsolve="chol",
                                 speculative=False))
    cpu = make_problem(6, 2, seed=1, device="cpu", model_type=model_type)
    losses = []
    for d in (cuda_device, torch.device("cpu")):
        assets, vw, cam, obs = (v.to(d) for v in cpu)
        jb, vb = JK.LAUNCHES, VK.LAUNCHES
        res = batched_fit_frames(
            cfg, assets, cam, BatchedFitInputs(obs, torch.full(
                (2,), 1080.0, device=d)), vposer_w=vw, device=d)
        assert (JK.LAUNCHES, VK.LAUNCHES) == (jb, vb)
        assert res.params.left_hand_pose.shape == (2, 6)
        losses.append(res.stage_losses.cpu())
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-3, atol=0.0)


@pytest.mark.cuda
def test_schur_on_card(cuda_device):
    """`schur_sequence_fit` (one stage, chol, 3 LM iterations) on a
    4-frame sequence: B1 and B2 once per iteration on the card, and the
    card against the CPU (losses rtol 1e-3; the shared block rtol 1e-3,
    atol 1e-4, its betas being near 0)."""
    from mvsmplfitting_tpu_torch.fitting.initialize import init_guess
    from mvsmplfitting_tpu_torch.fitting.lm import LMOptions
    from mvsmplfitting_tpu_torch.fitting.stages import FitConfig
    from mvsmplfitting_tpu_torch.parallel.schur import schur_sequence_fit
    from mvsmplfitting_tpu_torch.synthetic import make_person_sequence

    cfg = FitConfig(pose_weights=(57.4,), shape_weights=(10.0,),
                    coll_weights=(0.0,),
                    lm=LMOptions(max_iters=3, linsolve="chol",
                                 speculative=False))
    cpu = make_person_sequence(4, seed=1, device="cpu")[:4]
    out = []
    for d in (cuda_device, torch.device("cpu")):
        assets, vw, cam, obs = (v.to(d) for v in cpu)
        g = init_guess(assets, cam, obs.gt2d, obs.conf, obs.view_mask)
        jb, vb = JK.LAUNCHES, VK.LAUNCHES
        _, _, losses, shared, iters = schur_sequence_fit(
            cfg, assets, cam, obs, g.params, g.z, vposer_w=vw, device=d)
        launched = (JK.LAUNCHES - jb, VK.LAUNCHES - vb)
        assert launched == ((3, 3) if d.type == "cuda" else (0, 0))
        assert iters == [3]
        out.append((losses.cpu(), shared.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-3, atol=1e-4)
