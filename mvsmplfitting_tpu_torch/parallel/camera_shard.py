"""Camera-sharded Gauss-Newton fitting over `torch.distributed` (port of
`parallel/camera_shard.py`).

One frame's energy is a sum of per-view residual blocks plus priors.
With the views of each frame split over the `cameras` axis of a mesh,
each rank computes the Jacobian blocks of its own views only; the
normal equations of the shared body parameters are assembled with one
all_reduce of (J^T J, J^T r) per LM iteration over the `cameras` group,
and the prior (and 3D-joint) blocks are added once after it.  The step
is solved redundantly on every rank of the group (a replicated tiny
solve instead of a broadcast).  The `frames` axis splits the batch into
independent blocks that never communicate until the results are
gathered at the end.

Every rank of a `cameras` group takes the same loop turns: each turn's
all_reduce carries the ranks' per-frame "still running" flags, and the
loop ends when the reduced flags say no frame runs.  Ranks that disagree
on a frame raise together (each sees the mismatch in the same reduced
buffer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import jvp, vmap

from ..device import DeviceLike, resolve_device
from ..fitting import energy as E
from ..fitting.energy import Observations, StageWeights
from ..fitting.initialize import torso_indices
from ..fitting.lm import _solve_spd, ad_jacobian, stack_stages
from ..fitting.stages import FitConfig, default_stages, frame_heights
from ..models.camera import Camera
from ..models.smpl import SMPLParams, rest_joints
from ..ops.alignment import umeyama
from ..ops.rotations import matrix_to_axis_angle
from ..ops.triangulate import backproject_rays
from .mesh import CAMERAS_AXIS, axis_block, frames_slice, gather_frames


def sharded_triangulate(cam_l: Camera, gt2d: torch.Tensor,
                        conf: torch.Tensor, view_mask: torch.Tensor,
                        group=None) -> torch.Tensor:
    """Confidence-weighted DLT triangulation with the views split over
    the ranks of `group` (None: the whole world): each rank builds the
    3x3 normal-equation blocks of its own views, one all_reduce sums
    them, and every rank solves.  The same math as
    `ops.triangulate.triangulate` on all views, up to the order of the
    sum over views.

    Args are this rank's views: gt2d (B, Vl, K, 2), conf (B, Vl, K),
    view_mask (B, Vl).  Returns (B, K, 3).
    """
    n = backproject_rays(cam_l, gt2d)                        # (B, Vl, K, 3)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    nmat = eye - torch.einsum("zvka,zvkc->zvkac", n, n)
    rn = torch.einsum("vba,zvkbc->zvkac", cam_l.rotation, nmat)
    w = (conf + 1e-6) * view_mask[:, :, None]
    AtA = torch.einsum("zvk,zvkac,vcd->zkad", w, rn, cam_l.rotation)
    Atb = torch.einsum("zvk,zvkac,vc->zka", -w, rn, cam_l.translation)
    buf = torch.cat([AtA.flatten(-2), Atb], dim=-1)          # (B, K, 12)
    dist.all_reduce(buf, group=group)
    AtA = buf[..., :9].unflatten(-1, (3, 3))
    return torch.linalg.solve(AtA, buf[..., 9:, None])[..., 0]


def _jvp_columns(fn, primals, tangents) -> torch.Tensor:
    """(B, m, n) Jacobian of fn at primals from per-column tangents, each
    (B, n, ...)."""
    def column(*t):
        return jvp(fn, primals, t)[1]
    return vmap(column, in_dims=1, out_dims=2)(*tangents)


def _shard_rows(cfg: FitConfig, assets, vposer_w, gmm, cam_l: Camera,
                obs_l: Observations, weights: StageWeights):
    """(rows, r_and_J): x -> (data rows of this rank's views, prior and
    3D-joint rows) and x -> (r_d, J_d, r_p, J_p).

    The 3D-joint rows are view-independent, so they sit with the priors
    and are counted once, not once per camera rank.  The Jacobian is the
    closed form (`energy._analytic_core`, the joint-Jacobian and
    VPoser-tail kernels on the card, shared by both halves) where it
    covers the energy and the collision term is off (JAX's
    `camera_shard.py:82-84`), else forward-mode AD; no collision row is
    ever added.
    """
    spec, opts = cfg.spec, cfg.lm
    use_3d = spec.use_3d and obs_l.gt3d is not None

    def data_res(x):
        return E.data_residuals(spec, assets, cam_l, obs_l, weights,
                                vposer_w, x, include_3d=False)

    def prior_res(x):
        rows = [E.prior_residuals(spec, weights, gmm, vposer_w, x)]
        if use_3d:
            rows.append(E.joints3d_residuals(spec, assets, obs_l, weights,
                                             vposer_w, x))
        return torch.cat(rows, dim=-1)

    use_analytic = (opts.jac == "analytic"
                    and E.analytic_jac_ok(spec, assets)
                    and not spec.interpenetration)

    def analytic(x):
        (joints, djoints, z_in, dz, body_pose, dbp, betas, dbe) = \
            E._analytic_core(spec, assets, vposer_w, x)

        def drows(j):
            return E._data_rows_from_joints(spec, cam_l, obs_l, weights, j,
                                            include_3d=False)

        def prows(j, zz, bp, be):
            rows = [E._prior_rows_core(spec, weights, gmm, zz, bp, be)]
            if use_3d:
                rows.append(E._joints3d_rows(spec, obs_l, weights, j))
            return torch.cat(rows, dim=-1)

        primals = (joints, z_in, body_pose, betas)
        return (drows(joints), _jvp_columns(drows, (joints,), (djoints,)),
                prows(*primals),
                _jvp_columns(prows, primals, (djoints, dz, dbp, dbe)))

    def autodiff(x):
        return ad_jacobian(data_res, x) + ad_jacobian(prior_res, x)

    return (data_res, prior_res), (analytic if use_analytic else autodiff)


def _assemble(r_and_J, mask: torch.Tensor, x: torch.Tensor, group,
              flags: torch.Tensor, running: bool = True):
    """One all_reduce over `group` of this rank's data blocks (J^T J_d,
    J^T r_d) and per-frame `flags`; returns (J^T J, J^T r) with the prior
    blocks added once, and the summed flags.  Not `running`: zeros in
    place of the blocks (nothing is evaluated), (None, None, flags)."""
    B, n = x.shape
    if running:
        rd, Jd, rp, Jp = r_and_J(x)
        Jd, Jp = Jd * mask, Jp * mask
        JdT = Jd.transpose(1, 2)
        blocks = [(JdT @ Jd).flatten(1), (JdT @ rd[..., None])[..., 0]]
    else:
        blocks = [x.new_zeros((B, n * n + n))]
    buf = torch.cat(blocks + [flags[:, None]], dim=-1)
    dist.all_reduce(buf, group=group)
    if not running:
        return None, None, buf[:, -1]
    JpT = Jp.transpose(1, 2)
    return (buf[:, :n * n].unflatten(1, (n, n)) + JpT @ Jp,
            buf[:, n * n:n * n + n] + (JpT @ rp[..., None])[..., 0],
            buf[:, -1])


def _lm_sharded(cfg: FitConfig, assets, vposer_w, gmm, cam_l: Camera,
                obs_l: Observations, weights: StageWeights, x0: torch.Tensor,
                group, max_iters: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classic LM on this rank's frames with the data blocks summed over
    `group` (JAX `camera_shard.py:44-163`), each frame with its own
    lambda and stop.  Returns (x (B, n), loss (B,), iterations (B,)).

    Per iteration: one all_reduce of (J^T J_d, J^T r_d, running flags),
    B (n^2 + n + 1) floats, and one of the trial data loss, B floats.
    """
    opts = cfg.lm
    (data_res, prior_res), r_and_J = _shard_rows(
        cfg, assets, vposer_w, gmm, cam_l, obs_l, weights)
    mask = E.free_mask(cfg.spec, x0.device)
    B, n = x0.shape
    dtype, device = x0.dtype, x0.device
    eye = torch.eye(n, dtype=dtype, device=device)
    cams = dist.get_world_size(group)

    def loss_of(x):
        rd, rp = data_res(x), prior_res(x)
        ld = torch.sum(rd * rd, dim=-1)
        dist.all_reduce(ld, group=group)
        return ld + torch.sum(rp * rp, dim=-1)

    x, loss = x0, loss_of(x0)
    lam = torch.full((B,), opts.init_lambda, dtype=dtype, device=device)
    it = torch.zeros((B,), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)

    while True:
        local = (it < max_iters) & ~done
        running = bool(local.any())   # the last turn sends only flags
        flags = local.to(dtype)
        JtJ, g, summed = _assemble(r_and_J, mask, x, group, flags, running)
        if not torch.equal(summed, flags * cams):
            raise RuntimeError("the ranks of a cameras group disagree on "
                               "which frames are still running")
        if not running:
            break

        diag = torch.clamp_min(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-8)
        A = JtJ + lam[:, None, None] * torch.diag_embed(diag) + 1e-12 * eye
        dx = -_solve_spd(A, g, opts.linsolve, opts.schulz_iters) * mask

        new_x = x + dx
        new_loss = loss_of(new_x)
        accept = torch.isfinite(new_loss) & (new_loss < loss)
        rel = torch.abs(loss - new_loss) / torch.clamp_min(
            torch.maximum(torch.abs(loss), torch.abs(new_loss)), 1.0)
        step_done = (done | (accept & (rel <= opts.ftol))
                     | (torch.amax(torch.abs(g), dim=-1) < opts.gtol))
        step_lam = torch.clamp(
            torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
            opts.min_lambda, opts.max_lambda)

        take = local & accept
        x = torch.where(take[:, None], new_x, x)
        loss = torch.where(take, new_loss, loss)
        lam = torch.where(local, step_lam, lam)
        done = torch.where(local, step_done, done)
        it = it + local.to(it.dtype)
    return x, loss, it


def _view_block(cam: Camera, views: slice) -> Camera:
    return Camera(*(getattr(cam, f.name)[views]
                    for f in dataclasses.fields(cam)))


def _obs_block(obs: Observations, frames: slice, views: slice
               ) -> Observations:
    def f(t):
        return None if t is None else t[frames]
    return Observations(gt2d=obs.gt2d[frames, views],
                        conf=obs.conf[frames, views],
                        view_mask=obs.view_mask[frames, views],
                        joint_weights=f(obs.joint_weights),
                        gt3d=f(obs.gt3d), conf3d=f(obs.conf3d))


def camera_sharded_fit(cfg: FitConfig, assets, cam: Camera,
                       obs: Observations, mesh, vposer_w=None, gmm=None,
                       img_height=1080.0, est_scale: bool = True,
                       max_iters_cap: Optional[int] = None,
                       scan_stages: bool = False,
                       device: DeviceLike = None):
    """Fit a frame batch on a (frames, cameras) mesh (`mesh.make_mesh`),
    on `device` (CUDA unless ``device="cpu"``).

    Every rank passes the whole batch and fits its own block: the frames
    of its `frames` coordinate, the views of its `cameras` coordinate.
    Each frame starts from the sharded triangulation and umeyama on the
    torso, with zero betas, pose and latent (JAX `camera_shard.py:
    246-267`; no single-view fallback, no 3D-joint start), then runs the
    annealing stages with `_lm_sharded`.

    Args:
      obs: (B, V, ...) observations; B divisible by the frames axis, V
        by the cameras axis.
      img_height: a scalar, or (B,) per frame.
      max_iters_cap: replaces ``cfg.lm.max_iters`` per stage.
      scan_stages: run the stages as rows of one stacked weights table
        (JAX's `lax.scan` form, the collision flag cleared); in PyTorch
        both forms are the same Python loop over the same tensors.

    Returns:
      (x (B, n) packed parameters, loss (B,) at the last stage's weights),
      the whole batch on every rank.
    """
    dev = resolve_device(device)
    spec = cfg.spec
    B, V = obs.gt2d.shape[:2]
    fs = frames_slice(mesh, B)
    vs = axis_block(mesh, CAMERAS_AXIS, V)
    group = mesh.get_group(CAMERAS_AXIS)
    assets = assets.to(dev)
    cam_l = _view_block(cam, vs).to(dev)
    obs_l = _obs_block(obs, fs, vs).to(dev)
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    gmm = None if gmm is None else gmm.to(dev)
    cap = cfg.lm.max_iters if max_iters_cap is None else int(max_iters_cap)

    joints3d = sharded_triangulate(cam_l, obs_l.gt2d, obs_l.conf,
                                   obs_l.view_mask, group)
    Bl = joints3d.shape[0]
    torso = torso_indices(assets.model_type)
    rot, trans, scale = umeyama(rest_joints(assets)[torso].expand(Bl, -1, -1),
                                joints3d[:, torso], est_scale)
    zeros = joints3d.new_zeros
    params = SMPLParams(betas=zeros((Bl, assets.num_betas)),
                        global_orient=matrix_to_axis_angle(rot),
                        body_pose=zeros((Bl, 69)), transl=trans, scale=scale)
    x = E.pack(spec, params,
               zeros((Bl, E.LATENT_DIM)) if spec.use_vposer else None)

    h = torch.as_tensor(img_height, dtype=torch.float32, device=dev)
    stages = default_stages(cfg, frame_heights(h[fs] if h.dim() else h, x))
    if scan_stages:
        table = stack_stages([dataclasses.replace(s, coll_on=False)
                              for s in stages])
        stages = [dataclasses.replace(table, **{
            f.name: getattr(table, f.name)[i]
            for f in dataclasses.fields(table)
            if isinstance(getattr(table, f.name), torch.Tensor)})
            for i in range(len(stages))]

    loss = x.new_zeros((Bl,))
    for weights in stages:
        x, loss, _ = _lm_sharded(cfg, assets, vposer_w, gmm, cam_l, obs_l,
                                 weights, x, group, cap)
    return gather_frames(mesh, x, B), gather_frames(mesh, loss, B)
