"""Sequence fit with one shared shape by Schur-complement elimination
(port of `parallel/schur.py`), on one card or with the frames split over
the `frames` axis of a mesh.

One person has one shape, so a sequence couples a shared (betas, scale)
block against per-frame (pose block, orient, transl) blocks.  The
Gauss-Newton normal equations have block-arrow structure:

    [ A_1          B_1 ] [dx_1]   [g_1]
    [      ...     ...  ] [ ...] = [...]
    [          A_B B_B ] [dx_B]   [g_B]
    [ B_1^T ... B_B^T C ] [ ds ]   [h ]

Each frame's A_f (38 x 38 with VPoser) is inverted on its own; the shared
step solves the 11 x 11 Schur complement S = C - sum_f B_f^T A_f^-1 B_f.
JAX's `psum` over the frames mesh axis is a sum over the frame axis here,
and with a mesh each rank fits its block of frames and one all_reduce
over `frames` per iteration adds the ranks' sums (C, B^T A^-1 B, h,
B^T A^-1 g: 2 (ns^2 + ns) floats), a second the trial loss.  Every rank
then solves the same shared step from the same sums, so all take the
same accepts and loop turns.  The sequence has one LM lambda, one accept
and one ftol stop, judged on the loss summed over all frames, so a
frame's result depends on the whole sequence.

Each iteration takes the packed per-frame Jacobian (B, m, n) from
`stages.stage_jacobian`, whose per-stage choice the batched fit shares:
the closed form (the joint-Jacobian and VPoser-tail kernels on the card)
where it covers the energy, else forward-mode AD, and AD with each
frame's voxel grid held fixed on a stage whose collision term is on.
The frame/shared split is a column gather.  JAX's `use_analytic`
(`schur.py:100`) ignores the collision gate, so there its collision
stages linearize without the collision row while the trial loss keeps
it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..fitting import energy as E
from ..fitting.energy import EnergySpec, Observations
from ..fitting.lm import _solve_spd, _spd_inv, ad_jacobian
from ..fitting.stages import (FitConfig, default_stages, frame_heights,
                              stage_jacobian)
from ..models.camera import Camera
from ..models.smpl import SMPLParams
from .mesh import FRAMES_AXIS, frames_slice, gather_frames

# Parameter split: shared = [betas (NB), scale (1)]; per frame = [pose
# block (32 or 69), orient (3), transl (3)].


def split_dims(spec: EnergySpec) -> Tuple[int, int]:
    """(per-frame, shared) widths.  The SMPL-H/X tail blocks have no
    place in the split: JAX's `split_dims` (`schur.py:48-52`) leaves
    them out, so its residuals read them past the end of the packed
    vector; the port refuses them."""
    if E.extra_dims(spec):
        raise ValueError("schur_sequence_fit covers the body blocks only; "
                         "the SMPL-H/X tail blocks (hand_dim, num_expr, "
                         "opt_face) have no place in its split")
    return E.pose_dim(spec) + 6, spec.num_betas + 1


def _assemble_x(spec: EnergySpec, xf: torch.Tensor, xs: torch.Tensor
                ) -> torch.Tensor:
    """(per-frame (B, nf), shared (ns,)) -> the packed layout (B, n)
    [pose, betas, orient, transl, scale]."""
    p, nb = E.pose_dim(spec), spec.num_betas
    s = xs.expand(xf.shape[0], -1)
    return torch.cat([xf[:, :p], s[:, :nb], xf[:, p:p + 6], s[:, nb:]],
                     dim=-1)


def schur_sequence_fit(cfg: FitConfig, assets, cam: Camera,
                       obs: Observations, init_params: SMPLParams,
                       init_z: torch.Tensor, vposer_w=None, gmm=None,
                       img_height=1080.0, mesh=None,
                       device: DeviceLike = None):
    """Fit B frames of one person with one shared (betas, scale) on
    `device` (CUDA unless ``device="cpu"``).

    Args:
      obs: (B, V, ...) observations of one person over time.
      init_params / init_z: (B, ...) per-frame initial guesses; the
        shared block starts from frame 0's.
      img_height: a scalar, or (B,) per frame.
      mesh: optional (frames, cameras) mesh (`mesh.make_mesh`): every
        rank passes the whole sequence, fits the frames of its `frames`
        coordinate (ranks that differ only in `cameras` repeat the same
        work) and gets the whole result back; B divisible by the frames
        axis.

    Returns:
      (params (B, ...), z (B, 32), per-frame losses at the last stage's
      weights (B,), shared (NB + 1,), LM iterations per stage (S,)).
    """
    dev = resolve_device(device)
    spec, opts = cfg.spec, cfg.lm
    nf, ns = split_dims(spec)
    B_all = obs.gt2d.shape[0]
    fs = slice(None) if mesh is None else frames_slice(mesh, B_all)
    group = None if mesh is None else mesh.get_group(FRAMES_AXIS)

    def frames_sum(t):
        """A sum over the sequence's frames from this rank's sum."""
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    assets, cam = assets.to(dev), cam.to(dev)
    obs = Observations(*(None if t is None else t[fs].to(dev)
                         for t in (getattr(obs, f.name)
                                   for f in dataclasses.fields(obs))))
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    gmm = None if gmm is None else gmm.to(dev)
    init_params = SMPLParams(**{k: None if v is None else v.to(dev)
                                for k, v in vars(init_params).items()})
    init_z = init_z.to(dev)

    p, nb = E.pose_dim(spec), spec.num_betas
    f_cols = torch.tensor(list(range(p)) + list(range(p + nb, p + nb + 6)),
                          device=dev)
    s_cols = torch.tensor(list(range(p, p + nb)) + [p + nb + 6], device=dev)
    smask = torch.tensor([0.0 if spec.fix_shape else 1.0] * nb
                         + [0.0 if spec.fix_scale else 1.0], device=dev)
    eye_f = torch.eye(nf, device=dev)
    eye_s = torch.eye(ns, device=dev)

    xf = torch.cat([init_z if spec.use_vposer else init_params.body_pose,
                    init_params.global_orient, init_params.transl],
                   dim=-1)[fs]
    xs = torch.cat([init_params.betas[0], init_params.scale[:1]])
    heights = torch.as_tensor(img_height, dtype=torch.float32, device=dev)
    stages = default_stages(cfg, frame_heights(
        heights[fs] if heights.dim() else heights, xf))
    stage_iters: List[int] = []

    for weights in stages:
        def res(x, weights=weights):
            return E.residuals(spec, assets, cam, obs, weights, vposer_w,
                               gmm, x)

        jac = stage_jacobian(cfg, assets, cam, obs, weights, vposer_w, gmm)
        if jac is None:
            def jac(x, res=res):
                return ad_jacobian(res, x)

        def total(xf_, xs_, res=res):
            r = res(_assemble_x(spec, xf_, xs_))
            return frames_sum(torch.sum(r * r)[None])[0]

        loss = total(xf, xs)
        lam = torch.tensor(opts.init_lambda, device=dev)
        it = 0
        while it < opts.max_iters:
            r, J = jac(_assemble_x(spec, xf, xs))
            Jf, Js = J[:, :, f_cols], J[:, :, s_cols]
            JfT = Jf.transpose(1, 2)
            A, Bm = JfT @ Jf, JfT @ Js
            gf = (JfT @ r[..., None])[..., 0]
            C = torch.sum(Js.transpose(1, 2) @ Js, dim=0)
            h = torch.sum((Js.transpose(1, 2) @ r[..., None])[..., 0], dim=0)

            dA = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1), 1e-8)
            A_inv = _spd_inv(A + lam * torch.diag_embed(dA) + 1e-12 * eye_f)
            BtAi = Bm.transpose(1, 2) @ A_inv                  # (B, ns, nf)
            BtAiB = torch.sum(BtAi @ Bm, dim=0)
            BtAig = torch.sum((BtAi @ gf[..., None])[..., 0], dim=0)
            if group is not None:
                sums = frames_sum(torch.cat([C.flatten(), BtAiB.flatten(),
                                             h, BtAig]))
                C, BtAiB = (sums[i * ns * ns:(i + 1) * ns * ns].view(ns, ns)
                            for i in range(2))
                h, BtAig = sums[2 * ns * ns:].view(2, ns)
            dC = torch.clamp_min(torch.diagonal(C), 1e-8)
            S = C - BtAiB + lam * torch.diag(dC) + 1e-12 * eye_s
            ds = -_solve_spd(S[None], (h - BtAig)[None], "chol")[0]
            dxf = -(A_inv @ (gf + Bm @ ds)[..., None])[..., 0]
            ds = ds * smask            # fix_shape / fix_scale

            new_xf, new_xs = xf + dxf, xs + ds
            total_new = total(new_xf, new_xs)
            accept = bool(torch.isfinite(total_new) & (total_new < loss))
            rel = torch.abs(loss - total_new) / torch.clamp_min(
                torch.maximum(torch.abs(loss), torch.abs(total_new)), 1.0)
            it += 1
            if accept:
                xf, xs, loss = new_xf, new_xs, total_new
                lam = torch.clamp_min(lam * opts.lambda_down,
                                      opts.min_lambda)
                if bool(rel <= opts.ftol):
                    break
            else:
                lam = torch.clamp_max(lam * opts.lambda_up, opts.max_lambda)
        stage_iters.append(it)

    r = E.residuals(spec, assets, cam, obs, stages[-1], vposer_w, gmm,
                    _assemble_x(spec, xf, xs))
    losses = torch.sum(r * r, dim=-1)
    if mesh is not None:
        xf = gather_frames(mesh, xf, B_all)
        losses = gather_frames(mesh, losses, B_all)

    B = xf.shape[0]
    params = SMPLParams(
        betas=xs[:nb].expand(B, nb).clone(),
        global_orient=xf[:, p:p + 3],
        body_pose=(xf.new_zeros((B, 69)) if spec.use_vposer
                   else xf[:, :p]),
        transl=xf[:, p + 3:p + 6],
        scale=xs[nb].expand(B).clone())
    z = xf[:, :p] if spec.use_vposer else xf.new_zeros((B, E.LATENT_DIM))
    return params, z, losses, xs, stage_iters
