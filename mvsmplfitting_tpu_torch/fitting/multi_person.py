"""Multi-person fitting with interpenetration coupling (port of
`fitting/multi_person.py`, grid engine).

1. Independent staged fits, the people as the batch axis, with the
   collision term off.
2. A joint refinement over the concatenated (P*n,) parameter vector at
   the final stage's weights, whose residuals add one SDF coupling row
   per person (`ops/sdf.py`): every person's mesh is voxelized in its
   box frame and every person's vertices are sampled in every grid.

The refinement's Jacobian is forward-mode AD with the grids held fixed:
they are voxelized on plain tensors before each linearization (the
voxelizer is a kernel on the card), which equals JAX's linearization
since phi carries no derivative.  Not ported yet: the points engine
(`sdf_engine="points"`, ROADMAP A1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models import vposer as vposer_lib
from ..models.camera import Camera
from ..models.smpl import smpl_forward
from ..ops import sdf as sdf_ops
from . import energy as E
from .energy import EnergySpec, Observations, StageWeights
from .initialize import init_guess
from .lm import ad_jacobian, lm_fit
from .stages import FitConfig, FitResult, default_stages, fit_frame


@dataclasses.dataclass
class GridForms:
    """The grid-engine refinement's residual forms over flat (1, P*n).

    grids_of(flat): every person's (phi, centers, scales) at flat
      (plain tensors only: it launches the voxelizer on the card).
    joint_residual(flat, grids): the lagged form: per-person data + prior
      rows, then the P collision rows w * s / P sampled in the given
      grids AND their box frames, all held fixed.
    residual_exact(flat): the exact form: grids voxelized at flat and
      sampled in the live box frame of flat's vertices.
    jac_exact(flat): (r, J) of `residual_exact`, J by forward mode with
      the fields of flat held fixed.
    """

    grids_of: Callable
    joint_residual: Callable
    residual_exact: Callable
    jac_exact: Callable


def make_grid_forms(solo_spec: EnergySpec, assets, cam: Camera,
                    obs_people: Observations, vposer_w, gmm,
                    weights: StageWeights, P: int, n: int,
                    grid_size: int) -> GridForms:
    """The closures of JAX `fit_people`'s grid engine (`multi_person.py:
    250-289`), for flat parameter vectors (1, P*n)."""
    def all_verts(xs):
        params, z = E.unpack(solo_spec, xs)
        body_pose = (vposer_lib.decode(vposer_w, z) if solo_spec.use_vposer
                     else params.body_pose)
        return smpl_forward(assets, params, body_pose)[0]     # (P, V, 3)

    def grids_of(flat):
        return sdf_ops.person_grids(all_verts(flat.reshape(P, n)),
                                    assets.faces, grid_size)

    def with_sums(flat, sums_of_verts):
        xs = flat.reshape(P, n)
        rows = E.residuals(solo_spec, assets, cam, obs_people, weights,
                           vposer_w, gmm, xs).reshape(1, -1)
        s = sums_of_verts(all_verts(xs))
        return torch.cat([rows, (weights.coll * s / P)[None]], dim=-1)

    def joint_residual(flat, grids):
        return with_sums(
            flat, lambda v: sdf_ops.collision_sums_sampled(*grids, v))

    def exact_in(flat, phi):
        return with_sums(
            flat, lambda v: sdf_ops.sampled_at_live_frame(phi, v))

    def residual_exact(flat):
        return exact_in(flat, grids_of(flat)[0])

    def jac_exact(flat):
        phi = grids_of(flat)[0]
        return ad_jacobian(lambda f: exact_in(f, phi), flat)

    return GridForms(grids_of, joint_residual, residual_exact, jac_exact)


def fit_people(cfg: FitConfig, assets, cam: Camera,
               obs_people: Observations, vposer_w=None, gmm=None,
               img_height: float = 1080.0, est_scale: bool = True,
               refine_collision: Optional[bool] = None,
               lagged_sdf="hybrid", refine_iters: int = 12,
               polish_iters: int = 5, sdf_engine: str = "points",
               device: DeviceLike = None
               ) -> Tuple[FitResult, torch.Tensor]:
    """Fit P people of one frame on `device` (CUDA unless
    ``device="cpu"``).

    Args:
      obs_people: Observations with the people as the leading axis.
      refine_collision: run the joint SDF refinement; defaults to
        `cfg.spec.interpenetration`.
      lagged_sdf: refinement schedule: "lagged" (or True) voxelizes once
        per LM iteration (the `aux_fn` hook, 15 iterations), "exact" (or
        False) at every residual evaluation (15 iterations), "hybrid"
        `refine_iters` lagged then `polish_iters` exact.
      sdf_engine: "grid", the reference's voxelize-then-sample form at
        `cfg.spec.coll_grid_size`.  JAX's default "points" engine is not
        ported yet and raises.

    Returns:
      (FitResult over the people, collision sums (P,) at the result;
      zeros without the refinement).
    """
    if sdf_engine != "grid":
        raise NotImplementedError(
            f"sdf_engine={sdf_engine!r}: only the grid engine is ported; the "
            "points engine is still to come (ROADMAP A1)")
    if gmm is not None:
        raise NotImplementedError("the GMM pose prior is not ported yet")
    dev = resolve_device(device)
    assets = assets.to(dev)
    cam = cam.to(dev)
    obs_people = obs_people.to(dev)
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    spec = cfg.spec
    if refine_collision is None:
        refine_collision = spec.interpenetration
    P = obs_people.gt2d.shape[0]

    # Phase 1: independent fits without the collision term.
    solo_spec = dataclasses.replace(spec, interpenetration=False)
    solo_cfg = dataclasses.replace(cfg, spec=solo_spec)
    guess = init_guess(assets, cam, obs_people.gt2d, obs_people.conf,
                       obs_people.view_mask, est_scale=est_scale)
    results = fit_frame(solo_cfg, assets, cam, obs_people, guess.params,
                        guess.z, vposer_w=vposer_w, img_height=img_height)
    if not refine_collision:
        return results, torch.zeros((P,), device=dev)

    # Phase 2: joint refinement at the final stage's weights.
    h = torch.full((P,), float(img_height), device=dev)
    weights = default_stages(cfg, h)[-1]
    xs0 = E.pack(solo_spec, results.params,
                 results.z if spec.use_vposer else None)
    n = xs0.shape[-1]
    forms = make_grid_forms(solo_spec, assets, cam, obs_people, vposer_w,
                            gmm, weights, P, n, spec.coll_grid_size)
    mask = E.free_mask(solo_spec, dev).repeat(P)
    # Never speculative: the stiff collision refinement degrades under
    # speculative step judging (`multi_person.py:182-186`).
    base_lm = dataclasses.replace(cfg.lm, speculative=False)
    mode = (lagged_sdf if isinstance(lagged_sdf, str)
            else ("lagged" if lagged_sdf else "exact"))
    schedule = {"lagged": [("lagged", 15)], "exact": [("exact", 15)],
                "hybrid": [("lagged", refine_iters),
                           ("exact", polish_iters)]}[mode]
    flat = xs0.reshape(1, P * n)
    iters = torch.zeros((1,), dtype=torch.int32, device=dev)
    for kind, budget in schedule:
        opts = dataclasses.replace(base_lm, max_iters=budget)
        if kind == "lagged":
            flat, _, it = lm_fit(forms.joint_residual, flat, mask, opts,
                                 aux_fn=forms.grids_of)
        else:
            flat, _, it = lm_fit(forms.residual_exact, flat, mask, opts,
                                 jac_fn=forms.jac_exact)
        iters = iters + it
    xs = flat.reshape(P, n)

    params, z = E.unpack(solo_spec, xs)
    if spec.use_vposer:
        body_pose = vposer_lib.decode(vposer_w, z)
    else:
        body_pose = params.body_pose
        z = torch.zeros((P, E.LATENT_DIM), dtype=xs.dtype, device=dev)
    verts, _ = smpl_forward(assets, params, body_pose)
    final_sums = sdf_ops.collision_sums(verts, assets.faces,
                                        spec.coll_grid_size)
    r = E.residuals(solo_spec, assets, cam, obs_people, weights, vposer_w,
                    gmm, xs)
    per_loss = torch.sum(r * r, dim=-1)
    out = FitResult(params=params, z=z, body_pose=body_pose, loss=per_loss,
                    stage_losses=per_loss[:, None],
                    lm_iters=iters.expand(P)[:, None].clone())
    return out, final_sums
