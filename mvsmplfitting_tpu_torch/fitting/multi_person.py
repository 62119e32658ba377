"""Multi-person fitting with interpenetration coupling (port of
`fitting/multi_person.py`).

1. Independent staged fits, the people as the batch axis, with the
   collision term off.
2. A joint refinement over the concatenated (P*n,) parameter vector
   whose residuals add one SDF coupling row per person (`ops/sdf.py`).
   Two engines:
   - "points" (the default, as in JAX): the exact field evaluated at
     the other people's vertices (`collision_sums_points`), annealed
     through the collision-active stages' weights, from two starts (the
     solo fits and an informed restart), keeping the lower joint energy;
   - "grid": the reference's form, every person's mesh voxelized in its
     box frame and every person's vertices sampled in every grid, at the
     final stage's weights.

The grid engine's refinement Jacobian is forward-mode AD with the grids
held fixed: they are voxelized on plain tensors before each
linearization (the voxelizer is a kernel on the card), which equals
JAX's linearization since phi carries no derivative.  The points
engine's field is a `torch.autograd.Function` with the analytic spatial
derivative, so its forms differentiate through it directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.func import jacrev

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


def _person_verts(solo_spec: EnergySpec, assets, vposer_w,
                  xs: torch.Tensor) -> torch.Tensor:
    """(P, V, 3) vertices of the people's parameter rows xs (P, n)."""
    params, z = E.unpack(solo_spec, xs)
    body_pose = (vposer_lib.decode(vposer_w, z) if solo_spec.use_vposer
                 else params.body_pose)
    return smpl_forward(assets, params, body_pose)[0]


def make_grid_forms(solo_spec: EnergySpec, assets, cam: Camera,
                    obs_people: Observations, vposer_w, gmm,
                    weights: StageWeights, P: int, n: int,
                    grid_size: int) -> GridForms:
    """The closures of JAX `fit_people`'s grid engine (`multi_person.py:
    250-289`), for flat parameter vectors (1, P*n)."""
    def all_verts(xs):
        return _person_verts(solo_spec, assets, vposer_w, xs)

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


def make_points_forms(solo_spec: EnergySpec, assets, cam: Camera,
                      obs_people: Observations, vposer_w, gmm,
                      weights: StageWeights, P: int, n: int
                      ) -> Tuple[Callable, Callable]:
    """(residual_fn, jac_fn) of the points-engine refinement over flat
    parameter vectors (1, P*n) (JAX `multi_person.py:32-82`).

    residual_fn(flat, w): the people's data and prior rows, then the P
      collision rows w.coll * s / P with s the exact sums
      (`collision_sums_points`); sum(r^2) is the joint objective.
    jac_fn(flat, w): (r, J) with the base rows' Jacobian block-diagonal,
      from `energy.residual_jacobian` over the people as its batch (the
      joint-Jacobian and VPoser-tail kernels on the card), and the P
      collision rows from reverse mode of the sums (one backward pass
      each through the field's analytic derivative).
    """
    def sums_of(flat):
        verts = _person_verts(solo_spec, assets, vposer_w,
                              flat.reshape(P, n))
        s = sdf_ops.collision_sums_points(verts, assets.faces)
        return s, s

    def residual_fn(flat, w=weights):
        xs = flat.reshape(P, n)
        rows = E.residuals(solo_spec, assets, cam, obs_people, w, vposer_w,
                           gmm, xs).reshape(1, -1)
        return torch.cat([rows, (w.coll * sums_of(flat)[0] / P)[None]],
                         dim=-1)

    def jac_fn(flat, w=weights):
        rb, Jb = E.residual_jacobian(solo_spec, assets, cam, obs_people, w,
                                     vposer_w, gmm, flat.reshape(P, n))
        Jc, s = jacrev(sums_of, has_aux=True)(flat)     # (P, 1, P*n)
        r = torch.cat([rb.reshape(-1), w.coll * s / P])
        J = torch.cat([torch.block_diag(*Jb),
                       (w.coll / P) * Jc.reshape(P, P * n)])
        return r[None], J[None]

    return residual_fn, jac_fn


def _informed_restart(flat: torch.Tensor, P: int, n: int,
                      pidx: int) -> torch.Tensor:
    """Each body moved 1.5 cm away from the others' mean translation,
    along the line of centers (JAX `multi_person.py:291-303`)."""
    xs = flat.reshape(P, n).clone()
    tr = xs[:, pidx:pidx + 3]
    others = (tr.sum(dim=0, keepdim=True) - tr) / max(P - 1, 1)
    d = tr - others
    dn = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True),
                             1e-9)
    xs[:, pidx:pidx + 3] = tr + 0.015 * dn
    return xs.reshape(1, P * n)


def _points_refinement(cfg: FitConfig, solo_spec: EnergySpec, assets,
                       cam: Camera, obs_people: Observations, vposer_w,
                       gmm, stage_tbl, flat: torch.Tensor, mask, base_lm,
                       P: int, n: int, points_iters: int,
                       points_anneal: bool, restarts: int, points_jac: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The points engine's refinement (JAX `multi_person.py:254-310`):
    LM through the collision-active stages' weights (or the last stage's
    without `points_anneal`), `points_iters` split across them, from the
    solo fits and, with `restarts` >= 2 and P >= 2, the informed restart;
    the start whose result has the lowest joint energy at the last
    active stage's weights wins (the first on ties).  Returns (flat, LM
    iterations summed over the schedule and the starts run)."""
    ids = ([i for i, cw in enumerate(cfg.coll_weights) if cw > 0]
           if points_anneal else [])
    ids = ids or [len(stage_tbl) - 1]
    per = max(1, points_iters // len(ids))
    budgets = [per] * (len(ids) - 1) + [
        max(1, points_iters - per * (len(ids) - 1))]
    residual_fn, jac_fn = make_points_forms(
        solo_spec, assets, cam, obs_people, vposer_w, gmm, stage_tbl[-1], P,
        n)
    use_analytic = (points_jac == "analytic"
                    and E.analytic_jac_ok(solo_spec, assets))
    iters = torch.zeros((1,), dtype=torch.int32, device=flat.device)

    def run_sched(f):
        nonlocal iters
        for sid, budget in zip(ids, budgets):
            w = stage_tbl[sid]
            f, _, it = lm_fit(
                lambda ff, w=w: residual_fn(ff, w), f, mask,
                dataclasses.replace(base_lm, max_iters=budget),
                jac_fn=((lambda ff, w=w: jac_fn(ff, w)) if use_analytic
                        else None))
            iters = iters + it
        return f

    starts = [flat]
    if restarts >= 2 and P >= 2:
        starts.append(_informed_restart(
            flat, P, n, E.pose_dim(solo_spec) + solo_spec.num_betas + 3))
    refined = [run_sched(s) for s in starts[:max(1, restarts)]]
    if len(refined) > 1:
        w_last = stage_tbl[ids[-1]]
        energies = [float(torch.sum(residual_fn(f, w_last) ** 2))
                    for f in refined]
        flat = refined[energies.index(min(energies))]
    else:
        flat = refined[0]
    return flat, iters


def _grid_refinement(forms: GridForms, flat: torch.Tensor, mask, base_lm,
                     lagged_sdf, refine_iters: int, polish_iters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid engine's refinement schedule (JAX `multi_person.py:
    311-323`): lagged solves with the grids as aux state, exact ones with
    the held-grid Jacobian.  Returns (flat, LM iterations run)."""
    mode = (lagged_sdf if isinstance(lagged_sdf, str)
            else ("lagged" if lagged_sdf else "exact"))
    schedule = {"lagged": [("lagged", 15)], "exact": [("exact", 15)],
                "hybrid": [("lagged", refine_iters),
                           ("exact", polish_iters)]}[mode]
    iters = torch.zeros((1,), dtype=torch.int32, device=flat.device)
    for kind, budget in schedule:
        opts = dataclasses.replace(base_lm, max_iters=budget)
        if kind == "lagged":
            flat, _, it = lm_fit(forms.joint_residual, flat, mask, opts,
                                 aux_fn=forms.grids_of)
        else:
            flat, _, it = lm_fit(forms.residual_exact, flat, mask, opts,
                                 jac_fn=forms.jac_exact)
        iters = iters + it
    return flat, iters


def fit_people(cfg: FitConfig, assets, cam: Camera,
               obs_people: Observations, vposer_w=None, gmm=None,
               img_height: float = 1080.0, est_scale: bool = True,
               refine_collision: Optional[bool] = None,
               lagged_sdf="hybrid", refine_iters: int = 12,
               polish_iters: int = 5, sdf_engine: str = "points",
               points_iters: int = 15, points_anneal: bool = True,
               restarts: int = 2, points_jac: str = "ad",
               device: DeviceLike = None
               ) -> Tuple[FitResult, torch.Tensor]:
    """Fit P people of one frame on `device` (CUDA unless
    ``device="cpu"``).

    Args:
      obs_people: Observations with the people as the leading axis.
      refine_collision: run the joint SDF refinement; defaults to
        `cfg.spec.interpenetration`.
      lagged_sdf: the grid engine's schedule: "lagged" (or True)
        voxelizes once per LM iteration (the `aux_fn` hook, 15
        iterations), "exact" (or False) at every residual evaluation (15
        iterations), "hybrid" `refine_iters` lagged then `polish_iters`
        exact.
      sdf_engine: "points" (default), the exact field at the query
        vertices (`ops/sdf.py:collision_sums_points`); "grid", the
        reference's voxelize-then-sample form at
        `cfg.spec.coll_grid_size`.
      points_iters: the points refinement's LM budget, split across the
        collision-active stages (`points_anneal`) or all given to the
        last stage.
      restarts: points engine: refine from the solo fits and, when >= 2
        and P >= 2, from the informed restart; keep the lower joint
        energy.
      points_jac: points engine: "ad" (forward mode over the P*n
        columns, JAX's default) or "analytic" (`make_points_forms`'
        block-diagonal closed form plus reverse-mode collision rows).

    Returns:
      (FitResult over the people, collision sums (P,) at the result under
      the engine's field; zeros without the refinement).  `lm_iters` is
      the refinement's LM iterations (summed over its solves and starts).
    """
    if sdf_engine not in ("points", "grid"):
        raise ValueError(f"unknown sdf_engine {sdf_engine!r}")
    dev = resolve_device(device)
    assets = assets.to(dev)
    cam = cam.to(dev)
    obs_people = obs_people.to(dev)
    vposer_w = None if vposer_w is None else vposer_w.to(dev)
    gmm = None if gmm is None else gmm.to(dev)
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
                        guess.z, vposer_w=vposer_w, gmm=gmm,
                        img_height=img_height)
    if not refine_collision:
        return results, torch.zeros((P,), device=dev)

    # Phase 2: the joint refinement.
    h = torch.full((P,), float(img_height), device=dev)
    stage_tbl = default_stages(cfg, h)
    weights = stage_tbl[-1]
    xs0 = E.pack(solo_spec, results.params,
                 results.z if spec.use_vposer else None)
    n = xs0.shape[-1]
    mask = E.free_mask(solo_spec, dev).repeat(P)
    # Never speculative: the stiff collision refinement degrades under
    # speculative step judging (`multi_person.py:182-186`).
    base_lm = dataclasses.replace(cfg.lm, speculative=False)
    flat = xs0.reshape(1, P * n)
    if sdf_engine == "points":
        flat, iters = _points_refinement(
            cfg, solo_spec, assets, cam, obs_people, vposer_w, gmm,
            stage_tbl, flat, mask, base_lm, P, n, points_iters,
            points_anneal, restarts, points_jac)
    else:
        flat, iters = _grid_refinement(
            make_grid_forms(solo_spec, assets, cam, obs_people, vposer_w,
                            gmm, weights, P, n, spec.coll_grid_size),
            flat, mask, base_lm, lagged_sdf, refine_iters, polish_iters)
    xs = flat.reshape(P, n)

    params, z = E.unpack(solo_spec, xs)
    if spec.use_vposer:
        body_pose = vposer_lib.decode(vposer_w, z)
    else:
        body_pose = params.body_pose
        z = torch.zeros((P, E.LATENT_DIM), dtype=xs.dtype, device=dev)
    verts, _ = smpl_forward(assets, params, body_pose)
    final_sums = (sdf_ops.collision_sums_points(verts, assets.faces)
                  if sdf_engine == "points" else
                  sdf_ops.collision_sums(verts, assets.faces,
                                         spec.coll_grid_size))
    r = E.residuals(solo_spec, assets, cam, obs_people, weights, vposer_w,
                    gmm, xs)
    per_loss = torch.sum(r * r, dim=-1)
    out = FitResult(params=params, z=z, body_pose=body_pose, loss=per_loss,
                    stage_losses=per_loss[:, None],
                    lm_iters=iters.expand(P)[:, None].clone())
    return out, final_sums
