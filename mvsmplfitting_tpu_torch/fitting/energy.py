"""The multi-view SMPLify fitting energy, batched over frames (port of
`fitting/energy.py`).

`total_energy` is the scalar objective of the reference's `SMPLifyLoss`
(`code/utils/fitting.py:290-415`): GMoF-robustified, confidence-weighted
2D reprojection over all views plus the VPoser / GMM / L2 pose prior,
the L2 shape prior, the exponential bending prior and the optional
3D-joint term.  `residuals` restates it
as a least-squares vector with ``sum(r^2) == total_energy`` for the LM
solver, and `residual_jacobian` gives (r, dr/dx) with the deep blocks in
closed form (the two CUDA kernels on the card).  `data_residuals` and
`prior_residuals` are its two halves, for the camera-sharded solver
(`parallel/camera_shard.py`), which sums the per-view data blocks over
ranks and adds the prior blocks once.

The interpenetration term (grid engine, `ops/sdf.py`) samples each
frame's body in its own voxelized field; voxelizing launches a kernel on
the card, so `residuals` takes the grids as an argument when it runs
inside a `torch.func` transform (see `collision_grids`).

Every function takes x (B, n) and returns per-frame values.  The
SMPL-H/X tail blocks (hand PCA, expression, jaw and eyes) sit after the
scale and carry L2 priors; their fits take the AD Jacobian
(`analytic_jac_ok`), as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.func import jvp, vmap

from ..models import vposer as vposer_lib
from ..models.camera import Camera, project_points
from ..models.priors import GMMPrior, angle_prior_terms
from ..models.smpl import SMPLAssets, SMPLParams, smpl_forward
from ..ops import sdf as sdf_ops
from ..ops.robust import gmof, gmof_residual

LATENT_DIM = vposer_lib.LATENT_DIM


@dataclasses.dataclass
class Observations:
    """Per-frame fitting observations, frames leading (views masked)."""

    gt2d: torch.Tensor           # (B, V, K, 2) 2D keypoints
    conf: torch.Tensor           # (B, V, K) detection confidences
    view_mask: torch.Tensor      # (B, V) 1 for live views
    joint_weights: torch.Tensor  # (B, K) per-joint data weights
    gt3d: Optional[torch.Tensor] = None    # (B, K, 3) 3D joints
    conf3d: Optional[torch.Tensor] = None  # (B, K)

    def to(self, device) -> "Observations":
        return Observations(*(None if t is None else t.to(device)
                              for t in dataclasses.astuple(self)))


@dataclasses.dataclass
class StageWeights:
    """Annealing-stage loss weights (`non_linear_solver.py:103-121`).
    `data` is per frame (B,) (500 / image height); the rest are scalars,
    or per frame (B,) where frames sit at different stages (the fused
    loop, `lm.lm_fit_staged`)."""

    data: torch.Tensor
    pose: torch.Tensor
    shape: torch.Tensor
    bending: torch.Tensor
    coll: torch.Tensor
    coll_on: bool = False

    @classmethod
    def make(cls, data, pose, shape, bending=None, coll=0.0,
             device=None) -> "StageWeights":
        def f(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)
        if bending is None:
            bending = 3.17 * pose
        return cls(data=f(data), pose=f(pose), shape=f(shape),
                   bending=f(bending), coll=f(coll), coll_on=bool(coll > 0))


@dataclasses.dataclass(frozen=True)
class EnergySpec:
    """Static configuration of the energy."""

    use_vposer: bool = True
    fix_shape: bool = False
    fix_scale: bool = False
    use_3d: bool = False
    use_joints_conf: bool = True
    prior_type: str = "l2"
    rho: float = 100.0
    num_betas: int = 10
    interpenetration: bool = False
    coll_grid_size: int = 32
    hand_dim: int = 0
    num_expr: int = 0
    opt_face: bool = False


# Flat parameter vector (B, n): [pose block, betas(NB), global_orient(3),
# transl(3), scale(1), lhand(HD), rhand(HD), expression(NE), jaw(3),
# leye(3), reye(3)], pose block = z(32) with VPoser, else body_pose(69);
# the tail blocks exist only where the spec enables them (SMPL-H/X).

def pose_dim(spec: EnergySpec) -> int:
    return LATENT_DIM if spec.use_vposer else 69


def extra_dims(spec: EnergySpec) -> int:
    return 2 * spec.hand_dim + spec.num_expr + (9 if spec.opt_face else 0)


def num_unknowns(spec: EnergySpec) -> int:
    return pose_dim(spec) + spec.num_betas + 7 + extra_dims(spec)


# The tail blocks in pack order: (SMPLParams field, width).
def _tail_layout(spec: EnergySpec):
    out = []
    if spec.hand_dim:
        out += [("left_hand_pose", spec.hand_dim),
                ("right_hand_pose", spec.hand_dim)]
    if spec.num_expr:
        out.append(("expression", spec.num_expr))
    if spec.opt_face:
        out += [("jaw_pose", 3), ("leye_pose", 3), ("reye_pose", 3)]
    return out


def pack(spec: EnergySpec, params: SMPLParams,
         z: Optional[torch.Tensor] = None) -> torch.Tensor:
    block = z if spec.use_vposer else params.body_pose
    tail = [getattr(params, name) if getattr(params, name) is not None
            else block.new_zeros((block.shape[0], width))
            for name, width in _tail_layout(spec)]
    return torch.cat([block, params.betas, params.global_orient,
                      params.transl, params.scale[:, None]] + tail, dim=-1)


def unpack(spec: EnergySpec, x: torch.Tensor
           ) -> Tuple[SMPLParams, Optional[torch.Tensor]]:
    p = pose_dim(spec)
    nb = spec.num_betas
    block, betas = x[:, :p], x[:, p:p + nb]
    orient = x[:, p + nb:p + nb + 3]
    transl = x[:, p + nb + 3:p + nb + 6]
    scale = x[:, p + nb + 6]
    tail, o = {}, p + nb + 7
    for name, width in _tail_layout(spec):
        tail[name] = x[:, o:o + width]
        o += width
    if spec.use_vposer:
        return SMPLParams(betas=betas, global_orient=orient,
                          body_pose=torch.zeros_like(x[:, :1]).expand(
                              x.shape[0], 69),
                          transl=transl, scale=scale, **tail), block
    return SMPLParams(betas=betas, global_orient=orient, body_pose=block,
                      transl=transl, scale=scale, **tail), None


def free_mask(spec: EnergySpec, device=None) -> torch.Tensor:
    """(n,) 1 for optimized entries, 0 for frozen (fix_scale / fix_shape)."""
    m = [1.0] * pose_dim(spec)
    m += [0.0 if spec.fix_shape else 1.0] * spec.num_betas
    m += [1.0] * 6
    m += [0.0 if spec.fix_scale else 1.0]
    m += [1.0] * extra_dims(spec)
    return torch.tensor(m, dtype=torch.float32, device=device)


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-frame (B,) or scalar weight, shaped to broadcast over
    (B, ...) with `ndim` trailing axes."""
    return t.reshape((-1,) + (1,) * ndim) if t.dim() else t


def _forward(spec: EnergySpec, assets: SMPLAssets,
             vposer_w: Optional[vposer_lib.VPoserWeights], x: torch.Tensor,
             need_verts: bool = False):
    """(params, z, body_pose, verts or None, joints): the reduced joint
    model without vertex work unless `need_verts` (then the full LBS
    gives both, as JAX's `_forward` does)."""
    params, z = unpack(spec, x)
    body_pose = (vposer_lib.decode(vposer_w, z) if spec.use_vposer
                 else params.body_pose)
    if assets.joint_model is not None and not need_verts:
        from ..models.joint_model import joint_forward
        joints = joint_forward(assets.joint_model, params, body_pose)
        return params, z, body_pose, None, joints
    verts, joints = smpl_forward(assets, params, body_pose)
    return params, z, body_pose, verts, joints


def _coll_on(spec: EnergySpec, weights: StageWeights) -> bool:
    return spec.interpenetration and weights.coll_on


def collision_grids(spec: EnergySpec, assets: SMPLAssets,
                    vposer_w: Optional[vposer_lib.VPoserWeights],
                    x: torch.Tensor):
    """Each frame's body voxelized at x: (phi (B, 1, G, G, G), centers,
    scales), detached.  Launches the voxelizer on the card, so x must be
    a plain tensor (not inside a `torch.func` transform)."""
    verts = _forward(spec, assets, vposer_w, x, need_verts=True)[3]
    return sdf_ops.person_grids(verts[:, None], assets.faces,
                                spec.coll_grid_size)


def _data_weights(spec: EnergySpec, obs: Observations) -> torch.Tensor:
    """(B, V, K) combined joint weights, masked over dead views."""
    w = obs.joint_weights[:, None, :]
    if spec.use_joints_conf:
        w = w * obs.conf
    return w * obs.view_mask[:, :, None]


def _project(cam: Camera, joints: torch.Tensor) -> torch.Tensor:
    """(B, K, 3) -> (B, V, K, 2)."""
    return project_points(cam, joints).transpose(0, 1)


def _use_3d(spec: EnergySpec, obs: Observations) -> bool:
    return spec.use_3d and obs.gt3d is not None


def energy_terms(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
                 obs: Observations, weights: StageWeights,
                 vposer_w: Optional[vposer_lib.VPoserWeights],
                 gmm: Optional[GMMPrior], x: torch.Tensor) -> dict:
    """All energy terms as a dict of (B,) tensors (see `total_energy`)."""
    params, z, body_pose, verts, joints = _forward(
        spec, assets, vposer_w, x, need_verts=_coll_on(spec, weights))
    zero = torch.zeros_like(x[:, 0])

    diff = gmof(obs.gt2d - _project(cam, joints), spec.rho)
    w = _data_weights(spec, obs)
    joint_loss = (torch.sum(w[..., None] ** 2 * diff, dim=(1, 2, 3))
                  * weights.data ** 2)

    loss3d = zero
    if _use_3d(spec, obs):
        d3 = gmof(obs.gt3d - joints, spec.rho)
        loss3d = (torch.sum(obs.conf3d[..., None] ** 2 * d3, dim=(1, 2))
                  * weights.data ** 2)

    if spec.use_vposer:
        pprior = torch.sum(z * z, dim=-1) * weights.pose ** 2
    else:
        sq = torch.sum(body_pose ** 2, dim=-1)
        if spec.prior_type == "gmm":
            base = gmm.merged_nll(body_pose) * weights.pose ** 2
            base = torch.where(base > 5e4, zero, base)  # `fitting.py:334`
        else:
            base = sq * weights.pose ** 2
        pprior = base + sq * (weights.pose * 4) ** 2

    shape_loss = zero
    if not spec.fix_shape:
        shape_loss = torch.sum(params.betas ** 2, dim=-1) * weights.shape ** 2

    angle = torch.sum(angle_prior_terms(body_pose), dim=-1) * weights.bending
    if not spec.use_vposer:
        angle = torch.where(angle > 1e4, zero, angle)   # `fitting.py:349`

    coll = zero
    if _coll_on(spec, weights):
        coll = sdf_ops.collision_energy(verts[:, None], assets.faces,
                                        _col(weights.coll, 1),
                                        spec.coll_grid_size)

    extra = torch.sum(_tail_prior_rows(spec, weights, params) ** 2, dim=-1)
    return {"joint": joint_loss, "joint3d": loss3d, "pose_prior": pprior,
            "shape_prior": shape_loss, "angle_prior": angle,
            "collision": coll, "extra_prior": extra}


def total_energy(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
                 obs: Observations, weights: StageWeights,
                 vposer_w: Optional[vposer_lib.VPoserWeights],
                 gmm: Optional[GMMPrior], x: torch.Tensor) -> torch.Tensor:
    """(B,) scalar fitting energy, the quantity the reference minimizes."""
    t = energy_terms(spec, assets, cam, obs, weights, vposer_w, gmm, x)
    return (t["joint"] + t["joint3d"] + t["pose_prior"] + t["shape_prior"]
            + t["angle_prior"] + t["collision"] + t["extra_prior"])


def _joints3d_rows(spec: EnergySpec, obs: Observations,
                   weights: StageWeights,
                   joints: torch.Tensor) -> torch.Tensor:
    """3D-joint rows (B, K*3) from the mapped joints."""
    w3 = obs.conf3d[..., None] * _col(weights.data, 2)
    return (w3 * gmof_residual(obs.gt3d - joints, spec.rho)).reshape(
        joints.shape[0], -1)


def _data_rows_from_joints(spec: EnergySpec, cam: Camera,
                           obs: Observations, weights: StageWeights,
                           joints: torch.Tensor,
                           include_3d: bool = True) -> torch.Tensor:
    """Data rows from the mapped joints: 2D (B, V*K*2), then the 3D rows
    (K*3) when the term is on and `include_3d`."""
    w = _data_weights(spec, obs) * _col(weights.data, 2)
    e = gmof_residual(obs.gt2d - _project(cam, joints), spec.rho)
    rows = [(w[..., None] * e).reshape(joints.shape[0], -1)]
    if include_3d and _use_3d(spec, obs):
        rows.append(_joints3d_rows(spec, obs, weights, joints))
    return torch.cat(rows, dim=-1)


def data_residuals(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
                   obs: Observations, weights: StageWeights,
                   vposer_w: Optional[vposer_lib.VPoserWeights],
                   x: torch.Tensor, include_3d: bool = True) -> torch.Tensor:
    """The data rows (B, V*K*2 [+ K*3]) of `residuals`.  A camera-sharded
    solver passes ``include_3d=False`` and adds the (view-independent)
    3D rows once, with the priors; else each camera rank would count
    them once each."""
    joints = _forward(spec, assets, vposer_w, x)[4]
    return _data_rows_from_joints(spec, cam, obs, weights, joints,
                                  include_3d)


def joints3d_residuals(spec: EnergySpec, assets: SMPLAssets,
                       obs: Observations, weights: StageWeights,
                       vposer_w: Optional[vposer_lib.VPoserWeights],
                       x: torch.Tensor) -> torch.Tensor:
    """Only the 3D-joint rows (B, K*3); (B, 0) when the term is off."""
    if not _use_3d(spec, obs):
        return x.new_zeros((x.shape[0], 0))
    joints = _forward(spec, assets, vposer_w, x)[4]
    return _joints3d_rows(spec, obs, weights, joints)


def _prior_rows_core(spec: EnergySpec, weights: StageWeights,
                     gmm: Optional[GMMPrior], z: Optional[torch.Tensor],
                     body_pose: torch.Tensor,
                     betas: torch.Tensor) -> torch.Tensor:
    """Prior rows (B, r) as a function of (z, body_pose, betas)."""
    rows = []
    pose = _col(weights.pose, 1)
    if spec.use_vposer:
        rows.append(pose * z)
    else:
        if spec.prior_type == "gmm":
            # Gate (`fitting.py:334-335`): above 5e4 the whole term is
            # dropped, rows too, so sum(r^2) keeps matching total_energy;
            # the gate itself carries no derivative.
            base = gmm.merged_nll(body_pose) * weights.pose ** 2
            gate = (base <= 5e4).to(body_pose.dtype)[:, None]
            rows.append(gate * pose * gmm.residuals(body_pose))
        else:
            rows.append(pose * body_pose)
        rows.append(4.0 * pose * body_pose)
    if not spec.fix_shape:
        rows.append(_col(weights.shape, 1) * betas)
    terms = angle_prior_terms(body_pose)
    angle_rows = torch.sqrt(_col(weights.bending, 1)) * torch.sqrt(terms)
    if not spec.use_vposer:
        # Gate (`fitting.py:349-350`): the term is dropped above 1e4; the
        # gate itself carries no derivative.
        total = torch.sum(terms, dim=-1) * weights.bending
        gate = (total <= 1e4).to(angle_rows.dtype)[:, None]
        angle_rows = gate * angle_rows
    rows.append(angle_rows)
    return torch.cat(rows, dim=-1)


def _tail_prior_rows(spec: EnergySpec, weights: StageWeights,
                     params: SMPLParams) -> torch.Tensor:
    """SMPL-H/X block prior rows (B, extra_dims): L2 on the hand PCA and
    face pose at the pose weight, on the expression at the shape weight
    (smplify-x's structure; the reference's scaled SMPL-X path cannot
    run, `body_models_scale.py:622,935`)."""
    pose, shape = _col(weights.pose, 1), _col(weights.shape, 1)
    rows = [(shape if name == "expression" else pose) * getattr(params, name)
            for name, _ in _tail_layout(spec)]
    if not rows:
        return params.betas.new_zeros((params.betas.shape[0], 0))
    return torch.cat(rows, dim=-1)


def _prior_rows(spec: EnergySpec, weights: StageWeights,
                gmm: Optional[GMMPrior], params: SMPLParams,
                z: Optional[torch.Tensor],
                body_pose: torch.Tensor) -> torch.Tensor:
    """The core prior rows, then the SMPL-H/X tail rows."""
    return torch.cat([_prior_rows_core(spec, weights, gmm, z, body_pose,
                                       params.betas),
                      _tail_prior_rows(spec, weights, params)], dim=-1)


def prior_residuals(spec: EnergySpec, weights: StageWeights,
                    gmm: Optional[GMMPrior],
                    vposer_w: Optional[vposer_lib.VPoserWeights],
                    x: torch.Tensor) -> torch.Tensor:
    """The prior rows (B, r) of `residuals`: pose (32, or 69 + 69), shape
    (NB), bending (4), then the SMPL-H/X tail rows."""
    params, z = unpack(spec, x)
    body_pose = (vposer_lib.decode(vposer_w, z) if spec.use_vposer
                 else params.body_pose)
    return _prior_rows(spec, weights, gmm, params, z, body_pose)


def residuals(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
              obs: Observations, weights: StageWeights,
              vposer_w: Optional[vposer_lib.VPoserWeights],
              gmm: Optional[GMMPrior], x: torch.Tensor,
              grids=None) -> torch.Tensor:
    """Residual rows (B, m) with sum(r^2, -1) == total_energy (the GMM's
    -log w offset aside, which enters the scalar only): the 2D data rows
    (V*K*2, smooth `gmof_residual`), the 3D-joint rows (K*3) when that
    term is on (together `data_residuals`), the prior rows
    (`prior_residuals`) and, when the collision term is on this
    stage, one row w * s (the frame's one body sampled in its own field,
    `energy.py:439-447` with P = 1).

    `grids` (from `collision_grids`) holds the fields fixed; without it
    the body is voxelized at x, which needs x to be a plain tensor.
    """
    params, z, body_pose, verts, joints = _forward(
        spec, assets, vposer_w, x, need_verts=_coll_on(spec, weights))
    rows = [_data_rows_from_joints(spec, cam, obs, weights, joints),
            _prior_rows(spec, weights, gmm, params, z, body_pose)]
    if _coll_on(spec, weights):
        if grids is None:
            grids = sdf_ops.person_grids(verts[:, None], assets.faces,
                                         spec.coll_grid_size)
        s = sdf_ops.sampled_at_live_frame(grids[0], verts[:, None])
        rows.append(_col(weights.coll, 1) * s / s.shape[-1])
    return torch.cat(rows, dim=-1)


def reprojection_error_px(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
                          obs: Observations,
                          vposer_w: Optional[vposer_lib.VPoserWeights],
                          x: torch.Tensor) -> torch.Tensor:
    """(B,) confidence-weighted mean 2D reprojection error in pixels."""
    joints = _forward(spec, assets, vposer_w, x)[4]
    err = torch.linalg.norm(obs.gt2d - _project(cam, joints), dim=-1)
    w = _data_weights(spec, obs)
    return (torch.sum(w * err, dim=(1, 2))
            / torch.clamp_min(torch.sum(w, dim=(1, 2)), 1e-9))


def analytic_jac_ok(spec: EnergySpec, assets: SMPLAssets) -> bool:
    """True when `residual_jacobian` covers this energy exactly: a reduced
    joint model with a plain chain (smpl/smpllsp) and no extra blocks."""
    from ..ops.joint_kernel import kernel_ok
    return kernel_ok(assets.joint_model) and extra_dims(spec) == 0


def residual_jacobian(spec: EnergySpec, assets: SMPLAssets, cam: Camera,
                      obs: Observations, weights: StageWeights,
                      vposer_w: Optional[vposer_lib.VPoserWeights],
                      gmm: Optional[GMMPrior], x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r (B, m), J (B, m, n)) == (`residuals(x)`, its Jacobian).

    The deep part comes in closed form from the joint-Jacobian and
    VPoser-tail kernels (`_analytic_core`); only the shallow row maps
    (projection + GMoF, the 3D-joint rows, prior rows) are
    differentiated, by forward mode over the n tangent columns.
    """
    if _coll_on(spec, weights):
        raise ValueError("residual_jacobian does not cover the collision "
                         "rows; collision stages use the AD Jacobian")
    (joints, djoints, z_in, dz, body_pose, dbp, betas, dbe) = \
        _analytic_core(spec, assets, vposer_w, x)

    def rows(j, zz, bp, be):
        return torch.cat([
            _data_rows_from_joints(spec, cam, obs, weights, j),
            _prior_rows_core(spec, weights, gmm, zz, bp, be)], dim=-1)

    primals = (joints, z_in, body_pose, betas)
    r = rows(*primals)

    def column(tj, tz, tbp, tbe):
        return jvp(rows, primals, (tj, tz, tbp, tbe))[1]

    J = vmap(column, in_dims=1, out_dims=2)(djoints, dz, dbp, dbe)
    return r, J


def _analytic_core(spec: EnergySpec, assets: SMPLAssets, vposer_w,
                   x: torch.Tensor):
    """Deep half of the analytic Jacobian: the mapped joints, their
    tangents per packed column, and the tangent inputs of the shallow
    row maps (all with a leading frame axis)."""
    from ..ops import joint_kernel, vposer_kernel

    B, n = x.shape
    p = pose_dim(spec)
    nb = spec.num_betas
    params, z = unpack(spec, x)
    jm = assets.joint_model

    if spec.use_vposer:
        body_pose, D_z = vposer_kernel.decode_jac_batched(vposer_w, z)
    else:
        body_pose, D_z = params.body_pose, None
    theta = torch.cat([params.global_orient, body_pose], dim=-1)
    joints, blk = joint_kernel.joint_jacobian_batched(
        jm, theta, params.betas, params.scale)
    joints = joints + params.transl[:, None, :]

    # d joints / d x, one (K, 3) tangent per packed column, pack() order.
    cp = body_pose.shape[-1]
    if spec.use_vposer:
        block_cols = torch.einsum("bqkc,bqZ->bZkc", blk["pose"][:, :cp], D_z)
    else:
        block_cols = blk["pose"][:, :cp]
    djoints = torch.cat([block_cols, blk["betas"], blk["orient"],
                         blk["transl"], blk["scale"]], dim=1)  # (B,n,K,3)

    dtype, device = x.dtype, x.device
    z_in = z if spec.use_vposer else torch.zeros((B, 1), dtype=dtype,
                                                 device=device)
    dz = torch.zeros((B, n) + z_in.shape[1:], dtype=dtype, device=device)
    dbp = torch.zeros((B, n, cp), dtype=dtype, device=device)
    eye_p = torch.eye(p, dtype=dtype, device=device)
    if spec.use_vposer:
        dz[:, :p] = eye_p
        dbp[:, :p] = D_z.transpose(1, 2)
    else:
        dbp[:, :p] = eye_p[:, :cp]
    dbe = torch.zeros((B, n, nb), dtype=dtype, device=device)
    dbe[:, p:p + nb] = torch.eye(nb, dtype=dtype, device=device)
    return joints, djoints, z_in, dz, body_pose, dbp, params.betas, dbe
