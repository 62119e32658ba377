"""Scaled SMPL body model, batched over frames (port of `models/smpl.py`).

The learnable per-body `scale` multiplies the root transform's rotation
block, as the reference does (`lbs.py:348`).  Every function takes a
leading frame axis B.  SMPL-H and SMPL-X assemble their chain pose from
the body pose and the optional hand, face and expression blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.rotations import rodrigues, transform_mat
from . import joints as J


@dataclasses.dataclass
class SMPLAssets:
    """SMPL model data as tensors; static metadata as plain fields."""

    v_template: torch.Tensor       # (V, 3)
    shapedirs: torch.Tensor        # (V, 3, NB)
    posedirs: torch.Tensor         # (207, V*3)
    j_regressor: torch.Tensor      # (24, V)
    lbs_weights: torch.Tensor      # (V, 24)
    faces: torch.Tensor            # (F, 3) int64
    extra_joint_ids: torch.Tensor  # (E,) int64
    joint_map: torch.Tensor        # (K,) int64
    lsp_regressor: Optional[torch.Tensor] = None  # (14, V) for smpllsp
    joint_model: Optional[object] = None  # models.joint_model.JointModel
    # SMPL-H / SMPL-X only: the full MANO PCA bases [left, right] (the
    # energy picks how many components to fit), the hand means (zeros
    # when flat_hand_mean) and the SMPL-X expression blend shapes.
    hand_components: Optional[torch.Tensor] = None  # (2, C, 45)
    hand_means: Optional[torch.Tensor] = None       # (2, 45)
    expr_dirs: Optional[torch.Tensor] = None        # (V, 3, NE)
    parents: Tuple[int, ...] = J.SMPL_PARENTS
    model_type: str = "smpl"
    gender: str = "neutral"

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return 0 if self.expr_dirs is None else self.expr_dirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLAssets":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if hasattr(v, "to") else v
        return SMPLAssets(**kw)


@dataclasses.dataclass
class SMPLParams:
    """Per-body parameters with a leading frame axis B.

    The SMPL-H / SMPL-X blocks are optional (None behaves as zeros):
    hand poses are MANO PCA coefficients (B, C) or raw axis-angle
    (B, 45), expression is (B, NE), the face poses are (B, 3).
    """

    betas: torch.Tensor          # (B, NB)
    global_orient: torch.Tensor  # (B, 3)
    body_pose: torch.Tensor      # (B, 69)
    transl: torch.Tensor         # (B, 3)
    scale: torch.Tensor          # (B,)
    left_hand_pose: Optional[torch.Tensor] = None   # (B, C) or (B, 45)
    right_hand_pose: Optional[torch.Tensor] = None  # (B, C) or (B, 45)
    expression: Optional[torch.Tensor] = None       # (B, NE)
    jaw_pose: Optional[torch.Tensor] = None         # (B, 3)
    leye_pose: Optional[torch.Tensor] = None        # (B, 3)
    reye_pose: Optional[torch.Tensor] = None        # (B, 3)

    @classmethod
    def zeros(cls, batch: int = 1, num_betas: int = 10,
              dtype=torch.float32, device=None) -> "SMPLParams":
        def z(*s):
            return torch.zeros((batch,) + s, dtype=dtype, device=device)
        return cls(betas=z(num_betas), global_orient=z(3), body_pose=z(69),
                   transl=z(3),
                   scale=torch.ones((batch,), dtype=dtype, device=device))


# SMPLParams' optional SMPL-H/X blocks.
TAIL_FIELDS = ("left_hand_pose", "right_hand_pose", "expression",
               "jaw_pose", "leye_pose", "reye_pose")
NUM_HAND_JOINTS = 15           # per hand (MANO), SMPL-H/X
HAND_AA = 3 * NUM_HAND_JOINTS  # 45
BODY63 = 63                    # 21 body joints for SMPL-H/X


def _hand_aa(model, block: Optional[torch.Tensor], side: int,
             like: torch.Tensor) -> torch.Tensor:
    """One hand's (B, 45) axis-angle from its parameter block: PCA
    coefficients decoded through the MANO components
    (`body_models.py:593-596`), or a (B, 45) block taken as raw
    axis-angle.  The hand mean is always added (zeros when the model was
    loaded with flat_hand_mean)."""
    if block is None:
        aa = like.new_zeros(like.shape[:-1] + (HAND_AA,))
    elif block.shape[-1] == HAND_AA:
        aa = block
    else:
        aa = block @ model.hand_components[side, :block.shape[-1]]
    if model.hand_means is not None:
        aa = aa + model.hand_means[side]
    return aa


def assemble_chain_pose(assets, params: SMPLParams,
                        pose: torch.Tensor) -> torch.Tensor:
    """Full (B, (J-1)*3) chain pose from the body pose and the optional
    blocks.  `assets` is any carrier of `.parents`, `.model_type`,
    `.hand_components`, `.hand_means` (SMPLAssets or a JointModel).

    smpl/smpllsp: the 69-dim body pose is the chain pose.  SMPL-H:
    [body(63), left hand(45), right hand(45)]; SMPL-X: [body(63), jaw,
    leye, reye, hands(90)] (`body_models.py:596-608,903-910`).  A pose
    already of chain length passes through untouched.

    The reference's scaled SMPL-H/X forwards call `lbs()` without its
    `scale` (`body_models_scale.py:622,935`); this is the intended
    semantics: the stock smplx assembly with the scaled root.
    """
    need = (len(assets.parents) - 1) * 3
    if assets.model_type in ("smpl", "smpllsp") or pose.shape[-1] == need:
        return pose
    body = pose[..., :BODY63]
    if body.shape[-1] < BODY63:
        body = torch.cat([body, body.new_zeros(
            body.shape[:-1] + (BODY63 - body.shape[-1],))], dim=-1)
    pieces = [body]
    if assets.model_type == "smplx":
        for blk in (params.jaw_pose, params.leye_pose, params.reye_pose):
            pieces.append(blk if blk is not None
                          else body.new_zeros(body.shape[:-1] + (3,)))
    pieces.append(_hand_aa(assets, params.left_hand_pose, 0, body))
    pieces.append(_hand_aa(assets, params.right_hand_pose, 1, body))
    return torch.cat(pieces, dim=-1)


def _rigid_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                 parents: Tuple[int, ...], scale: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose the kinematic tree; returns posed joints and skinning A.

    rot_mats: (B, J, 3, 3); joints: (B, J, 3) rest joints; scale: (B,).
    The root's rotation block is multiplied by `scale` (`lbs.py:348`).
    Composed by pointer jumping, as the JAX reference does, so the
    products associate the same way: after step k, entry j holds the
    product along the 2^k-ancestor segment ending at j.
    """
    device = joints.device
    par = np.asarray(parents, np.int64)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par[1:]]],
                    dim=1)
    rot_scaled = torch.cat([rot_mats[:, :1] * scale[:, None, None, None],
                            rot_mats[:, 1:]], dim=1)
    transforms = transform_mat(rot_scaled, rel)             # (B, J, 4, 4)

    nj = len(parents)
    depth = [0] * nj
    for i in range(1, nj):
        depth[i] = depth[parents[i]] + 1
    ptr = par.copy()
    ptr[0] = 0
    done = np.zeros(nj, bool)
    done[0] = True
    steps = max(1, int(np.ceil(np.log2(max(max(depth), 1) + 1))))
    for _ in range(steps):
        if done.all():
            break
        par_t = transforms[:, torch.as_tensor(ptr, device=device)]
        gathered = sum(par_t[:, :, :, b, None] * transforms[:, :, None, b, :]
                       for b in range(4))
        keep = torch.as_tensor(done, device=device)[None, :, None, None]
        transforms = torch.where(keep, transforms, gathered)
        done = done | done[ptr]
        ptr = ptr[ptr]

    posed_joints = transforms[:, :, :3, 3]
    correction = sum(transforms[:, :, :3, b] * joints[:, :, None, b]
                     for b in range(3))
    A = transform_mat(transforms[:, :, :3, :3], posed_joints - correction)
    return posed_joints, A


def lbs(assets: SMPLAssets, betas: torch.Tensor, full_pose: torch.Tensor,
        scale: torch.Tensor, expression: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning for a batch of bodies.

    Args:
      betas: (B, NB); full_pose: (B, J*3) axis-angle; scale: (B,);
      expression: optional (B, NE) SMPL-X coefficients through
        `expr_dirs`, as the reference's [betas, expression] against the
        full shapedirs (`body_models.py:914-921`).

    Returns:
      verts (B, V, 3), posed joints (B, J, 3), both before translation.
    """
    B = betas.shape[0]
    nj = len(assets.parents)
    dtype = assets.v_template.dtype
    v_shaped = assets.v_template + torch.einsum(
        "vct,bt->bvc", assets.shapedirs, betas.to(dtype))
    if expression is not None and assets.expr_dirs is not None:
        v_shaped = v_shaped + torch.einsum(
            "vce,be->bvc", assets.expr_dirs, expression.to(dtype))
    j_rest = torch.einsum("jv,bvc->bjc", assets.j_regressor, v_shaped)

    rot_mats = rodrigues(full_pose.reshape(B, nj, 3))
    ident = torch.eye(3, dtype=dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ assets.posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = _rigid_chain(rot_mats, j_rest, assets.parents, scale)

    T = (assets.lbs_weights @ A.reshape(B, nj, 16)).reshape(B, -1, 4, 4)
    verts = (torch.einsum("bvac,bvc->bva", T[..., :3, :3], v_posed)
             + T[..., :3, 3])
    return verts, posed_joints


def smpl_forward(assets: SMPLAssets, params: SMPLParams,
                 body_pose: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full model forward: (verts (B, V, 3), mapped joints (B, K, 3)).

    LBS -> (LSP joint regression for smpllsp) -> append surface keypoints
    -> gather into annotation order -> add translation.  `body_pose`
    overrides `params.body_pose` (the VPoser-decoded pose); SMPL-H/X
    assemble the chain pose with `assemble_chain_pose`.
    """
    pose = body_pose if body_pose is not None else params.body_pose
    pose = assemble_chain_pose(assets, params, pose)
    full_pose = torch.cat([params.global_orient, pose], dim=-1)
    verts, posed_joints = lbs(assets, params.betas, full_pose, params.scale,
                              expression=params.expression)

    if assets.model_type == "smpllsp":
        base_joints = torch.einsum("jv,bvc->bjc", assets.lsp_regressor, verts)
    else:
        base_joints = posed_joints
    extra = verts[:, assets.extra_joint_ids]
    all_joints = torch.cat([base_joints, extra], dim=1)
    mapped = all_joints[:, assets.joint_map]

    t = params.transl[:, None, :]
    return verts + t, mapped + t


def rest_joints(assets: SMPLAssets) -> torch.Tensor:
    """(K, 3) annotation-order joints of the zero-pose, zero-shape,
    unit-scale body (the initializer's source points)."""
    params = SMPLParams.zeros(1, assets.num_betas, assets.v_template.dtype,
                              assets.device)
    _, joints = smpl_forward(assets, params)
    return joints[0]
