"""Reduced joint model: the LBS -> joint pipeline with vertices folded
out (port of `models/joint_model.py`).

Every mapped joint the energy consumes is linear in the posed vertices,
so with GW[k,j,v] = G[k,v] W[v,j]

    joints_k = sum_j A_j[:3,:4] @ H_kj,
    H_kj     = H0_kj + Hb_kj @ beta + Hp_kj @ posefeat

where H0 (K,24,4), Hb (K,24,3,NB) and Hp (K,24,3,207) are constants
built once from the assets.  Chain-derived slots (smpl body joints) come
from the kinematic chain; rest joints are j0 + JB @ beta.  One fused
"fold" matrix applies JB, Hb and Hp to [betas; posefeat] in one product.
SMPL-H/X use the same algebra at 52/55 joints, with the SMPL-X
expression folded as He/JE over `expr_dirs`.

The constants are built on the host in float64 (BLAS products instead of
the reference's float32 einsums) and stored as float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.rotations import rodrigues
from .smpl import SMPLAssets, SMPLParams, _rigid_chain, assemble_chain_pose


@dataclasses.dataclass
class JointModel:
    """Precomputed reduced model for the K mapped annotation joints."""

    H0: torch.Tensor          # (K, 24, 4)
    Hb: torch.Tensor          # (K, 24, 3, NB)
    Hp: torch.Tensor          # (K, 24, 3, 207)
    j0: torch.Tensor          # (24, 3) rest joints at beta=0
    JB: torch.Tensor          # (24, 3, NB) rest-joint shape basis
    chain_idx: torch.Tensor   # (K,) int64: source chain joint (0 if none)
    chain_mask: torch.Tensor  # (K,) 1.0 where chain-derived
    fold: torch.Tensor        # (J*3 + K*J*3, NB + 207)
    # SMPL-X expression fold (None otherwise), as Hb/JB over expr_dirs.
    He: Optional[torch.Tensor] = None   # (K, J, 3, NE)
    JE: Optional[torch.Tensor] = None   # (J, 3, NE)
    # Hand PCA shared with the full assets (for the pose assembly).
    hand_components: Optional[torch.Tensor] = None  # (2, C, 45)
    hand_means: Optional[torch.Tensor] = None       # (2, 45)
    parents: Tuple[int, ...] = ()
    model_type: str = "smpl"
    # Per-device constants of the CUDA kernel (ops/joint_kernel.py),
    # built on first use.
    kernel_tables: dict = dataclasses.field(default_factory=dict,
                                            repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.H0.device

    def to(self, device) -> "JointModel":
        """This model on `device` (itself, kernel constants kept, when it
        is already there)."""
        if self.device == torch.device(device):
            return self
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(device)
        kw["kernel_tables"] = {}
        return JointModel(**kw)


def build_joint_model(assets: SMPLAssets) -> JointModel:
    """Precompute the reduced tensors from full SMPL assets (one-time)."""
    f64 = np.float64

    def host(t):
        return t.detach().cpu().numpy().astype(f64)

    V = assets.num_verts
    K = int(assets.joint_map.shape[0])
    NB = assets.num_betas
    joint_map = assets.joint_map.cpu().numpy()
    extra_ids = assets.extra_joint_ids.cpu().numpy()
    nj = len(assets.parents)

    if assets.model_type == "smpllsp":
        base_rows = host(assets.lsp_regressor)
        num_base = base_rows.shape[0]
        base_is_chain = np.zeros(num_base, bool)
    else:
        base_rows = None
        num_base = nj
        base_is_chain = np.ones(num_base, bool)

    G = np.zeros((K, V), f64)
    chain_idx = np.full((K,), -1, np.int64)
    for k, src in enumerate(joint_map):
        if src < num_base:
            if base_is_chain[src]:
                chain_idx[k] = src
            else:
                G[k] = base_rows[src]
        else:
            G[k, extra_ids[src - num_base]] = 1.0
    chain_mask = (chain_idx >= 0).astype(np.float32)

    W = host(assets.lbs_weights)                           # (V, J)
    GW = (G[:, None, :] * W.T[None]).reshape(K * nj, V)    # (K*J, V)
    vt = host(assets.v_template)
    vt_h = np.concatenate([vt, np.ones((V, 1))], 1)
    H0 = (GW @ vt_h).reshape(K, nj, 4)
    S = host(assets.shapedirs)                             # (V, 3, NB)
    Hb = (GW @ S.reshape(V, 3 * NB)).reshape(K, nj, 3, NB)
    Pd = host(assets.posedirs).reshape(-1, V, 3)           # (P9, V, 3)
    P9 = Pd.shape[0]
    Hp = (GW @ Pd.transpose(1, 2, 0).reshape(V, 3 * P9)
          ).reshape(K, nj, 3, P9)
    JR = host(assets.j_regressor)                          # (J, V)
    j0 = JR @ vt
    JB = (JR @ S.reshape(V, 3 * NB)).reshape(nj, 3, NB)

    nj3 = nj * 3
    fold = np.zeros((nj3 + K * nj3, NB + P9), f64)
    fold[:nj3, :NB] = JB.reshape(nj3, NB)
    fold[nj3:, :NB] = Hb.reshape(K * nj3, NB)
    fold[nj3:, NB:] = Hp.reshape(K * nj3, P9)

    dev = assets.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    He = JE = None
    if assets.expr_dirs is not None:
        Ed = host(assets.expr_dirs)                        # (V, 3, NE)
        NE = Ed.shape[-1]
        He = t((GW @ Ed.reshape(V, 3 * NE)).reshape(K, nj, 3, NE))
        JE = t((JR @ Ed.reshape(V, 3 * NE)).reshape(nj, 3, NE))

    return JointModel(
        H0=t(H0), Hb=t(Hb), Hp=t(Hp), j0=t(j0), JB=t(JB),
        chain_idx=torch.as_tensor(np.maximum(chain_idx, 0), device=dev),
        chain_mask=t(chain_mask), fold=t(fold), He=He, JE=JE,
        hand_components=assets.hand_components,
        hand_means=assets.hand_means,
        parents=tuple(assets.parents), model_type=assets.model_type)


def with_joint_model(assets: SMPLAssets) -> SMPLAssets:
    """Return assets carrying their precomputed reduced joint model."""
    return dataclasses.replace(assets, joint_model=build_joint_model(assets))


def joint_forward(jm: JointModel, params: SMPLParams,
                  body_pose: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mapped annotation joints (B, K, 3) without touching vertices."""
    pose = body_pose if body_pose is not None else params.body_pose
    pose = assemble_chain_pose(jm, params, pose)
    B = pose.shape[0]
    nj = len(jm.parents)
    full_pose = torch.cat([params.global_orient, pose], dim=-1)

    dtype = jm.H0.dtype
    betas = params.betas.to(dtype)
    K = jm.H0.shape[0]
    ident = torch.eye(3, dtype=dtype, device=pose.device)

    rot_mats = rodrigues(full_pose.reshape(B, nj, 3))
    pf = (rot_mats[:, 1:] - ident).reshape(B, -1)           # (B, 207)
    v = torch.cat([betas, pf], dim=-1) @ jm.fold.T          # (B, rows)
    j_rest = jm.j0 + v[:, :nj * 3].reshape(B, nj, 3)
    off = v[:, nj * 3:].reshape(B, K, nj, 3)
    if params.expression is not None and jm.He is not None:
        expr = params.expression.to(dtype)
        j_rest = j_rest + torch.einsum("jce,be->bjc", jm.JE, expr)
        off = off + torch.einsum("kjce,be->bkjc", jm.He, expr)

    posed_joints, A = _rigid_chain(rot_mats, j_rest, jm.parents,
                                   params.scale)
    H = jm.H0 + torch.cat([off, torch.zeros_like(off[..., :1])], dim=-1)
    vert_joints = torch.einsum("bjac,bkjc->bka", A[:, :, :3, :4], H)
    chain_joints = posed_joints[:, jm.chain_idx]
    joints = torch.where(jm.chain_mask[:, None] > 0, chain_joints,
                         vert_joints)
    return joints + params.transl[:, None, :]
