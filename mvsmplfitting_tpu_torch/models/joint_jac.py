"""Closed-form Jacobian of the reduced joint model, batched over frames
(port of `models/joint_jac.py`).

For a chain of local transforms ``W_j = W_parent . T_j``, perturbing
joint l's parameters moves every descendant j as ``dW_j = G_l . W_j``
with the generator ``G_l = W_{l-} (dT_l T_l^-1) W_{l-}^-1`` built from
primal quantities; an ancestry mask turns the sum over parameters into
one contraction.  Extended to the scaled root (`lbs.py:348`), the
beta-dependent rest skeleton, the pose-corrective offsets and the
vertex-regressed joint rows of the reduced model.

This is the plain PyTorch version of the CUDA joint-Jacobian kernel
(`ops/joint_kernel.py`, `csrc/joint_jacobian.cu`).  The rodrigues
derivative is forward mode through the shared `rodrigues`, so the +1e-8
quirk differentiates consistently.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.forward_mode import jacobian_columns
from ..ops.rotations import rodrigues
from .joint_model import JointModel
from .smpl import SMPLParams, _rigid_chain


def _ancestry(parents: Tuple[int, ...]) -> np.ndarray:
    """(J, J) anc[l, j] = 1 if l is an ancestor of j or l == j."""
    J = len(parents)
    anc = np.zeros((J, J), np.float32)
    for j in range(J):
        l = j
        while True:
            anc[l, j] = 1.0
            if l == 0:
                break
            l = parents[l]
    return anc


def rest_offset_basis(jm: JointModel) -> torch.Tensor:
    """drel (J, 3, NB): d(local rest offset) / d betas."""
    par = np.asarray(jm.parents)
    return torch.cat([jm.JB[:1], jm.JB[1:] - jm.JB[par[1:]]], dim=0)


def joint_jacobian(jm: JointModel, params: SMPLParams,
                   body_pose: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mapped joints (B, K, 3) and their Jacobian blocks.

    ``blocks`` maps each parameter group to columns shaped
    ``(B, n_group, K, 3)``: "pose" (69), "orient" (3), "betas" (NB),
    "transl" (3) and "scale" (1).
    """
    parents = jm.parents
    J = len(parents)
    dtype = jm.H0.dtype
    device = body_pose.device
    par = np.asarray(parents)
    B = body_pose.shape[0]
    K = jm.H0.shape[0]
    need = (J - 1) * 3

    theta = torch.cat([params.global_orient, body_pose],
                      dim=-1).reshape(B, J, 3)
    betas = params.betas.to(dtype)
    scale = params.scale.to(dtype)

    # --- primal chain (the same computation as joint_forward) ---
    R = rodrigues(theta)                                      # (B, J, 3, 3)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    pf = (R[:, 1:] - eye3).reshape(B, -1)
    v = torch.cat([betas, pf], dim=-1) @ jm.fold.T
    j_rest = jm.j0 + v[:, :J * 3].reshape(B, J, 3)
    h_off = v[:, J * 3:].reshape(B, K, J, 3)
    p, A = _rigid_chain(R, j_rest, parents, scale)
    Rw = A[:, :, :3, :3]                                  # scaled world rot
    tw = p

    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, par[1:]]],
                    dim=1)
    Rp = torch.cat([eye3.expand(B, 1, 3, 3), Rw[:, par[1:]]], dim=1)
    twp = torch.cat([torch.zeros_like(tw[:, :1]), tw[:, par[1:]]], dim=1)
    # Rw = scale * orthonormal, so the parent inverse is Rp^T / scale^2,
    # except at the root, whose "parent" is the identity.
    inv_s2 = 1.0 / torch.clamp_min(scale * scale, 1e-30)
    inv_f = torch.cat([torch.ones_like(scale)[:, None],
                       inv_s2[:, None].expand(B, J - 1)], dim=1)
    Rpinv = Rp.transpose(-1, -2) * inv_f[..., None, None]

    anc = torch.as_tensor(_ancestry(parents), dtype=dtype, device=device)

    # --- rotation generators: (B, l, r, s, A) etc. ---
    dR = jacobian_columns(rodrigues, theta.reshape(-1, 3)).reshape(
        B, J, 3, 3, 3)
    Kg = sum(dR[:, :, :, None, c, :] * R[:, :, None, :, c, None]
             for c in range(3))
    G1 = sum(Rp[:, :, :, b, None, None] * Kg[:, :, None, b, :, :]
             for b in range(3))                               # (B,l,i,c,A)
    G_rot = sum(G1[:, :, :, c, None, :] * Rpinv[:, :, None, c, :, None]
                for c in range(3))                            # (B,l,3,3,A)
    G_t = -(sum(G_rot[:, :, :, d, :] * twp[:, :, None, d, None]
                for d in range(3))
            + sum(G1[:, :, :, c, :] * rel[:, :, None, c, None]
                  for c in range(3)))                         # (B,l,3,A)
    GrT = G_rot.permute(0, 1, 4, 2, 3)                        # (B,l,A,a,d)
    GtT = G_t.permute(0, 1, 3, 2)                             # (B,l,A,a)

    # --- chain-joint derivatives: dp[l,A,j,:] = anc(l,j)(G_rot p_j + G_t)
    dp_theta = ((sum(GrT[:, :, :, None, :, d] * p[:, None, None, :, None, d]
                     for d in range(3))
                 + GtT[:, :, :, None, :])
                * anc[None, :, None, :, None])                # (B,l,A,j,3)

    drel = rest_offset_basis(jm)                              # (J, 3, NB)
    anc_drel = torch.einsum("lj,lbB->ljbB", anc, drel)
    dtw_b = torch.einsum("zlab,ljbB->zjaB", Rp, anc_drel)     # (B,j,3,NB)
    dp_s = (p - rel[:, :1]) / scale[:, None, None]            # (B,j,3)

    # --- vertex-regressed joint rows ---
    h = jm.H0[..., :3] + h_off                                # (B,K,J,3)
    w = jm.H0[..., 3]                                         # (K,J)
    q = h - w[..., None] * j_rest[:, None]
    contrib = (sum(Rw[:, None, :, :, b] * q[:, :, :, None, b]
                   for b in range(3))
               + w[None, :, :, None] * tw[:, None])           # (B,K,J,3)
    v_pre = contrib.sum(dim=2)                                # (B,K,3)
    Y = torch.einsum("lj,zkja->zkla", anc, contrib)
    Yt = Y.permute(0, 2, 1, 3)                                # (B,l,K,3)
    u = torch.einsum("lj,kj->kl", anc, w)                     # (K,J)

    dv_theta = (sum(GrT[:, :, :, None, :, d] * Yt[:, :, None, :, None, d]
                    for d in range(3))
                + u.T[None, :, None, :, None]
                * GtT[:, :, :, None, :])                      # (B,l,A,K,3)
    P = torch.einsum("zjab,kjbp->zkap", Rw, jm.Hp)            # (B,K,3,207)
    P9 = P.reshape(B, K, 3, J - 1, 9)
    dR9 = dR.reshape(B, J, 9, 3)
    dv_pc = torch.einsum("zkalq,zlqA->zlAka", P9, dR9[:, 1:])
    dv_theta = torch.cat([dv_theta[:, :1], dv_theta[:, 1:] + dv_pc], dim=1)

    HbW = jm.Hb - torch.einsum("kj,jbB->kjbB", w, jm.JB)
    u_drel = torch.einsum("kl,lbB->klbB", u, drel)
    dv_b = (torch.einsum("zjab,kjbB->zkaB", Rw, HbW)
            + torch.einsum("zlab,klbB->zkaB", Rp, u_drel))    # (B,K,3,NB)
    Wk = w.sum(dim=1)                                         # (K,)
    dv_s = (v_pre - Wk[None, :, None] * rel[:, :1]) / scale[:, None, None]

    # --- combine per mapped slot ---
    cidx = jm.chain_idx
    cm = (jm.chain_mask > 0)[:, None]                         # (K,1)

    def mix(d_chain, d_vert):
        return torch.where(cm, d_chain, d_vert)

    joints = mix(p[:, cidx], v_pre) + params.transl[:, None, :]
    dth = mix(dp_theta[:, :, :, cidx, :].reshape(B, J * 3, K, 3),
              dv_theta.reshape(B, J * 3, K, 3))
    blocks = {
        "orient": dth[:, :3],
        "pose": dth[:, 3:3 + need],
        "betas": mix(dtw_b[:, cidx].permute(0, 3, 1, 2),
                     dv_b.permute(0, 3, 1, 2)),
        "transl": eye3[None, :, None, :].expand(B, 3, K, 3),
        "scale": mix(dp_s[:, cidx], dv_s)[:, None],
    }
    return joints, blocks
