"""Similarity alignment (Umeyama), batched (port of `ops/alignment.py`).

Keeps the reference's two quirks (`code/utils/umeyama.py:16-110`): the
full-rank rotation is ``U d Vh^T`` (not the Kabsch ``U d Vh``), and the
translation always comes from the column-flipped candidate.

Because ``U d Vh^T`` is not invariant to the sign of a singular-vector
pair, the result depends on the SVD routine's sign convention.  The 3x3
SVDs (and determinants) therefore run on the host through LAPACK, the
routine the JAX reference also uses on the CPU, whatever device the
frames live on: a few hundred 3x3 matrices, once per fit.
"""

from __future__ import annotations

from typing import Tuple

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor,
            estimate_scale: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares similarity transform src -> dst, per frame.

    Args:
      src, dst: (B, M, 3) point sets (broadcast against each other).

    Returns:
      (rot (B, 3, 3), trans (B, 3), scale (B,)) with
      ``dst ~= scale * rot @ src + trans``.
    """
    src, dst = torch.broadcast_tensors(src, dst)
    num, dim = src.shape[-2], src.shape[-1]
    device, dtype = src.device, src.dtype

    src_mean = src.mean(dim=-2)
    dst_mean = dst.mean(dim=-2)
    src_d = src - src_mean[..., None, :]
    dst_d = dst - dst_mean[..., None, :]

    A = (dst_d.transpose(-1, -2) @ src_d) / num
    A_host = A.cpu()
    U, S, Vt = (t.to(device) for t in torch.linalg.svd(A_host))
    det_A = torch.linalg.det(A_host).to(device)
    det_uv = (torch.linalg.det(U.cpu()) * torch.linalg.det(Vt.cpu())
              ).to(device)

    ones = torch.ones(A.shape[:-2] + (dim,), dtype=dtype, device=device)
    d = ones.clone()
    d[..., dim - 1] = torch.where(det_A < 0, -1.0, 1.0).to(dtype)
    # sic: U d Vh^T (the reference's full-rank branch, see module doc).
    rot_full = (U * d[..., None, :]) @ Vt.transpose(-1, -2)
    # Rank-deficient branch: rank == dim-1 uses the proper Kabsch form.
    eps = torch.finfo(dtype).eps
    tol = S[..., 0] * dim * eps
    rank = torch.sum(S > tol[..., None], dim=-1)
    d_neg = ones.clone()
    d_neg[..., dim - 1] = -1.0
    rot_def = torch.where((det_uv > 0)[..., None, None], U @ Vt,
                          (U * d_neg[..., None, :]) @ Vt)
    rot0 = torch.where((rank == dim - 1)[..., None, None], rot_def,
                       rot_full)

    if estimate_scale:
        var = src_d.var(dim=-2, unbiased=False).sum(dim=-1)
        scale = torch.sum(S * d, dim=-1) / var
    else:
        scale = torch.ones(A.shape[:-2], dtype=dtype, device=device)

    # Candidates: as-is, and with the first two columns negated.
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=dtype, device=device)
    rot1 = rot0 * flip

    def residual(rot):
        t = dst_mean - scale[..., None] * (rot @ src_mean[..., None])[..., 0]
        moved = (scale[..., None, None] * (src @ rot.transpose(-1, -2))
                 + t[..., None, :])
        return torch.linalg.vector_norm(moved - dst, dim=(-2, -1))

    take_flipped = residual(rot0) > residual(rot1)
    rot = torch.where(take_flipped[..., None, None], rot1, rot0)
    # sic: the translation always uses the flipped rotation.
    trans = dst_mean - scale[..., None] * (rot1 @ src_mean[..., None])[..., 0]
    return rot, trans, scale
