"""VPoser pose prior decoder, batched (port of `models/vposer.py`).

z (B, 32) -> fc 512 -> lrelu(0.2) -> fc 512 -> lrelu(0.2) -> fc 138 ->
23 6D rotations -> matrices -> axis-angle (B, 69).  Only the decoder is
on the fitting path; the encoder weights are loaded but not used.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.forward_mode import jacobian_columns
from ..ops.rotations import matrix_to_axis_angle, sixd_to_matrix

LATENT_DIM = 32
NUM_JOINTS = 23


@dataclasses.dataclass
class VPoserWeights:
    dec_fc1_w: torch.Tensor  # (32, 512)  input-major, x @ W
    dec_fc1_b: torch.Tensor  # (512,)
    dec_fc2_w: torch.Tensor  # (512, 512)
    dec_fc2_b: torch.Tensor  # (512,)
    dec_out_w: torch.Tensor  # (512, 138)
    dec_out_b: torch.Tensor  # (138,)
    # Encoder: `encode_mean` (the adjustment GUI's warm start).
    enc_bn1_mean: Optional[torch.Tensor] = None
    enc_bn1_var: Optional[torch.Tensor] = None
    enc_bn1_w: Optional[torch.Tensor] = None
    enc_bn1_b: Optional[torch.Tensor] = None
    enc_fc1_w: Optional[torch.Tensor] = None
    enc_fc1_b: Optional[torch.Tensor] = None
    enc_bn2_mean: Optional[torch.Tensor] = None
    enc_bn2_var: Optional[torch.Tensor] = None
    enc_bn2_w: Optional[torch.Tensor] = None
    enc_bn2_b: Optional[torch.Tensor] = None
    enc_fc2_w: Optional[torch.Tensor] = None
    enc_fc2_b: Optional[torch.Tensor] = None
    enc_mu_w: Optional[torch.Tensor] = None
    enc_mu_b: Optional[torch.Tensor] = None

    def to(self, device) -> "VPoserWeights":
        return VPoserWeights(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def _tail(o6: torch.Tensor) -> torch.Tensor:
    """6D (..., 6) -> axis-angle (..., 3)."""
    return matrix_to_axis_angle(sixd_to_matrix(o6))


def decode(weights: VPoserWeights, z: torch.Tensor) -> torch.Tensor:
    """Decode latent z (..., 32) -> body pose axis-angle (..., 69)."""
    x = _lrelu(z @ weights.dec_fc1_w + weights.dec_fc1_b)
    x = _lrelu(x @ weights.dec_fc2_w + weights.dec_fc2_b)
    x = x @ weights.dec_out_w + weights.dec_out_b
    aa = _tail(x.reshape(x.shape[:-1] + (NUM_JOINTS, 6)))
    return aa.reshape(z.shape[:-1] + (NUM_JOINTS * 3,))



def encode_mean(weights: VPoserWeights, body_pose: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Posterior mean of a body pose (..., 69) -> z (..., 32), BatchNorm
    in eval mode (JAX `models/vposer.py:106-115`)."""
    w = weights
    if w.enc_mu_w is None:
        raise ValueError("encode_mean: these VPoser weights carry no encoder")
    x = (body_pose - w.enc_bn1_mean) * torch.rsqrt(w.enc_bn1_var + eps) \
        * w.enc_bn1_w + w.enc_bn1_b
    x = _lrelu(x @ w.enc_fc1_w + w.enc_fc1_b)
    x = (x - w.enc_bn2_mean) * torch.rsqrt(w.enc_bn2_var + eps) \
        * w.enc_bn2_w + w.enc_bn2_b
    x = _lrelu(x @ w.enc_fc2_w + w.enc_fc2_b)
    return x @ w.enc_mu_w + w.enc_mu_b

def mlp_head(w: VPoserWeights, z: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLP forward and its factored Jacobian: z (B, 32) ->
    o (B, 138), Do (B, 138, 32).  Plain matmuls (fp32, TF32 off)."""
    h1p = z @ w.dec_fc1_w + w.dec_fc1_b
    g1 = torch.where(h1p >= 0, 1.0, 0.2).to(z.dtype)
    h1 = torch.where(h1p >= 0, h1p, 0.2 * h1p)
    h2p = h1 @ w.dec_fc2_w + w.dec_fc2_b
    g2 = torch.where(h2p >= 0, 1.0, 0.2).to(z.dtype)
    h2 = torch.where(h2p >= 0, h2p, 0.2 * h2p)
    o = h2 @ w.dec_out_w + w.dec_out_b                    # (B, 138)
    D1 = g1[:, :, None] * w.dec_fc1_w.T[None]             # (B, 512, 32)
    D2 = g2[:, :, None] * torch.matmul(w.dec_fc2_w.T, D1)
    Do = torch.matmul(w.dec_out_w.T, D2)                  # (B, 138, 32)
    return o, Do


def tail_jac(o: torch.Tensor, Do: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder tail and its Jacobian composed with the MLP's:
    o (B, 138), Do (B, 138, 32) -> (body_pose (B, 69), D (B, 69, 32)).

    The tail's 6 derivative columns per joint are forward mode through
    the same 6D -> matrix -> axis-angle graph `decode` runs.
    """
    B = o.shape[0]
    o6 = o.reshape(B * NUM_JOINTS, 6)
    aa = _tail(o6)                                          # (B*23, 3)
    Jt = jacobian_columns(_tail, o6)                        # (B*23, 3, 6)
    D = torch.einsum("jab,jbZ->jaZ", Jt,
                     Do.reshape(B * NUM_JOINTS, 6, -1))
    return (aa.reshape(B, NUM_JOINTS * 3),
            D.reshape(B, NUM_JOINTS * 3, -1))


def decode_jac(weights: VPoserWeights, z: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, 32) -> (body_pose (B, 69), d body_pose / d z (B, 69, 32))."""
    o, Do = mlp_head(weights, z)
    return tail_jac(o, Do)


def load_npz(path: str, device: DeviceLike = None,
             dtype=torch.float32) -> VPoserWeights:
    dev = resolve_device(device)
    with np.load(path) as d:
        kw = {k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=dev)
              for k in d.files}
    return VPoserWeights(**kw)


def save_npz(path: str, weights: VPoserWeights) -> None:
    np.savez(path, **{f.name: getattr(weights, f.name).cpu().numpy()
                      for f in dataclasses.fields(weights)
                      if getattr(weights, f.name) is not None})


def convert_torch_snapshot(snapshot_path: str,
                           out_npz: Optional[str] = None,
                           device: DeviceLike = None) -> VPoserWeights:
    """The weights of a torch VPoser snapshot pkl, read with `torch.load`.

    The snapshot pickles a whole nn.Module by its class path
    `model.VPoser`, so stub classes are registered for unpickling and the
    state dict is read; Linear weights (out, in) are transposed to the
    input-major layout of `VPoserWeights`.
    """
    import sys
    import types

    import torch.nn as nn

    mod = types.ModuleType("model")
    vp_mod = types.ModuleType("model.VPoser")

    class VPoser(nn.Module):
        pass

    class ContinousRotReprDecoder(nn.Module):
        pass

    vp_mod.VPoser = VPoser
    vp_mod.ContinousRotReprDecoder = ContinousRotReprDecoder
    mod.VPoser = vp_mod
    sys.modules.setdefault("model", mod)
    sys.modules.setdefault("model.VPoser", vp_mod)

    dev = resolve_device(device)
    sd = torch.load(snapshot_path, map_location="cpu",
                    weights_only=False).state_dict()

    def t(name):  # torch Linear stores (out, in)
        return sd[name].detach().t().contiguous().to(dev, torch.float32)

    def v(name):
        return sd[name].detach().to(dev, torch.float32)

    weights = VPoserWeights(
        dec_fc1_w=t("bodyprior_dec_fc1.weight"),
        dec_fc1_b=v("bodyprior_dec_fc1.bias"),
        dec_fc2_w=t("bodyprior_dec_fc2.weight"),
        dec_fc2_b=v("bodyprior_dec_fc2.bias"),
        dec_out_w=t("bodyprior_dec_out.weight"),
        dec_out_b=v("bodyprior_dec_out.bias"),
        enc_bn1_mean=v("bodyprior_enc_bn1.running_mean"),
        enc_bn1_var=v("bodyprior_enc_bn1.running_var"),
        enc_bn1_w=v("bodyprior_enc_bn1.weight"),
        enc_bn1_b=v("bodyprior_enc_bn1.bias"),
        enc_fc1_w=t("bodyprior_enc_fc1.weight"),
        enc_fc1_b=v("bodyprior_enc_fc1.bias"),
        enc_bn2_mean=v("bodyprior_enc_bn2.running_mean"),
        enc_bn2_var=v("bodyprior_enc_bn2.running_var"),
        enc_bn2_w=v("bodyprior_enc_bn2.weight"),
        enc_bn2_b=v("bodyprior_enc_bn2.bias"),
        enc_fc2_w=t("bodyprior_enc_fc2.weight"),
        enc_fc2_b=v("bodyprior_enc_fc2.bias"),
        enc_mu_w=t("bodyprior_enc_mu.weight"),
        enc_mu_b=v("bodyprior_enc_mu.bias"),
    )
    if out_npz:
        save_npz(out_npz, weights)
    return weights


def load_vposer(prior_folder: str, device: DeviceLike = None
                ) -> VPoserWeights:
    """Resolve VPoser weights like the reference loader (`utils/prior.py`):
    a converted `vposer_weights.npz` in the folder first, else the newest
    `snapshots/*.pkl` torch snapshot."""
    npz = os.path.join(prior_folder, "vposer_weights.npz")
    if os.path.exists(npz):
        return load_npz(npz, device)
    snap_dir = os.path.join(prior_folder, "snapshots")
    if os.path.isdir(snap_dir):
        pkls = sorted(
            (os.path.join(snap_dir, p) for p in os.listdir(snap_dir)
             if p.endswith(".pkl")),
            key=os.path.getmtime)
        if pkls:
            return convert_torch_snapshot(pkls[-1], device=device)
    raise FileNotFoundError(f"No VPoser weights under {prior_folder}")
