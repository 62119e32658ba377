"""Batched joint Jacobian: the CUDA kernel `csrc/joint_jacobian.cu` and
its plain PyTorch version (port of `ops/joint_kernel.py`).

`joint_jacobian_batched` takes theta (B, 72), betas (B, NB), scale (B,)
and returns the mapped joints (B, K, 3) WITHOUT translation plus the
Jacobian blocks of `models.joint_jac.joint_jacobian`.  CUDA tensors
launch the kernel (or raise); CPU tensors take the plain closed form.

The kernel takes the per-model constants in plain row-major layouts
(no TPU lane permutation), built once per `JointModel` and device.  The
per-slot tables hold only the vertex slots: a chain slot's rows of the
fold, H0, Hb and Hp are zero, and its joint comes from the chain.  Each
vertex slot's beta table, fold slab and pose-corrective slab are
contiguous, with rows of a multiple of 16 bytes, so a block streams them
through shared memory with 16-byte copies.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.joint_jac import _ancestry, joint_jacobian, rest_offset_basis
from ..models.joint_model import JointModel
from ..models.smpl import SMPLParams
from . import cuda_build

# Kernel launches; the wrapper adds one where it launches the kernel.
LAUNCHES = 0

# Limits compiled into the kernel (shared-memory sizing).
NUM_JOINTS = 24
MAX_SLOTS = 24
MAX_BETAS = 16
HP_LD = 208          # the pose-corrective slab's row, 0-padded (16 bytes)


def kernel_ok(jm: JointModel) -> bool:
    """The kernel covers the plain SMPL chain (smpl/smpllsp)."""
    return jm is not None and jm.model_type in ("smpl", "smpllsp")


@dataclasses.dataclass
class KernelTables:
    """Device constants of the kernel for one JointModel; per-slot
    tables are indexed by vertex slot v = vslot[k]."""

    JBT: torch.Tensor         # (NB, 72) rest-joint shape basis transposed
    fold: torch.Tensor        # (Kv, NB + 207, 72) vertex-slot fold slabs
    Hp: torch.Tensor          # (Kv, 72, 208): [v, j*3+b, (l-1)*9+q], 0-padded
    Hb2: torch.Tensor         # (Kv, 72, NB): [v, j*3+b, bt], see kernel_tables

    j0: torch.Tensor          # (24, 3)
    H0: torch.Tensor          # (Kv, 24, 4)
    u: torch.Tensor           # (Kv, 24) ancestry-summed skinning weights
    drel: torch.Tensor        # (24, 3, NB)
    parents: torch.Tensor     # (24,) int32, root -1
    desc: torch.Tensor        # (24,) int32, bit j set if l is j or an ancestor
    chain_idx: torch.Tensor   # (K,) int32
    vslot: torch.Tensor       # (K,) int32 vertex slot, -1 for a chain slot
    kslot: torch.Tensor       # (Kv,) int32 slot k of each vertex slot
    K: int
    Kv: int
    NB: int

    def nbytes(self) -> int:
        """Bytes of all tables (each read once per call at the least)."""
        tensors = (getattr(self, f.name) for f in dataclasses.fields(self))
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))


def kernel_tables(jm: JointModel, device: torch.device) -> KernelTables:
    """The kernel's constants for `jm` on `device` (cached on `jm`)."""
    key = str(device)
    tables = jm.kernel_tables.get(key)
    if tables is not None:
        return tables
    J = len(jm.parents)
    if J != NUM_JOINTS or any(p >= j for j, p in enumerate(jm.parents)):
        raise ValueError("the joint-Jacobian kernel needs the 24-joint SMPL "
                         "tree with parents before children")
    K, NB = jm.H0.shape[0], jm.JB.shape[-1]
    if K > MAX_SLOTS or NB > MAX_BETAS:
        raise ValueError(f"kernel limits: K <= {MAX_SLOTS}, NB <= "
                         f"{MAX_BETAS} (got K={K}, NB={NB})")
    f32 = dict(dtype=torch.float32, device=device)
    vs = torch.nonzero(jm.chain_mask.cpu() == 0).flatten()   # vertex slots
    Kv = int(vs.numel())
    vslot = torch.full((K,), -1, dtype=torch.int32)
    vslot[vs] = torch.arange(Kv, dtype=torch.int32)
    vs = vs.to(device)
    anc_np = _ancestry(jm.parents)
    anc = torch.as_tensor(anc_np, **f32)
    desc = (anc_np > 0).astype(np.int64) @ (1 << np.arange(J, dtype=np.int64))
    H0 = jm.H0.to(**f32)[vs]
    w = H0[..., 3]
    JB = jm.JB.to(**f32)
    u = torch.einsum("lj,kj->kl", anc, w)
    drel = rest_offset_basis(jm).to(**f32)
    # Hb2[v, j] = Hb - w JB + sum of u_l drel_l over the children l of j:
    # the rest offsets' beta terms ride on the parent's world rotation, so
    # a vertex slot's beta block is W . Hb2 + u_0 drel_0.
    child = torch.zeros((J, J), **f32)                        # [j, l]
    for l in range(1, J):
        child[jm.parents[l], l] = 1.0
    Hb2 = (jm.Hb.to(**f32)[vs] - torch.einsum("kj,jbB->kjbB", w, JB)
           + torch.einsum("jl,kl,lbB->kjbB", child, u, drel))
    Hp = torch.zeros((Kv, J * 3, HP_LD), **f32)
    Hp[..., :9 * (J - 1)] = jm.Hp.to(**f32)[vs].reshape(Kv, J * 3, -1)
    fold_v = jm.fold.to(**f32)[J * 3:].reshape(K, J * 3, -1)[vs]
    i32 = dict(dtype=torch.int32, device=device)
    tables = KernelTables(
        JBT=JB.reshape(J * 3, NB).T.contiguous(),
        fold=fold_v.transpose(1, 2).contiguous(),
        Hp=Hp,
        Hb2=Hb2.reshape(Kv, J * 3, NB).contiguous(),
        j0=jm.j0.to(**f32).contiguous(),
        H0=H0.contiguous(),
        u=u.contiguous(),
        drel=drel.contiguous(),
        parents=torch.as_tensor(np.asarray(jm.parents), **i32),
        desc=torch.as_tensor(desc, **i32),
        chain_idx=jm.chain_idx.to(**i32).contiguous(),
        vslot=vslot.to(device),
        kslot=vs.to(**i32),
        K=K, Kv=Kv, NB=NB)
    jm.kernel_tables[key] = tables
    return tables


def _blocks(joints, dth, dbe, dsc):
    B, K = joints.shape[:2]
    eye3 = torch.eye(3, dtype=joints.dtype, device=joints.device)
    return joints, {
        "orient": dth[:, :3],
        "pose": dth[:, 3:],
        "betas": dbe,
        "transl": eye3[None, :, None, :].expand(B, 3, K, 3),
        "scale": dsc,
    }


def joint_jacobian_plain(jm: JointModel, theta: torch.Tensor,
                         betas: torch.Tensor, scale: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain PyTorch version: the batched closed form, no transl."""
    B = theta.shape[0]
    params = SMPLParams(betas=betas, global_orient=theta[:, :3],
                        body_pose=theta[:, 3:],
                        transl=torch.zeros_like(theta[:, :3]), scale=scale)
    return joint_jacobian(jm, params, theta[:, 3:])


def bind(lib: ctypes.CDLL):
    """The library's C entry point with its argument types declared."""
    fn = lib.mvsf_joint_jacobian
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _check_input(name, t, shape):
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need contiguous float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} contiguous="
                         f"{t.is_contiguous()}")


def joint_jacobian_cuda(jm: JointModel, theta: torch.Tensor,
                        betas: torch.Tensor, scale: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Launch `csrc/joint_jacobian.cu` (a block per 8 frames and slot)."""
    global LAUNCHES
    device = theta.device
    if device.type != "cuda" or betas.device != device \
            or scale.device != device:
        raise ValueError("joint_jacobian_cuda: all inputs must be on one "
                         "CUDA device")
    fn = bind(cuda_build.load("joint_jacobian"))
    out = call(fn, kernel_tables(jm, device), theta, betas, scale,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES += int(theta.shape[0] > 0)   # B == 0 launches nothing
    return out


def call(fn, tb: KernelTables, theta: torch.Tensor, betas: torch.Tensor,
         scale: torch.Tensor, stream):
    """Check the inputs, allocate the outputs and call the C entry point
    `fn` (see `bind`) on `stream`."""
    B = theta.shape[0]
    K, NB = tb.K, tb.NB
    _check_input("theta", theta, (B, NUM_JOINTS * 3))
    _check_input("betas", betas, (B, NB))
    _check_input("scale", scale, (B,))
    out = dict(dtype=torch.float32, device=theta.device)
    joints = torch.empty((B, K, 3), **out)
    dth = torch.empty((B, NUM_JOINTS * 3, K, 3), **out)
    dbe = torch.empty((B, NB, K, 3), **out)
    dsc = torch.empty((B, 1, K, 3), **out)
    if B == 0:
        return _blocks(joints, dth, dbe, dsc)
    err = fn(theta.data_ptr(), betas.data_ptr(), scale.data_ptr(),
             tb.JBT.data_ptr(), tb.fold.data_ptr(), tb.Hp.data_ptr(),
             tb.Hb2.data_ptr(), tb.j0.data_ptr(), tb.H0.data_ptr(), tb.u.data_ptr(), tb.drel.data_ptr(), tb.parents.data_ptr(),
             tb.desc.data_ptr(), tb.chain_idx.data_ptr(),
             tb.vslot.data_ptr(), tb.kslot.data_ptr(), B, K, tb.Kv, NB,
             joints.data_ptr(), dth.data_ptr(), dbe.data_ptr(),
             dsc.data_ptr(), stream)
    cuda_build.check(err, "joint_jacobian kernel")
    return _blocks(joints, dth, dbe, dsc)


def joint_jacobian_batched(jm: JointModel, theta: torch.Tensor,
                           betas: torch.Tensor, scale: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched joints (no transl) and Jacobian blocks; the kernel for
    CUDA tensors, the plain closed form for CPU tensors."""
    if theta.is_cuda:
        return joint_jacobian_cuda(jm, theta.float().contiguous(),
                                   betas.float().contiguous(),
                                   scale.float().contiguous())
    if theta.device.type == "cpu":
        return joint_jacobian_plain(jm, theta, betas, scale)
    raise ValueError(f"unsupported device {theta.device}")
