"""VPoser decoder tail and its Jacobian: the CUDA kernel
`csrc/vposer_tail.cu` and its plain PyTorch version (port of
`ops/vposer_kernel.py`).

The MLP matmuls stay `torch.matmul` (`models.vposer.mlp_head`).  The
tail (6D -> rotation -> quaternion -> axis-angle per joint), its 6
forward-derivative columns and their composition with the MLP Jacobian
run in one kernel for CUDA tensors; CPU tensors take the plain version
(`jacfwd` of the same tail, `models.vposer.tail_jac`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..models import vposer as V
from . import cuda_build

# Kernel launches; the wrapper adds one where it launches the kernel.
LAUNCHES = 0

_ROWS = 6 * V.NUM_JOINTS          # 138
_OUT = 3 * V.NUM_JOINTS           # 69


def tail_plain(o: torch.Tensor, Do: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: o (B, 138), Do (B, 138, 32) -> (aa (B, 69),
    D (B, 69, 32))."""
    return V.tail_jac(o, Do)


def tail_cuda(o: torch.Tensor, Do: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/vposer_tail.cu` on o (B, 138), Do (B, 138, 32)."""
    global LAUNCHES
    device = o.device
    if device.type != "cuda" or Do.device != device:
        raise ValueError("tail_cuda: inputs must be on one CUDA device")
    out = call(bind(cuda_build.load("vposer_tail")), o, Do,
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES += int(o.shape[0] > 0)   # B == 0 launches nothing
    return out


def bind(lib: ctypes.CDLL):
    """The library's C entry point with its argument types declared."""
    fn = lib.mvsf_vposer_tail
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, o: torch.Tensor, Do: torch.Tensor, stream
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs, allocate the outputs and call the C entry point
    `fn` (see `bind`) on `stream`."""
    device = o.device
    B = o.shape[0]
    Z = V.LATENT_DIM
    for name, t, shape in (("o", o, (B, _ROWS)), ("Do", Do, (B, _ROWS, Z))):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if Do.data_ptr() % 16:
        raise ValueError("Do: the kernel copies it in 16-byte pieces and "
                         "needs it 16-byte aligned")
    aa = torch.empty((B, _OUT), dtype=torch.float32, device=device)
    D = torch.empty((B, _OUT, Z), dtype=torch.float32, device=device)
    if B == 0:
        return aa, D
    err = fn(o.data_ptr(), Do.data_ptr(), B, aa.data_ptr(), D.data_ptr(),
             stream)
    cuda_build.check(err, "vposer_tail kernel")
    return aa, D


def tail(o: torch.Tensor, Do: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.is_cuda:
        return tail_cuda(o.float().contiguous(), Do.float().contiguous())
    if o.device.type == "cpu":
        return tail_plain(o, Do)
    raise ValueError(f"unsupported device {o.device}")


def decode_jac_batched(w: V.VPoserWeights, z: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, 32) -> (body_pose (B, 69), D (B, 69, 32))."""
    o, Do = V.mlp_head(w, z.float())
    return tail(o, Do)
