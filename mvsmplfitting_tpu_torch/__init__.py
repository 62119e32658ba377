"""PyTorch/CUDA port of `mvsmplfitting_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
module layout and function names so each counterpart is easy to find.
Inside, frames are an explicit leading batch dimension (in place of
`jax.vmap`), parameters are dataclasses of tensors, and every entry point
takes a `device` that defaults to CUDA (see `device.resolve_device`).

The slice ported so far is the batched single-person Levenberg-Marquardt
fit (`parallel.batched.batched_fit_frames`), with the two kernels on its
path hand-written in CUDA C++ under `csrc/`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
