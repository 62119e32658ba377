"""PyTorch/CUDA port of `mvsmplfitting_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
module layout and function names so each counterpart is easy to find.
Inside, frames are an explicit leading batch dimension (in place of
`jax.vmap`), parameters are dataclasses of tensors, and every entry point
takes a `device` that defaults to CUDA (see `device.resolve_device`).

Ported so far: the batched single-person fit
(`parallel.batched.batched_fit_frames`) with every solver, prior and
sequence option of JAX's `FitConfig` for the whole body family (smpl,
smpllsp, SMPL-H and SMPL-X with their hand, expression and face
blocks), the one-card shared-shape sequence fit
(`parallel.schur.schur_sequence_fit`), and the multi-person collision
fits (`fitting.multi_person.fit_people`); the kernels on their paths are
hand-written in CUDA C++ under `csrc/`.  `cli.main` fits a folder in the
reference's layout from a YAML config, as the JAX package's CLI does.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
