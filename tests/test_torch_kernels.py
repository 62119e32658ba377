"""The port's two kernel modules against the JAX package, on the CPU.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX Pallas kernels run in interpret mode (as the JAX
package's own tests run them) and against the vmapped JAX closed forms.
Both packages get the same inputs (numpy, seeded) and the same
per-model constants (the port-built joint model).

Tolerances: RTOL 3e-5 / ATOL 1e-5 (fp32 reassociation, the JAX kernel
tests' `tests/test_joint_kernel.py:24`); the VPoser D block at rtol 3e-4
/ atol 3e-4 max|D| (`tests/test_joint_kernel.py:213-215`).

The CUDA kernels themselves are held against these plain versions on the
card by `tests/test_torch_cuda.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.models import vposer as jvp
from mvsmplfitting_tpu.models.joint_jac import joint_jacobian as jjoint_jac
from mvsmplfitting_tpu.models.smpl import SMPLParams as JParams
from mvsmplfitting_tpu.ops import joint_kernel as JK
from mvsmplfitting_tpu.ops import vposer_kernel as JVK
from mvsmplfitting_tpu_torch.ops import joint_kernel as TK
from mvsmplfitting_tpu_torch.ops import vposer_kernel as TVK

from torch_port_helpers import (jax_joint_model, port_assets,
                                rand_joint_inputs, vposer_pair)

RTOL = 3e-5
ATOL = 1e-5


def _assert_blocks(got, want, what):
    gj, gb = got
    wj, wb = want
    np.testing.assert_allclose(gj.cpu().numpy(), np.asarray(wj), rtol=RTOL,
                               atol=ATOL, err_msg=f"{what} joints")
    assert set(gb) == set(wb)
    for k in wb:
        np.testing.assert_allclose(gb[k].cpu().numpy(), np.asarray(wb[k]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} block {k}")


def _jax_closed_form(jm, theta, betas, scale):
    def one(th, be, sc):
        params = JParams(betas=be, global_orient=th[:3],
                         body_pose=jnp.zeros((th.shape[0] - 3,), th.dtype),
                         transl=jnp.zeros((3,), th.dtype), scale=sc)
        return jjoint_jac(jm, params, th[3:])
    return jax.jit(jax.vmap(one))(jnp.asarray(theta), jnp.asarray(betas),
                                  jnp.asarray(scale))


@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_joint_jacobian_matches_jax(model_type):
    """Port (CPU plain version) == JAX Pallas kernel (interpret) == JAX
    vmapped closed form, both slot kinds."""
    tjm = port_assets(model_type).joint_model
    jjm = jax_joint_model(tjm)
    theta, betas, scale = rand_joint_inputs(np.random.default_rng(1), 5)
    got = TK.joint_jacobian_batched(tjm, torch.from_numpy(theta),
                                    torch.from_numpy(betas),
                                    torch.from_numpy(scale))
    assert TK.kernel_ok(tjm)
    pallas = jax.jit(lambda a, b, c: JK.joint_jacobian_batched(
        jjm, a, b, c, interpret=True))
    _assert_blocks(got, pallas(theta, betas, scale),
                   f"{model_type} vs pallas interpret")
    _assert_blocks(got, _jax_closed_form(jjm, theta, betas, scale),
                   f"{model_type} vs closed form")


def test_joint_jacobian_cpu_takes_plain_version():
    """A CPU tensor takes the plain version: no kernel launch counted."""
    tjm = port_assets("smpl").joint_model
    theta, betas, scale = rand_joint_inputs(np.random.default_rng(2), 2)
    before = TK.LAUNCHES
    j, blk = TK.joint_jacobian_batched(tjm, torch.from_numpy(theta),
                                       torch.from_numpy(betas),
                                       torch.from_numpy(scale))
    assert TK.LAUNCHES == before
    K = tjm.H0.shape[0]
    assert j.shape == (2, K, 3)
    assert {k: tuple(v.shape) for k, v in blk.items()} == {
        "orient": (2, 3, K, 3), "pose": (2, 69, K, 3),
        "betas": (2, 10, K, 3), "transl": (2, 3, K, 3),
        "scale": (2, 1, K, 3)}


SIGMAS = (0.6, 1e-3)


@functools.lru_cache(maxsize=None)
def _vposer_case():
    """Latents for both cases in one batch (z ~ N(0, 0.6) and the
    near-identity z ~ N(0, 1e-3)) and the JAX references for it: the
    Pallas tail in interpret mode (one call, it is slow to interpret)
    and the vmapped closed form."""
    jw, _ = vposer_pair()
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.normal(0, s, (5, 32)) for s in SIGMAS]
                       ).astype(np.float32)
    # XLA's backend optimisation passes take ~9 of the ~28 s this
    # interpreted kernel costs to compile on the CPU; they are skipped.
    pallas = jax.jit(lambda zz: JVK.decode_jac_batched(
        jw, zz, interpret=True)).lower(jnp.asarray(z)).compile(
            {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True})(jnp.asarray(z))
    closed = jax.jit(jax.vmap(lambda zi: jvp.decode_jac(jw, zi)))(
        jnp.asarray(z))
    return z, [tuple(np.asarray(a) for a in pallas),
               tuple(np.asarray(a) for a in closed)]


@pytest.mark.parametrize("case", range(len(SIGMAS)))
def test_vposer_tail_matches_jax(case):
    """Port decode_jac_batched (CPU plain version) == JAX Pallas tail
    (interpret) == vmapped JAX decode_jac, incl. near-identity poses."""
    _, tw = vposer_pair()
    z_all, refs = _vposer_case()
    rows = slice(5 * case, 5 * case + 5)
    aa1, D1 = TVK.decode_jac_batched(tw, torch.from_numpy(z_all[rows]))
    for aa0, D0 in refs:
        aa0, D0 = aa0[rows], D0[rows]
        np.testing.assert_allclose(aa1.numpy(), np.asarray(aa0), rtol=RTOL,
                                   atol=ATOL)
        sc = max(float(np.abs(np.asarray(D0)).max()), 1.0)
        np.testing.assert_allclose(D1.numpy(), np.asarray(D0), rtol=3e-4,
                                   atol=3e-4 * sc)
