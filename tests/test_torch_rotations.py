"""The port's quaternion, 6D and Euler helpers
(`mvsmplfitting_tpu_torch/ops/rotations.py`) against JAX's
(`mvsmplfitting_tpu/ops/rotations.py`), on the same seeded inputs.

Tolerance: atol = rtol = 1e-5, the tightest that `tests/test_rotations.py`
uses: the same float32 formulas in both packages.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.ops import rotations as jrot
from mvsmplfitting_tpu_torch.ops import rotations as trot

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "quaternion_to_matrix":
        q = rng.normal(0, 1, (64, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        q[0] = [1, 0, 0, 0]
        return q.astype(np.float32)
    if name == "axis_angle_to_quaternion":
        aa = rng.normal(0, 1.5, (64, 3))
        aa[0] = 0.0                       # the +1e-8 shift at zero angle
        return aa.astype(np.float32)
    if name == "matrix_to_sixd":
        aa = rng.normal(0, 1.0, (2, 32, 3)).astype(np.float32)
        return np.array(jrot.rodrigues(jnp.asarray(aa)))
    return rng.uniform(-np.pi, np.pi, (2, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["quaternion_to_matrix",
                                  "axis_angle_to_quaternion",
                                  "matrix_to_sixd"])
def test_rotation_helper_matches_jax(name):
    x = _inputs(name)
    want = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    got = getattr(trot, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "convention", ["".join(c) for c in itertools.product("XYZ", repeat=3)])
def test_euler_angles_to_matrix_matches_jax(convention):
    x = _inputs("euler")
    x[0, 0] = [0.0, 0.0, np.pi / 2]
    want = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(x),
                                                  convention))
    got = trot.euler_angles_to_matrix(torch.from_numpy(x), convention)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quaternion_round_trips():
    """axis-angle -> quaternion -> matrix is rodrigues, and matrix ->
    6D -> matrix is the identity on rotations, as in JAX's tests."""
    aa = torch.from_numpy(_inputs("axis_angle_to_quaternion"))
    R = trot.quaternion_to_matrix(trot.axis_angle_to_quaternion(aa))
    np.testing.assert_allclose(R.numpy(), trot.rodrigues(aa).numpy(),
                               atol=1e-5)
    R = trot.rodrigues(aa)
    back = trot.sixd_to_matrix(trot.matrix_to_sixd(R))
    np.testing.assert_allclose(back.numpy(), R.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        trot.euler_angles_to_matrix(aa, "XYW")
