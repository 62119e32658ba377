"""The PyTorch port's ops against the JAX package, on the CPU.

Tolerance: rtol = atol = 1e-5 throughout: the same fp32 formulas, so the
two packages differ only by the order of float32 operations.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.models import camera as jcam
from mvsmplfitting_tpu.ops import robust as jrob
from mvsmplfitting_tpu.ops import rotations as jrot
from mvsmplfitting_tpu.ops.alignment import umeyama as jumeyama
from mvsmplfitting_tpu.ops.triangulate import triangulate as jtriangulate
from mvsmplfitting_tpu_torch import convert
from mvsmplfitting_tpu_torch.models import camera as tcam
from mvsmplfitting_tpu_torch.ops import robust as trob
from mvsmplfitting_tpu_torch.ops import rotations as trot
from mvsmplfitting_tpu_torch.ops.alignment import umeyama as tumeyama
from mvsmplfitting_tpu_torch.ops.triangulate import (
    triangulate as ttriangulate)

from torch_port_helpers import arrays

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _rot_mats(rng, n):
    return np.array(jrot.rodrigues(jnp.asarray(
        rng.normal(0, 1.0, (n, 3)), jnp.float32)))


@pytest.mark.parametrize("name", ["rodrigues", "sixd_to_matrix",
                                  "matrix_to_quaternion",
                                  "quaternion_to_axis_angle",
                                  "matrix_to_axis_angle"])
def test_rotation_matches_jax(name):
    rng = np.random.default_rng(0)
    if name == "rodrigues":
        x = rng.normal(0, 1.0, (64, 3))
        x[:4] = 0.0                      # the +1e-8 quirk at zero rotation
    elif name == "sixd_to_matrix":
        x = rng.normal(0, 1.0, (64, 6))
    elif name == "quaternion_to_axis_angle":
        x = rng.normal(0, 1.0, (64, 4))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[0] = [1.0, 0.0, 0.0, 0.0]      # identity: the 2v branch
        x[1] = [-0.5, 0.5, 0.5, 0.5]     # w < 0: the sign fold
    else:
        x = _rot_mats(rng, 64)
        x[0] = np.diag([1.0, -1.0, -1.0])   # pi about x: pivot selection
    x = x.astype(np.float32)
    got = getattr(trot, name)(torch.from_numpy(x))
    _close(got, getattr(jrot, name)(jnp.asarray(x)))


def test_rotation_derivatives_match_jax():
    """Forward-mode derivatives of the VPoser tail agree, including the
    floor and branch quirks near the identity."""
    rng = np.random.default_rng(1)
    o6 = rng.normal(0, 1.0, (32, 6)).astype(np.float32)
    o6[:4] = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    o6[4:8] += rng.normal(0, 1e-4, (4, 6)).astype(np.float32)

    def jtail(x):
        return jrot.matrix_to_axis_angle(jrot.sixd_to_matrix(x))

    want = jax.vmap(jax.jacfwd(jtail))(jnp.asarray(o6))
    from mvsmplfitting_tpu_torch.ops.forward_mode import jacobian_columns

    def ttail(x):
        return trot.matrix_to_axis_angle(trot.sixd_to_matrix(x))

    got = jacobian_columns(ttail, torch.from_numpy(o6))
    assert got.dtype == torch.float32
    _close(got, want, rtol=3e-4, atol=3e-4)


def test_transform_mat():
    rng = np.random.default_rng(2)
    R = _rot_mats(rng, 5)
    t = rng.normal(0, 1, (5, 3)).astype(np.float32)
    _close(trot.transform_mat(torch.from_numpy(R), torch.from_numpy(t)),
           jrot.transform_mat(jnp.asarray(R), jnp.asarray(t)))


@pytest.mark.parametrize("fn", ["gmof", "gmof_residual"])
def test_robust(fn):
    r = np.random.default_rng(3).normal(0, 150, (200,)).astype(np.float32)
    _close(getattr(trob, fn)(torch.from_numpy(r), 100.0),
           getattr(jrob, fn)(jnp.asarray(r), 100.0), rtol=1e-5, atol=1e-3)


def _cameras(rng, n=4):
    R = _rot_mats(rng, n)
    return jcam.Camera(
        rotation=jnp.asarray(R),
        translation=jnp.asarray(rng.normal(0, 0.2, (n, 3)) + [0, 0, 5],
                                jnp.float32),
        focal=jnp.asarray(rng.uniform(900, 1300, (n, 2)), jnp.float32),
        center=jnp.asarray(rng.uniform(400, 600, (n, 2)), jnp.float32))


def test_project_points():
    rng = np.random.default_rng(4)
    jc = _cameras(rng)
    tc = convert.camera(arrays(jc), device="cpu")
    pts = rng.normal(0, 0.5, (3, 17, 3)).astype(np.float32)
    got = tcam.project_points(tc, torch.from_numpy(pts))
    _close(got, jcam.project_points(jc, jnp.asarray(pts)), rtol=1e-5,
           atol=1e-3)


def test_load_cameras_txt(tmp_path):
    rng = np.random.default_rng(5)
    jc = _cameras(rng, 3)
    path = str(tmp_path / "cams.txt")
    jcam.save_cameras_txt(path, jc)
    got = tcam.load_cameras_txt(path, device="cpu")
    want = jcam.load_cameras_txt(path)
    for f in ("rotation", "translation", "focal", "center"):
        _close(getattr(got, f), getattr(want, f))


def test_triangulate():
    rng = np.random.default_rng(6)
    jc = _cameras(rng, 4)
    tc = convert.camera(arrays(jc), device="cpu")
    pts = rng.normal(0, 0.4, (2, 17, 3)).astype(np.float32)
    pix = np.stack([np.asarray(jcam.project_points(jc, jnp.asarray(p)))
                    for p in pts])                          # (B, V, K, 2)
    pix = pix + rng.normal(0, 1.0, pix.shape).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, pix.shape[:-1]).astype(np.float32)
    mask = np.ones((2, 4), np.float32)
    mask[1, 3] = 0.0
    got = ttriangulate(tc, torch.from_numpy(pix), torch.from_numpy(conf),
                       torch.from_numpy(mask))
    want = np.stack([np.asarray(jtriangulate(
        jc, jnp.asarray(pix[b]), jnp.asarray(conf[b]),
        jnp.asarray(mask[b]))) for b in range(2)])
    _close(got, want, rtol=1e-5, atol=1e-4)


def test_umeyama_with_flip_quirk():
    rng = np.random.default_rng(7)
    B = 16
    src = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    R = _rot_mats(rng, B)
    dst = (np.einsum("bij,mj->bmi", R, src) * rng.uniform(0.8, 1.2, (B, 1, 1))
           + rng.normal(0, 1, (B, 1, 3))
           + rng.normal(0, 0.01, (B, 4, 3))).astype(np.float32)
    for est in (True, False):
        rot, trans, scale = tumeyama(
            torch.from_numpy(src).expand(B, -1, -1), torch.from_numpy(dst),
            est)
        for b in range(B):
            wr, wt, ws = jumeyama(jnp.asarray(src), jnp.asarray(dst[b]),
                                  est)
            _close(rot[b], wr, rtol=1e-5, atol=3e-5)
            _close(trans[b], wt, rtol=1e-5, atol=3e-5)
            _close(scale[b], ws)


def test_entry_points_default_to_cuda():
    """Without a GPU the default device raises; device='cpu' works."""
    from mvsmplfitting_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32


BANNED = {"jax", "jaxlib", "flax", "mvsmplfitting_tpu"}


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    """No module of the port (nor chip_smoke.py) imports JAX, flax or the
    JAX package; exact top-level names, so the port's own name (which
    shares the prefix) is allowed."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "mvsmplfitting_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in BANNED}
    assert not bad, bad
    assert "mvsmplfitting_tpu_torch" not in BANNED
