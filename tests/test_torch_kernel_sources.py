"""The port's CUDA sources, compiled for the host and run on the CPU.

There is no GPU or nvcc here, so the kernels' own arithmetic would
otherwise go untested until a run on the card.  g++ compiles each
`mvsmplfitting_tpu_torch/csrc/*.cu` against `tests/cuda_host/
cuda_runtime.h`, which runs every block's threads as std::threads with
barriers for `__syncthreads`/`__syncwarp`; the C entry point is then
called through the wrappers' own `bind`/`call` on CPU tensors and held
against the plain PyTorch version at the kernel tolerances (RTOL 3e-5 /
ATOL 1e-5; the VPoser D block at 3e-4 / 3e-4 max|D|; the SDF voxelizers
bitwise).  This checks the
arithmetic and indexing, not the GPU's memory model or timing.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mvsmplfitting_tpu_torch.models import vposer as V
from mvsmplfitting_tpu_torch.ops import cuda_build
from mvsmplfitting_tpu_torch.ops import joint_kernel as JK
from mvsmplfitting_tpu_torch.ops import sdf as sdf_ops
from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
from mvsmplfitting_tpu_torch.ops import vposer_kernel as VK

from torch_port_helpers import (icosphere, phase_b_walk, port_assets,
                                posed_bodies, rand_joint_inputs, vposer_pair)

STUB_DIR = os.path.join(os.path.dirname(__file__), "cuda_host")
LAUNCH = re.compile(r"(\w+)<<<(.*?),(.*?),(.*?),.*?>>>\((.*?)\);", re.S)
DYNAMIC_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out_dir = tmp_path_factory.mktemp("cuda_host")
    libs = {}
    for name in cuda_build.KERNEL_SOURCES:
        src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        src, n = LAUNCH.subn(r"emu_launch(\2, \3, \4, [&] { \1(\5); });",
                             src)
        src = DYNAMIC_SMEM.sub(
            r"\1* \2 = static_cast<\1*>(emu_dynamic_smem);", src)
        want = 2 if name == "sdf_grid_fast" else 1
        assert n == want, f"{name}: expected {want} kernel launches, found {n}"
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(src)
        so = out_dir / f"lib{name}.so"
        done = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                               "-pthread", "-I", STUB_DIR, "-I",
                               str(cuda_build.CSRC_DIR), "-o", str(so),
                               str(cpp)], timeout=300, capture_output=True,
                              text=True)
        assert done.returncode == 0, f"{name}: g++ failed\n{done.stderr}"
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture
def nan_outputs(monkeypatch):
    """The wrappers' outputs start as NaN, so an element the kernel does
    not write fails the comparison."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(
        float("nan")))


@pytest.mark.parametrize("B", [1, 11])
@pytest.mark.parametrize("model_type", ["smpl", "smpllsp"])
def test_joint_jacobian_source_on_host(host_libs, model_type, B,
                                       nan_outputs):
    """B=1 and B=11 (one 8-frame tile and a ragged one): padding frames
    must not write, and every (tile, slot) block must."""
    jm = port_assets(model_type).joint_model
    theta, betas, scale = (torch.from_numpy(a) for a in rand_joint_inputs(
        np.random.default_rng(7), B))
    fn = JK.bind(host_libs["joint_jacobian"])
    gj, gb = JK.call(fn, JK.kernel_tables(jm, torch.device("cpu")), theta,
                     betas, scale, None)
    wj, wb = JK.joint_jacobian_plain(jm, theta, betas, scale)
    torch.testing.assert_close(gj, wj, rtol=3e-5, atol=1e-5)
    for k in wb:
        torch.testing.assert_close(gb[k], wb[k], rtol=3e-5, atol=1e-5,
                                   msg=f"{model_type} block {k}")


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("sigma", [0.6, 1e-3])
def test_vposer_tail_source_on_host(host_libs, sigma, B, nan_outputs):
    _, tw = vposer_pair()
    z = torch.from_numpy(np.random.default_rng(8).normal(
        0, sigma, (B, 32)).astype(np.float32))
    o, Do = V.mlp_head(tw, z)
    o, Do = o.contiguous(), Do.contiguous()
    aa1, D1 = VK.call(VK.bind(host_libs["vposer_tail"]), o, Do, None)
    aa0, D0 = VK.tail_plain(o, Do)
    torch.testing.assert_close(aa1, aa0, rtol=3e-5, atol=1e-5)
    sc = max(D0.abs().max().item(), 1.0)
    torch.testing.assert_close(D1, D0, rtol=3e-4, atol=3e-4 * sc)


def test_vposer_tail_call_refuses_misaligned_do():
    """The tail kernel copies Do in 16-byte pieces: a view 4 bytes into
    its storage is refused before the entry point is reached."""
    o = torch.zeros((2, 138))
    Do = torch.zeros(2 * 138 * 32 + 1)[1:].view(2, 138, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        VK.call(None, o, Do, None)


def _sdf_batches():
    """(name, verts (M, V, 3), faces): two tilted spheres in one batch
    (one partly outside the grid) and two posed bodies in another."""
    v1, faces = icosphere(radius=0.45, center=(0.2, 0.1, -0.1), n=9)
    v2, _ = icosphere(radius=0.6, center=(0.7, 0.7, 0.0), n=9)
    spheres = torch.from_numpy(np.stack([v1, v2]))
    bodies, body_faces = posed_bodies()
    return [("spheres", spheres, torch.from_numpy(faces)),
            ("bodies", bodies, body_faces)]


@pytest.mark.parametrize("G", [8, 12])
def test_sdf_sources_on_host(host_libs, G):
    """Both voxelizers, bitwise against the plain version: the pair
    arithmetic is the same IEEE operations in the same order.  At G=12
    the grid is not a multiple of the 8-voxel brick, so the last bricks
    of each axis are ragged.  Phase A's work list holds exactly the
    inside voxels, in groups of 8 from one brick each (padding last),
    and every group visits as many chunks as the plain mirror of its walk
    (`phase_b_walk`)."""
    grid_fn = SK.bind_grid(host_libs["sdf_grid"])
    cross_fn, dist_fn = SK.bind_fast(host_libs["sdf_grid_fast"])
    for name, verts, faces in _sdf_batches():
        tri = sdf_ops.triangles(verts, faces)
        want = sdf_ops.sdf_grid(verts, faces, G)
        assert (want > 0).any(), name
        got3 = SK.call_grid(grid_fn, tri, G, None)
        tb = SK.cull_tables(tri, G)
        phi, work, counts = SK.call_cross(cross_fn, tb, None)
        visits = SK.call_dist(dist_fn, tb, phi, work, counts, 2, None)
        assert torch.equal(got3, want), name
        assert torch.equal(phi, want), name
        n = int(counts[0])
        groups = work[:n * SK.GROUP].reshape(n, SK.GROUP).long()
        listed = groups[groups >= 0]
        inside = torch.zeros(want.numel(), dtype=torch.bool)
        inside[listed] = True
        assert listed.numel() == int(inside.sum()), name      # no repeats
        assert torch.equal(inside.reshape(want.shape), want > 0), name
        # One brick per group; padding only after the voxels; each brick
        # fills as few groups as it can.
        lin = groups.clamp_min(0) % G ** 3
        brick = ((groups.clamp_min(0) // G ** 3 * tb.nb ** 3)
                 + (lin // G ** 2 // SK.BRICK * tb.nb
                    + lin // G % G // SK.BRICK) * tb.nb
                 + lin % G // SK.BRICK)
        assert bool((brick == brick[:, :1]).where(groups >= 0, True).all())
        valid = (groups >= 0).int()
        assert bool((valid[:, 1:] <= valid[:, :-1]).all()), name
        per_brick = torch.bincount(brick[groups >= 0])
        assert n == int(((per_brick + SK.GROUP - 1) // SK.GROUP).sum())
        # Each group's walk visits as many chunks as the plain mirror's.
        for g in range(n):
            vox = groups[g][groups[g] >= 0]
            m = int(vox[0]) // G ** 3
            want_v = phase_b_walk(tb, m, vox - m * G ** 3)[0]
            assert int(visits[g]) == want_v > 0, (name, g)
