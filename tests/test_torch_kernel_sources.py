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
        want = 2 if name.startswith("sdf_grid") else 1
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


def _box(lo, hi, G):
    """An axis-aligned box (8, 3) with its corners on the voxel centers
    lo and hi (x, y, z indices) of the G-grid, and its 12 faces (two
    triangles a side, split along a diagonal): parity rays from voxel
    centers graze its edges and start on its sides."""
    line = sdf_ops.voxel_line(G)
    c = [[line[lo[k]], line[hi[k]]] for k in range(3)]
    verts = torch.tensor([[c[0][i & 1], c[1][i >> 1 & 1], c[2][i >> 2]]
                          for i in range(8)])
    faces = torch.tensor([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6],
                          [0, 1, 4], [1, 5, 4], [2, 6, 3], [3, 6, 7],
                          [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]])
    return verts, faces


def _plain_inside(tri, G):
    """(M*G^3,) bool: the odd crossing counts of the plain voxelizer's
    first pass (phi can be 0 there, at a voxel on the surface)."""
    p = sdf_ops.voxel_centers(G)
    px, py, pz = (p[:, i:i + 1] for i in range(3))
    n = torch.stack([sdf_ops._pair_crossing(
        *(t[:, i][None] for i in range(9)), px, py, pz, -1.0 - px,
        -1.0 - py, -1.0 - pz).sum(1) for t in tri])
    return (n % 2 == 1).reshape(-1)


def _sdf_batches(G):
    """(name, verts (M, V, 3), faces): two tilted spheres in one batch
    (one partly outside the grid), two posed bodies in another, and two
    boxes on voxel centers (one reaching the grid's first and last)."""
    v1, faces = icosphere(radius=0.45, center=(0.2, 0.1, -0.1), n=9)
    v2, _ = icosphere(radius=0.6, center=(0.7, 0.7, 0.0), n=9)
    spheres = torch.from_numpy(np.stack([v1, v2]))
    bodies, body_faces = posed_bodies()
    b1, box_faces = _box((1, 2, 2), (G - 3, G - 2, G - 4), G)
    b2, _ = _box((0, 1, 3), (G - 2, G - 4, G - 1), G)
    return [("spheres", spheres, torch.from_numpy(faces)),
            ("bodies", bodies, body_faces),
            ("boxes", torch.stack([b1, b2]), box_faces)]


@pytest.mark.parametrize("G", [8, 12, 13])
def test_sdf_sources_on_host(host_libs, G):
    """Both voxelizers, bitwise against the plain version: the pair
    arithmetic is the same IEEE operations in the same order.  At G=12
    and 13 the two-phase kernels' 8-voxel bricks are ragged at the end
    of each axis, and at G=13 the brute force's tiles of 4 voxels by 4
    rows at the end of each row and plane.  The brute force's lists
    and phase A's work list hold exactly the inside voxels (the odd
    crossing counts: on the boxes phi is 0 at inside voxels on a side),
    each once; phase A's in groups of 8 from one brick each (padding
    last), and every group visits as many chunks as the plain mirror of
    its walk (`phase_b_walk`)."""
    grid_fn = SK.bind_grid(host_libs["sdf_grid"])
    cross_fn, dist_fn = SK.bind_fast(host_libs["sdf_grid_fast"])
    for name, verts, faces in _sdf_batches(G):
        tri = sdf_ops.triangles(verts, faces)
        want = sdf_ops.sdf_grid(verts, faces, G)
        assert (want > 0).any(), name
        inside = (_plain_inside(tri, G) if name == "boxes"
                  else (want > 0).reshape(-1))
        got3, w3 = SK.call_grid(grid_fn, tri, G, None, blocks=3,
                                with_work=True)
        tb = SK.cull_tables(tri, G)
        phi, work, counts = SK.call_cross(cross_fn, tb, None)
        visits = SK.call_dist(dist_fn, tb, phi, work, counts, 2, None)
        assert torch.equal(got3, want), name
        assert torch.equal(phi, want), name
        # The brute force's list of mesh m starts row m of its work.
        M = tri.shape[0]
        listed3 = torch.cat([w3["work"][m, :int(w3["counts"][m])].long()
                             + m * G ** 3 for m in range(M)])
        assert torch.equal(torch.sort(listed3).values,
                           torch.nonzero(inside).flatten()), name
        assert int(w3["counts"][M]) >= listed3.numel(), name
        n = int(counts[0])
        groups = work[:n * SK.GROUP].reshape(n, SK.GROUP).long()
        listed = groups[groups >= 0]
        assert torch.equal(torch.sort(listed).values,
                           torch.nonzero(inside).flatten()), name
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


@pytest.mark.parametrize("F", [1, SK.GRID_CHUNK, SK.GRID_CHUNK + 1])
def test_grid_tables_pad_to_whole_chunks(F):
    """The brute force's tables: each mesh's triangles padded to whole
    chunks of GRID_CHUNK, as [a, b - a, c - a, 0] and [a, b, c]; the
    padding triangles cross no parity ray from a voxel center and lie
    farther than SDF_FAR_D2 from every one, so they change no voxel."""
    tri = torch.from_numpy(np.random.default_rng(F).uniform(
        -1, 1, (2, F, 9)).astype(np.float32))
    tb = SK.grid_tables(tri, 6)
    nc = -(-F // SK.GRID_CHUNK)
    assert tb.nc == nc and tb.G == 6
    assert tb.trib.shape == (2, nc * SK.GRID_CHUNK, 9)
    assert tb.tria.shape == (2, nc * SK.GRID_CHUNK, 12)
    assert torch.equal(tb.trib[:, :F], tri)
    a = tb.trib[..., 0:3]
    assert torch.equal(tb.tria[..., 0:3], a)
    assert torch.equal(tb.tria[..., 3:6], tb.trib[..., 3:6] - a)
    assert torch.equal(tb.tria[..., 6:9], tb.trib[..., 6:9] - a)
    assert not tb.tria[..., 9:].any()
    pad = tb.trib[:, F:].reshape(-1, 9)
    assert pad.shape[0] == 2 * (nc * SK.GRID_CHUNK - F)
    if pad.shape[0]:
        p = sdf_ops.voxel_centers(6)
        px, py, pz = (p[:, i:i + 1] for i in range(3))
        t = [pad[:, i][None] for i in range(9)]
        assert not sdf_ops._pair_crossing(*t, px, py, pz, -1.0 - px,
                                          -1.0 - py, -1.0 - pz).any()
        assert bool((sdf_ops._pair_dist_sq(*t, px, py, pz) > 1e6).all())
