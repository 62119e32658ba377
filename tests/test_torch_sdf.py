"""The port's SDF voxelizer, trilinear sampler and collision sums against
the JAX package, on the CPU (`ops/sdf.py`, `ops/sdf_kernel.py`).

Inputs are made by numpy from seeds and handed to both packages.  On the
CPU the voxelizer wrappers take the plain `sdf_grid`; the CUDA kernels
are held to it in `test_torch_kernel_sources.py` (compiled for the host)
and `test_torch_cuda.py` (on a GPU).

Tolerances and why:
- primitives: d^2 rtol 1e-5 / atol 1e-7, closest points atol 1e-6,
  crossings equal (XLA contracts the dot products into FMAs, the port
  rounds every operation; the test points are not on edges);
- voxel centers: bitwise (the same fp32 operations);
- phi against JAX: the same inside set and atol 1e-5 (`tests/test_sdf.py`
  uses 1e-5; the two differ by a few ulps where XLA contracts);
- trilinear values against JAX and torch `grid_sample`: atol 2e-5 (as
  `tests/test_sdf.py:167`); its tangent against JAX's custom JVP: rtol
  1e-5 / atol 1e-4 (the same sums in another order, at points away
  from cell faces, where the sampler is differentiable);
- collision sums: rtol 1e-5, their tangents rtol 1e-4 (sums of a few
  hundred fp32 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF
from torch.func import jvp

from mvsmplfitting_tpu.ops import sdf as J
from mvsmplfitting_tpu_torch.ops import sdf as S
from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK

from torch_port_helpers import icosphere, phase_b_walk, posed_bodies


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Each test worker shares the CPU with others: a torch op spread
    over every core stalls on the busiest one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tri(rng, n):
    return [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4)]


def test_point_triangle_primitives_match_jax():
    p, a, b, c = _tri(np.random.default_rng(0), 2000)
    tp, ta, tb, tc = (torch.from_numpy(v) for v in (p, a, b, c))
    cl0, d0 = J.point_triangle_closest(*(jnp.asarray(v)
                                         for v in (p, a, b, c)))
    cl1, d1 = S.point_triangle_closest(tp, ta, tb, tc)
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(cl1.numpy(), np.asarray(cl0), atol=1e-6)
    np.testing.assert_array_equal(
        S.point_triangle_dist_sq(tp, ta, tb, tc).numpy(), d1.numpy())
    dest = np.random.default_rng(1).uniform(-2, 2, (2000, 3)).astype(
        np.float32)
    hit0 = np.asarray(J.ray_crossings(*(jnp.asarray(v)
                                        for v in (p, a, b, c, dest))))
    hit1 = S.ray_crossings(tp, ta, tb, tc, torch.from_numpy(dest))
    assert 100 < hit0.sum() < 1900
    np.testing.assert_array_equal(hit1.numpy(), hit0)
    assert hit1.dtype == torch.int32


@pytest.mark.parametrize("G", [7, 12, 16])
def test_voxel_centers_bitwise(G):
    np.testing.assert_array_equal(S.voxel_centers(G).numpy(),
                                  np.asarray(J.voxel_centers(G)))


def _meshes():
    v, f = icosphere(radius=0.55, n=10)
    bodies, body_faces = posed_bodies()
    return {"sphere": (v, f), "body": (bodies[0].numpy(),
                                       body_faces.numpy())}


@pytest.mark.parametrize("name,G", [("sphere", 16), ("body", 12)])
def test_sdf_grid_matches_jax(name, G):
    verts, faces = _meshes()[name]
    want = np.asarray(jax.jit(J.sdf_grid, static_argnums=2)(
        jnp.asarray(verts), jnp.asarray(faces), G))
    got = S.sdf_grid(torch.from_numpy(verts), torch.from_numpy(faces),
                     G).numpy()
    assert (want > 0).sum() > 10
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fast_wrapper_matches_jax_pallas_interpret():
    """JAX's two-phase Pallas voxelizer in interpret mode, with 16-lane
    tiles that straddle rows (G=12: L % G != 0), against the port's
    `sdf_grid_fast` (on the CPU, its plain version), two meshes in one
    call."""
    v1, faces = icosphere(radius=0.45, center=(0.2, 0.1, -0.1), n=9)
    v2, _ = icosphere(radius=0.6, center=(0.7, 0.7, 0.0), n=9)
    # Jitted, the interpreted kernel runs ~4x faster than op by op.
    want = [np.asarray(w) for w in jax.jit(lambda vs: [
        J.sdf_grid_pallas_fast(v, jnp.asarray(faces), 12, face_chunk=8,
                               interpret=True, _max_lanes=16)
        for v in vs])((jnp.asarray(v1), jnp.asarray(v2)))]
    got = SK.sdf_grid_fast(torch.from_numpy(np.stack([v1, v2])),
                           torch.from_numpy(faces), 12).numpy()
    for g, w in zip(got, want):
        assert (w > 0).any()
        np.testing.assert_array_equal(g > 0, w > 0)
        np.testing.assert_allclose(g, w, atol=1e-5)


def _brick_rows(G, nb):
    """The two-phase kernel's threads (csrc/sdf_grid_fast.cu), 128 per
    brick, each with a row of 4 consecutive x voxels: their first x, y
    and z (nb^3, 128) and the bricks' voxels in the kernel's order
    (nb^3, 512), -1 where a ragged brick leaves the grid."""
    t = torch.arange(128)
    b = torch.arange(nb ** 3)[:, None]
    x0 = (b % nb) * SK.BRICK + ((t >> 3) & 1) * 4
    y = (b // nb % nb) * SK.BRICK + ((t & 3) | (((t >> 4) & 1) << 2))
    z = (b // nb ** 2) * SK.BRICK + (((t >> 2) & 1) | (((t >> 5) & 3) << 1))
    x = x0[..., None] + torch.arange(4)
    ids = torch.where((x < G) & (y < G)[..., None] & (z < G)[..., None],
                      (z[..., None] * G + y[..., None]) * G + x, -1)
    return x0, y, z, ids.reshape(nb ** 3, 512)


@pytest.mark.parametrize("G", [16, 12])
def test_cull_tables_are_conservative(G):
    """With the plain pair functions, over every brick and chunk: a chunk
    that phase A's mask drops has no crossing with any voxel of the
    brick; a face of an admitted chunk that phase A's per-face test (its
    box minimum and projected box against each thread's row of 4 voxels)
    rules out for a row has no crossing with the row's voxels; and phase
    B's walk, run as the kernel runs it on each group of 8 inside voxels
    of a brick (`phase_b_walk`), drops no chunk with a face that would
    lower an inside voxel's minimum.  At G=12 the last brick of each
    axis is ragged (4 voxels)."""
    v1, faces = icosphere(radius=0.45, center=(0.2, 0.1, -0.1), n=9)
    v2, _ = icosphere(radius=0.3, center=(-0.4, 0.5, 0.3), n=9)
    verts = torch.from_numpy(np.concatenate([v1, v2]))
    faces = torch.from_numpy(np.concatenate([faces, faces + len(v1)]))
    tb = SK.cull_tables(S.triangles(verts[None], faces), G)
    tri, nc = tb.trib[0], tb.nc                      # ordered, padded
    centers = S.voxel_centers(G)
    comps = [tri[:, i][None] for i in range(9)]
    px, py, pz = (centers[:, i:i + 1] for i in range(3))
    cross = S._pair_crossing(*comps, px, py, pz, -1.0 - px, -1.0 - py,
                             -1.0 - pz).reshape(G ** 3, nc, SK.CHUNK)
    d2 = S._pair_dist_sq(*comps, px, py, pz).reshape(G ** 3, nc, SK.CHUNK)
    inside = cross.sum((1, 2)) % 2 == 1
    assert int(inside.sum()) > 50

    x0, y, z, order = _brick_rows(G, tb.nb)
    mask = tb.mask[0]                                # (NB, nc)
    rec = tb.tria[0].reshape(nc, SK.CHUNK, 16)
    cross_f = cross.reshape(G ** 3, nc * SK.CHUNK)

    def coord(i):
        return -1.0 + (i.float() + 0.5) * S.voxel_step(G)

    dropped_b = skipped = 0
    for b in range(tb.nb ** 3):
        vox = order[b][order[b] >= 0]
        dropped = ~mask[b]
        assert int(cross[vox][:, dropped].sum()) == 0, (b, dropped)
        # The per-face test, row by row, as the kernel computes it.
        rx0, rx3 = coord(x0[b]), coord(x0[b] + 3)
        ry, rz = coord(y[b]), coord(z[b])
        e0, e3, ey, ez = rx0 + 1.0, rx3 + 1.0, ry + 1.0, rz + 1.0
        s0, s3 = e0 + ey + ez, e3 + ey + ez
        ru = torch.stack([e0 / s0, e3 / s3])
        rv = torch.stack([ey / s0, ey / s3])
        fid = torch.nonzero(mask[b].repeat_interleave(SK.CHUNK)).flatten()
        f = rec.reshape(-1, 16)[fid]
        near = ((f[:, 9] <= rx3[:, None]) & (f[:, 10] <= ry[:, None])
                & (f[:, 11] <= rz[:, None])
                & (f[:, 12] <= ru.amax(0)[:, None])
                & (ru.amin(0)[:, None] <= f[:, 13])
                & (f[:, 14] <= rv.amax(0)[:, None])
                & (rv.amin(0)[:, None] <= f[:, 15]))      # (128, faces)
        rows = order[b].reshape(128, 4)
        for t in range(128):
            vt = rows[t][rows[t] >= 0]
            off = fid[~near[t]]
            assert int(cross_f[vt][:, off].sum()) == 0, (b, t)
            skipped += len(off)
        ins = vox[inside[vox]]
        for g0 in range(0, len(ins), SK.GROUP):
            grp = ins[g0:g0 + SK.GROUP]
            _, run_min, left = phase_b_walk(tb, 0, grp)
            dropped_b += int(left.sum())
            full = d2[grp].reshape(len(grp), -1).amin(-1)
            assert torch.equal(run_min, full), (b, g0)
    assert int((~mask).sum()) > 0 and skipped > 0 and dropped_b > 0


def test_grid_sample_matches_jax_and_torch():
    rng = np.random.default_rng(11)
    G = 9
    phi = rng.standard_normal((G, G, G)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, size=(60, 3)).astype(np.float32)
    got = S.grid_sample_trilinear(torch.from_numpy(phi),
                                  torch.from_numpy(coords)).numpy()
    want = np.asarray(J.grid_sample_trilinear(jnp.asarray(phi),
                                              jnp.asarray(coords)))
    ref = tF.grid_sample(torch.from_numpy(phi)[None, None],
                         torch.from_numpy(coords).view(1, -1, 1, 1, 3),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False).view(-1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    batched = S.grid_sample_trilinear(
        torch.from_numpy(np.stack([phi, 2 * phi])),
        torch.from_numpy(np.stack([coords, coords])))
    np.testing.assert_allclose(batched[1].numpy(), 2 * got, rtol=1e-6,
                               atol=1e-6)


def test_grid_sample_tangent_matches_jax_custom_jvp():
    rng = np.random.default_rng(7)
    G = 8
    phi = rng.standard_normal((G, G, G)).astype(np.float32)
    k = rng.integers(-1, G, size=(40, 3))          # some cells at the rim
    pix = k + rng.uniform(0.2, 0.8, size=(40, 3))
    c0 = ((2.0 * pix + 1.0) / G - 1.0).astype(np.float32)
    dc = (rng.standard_normal((40, 3)) * 0.5).astype(np.float32)
    _, want = jax.jit(lambda c, d: jax.jvp(
        lambda cc: J.grid_sample_trilinear(jnp.asarray(phi), cc),
        (c,), (d,)))(jnp.asarray(c0), jnp.asarray(dc))
    tphi = torch.from_numpy(phi)
    _, got = jvp(lambda c: S.grid_sample_trilinear(tphi, c),
                 (torch.from_numpy(c0),), (torch.from_numpy(dc),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_collision_sums_match_jax():
    """Two overlapping spheres at G=16 with every vertex sampled in every
    grid; then the tangent in a random direction of the vertices, the
    port's with the grids held fixed (as its fits do) against JAX's jvp
    through `collision_sums`."""
    v1, faces = icosphere(radius=0.5, center=(0, 0, 0), n=12)
    v2, _ = icosphere(radius=0.5, center=(0.3, 0.05, 0), n=12)
    verts = np.stack([v1, v2])
    dv = np.random.default_rng(5).normal(0, 0.1, verts.shape).astype(
        np.float32)
    G = 16

    @jax.jit
    def jax_side(v, d):
        s, s_t = jax.jvp(lambda vv: J.collision_sums(vv, jnp.asarray(faces),
                                                      G), (v,), (d,))
        return s, s_t, J.collision_energy(v, jnp.asarray(faces),
                                          jnp.asarray(3.0), G)
    want, want_t, want_e = jax_side(jnp.asarray(verts), jnp.asarray(dv))
    tv, tf = torch.from_numpy(verts), torch.from_numpy(faces)
    got = S.collision_sums(tv, tf, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(got.min()) > 1.0                   # they overlap
    phi, _, _ = S.person_grids(tv, tf, G)
    _, got_t = jvp(lambda v: S.sampled_at_live_frame(phi, v), (tv,),
                   (torch.from_numpy(dv),))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                               rtol=1e-4, atol=1e-4)
    e = S.collision_energy(tv, tf, 3.0, G)
    np.testing.assert_allclose(e.item(), float(want_e), rtol=1e-5)
