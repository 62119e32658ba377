// Two-phase SDF voxelizer with exact face-chunk culls: crossings first,
// distances only where a voxel is inside.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/sdf.py:
// sdf_grid_pallas_fast, its `cross_kernel` (pallas_call at :798) and its
// `dist_kernel` (pallas_call at :888).  The result is bitwise equal to
// csrc/sdf_grid.cu: both evaluate every pair through csrc/sdf_common.cuh,
// and the culls only skip triangles that cannot change the result.
//
// The wrapper (ops/sdf_kernel.py:cull_tables) sorts each mesh's faces
// by centroid y and cuts them into chunks of SDF_CHUNK, so each chunk's
// bounding box is a thin y band.  A tile is SDF_THREADS consecutive
// voxels of one z slice (x fastest), one thread per voxel; when G*G is
// not a multiple of SDF_THREADS a tile straddles rows and the last tile
// of a slice is partial.
//
// Phase A (sdf_cross_kernel), one block per tile: the parity ray runs
// from the voxel toward (-1, -1, -1) with t >= 0, so it never reaches
// y above the voxel or z above the slice.  The block visits only the
// sorted-prefix chunks ny[tile] whose y_min can lie at or below the
// tile's highest row, and of those only the ones zmask admits for the
// slice.  It writes each voxel's inside flag and, with
// __syncthreads_or, the tile's flag.
//
// Phase B (sdf_dist_kernel), one block per tile: a tile without an
// inside voxel writes phi = 0 and leaves.  Otherwise the block visits
// chunks in the tile's order of lower bound lb2 (the squared y/z gap of
// the chunk's box to the tile's band), keeps a block-wide maximum
// `worst` of the inside voxels' running minima, and stops once the next
// bound exceeds worst * (1 + 1e-4) + 1e-9: no later chunk can lower any
// inside voxel's minimum (outside voxels get phi = 0 anyway).  The
// guard entry lb2[nc] = +inf ends the walk.  It writes, per tile, the
// number of chunks visited.
//
// Bound on the H100: operations, counted over the pairs the culls
// admit (phase A: ~60 operations a pair, phase B: ~116; see
// csrc/sdf_common.cuh).  Design: as csrc/sdf_grid.cu, one thread per
// voxel with its state in registers and each chunk staged in shared
// memory for all threads to read as a broadcast; every cull decision
// is the same for the whole block, so no thread diverges from it.

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

struct Tile {
  long mesh_tile;  // m * G * T + tile
  long vox;        // m * G^3 + k * G^2 + lane
  int k;           // z slice
  int t;           // tile within the slice
  bool valid;      // lane < G^2
  float px, py, pz;
};

__device__ __forceinline__ Tile sdf_tile(int G, int T, float dx) {
  Tile s;
  const int tile = blockIdx.x;
  s.k = tile / T;
  s.t = tile - s.k * T;
  const int GG = G * G;
  const int lane = s.t * SDF_THREADS + threadIdx.x;
  s.valid = lane < GG;
  const int l = s.valid ? lane : 0;
  s.mesh_tile = (long)blockIdx.y * G * T + tile;
  s.vox = (long)blockIdx.y * G * GG + (long)s.k * GG + l;
  s.px = sdf_coord(l % G, dx);
  s.py = sdf_coord(l / G, dx);
  s.pz = sdf_coord(s.k, dx);
  return s;
}

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_cross_kernel(const float* __restrict__ tri,
                     const int* __restrict__ ny,
                     const int* __restrict__ zmask, int F, int nc, int G,
                     int T, float dx, int* __restrict__ inside,
                     int* __restrict__ flags) {
  __shared__ float s_tri[SDF_CHUNK * 9];
  const Tile s = sdf_tile(G, T, dx);
  const float dxr = -1.0f - s.px, dyr = -1.0f - s.py, dzr = -1.0f - s.pz;
  const float* mesh = tri + (long)blockIdx.y * F * 9;
  const int* zm = zmask + ((long)blockIdx.y * G + s.k) * nc;
  const int n_y = ny[(long)blockIdx.y * T + s.t];

  int n_cross = 0;
  for (int c = 0; c < n_y; ++c) {
    if (!zm[c]) continue;  // the same for every thread of the block
    const int f0 = c * SDF_CHUNK;
    const int nf = min(SDF_CHUNK, F - f0);
    __syncthreads();
    sdf_stage_chunk(s_tri, mesh, f0, nf);
    __syncthreads();
    if (s.valid)
      for (int j = 0; j < nf; ++j)
        n_cross += sdf_pair_crossing(s_tri + j * 9, s.px, s.py, s.pz, dxr,
                                     dyr, dzr);
  }
  const int in = (s.valid && (n_cross & 1)) ? 1 : 0;
  if (s.valid) inside[s.vox] = in;
  const int any = __syncthreads_or(in);
  if (threadIdx.x == 0) flags[s.mesh_tile] = any ? 1 : 0;
}

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_dist_kernel(const float* __restrict__ tri,
                    const int* __restrict__ flags,
                    const int* __restrict__ order,
                    const float* __restrict__ lb2,
                    const int* __restrict__ inside, int F, int nc, int G,
                    int T, float dx, float* __restrict__ phi,
                    int* __restrict__ visits) {
  __shared__ float s_tri[SDF_CHUNK * 9];
  __shared__ float s_red[SDF_THREADS];
  const Tile s = sdf_tile(G, T, dx);
  if (flags[s.mesh_tile] == 0) {  // the same for every thread of the block
    if (s.valid) phi[s.vox] = 0.0f;
    if (threadIdx.x == 0) visits[s.mesh_tile] = 0;
    return;
  }
  const bool ins = s.valid && inside[s.vox] != 0;
  const float* mesh = tri + (long)blockIdx.y * F * 9;
  const int* ord = order + s.mesh_tile * (nc + 1);
  const float* lb = lb2 + s.mesh_tile * (nc + 1);

  float run_min = SDF_FAR_D2;
  float worst = SDF_FAR_D2;
  int c = 0;
  // lb[nc] is +inf, so the walk ends after the last chunk at the latest.
  while (lb[c] < worst * (1.0f + 1e-4f) + 1e-9f) {
    const int f0 = ord[c] * SDF_CHUNK;
    const int nf = min(SDF_CHUNK, F - f0);
    __syncthreads();
    sdf_stage_chunk(s_tri, mesh, f0, nf);
    __syncthreads();
    if (s.valid)
      for (int j = 0; j < nf; ++j)
        run_min = fminf(run_min,
                        sdf_pair_dist_sq(s_tri + j * 9, s.px, s.py, s.pz));
    // worst = max over the block's inside voxels of their minima.
    s_red[threadIdx.x] = ins ? run_min : 0.0f;
    __syncthreads();
    for (int h = SDF_THREADS / 2; h > 0; h >>= 1) {
      if ((int)threadIdx.x < h)
        s_red[threadIdx.x] = fmaxf(s_red[threadIdx.x], s_red[threadIdx.x + h]);
      __syncthreads();
    }
    worst = s_red[0];
    ++c;
  }
  if (s.valid) phi[s.vox] = ins ? sqrtf(run_min) : 0.0f;
  if (threadIdx.x == 0) visits[s.mesh_tile] = c;
}

}  // namespace

// Phase A.  tri (M, F, 9) y-sorted float32; ny (M, T); zmask (M, G, nc);
// out inside (M, G^3) and flags (M, G*T), int32.
extern "C" int mvsf_sdf_cross(const float* tri, const int* ny,
                              const int* zmask, int M, int F, int nc, int G,
                              int T, int chunk, float dx, int* inside,
                              int* flags, void* stream) {
  if (chunk != SDF_CHUNK || T * SDF_THREADS < G * G) return 1;
  if (M <= 0) return 0;
  const dim3 grid((unsigned)(G * T), (unsigned)M);
  sdf_cross_kernel<<<grid, SDF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, ny, zmask, F, nc, G, T, dx, inside, flags);
  return (int)cudaGetLastError();
}

// Phase B.  order (M, G*T, nc + 1) int32 and lb2 (M, G*T, nc + 1)
// float32 with lb2[..., nc] = +inf; out phi (M, G^3) float32 and visits
// (M, G*T) int32.
extern "C" int mvsf_sdf_dist(const float* tri, const int* flags,
                             const int* order, const float* lb2,
                             const int* inside, int M, int F, int nc, int G,
                             int T, int chunk, float dx, float* phi,
                             int* visits, void* stream) {
  if (chunk != SDF_CHUNK || T * SDF_THREADS < G * G) return 1;
  if (M <= 0) return 0;
  const dim3 grid((unsigned)(G * T), (unsigned)M);
  sdf_dist_kernel<<<grid, SDF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, flags, order, lb2, inside, F, nc, G, T, dx, phi, visits);
  return (int)cudaGetLastError();
}
