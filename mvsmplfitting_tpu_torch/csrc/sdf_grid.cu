// Brute-force SDF voxelizer: phi = sqrt(min d^2 over all F triangles) at
// the voxels of a G^3 grid whose corner-ray crossing count is odd, else 0.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/sdf.py:sdf_grid_pallas
// (pallas_call at :599).  It is the un-culled yardstick: no fit calls it
// (they use csrc/sdf_grid_fast.cu), and it holds that kernel's culls to
// account bitwise, as the Pallas version does for its two-phase sibling.
// So it uses no cull of any kind (no face order, brick mask, face box,
// distance bound or early exit): every voxel's crossing is evaluated
// against every triangle, and every inside voxel's distance against
// every triangle.  All arithmetic is that of csrc/sdf_common.cuh, so
// the result equals the plain ops/sdf.py:sdf_grid and the two-phase
// kernels bit for bit.
//
// Bound on the H100: operations, counted as the algorithm needs them
// whatever the tile (ops/sdf_kernel.py's constants, from
// csrc/sdf_common.cuh; chip_smoke.py sdf_work): the row form of the
// crossing, 14 per triangle and (y, z) row of voxels, 5 per triangle and
// x, 32 per (voxel, triangle) pair; 10 more per pair that passes the
// crossing's pre-test; 116 per (inside voxel, triangle) distance.  At
// G=128 on two posed bodies (13776 triangles, 59250 of 4.2M voxels
// inside) that is 1.95e12 operations, 29 ms at 67 TFLOP/s;
// built with -fmad=false, no operation fuses, so about half that rate
// is the ceiling.  The first design (one thread per voxel, distance and
// crossing for every pair, 176 operations each) needed 1.0e13.  Both
// passes are bound by instruction issue: the design cuts the
// instructions a pair costs and the pairs that need a distance.
//
// Pass 1 (sdf_parity_kernel), parity for every voxel: most of the work.
// Each thread holds a tile of B3_XV consecutive voxels in each of B3_YV
// consecutive rows of one z-plane.  Triangles stream through a ring of
// three shared-memory buffers, filled by cp.async, as [a, ab, ac] (ab =
// b - a and ac = c - a subtracted once per triangle by the wrapper), so
// two chunks are in flight while one is evaluated, with one barrier per
// chunk; every warp reads the same triangle at once (three float4
// broadcasts).  Per triangle the thread computes each row's terms once
// (sdf_cross_row), the terms of each x once for its rows, then each
// voxel's numerators and the divide-free pre-test (sdf_cross_pre): about
// 40 SASS instructions a pair for sm_90a (tools/sass_loops.py).  Only
// where one of its voxels passed (on posed bodies, fewer than one
// triangle a voxel does) does it branch, to evaluate the tile again out
// of line with the divide and the exact test (sdf_cross_exact).
// Outside voxels get phi = 0; the inside ones are appended to the mesh's
// work list (a warp scan of the counts, one atomicAdd per warp), and the
// pairs that passed the pre-test are counted (one atomicAdd per warp).
//
// Pass 2 (sdf_inside_dist_kernel), distances for the inside voxels only.
// Persistent blocks read the list lengths from device memory, so no host
// round trip separates the passes.  A block takes B3_VPB listed voxels
// of one mesh at a time; each voxel's triangles are split over
// B3_SPLIT lanes (lane s takes triangles s, s + B3_SPLIT, ...), whose
// running minima a shuffle combines (fminf is exact in any order).
// Triangles [a, b, c] stream through a cp.async ring as in pass 1, for
// sdf_pair_dist_sq; each block writes phi = sqrt(min) for its voxels.

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

constexpr int B3_XV = 4;          // voxels per pass-1 thread in x ...
constexpr int B3_YV = 4;          // ... in each of this many rows
constexpr int B3_CHUNK = 64;      // triangles per staged chunk
constexpr int B3_A_VEC = B3_CHUNK * 3;      // float4 per chunk, pass 1
constexpr int B3_B_VEC = B3_CHUNK * 9 / 4;  // float4 per chunk, pass 2
constexpr int B3_SPLIT = 4;       // lanes per inside voxel in pass 2
constexpr int B3_VPB = SDF_THREADS / B3_SPLIT;  // voxels per pass-2 task
constexpr unsigned FULL = 0xffffffffu;

static_assert(B3_XV * B3_YV <= 32, "one bit a voxel");
static_assert(B3_CHUNK % B3_SPLIT == 0, "whole slices per chunk");
static_assert(B3_CHUNK * 9 % 4 == 0, "whole float4 per chunk");

// Issue the cp.async copies of chunk c (vec float4 each) into buf.
__device__ __forceinline__ void b3_stage(float4* buf, const float4* mesh,
                                         int c, int vec) {
  const float4* src = mesh + (long)c * vec;
  for (int e = threadIdx.x; e < vec; e += SDF_THREADS)
    async_copy16(buf + e, src + e);
}

// The crossing of voxel (x, y, z) and triangle t = [a, ab, ac] with its
// pre-test: 0 if the pair fails the pre-test, else 1 + the crossing.
// Out of line, for the rare triangles where one of a thread's voxels
// passes the pre-test: the common path then holds no numerators while it
// finds out (inlined, the compiler would keep every voxel's from the
// first evaluation instead of computing them again, the same bits).
__device__ __noinline__ int b3_crossing(const float* t, int x, int y, int z,
                                        float dx) {
  const float px = sdf_coord(x, dx), py = sdf_coord(y, dx);
  const float pz = sdf_coord(z, dx);
  const float dxr = -1.0f - px, dyr = -1.0f - py, dzr = -1.0f - pz;
  const SdfCrossRow row = sdf_cross_row(t, py, pz, dyr, dzr);
  const SdfCrossPre q = sdf_cross_pre(row, px, dxr, dyr, dzr);
  return q.pass ? 1 + sdf_cross_exact(q) : 0;
}

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_parity_kernel(const float4* __restrict__ tria, int nc, int G,
                      float dx, float* __restrict__ phi,
                      int* __restrict__ list,
                      unsigned long long* __restrict__ counts) {
  __shared__ float4 s_tri[3][B3_A_VEC];
  const int t = threadIdx.x, lane = t & 31;
  const int m = blockIdx.y, M = gridDim.y;
  // This thread's tile: voxels x0 .. x0 + B3_XV - 1 of rows y0 .. y0 +
  // B3_YV - 1 of plane z (past the grid's end: computed, not written).
  const int xt = (G + B3_XV - 1) / B3_XV, yt = (G + B3_YV - 1) / B3_YV;
  const long r = (long)blockIdx.x * SDF_THREADS + t;
  const bool tile_ok = r < (long)xt * yt * G;
  const long rc = tile_ok ? r : 0;
  const int x0 = (int)(rc % xt) * B3_XV;
  const int y0 = (int)((rc / xt) % yt) * B3_YV;
  const int z = (int)(rc / ((long)xt * yt));
  const float pz = sdf_coord(z, dx), dzr = -1.0f - pz;
  float px[B3_XV], dxr[B3_XV], py[B3_YV], dyr[B3_YV];
#pragma unroll
  for (int k = 0; k < B3_XV; ++k) {
    px[k] = sdf_coord(x0 + k, dx);
    dxr[k] = -1.0f - px[k];
  }
#pragma unroll
  for (int i = 0; i < B3_YV; ++i) {
    py[i] = sdf_coord(y0 + i, dx);
    dyr[i] = -1.0f - py[i];
  }
  unsigned odd = 0;  // crossing parity, bit i * B3_XV + k
  int passed = 0;    // (voxel, triangle) pairs that passed the pre-test
  const float4* mesh = tria + (long)m * nc * B3_A_VEC;

  // Three-buffer ring: chunks c + 1 and c + 2 are in flight while chunk
  // c is evaluated.  The barrier at the top of iteration c makes chunk c
  // visible and frees the buffer of chunk c - 1 for chunk c + 2.
  b3_stage(s_tri[0], mesh, 0, B3_A_VEC);
  async_commit();
  if (nc > 1) b3_stage(s_tri[1], mesh, 1, B3_A_VEC);
  async_commit();
  for (int c = 0; c < nc; ++c) {
    async_wait<1>();
    __syncthreads();
    if (c + 2 < nc) b3_stage(s_tri[(c + 2) % 3], mesh, c + 2, B3_A_VEC);
    async_commit();
    const float4* st = s_tri[c % 3];
#pragma unroll 1
    for (int j = 0; j < B3_CHUNK; ++j) {
      const float4 q0 = st[3 * j], q1 = st[3 * j + 1], q2 = st[3 * j + 2];
      const float tr[9] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                           q1.y, q1.z, q1.w, q2.x};
      bool any = false;
#pragma unroll
      for (int i = 0; i < B3_YV; ++i) {
        const SdfCrossRow row = sdf_cross_row(tr, py[i], pz, dyr[i], dzr);
#pragma unroll
        for (int k = 0; k < B3_XV; ++k)
          any |= sdf_cross_pre(row, px[k], dxr[k], dyr[i], dzr).pass;
      }
      if (any) {  // rare: the tile again, out of line
#pragma unroll 1
        for (int b = 0; b < B3_XV * B3_YV; ++b) {
          const float* t = reinterpret_cast<const float*>(st + 3 * j);
          const int c = b3_crossing(t, x0 + b % B3_XV, y0 + b / B3_XV, z, dx);
          passed += c != 0;
          odd ^= (unsigned)(c >> 1) << b;
        }
      }
    }
  }

  // Outside voxels get phi = 0; inside ones go to the mesh's list, in
  // the order of the warp's lanes, then y, then x.
  const long N = (long)G * G * G;
  unsigned ins = 0;
#pragma unroll
  for (int i = 0; i < B3_YV; ++i)
#pragma unroll
    for (int k = 0; k < B3_XV; ++k) {
      const bool valid = tile_ok && y0 + i < G && x0 + k < G;
      const long v = ((long)z * G + y0 + i) * G + x0 + k;
      const int b = i * B3_XV + k;
      if (valid && (odd >> b & 1)) ins |= 1u << b;
      else if (valid) phi[m * N + v] = 0.0f;
    }
  const int nin = __popc(ins);
  int incl = nin;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  int base = 0;
  if (lane == 31 && incl > 0)
    base = (int)atomicAdd(counts + m, (unsigned long long)incl);
  base = __shfl_sync(FULL, base, 31);
  int* out = list + m * N + base + (incl - nin);
#pragma unroll
  for (int i = 0; i < B3_YV; ++i)
#pragma unroll
    for (int k = 0; k < B3_XV; ++k)
      if (ins >> (i * B3_XV + k) & 1)
        *out++ = (int)(((long)z * G + y0 + i) * G + x0 + k);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) passed += __shfl_xor_sync(FULL, passed, o);
  if (lane == 0 && passed > 0)
    atomicAdd(counts + M, (unsigned long long)passed);
}

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_inside_dist_kernel(const float4* __restrict__ trib,
                           const int* __restrict__ list,
                           const unsigned long long* __restrict__ counts,
                           int M, int nc, int G, float dx,
                           float* __restrict__ phi) {
  __shared__ float4 s_tri[3][B3_B_VEC];
  const int t = threadIdx.x;
  const int slice = t % B3_SPLIT;  // this lane's triangles of a chunk
  const long N = (long)G * G * G;

  for (long task = blockIdx.x;; task += gridDim.x) {
    // Mesh m's list makes ceil(counts[m] / B3_VPB) tasks, meshes in
    // order; the same for every thread of the block.
    int m = 0;
    long first = task;
    for (; m < M; ++m) {
      const long tasks = (long)((counts[m] + B3_VPB - 1) / B3_VPB);
      if (first < tasks) break;
      first -= tasks;
    }
    if (m == M) break;
    first *= B3_VPB;
    const long slot = first + t / B3_SPLIT;
    const bool valid = slot < (long)counts[m];  // else on the task's first
    const int v = list[m * N + (valid ? slot : first)];
    const float px = sdf_coord(v % G, dx);
    const float py = sdf_coord((v / G) % G, dx);
    const float pz = sdf_coord(v / (G * G), dx);
    const float4* mesh = trib + (long)m * nc * B3_B_VEC;

    float run_min = SDF_FAR_D2;
    b3_stage(s_tri[0], mesh, 0, B3_B_VEC);
    async_commit();
    if (nc > 1) b3_stage(s_tri[1], mesh, 1, B3_B_VEC);
    async_commit();
    for (int c = 0; c < nc; ++c) {
      async_wait<1>();
      __syncthreads();
      if (c + 2 < nc) b3_stage(s_tri[(c + 2) % 3], mesh, c + 2, B3_B_VEC);
      async_commit();
      const float* st = reinterpret_cast<const float*>(s_tri[c % 3]);
#pragma unroll 2
      for (int j = slice; j < B3_CHUNK; j += B3_SPLIT)
        run_min = fminf(run_min, sdf_pair_dist_sq(st + j * 9, px, py, pz));
    }
    async_wait<0>();
#pragma unroll
    for (int o = 1; o < B3_SPLIT; o <<= 1)
      run_min = fminf(run_min, __shfl_xor_sync(FULL, run_min, o));
    if (valid && slice == 0) phi[m * N + v] = sqrtf(run_min);
    __syncthreads();  // the buffers are free for the next task
  }
}

}  // namespace

// Pass 1.  tria (M, nc * chunk, 12) float32: per triangle a, b - a,
// c - a and 3 unused floats, the last chunk padded with degenerate
// triangles.  Writes phi = 0 at the outside voxels of phi (M, G^3), the
// inside voxels of mesh m (z * G^2 + y * G + x) to list[m * G^3 ...], their
// number to counts[m] and the pairs that passed the pre-test to
// counts[M]; counts (M + 1,) must be zero.
extern "C" int mvsf_sdf_parity(const float* tria, int M, int nc, int G,
                               int chunk, float dx, float* phi, int* list,
                               unsigned long long* counts, void* stream) {
  if (chunk != B3_CHUNK || (long)G * G * G >= (1L << 31) || nc <= 0)
    return 1;
  if (M <= 0) return 0;
  const long tiles = (long)G * ((G + B3_YV - 1) / B3_YV) *
                     ((G + B3_XV - 1) / B3_XV);
  const dim3 grid((unsigned)((tiles + SDF_THREADS - 1) / SDF_THREADS),
                  (unsigned)M);
  sdf_parity_kernel<<<grid, SDF_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tria), nc, G, dx, phi, list, counts);
  return (int)cudaGetLastError();
}

// Pass 2.  trib (M, nc * chunk, 9) float32 triangles [a, b, c], padded
// with far triangles; list and counts from pass 1.  Writes phi at the
// listed voxels, with `blocks` persistent blocks.
extern "C" int mvsf_sdf_inside_dist(const float* trib, const int* list,
                                    const unsigned long long* counts, int M,
                                    int nc, int G, int chunk, int blocks,
                                    float dx, float* phi, void* stream) {
  if (chunk != B3_CHUNK || blocks <= 0 || nc <= 0) return 1;
  if (M <= 0) return 0;
  sdf_inside_dist_kernel<<<blocks, SDF_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(trib), list, counts, M, nc, G, dx,
      phi);
  return (int)cudaGetLastError();
}
