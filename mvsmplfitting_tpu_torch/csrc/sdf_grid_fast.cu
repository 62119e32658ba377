// Two-phase SDF voxelizer with exact face-chunk culls: crossings first,
// distances only for the inside voxels.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/sdf.py:
// sdf_grid_pallas_fast, its `cross_kernel` (pallas_call at :798) and its
// `dist_kernel` (pallas_call at :888).  The result is bitwise equal to
// csrc/sdf_grid.cu: every pair goes through the arithmetic of
// csrc/sdf_common.cuh, and the culls only skip triangles that cannot
// change the result.
//
// The wrapper (ops/sdf_kernel.py:cull_tables) orders each mesh's faces by
// a Morton key of their centroids seen from the corner (-1, -1, -1) (the
// central projection and the depth), cuts them into chunks of
// B4_CHUNK and pads the last chunk with far degenerate faces, which
// neither cross a ray nor lower a minimum.  It also writes, for each
// brick of 8^3 voxels, which chunks phase A must visit.
//
// Phase A (sdf_cross_kernel), one block per brick, each thread 4
// consecutive voxels of one x-row.  The parity ray runs from the voxel
// toward (-1, -1, -1) with t >= 0, so it never reaches x, y or z above
// the voxel, and every voxel's ray is the line through that corner.  A
// chunk is visited only if its box reaches below the brick's top on
// all three axes and its central projection from the corner overlaps
// the brick's (both with MARGIN slack; the wrapper's mask).  Chunks
// stream through a ring of three shared-memory buffers filled by
// cp.async, so the next two are in flight while one is evaluated, with
// one barrier per chunk.  Each staged face carries its box minimum and
// the box of its central projection: a thread evaluates a face only if
// it can meet the ray of one of its 4 voxels, which skips most of the
// admitted faces (and a warp, those that none of its rows can meet).
// An evaluated face is read from shared memory once (float4 broadcasts)
// for the thread's 4 voxels, and the terms that depend on it and the row
// only are computed once (sdf_cross_row).  Outside voxels get phi = 0;
// the brick's inside voxels are appended to a work list in groups of 8
// (a 4x2x1 block of the brick when it is full; the last group of a
// brick padded with -1), the group count taken with one atomicAdd per
// brick.
//
// Phase B (sdf_dist_kernel), persistent blocks, one group per warp
// taken from an atomic counter: every 4 lanes are an inside voxel (or
// padding), each lane taking every 4th face of a chunk, so a chunk costs
// a warp 8 pair evaluations in a row instead of 32.  The warp bounds
// each chunk by the squared x/y/z gap of the
// chunk's box to the group's box, visits chunks in increasing bound
// (a warp argmin each step), keeps `worst` = the largest running minimum
// of its voxels by warp shuffles, and stops once the next bound exceeds
// worst * (1 + 1e-4) + 1e-9: no later chunk can lower any of its minima.
// The chunk after the current one is copied (cp.async) while the current
// one is evaluated.  It writes phi = sqrt(min d^2) for its voxels and,
// per group, the number of chunks visited.
//
// Bound on the H100: operations, counted over the work each phase
// evaluates: phase A's per-face tests and the row form of the crossing
// test (csrc/sdf_common.cuh) for the (row, face) pairs that pass them,
// phase B's distance (116 a pair) over the chunks its groups visit.

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

constexpr int B4_BRICK = 8;        // voxels per brick edge
constexpr int B4_XV = 4;           // voxels per thread, consecutive in x
constexpr int B4_CHUNK = 32;       // triangles per chunk
constexpr int B4_MAX_CHUNKS = 1024;
constexpr int B4_GROUP = 8;        // inside voxels per phase-B group
constexpr int B4_SPLIT = 32 / B4_GROUP;  // lanes per voxel in phase B
constexpr int B4_WARPS = SDF_THREADS / 32;
constexpr int B4_A_VEC = B4_CHUNK * 4;   // float4 per staged chunk, phase A
constexpr int B4_B_VEC = B4_CHUNK * 9 / 4;  // float4 per staged chunk, B
constexpr unsigned FULL = 0xffffffffu;

static_assert(SDF_THREADS * B4_XV == B4_BRICK * B4_BRICK * B4_BRICK,
              "one brick per block");
static_assert(B4_A_VEC <= SDF_THREADS, "one copy per thread");

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_cross_kernel(const float4* __restrict__ tria,
                     const unsigned char* __restrict__ mask, int nc, int G,
                     int nb, float dx, float* __restrict__ phi,
                     int* __restrict__ list, int* __restrict__ counts) {
  __shared__ float4 s_tri[3][B4_A_VEC];
  __shared__ int s_list[B4_MAX_CHUNKS];
  __shared__ int s_n, s_base;
  __shared__ int s_warp[B4_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m = blockIdx.y, b = blockIdx.x;
  const int NB = nb * nb * nb;

  // The brick's admitted chunks, compacted by warp 0.
  if (warp == 0) {
    const unsigned char* row = mask + ((long)m * NB + b) * nc;
    int n = 0;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int c = c0 + lane;
      const bool a = c < nc && row[c] != 0;
      const unsigned bal = __ballot_sync(FULL, a);
      if (a) s_list[n + __popc(bal & ((1u << lane) - 1u))] = c;
      n += __popc(bal);
    }
    if (lane == 0) s_n = n;
  }

  // Thread t holds voxels x0 .. x0 + 3 of row (y, z).  In the order of t
  // and then x, 8 consecutive voxels form a 4x2x1 block of the brick,
  // 32 a 4x4x2 block.
  const int bx = b % nb, by = (b / nb) % nb, bz = b / (nb * nb);
  const int x0 = bx * B4_BRICK + ((t >> 3) & 1) * B4_XV;
  const int y = by * B4_BRICK + ((t & 3) | (((t >> 4) & 1) << 2));
  const int z = bz * B4_BRICK + (((t >> 2) & 1) | (((t >> 5) & 3) << 1));
  const float py = sdf_coord(y, dx), pz = sdf_coord(z, dx);
  const float dyr = -1.0f - py, dzr = -1.0f - pz;
  float px[B4_XV], dxr[B4_XV];
  int cnt[B4_XV];
#pragma unroll
  for (int k = 0; k < B4_XV; ++k) {
    px[k] = sdf_coord(x0 + k, dx);
    dxr[k] = -1.0f - px[k];
    cnt[k] = 0;
  }
  // The central projection (u, v) = (e_x, e_y) / (e_x + e_y + e_z), e =
  // p + 1, of the row's 4 voxels lies between those of its ends.
  const float e0 = px[0] + 1.0f, e3 = px[B4_XV - 1] + 1.0f;
  const float ey = py + 1.0f, ez = pz + 1.0f;
  const float s0 = e0 + ey + ez, s3 = e3 + ey + ez;
  const float ru0 = fminf(e0 / s0, e3 / s3), ru1 = fmaxf(e0 / s0, e3 / s3);
  const float rv0 = fminf(ey / s0, ey / s3), rv1 = fmaxf(ey / s0, ey / s3);
  int evaluated = 0;  // faces this thread evaluated
  __syncthreads();
  const int n = s_n;
  const float4* mesh = tria + (long)m * nc * B4_A_VEC;

  // Three-buffer ring: chunks i + 1 and i + 2 are in flight while chunk
  // i is evaluated.  The barrier at the top of iteration i makes chunk i
  // visible and frees the buffer of chunk i - 1 for chunk i + 2.
  if (n > 0 && t < B4_A_VEC)
    async_copy16(&s_tri[0][t], mesh + (long)s_list[0] * B4_A_VEC + t);
  async_commit();
  if (n > 1 && t < B4_A_VEC)
    async_copy16(&s_tri[1][t], mesh + (long)s_list[1] * B4_A_VEC + t);
  async_commit();
  for (int i = 0; i < n; ++i) {
    async_wait<1>();
    __syncthreads();
    if (i + 2 < n && t < B4_A_VEC)
      async_copy16(&s_tri[(i + 2) % 3][t],
                 mesh + (long)s_list[i + 2] * B4_A_VEC + t);
    async_commit();
    const float4* st = s_tri[i % 3];
#pragma unroll 2
    for (int j = 0; j < B4_CHUNK; ++j) {
      // The face's box minimum and projected box (MARGIN slack in the
      // wrapper's table) against this thread's row: a face that cannot
      // meet the ray of any of its voxels adds no crossing, so the thread
      // skips it (a warp pays for a face if one of its rows can meet it).
      const float4 q2 = st[4 * j + 2], q3 = st[4 * j + 3];
      const bool near = q2.y <= px[B4_XV - 1] && q2.z <= py && q2.w <= pz &&
                        q3.x <= ru1 && ru0 <= q3.y && q3.z <= rv1 &&
                        rv0 <= q3.w;
      if (!near) continue;
      ++evaluated;
      const float4 q0 = st[4 * j], q1 = st[4 * j + 1];
      const float tr[9] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                           q1.y, q1.z, q1.w, q2.x};
      const SdfCrossRow r = sdf_cross_row(tr, py, pz, dyr, dzr);
#pragma unroll
      for (int k = 0; k < B4_XV; ++k)
        cnt[k] += sdf_cross_voxel(r, px[k], dxr[k], dyr, dzr);
    }
  }

  // Outside voxels get phi = 0; inside ones go to the work list.
  const long row0 = (long)m * G * G * G + ((long)z * G + y) * G;
  const bool row_ok = y < G && z < G;
  bool ins[B4_XV];
  int nin = 0;
#pragma unroll
  for (int k = 0; k < B4_XV; ++k) {
    const bool valid = row_ok && x0 + k < G;
    ins[k] = valid && (cnt[k] & 1);
    nin += ins[k] ? 1 : 0;
    if (valid && !ins[k]) phi[row0 + x0 + k] = 0.0f;
  }
  int incl = nin;  // inclusive scan over the block, in the order of t
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < B4_WARPS; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  const int padded = (total + B4_GROUP - 1) / B4_GROUP * B4_GROUP;
  if (t == 0 && padded > 0)
    s_base = atomicAdd(counts, padded / B4_GROUP) * B4_GROUP;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    evaluated += __shfl_xor_sync(FULL, evaluated, o);
  if (lane == 0 && evaluated > 0) atomicAdd(counts + 2, evaluated);
  __syncthreads();
  if (padded > 0) {  // the same for every thread of the block
    int* out = list + s_base;
    int j = before + incl - nin;
#pragma unroll
    for (int k = 0; k < B4_XV; ++k)
      if (ins[k]) out[j++] = (int)(row0 + x0 + k);
    if (t < padded - total) out[total + t] = -1;
  }
}

// The smallest bound left in lb[0, nc) and its index (the lowest index
// among equals; nc when none is finite), the same on every lane of the
// warp; that entry is set to +inf.  Lane l owns the entries l, l + 32, ...
__device__ __forceinline__ int sdf_take_nearest(float* lb, int nc, int lane,
                                                float* best_out) {
  float best = INFINITY;
  int idx = nc;
  for (int c = lane; c < nc; c += 32) {
    const float v = lb[c];
    if (v < best) best = v, idx = c;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    if (ob < best || (ob == best && oi < idx)) best = ob, idx = oi;
  }
  if (idx < nc && (idx & 31) == lane) lb[idx] = INFINITY;
  *best_out = best;
  return idx;
}

__device__ __forceinline__ float sdf_warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float sdf_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_dist_kernel(const float4* __restrict__ trib,
                    const float* __restrict__ boxes,
                    const int* __restrict__ list, int* __restrict__ counts,
                    int nc, int G, float dx, float* __restrict__ phi,
                    int* __restrict__ visits) {
  __shared__ float4 s_tri[B4_WARPS][2][B4_B_VEC];
  __shared__ float s_lb[B4_WARPS][B4_MAX_CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = lane % B4_SPLIT;  // this lane's faces: slice, + 4, ...
  float* lb = s_lb[warp];
  const int ngroups = counts[0];
  const long N = (long)G * G * G;

  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(counts + 1, 1);
    g = __shfl_sync(FULL, g, 0);
    if (g >= ngroups) break;  // the same for the whole warp
    const int v = list[(long)g * B4_GROUP + lane / B4_SPLIT];
    const int v0 = __shfl_sync(FULL, v, 0);  // voxel 0 is never padding
    const bool valid = v >= 0;
    const int m = (int)(v0 / N);
    const long l = (valid ? v : v0) - (long)m * N;
    const float px = sdf_coord((int)(l % G), dx);
    const float py = sdf_coord((int)((l / G) % G), dx);
    const float pz = sdf_coord((int)(l / ((long)G * G)), dx);

    // Lower bound of each chunk: the squared gap of its box to the
    // group's box (padding lanes sit on voxel 0).
    const float x0 = sdf_warp_min(px), x1 = sdf_warp_max(px);
    const float y0 = sdf_warp_min(py), y1 = sdf_warp_max(py);
    const float z0 = sdf_warp_min(pz), z1 = sdf_warp_max(pz);
    const float* bx = boxes + (long)m * nc * 6;
    for (int c = lane; c < nc; c += 32) {
      const float* q = bx + c * 6;
      const float gx = fmaxf(fmaxf(q[0] - x1, x0 - q[3]), 0.0f);
      const float gy = fmaxf(fmaxf(q[1] - y1, y0 - q[4]), 0.0f);
      const float gz = fmaxf(fmaxf(q[2] - z1, z0 - q[5]), 0.0f);
      lb[c] = gx * gx + gy * gy + gz * gz;
    }
    // lb[c] is written and read by lane c % 32 only.

    // Each lane keeps the minimum over its slice of the faces; a voxel's
    // minimum is that of its B4_SPLIT lanes (fminf: any order).
    const float4* mesh = trib + (long)m * nc * B4_B_VEC;
    float run_min = SDF_FAR_D2, worst = SDF_FAR_D2;
    float cur_lb;
    int cur = sdf_take_nearest(lb, nc, lane, &cur_lb);
    if (cur_lb < worst * (1.0f + 1e-4f) + 1e-9f)
      for (int e = lane; e < B4_B_VEC; e += 32)
        async_copy16(&s_tri[warp][0][e], mesh + (long)cur * B4_B_VEC + e);
    async_commit();
    int nv = 0;
    while (cur_lb < worst * (1.0f + 1e-4f) + 1e-9f) {
      // The next chunk, copied now if it could still be visited (worst
      // only decreases).
      float nxt_lb;
      const int nxt = sdf_take_nearest(lb, nc, lane, &nxt_lb);
      if (nxt_lb < worst * (1.0f + 1e-4f) + 1e-9f)
        for (int e = lane; e < B4_B_VEC; e += 32)
          async_copy16(&s_tri[warp][(nv + 1) & 1][e],
                     mesh + (long)nxt * B4_B_VEC + e);
      async_commit();
      async_wait<1>();
      __syncwarp();
      const float* st = reinterpret_cast<const float*>(s_tri[warp][nv & 1]);
#pragma unroll 2
      for (int j = slice; j < B4_CHUNK; j += B4_SPLIT)
        run_min = fminf(run_min, sdf_pair_dist_sq(st + j * 9, px, py, pz));
      float vmin = run_min;
#pragma unroll
      for (int o = 1; o < B4_SPLIT; o <<= 1)
        vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, o));
      worst = sdf_warp_max(valid ? vmin : 0.0f);
      ++nv;
      __syncwarp();  // the buffer just read is the next one written
      cur = nxt;
      cur_lb = nxt_lb;
    }
    async_wait<0>();
#pragma unroll
    for (int o = 1; o < B4_SPLIT; o <<= 1)
      run_min = fminf(run_min, __shfl_xor_sync(FULL, run_min, o));
    if (valid && slice == 0) phi[v] = sqrtf(run_min);
    if (lane == 0) visits[g] = nv;
    __syncwarp();  // the group's buffers are free for the next one
  }
}

}  // namespace

// Phase A.  tria (M, nc * chunk, 16) float32: per triangle a, b - a,
// c - a, its box minimum less MARGIN and the box of its central
// projection (u_lo, u_hi, v_lo, v_hi) with slack, in the wrapper's order;
// mask (M, nb^3, nc) uint8, the chunks each brick visits.  Writes phi = 0
// at the outside voxels of phi (M, G^3), the inside voxels (m * G^3 +
// voxel) to list (M * nb^3 * 512 int32, in groups of 8 padded with -1),
// the number of groups to counts[0] and adds the (thread, face) pairs
// evaluated, each for 4 voxels, to counts[2].  counts (3,) int32 must be zero.
extern "C" int mvsf_sdf_cross(const float* tria, const unsigned char* mask,
                              int M, int nc, int G, int nb, int chunk,
                              int brick, float dx, float* phi, int* list,
                              int* counts, void* stream) {
  if (chunk != B4_CHUNK || brick != B4_BRICK || nc > B4_MAX_CHUNKS ||
      nb * B4_BRICK < G)
    return 1;
  if (M <= 0) return 0;
  const dim3 grid((unsigned)(nb * nb * nb), (unsigned)M);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sdf_cross_kernel<<<grid, SDF_THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(tria), mask, nc, G, nb, dx, phi, list,
      counts);
  return (int)cudaGetLastError();
}

// Phase B.  trib (M, nc * chunk, 9) float32 triangles [a, b, c] in the
// same order; boxes (M, nc, 6) float32 per chunk (min x, y, z, max x, y,
// z); list and counts from phase A.  Writes phi at the listed voxels and
// the chunks each group visited to visits (M * nb^3 * 64 int32), with
// `blocks` persistent blocks.
extern "C" int mvsf_sdf_dist(const float* trib, const float* boxes,
                             const int* list, int* counts, int M, int nc,
                             int G, int chunk, int blocks, float dx,
                             float* phi, int* visits, void* stream) {
  if (chunk != B4_CHUNK || nc > B4_MAX_CHUNKS || blocks <= 0) return 1;
  if (M <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sdf_dist_kernel<<<blocks, SDF_THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(trib), boxes, list, counts, nc, G, dx,
      phi, visits);
  return (int)cudaGetLastError();
}
