// VPoser decoder tail and its Jacobian, batched.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/vposer_kernel.py:
// decode_jac_batched (Pallas body `_tail_core` / `_tail6`).  For every
// (frame b, joint j): the 6D output o[b, 6j:6j+6] of the decoder MLP ->
// rotation (Gram-Schmidt, 1e-12 floors) -> quaternion (Shepperd, 1e-6
// pivot floor, first maximum wins) -> axis-angle (sign-folded atan2),
// with the 6 forward-derivative columns of that same graph, then
// composed with the MLP Jacobian:
//   aa[b, 3j+a]   = tail(o6)[a]
//   D[b, 3j+a, Z] = sum_c Jt[c][a] * Do[b, 6j+c, Z].
// The MLP matmuls before it stay in PyTorch.  atan2f replaces the
// TPU kernel's minimax atan (Mosaic had no atan2).  A floor max(x, f)
// takes half the tangent at an exact tie, as JAX's maximum does.
//
// Bound on the H100: bytes, 0.00418 ms at B=512: it reads 9.1 MB of o
// and Do and writes 4.5 MB of aa and D; the tail itself is a few hundred
// flops per (b, j).  The first design (4 frames per 128-thread block)
// left ~1 block per SM with little in flight and started reading Do only
// after the tails.  This design: one block per frame (512 blocks at
// B=512, up to 10 per SM).  A block first issues cp.async 16-byte
// copies of its frame's Do slab (138 x 32 floats, contiguous) into
// shared memory, then computes the tails while they land: one thread per
// (joint, tangent column), each carrying one tangent through the dual
// numbers (the primal is recomputed by the 6 threads of a joint, which
// take the same branches), so 138 threads work and few registers are
// live.  Then it waits for the copies and composes D from shared memory
// with float4 loads and 16-byte stores; consecutive threads write
// consecutive 16 bytes of the frame's contiguous D slab.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int NJ = 23;        // body joints
constexpr int ROWS = 6 * NJ;  // 138 MLP outputs per frame
constexpr int OUT = 3 * NJ;   // 69 axis-angle values per frame
constexpr int Z = 32;         // latent size
constexpr int THREADS = 192;  // one frame per block
constexpr int TAILS = 6 * NJ; // one thread per (joint, tangent column)
constexpr int NT = 1;         // tangents carried per thread
constexpr int Z4 = Z / 4;     // float4 per row of Do and D

struct Dual {
  float v;
  float d[NT];
};

__device__ __forceinline__ Dual constant(float v) {
  Dual r;
  r.v = v;
  for (int i = 0; i < NT; ++i) r.d[i] = 0.0f;
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator*(float s, const Dual& a) {
  Dual r;
  r.v = s * a.v;
  for (int i = 0; i < NT; ++i) r.d[i] = s * a.d[i];
  return r;
}
__device__ __forceinline__ Dual operator+(float s, const Dual& a) {
  Dual r = a;
  r.v = s + a.v;
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a) { return -1.0f * a; }
__device__ __forceinline__ Dual operator-(float s, const Dual& a) {
  Dual r = -a;
  r.v = s - a.v;
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
  for (int i = 0; i < NT; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
  const float h = 0.5f / r.v;
  for (int i = 0; i < NT; ++i) r.d[i] = a.d[i] * h;
  return r;
}
// max(a, f) with JAX's tie rule: half the tangent when a == f.
__device__ __forceinline__ Dual dfloor(const Dual& a, float f) {
  if (a.v > f) return a;
  Dual r = constant(f);
  if (a.v == f)
    for (int i = 0; i < NT; ++i) r.d[i] = 0.5f * a.d[i];
  return r;
}
__device__ __forceinline__ Dual datan2(const Dual& y, const Dual& x) {
  Dual r;
  r.v = atan2f(y.v, x.v);
  const float inv = 1.0f / (x.v * x.v + y.v * y.v);
  for (int i = 0; i < NT; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) * inv;
  return r;
}

// 6D (o0..o5) -> axis-angle aa[3], tangent with respect to o[tc].
__device__ void tail(const float* o, int tc, Dual aa[3]) {
  Dual x[6];
  for (int c = 0; c < 6; ++c) {
    x[c] = constant(o[c]);
    x[c].d[0] = (c == tc) ? 1.0f : 0.0f;
  }
  // reshape (3, 2): column a1 = (o0, o2, o4), a2 = (o1, o3, o5)
  const Dual a1[3] = {x[0], x[2], x[4]};
  const Dual a2[3] = {x[1], x[3], x[5]};
  const Dual n1 = dfloor(dsqrt(a1[0] * a1[0] + a1[1] * a1[1] + a1[2] * a1[2]), 1e-12f);
  Dual b1[3], b2u[3], b2[3], b3[3];
  for (int i = 0; i < 3; ++i) b1[i] = a1[i] / n1;
  const Dual dot = b1[0] * a2[0] + b1[1] * a2[1] + b1[2] * a2[2];
  for (int i = 0; i < 3; ++i) b2u[i] = a2[i] - dot * b1[i];
  const Dual n2 = dfloor(dsqrt(b2u[0] * b2u[0] + b2u[1] * b2u[1] + b2u[2] * b2u[2]), 1e-12f);
  for (int i = 0; i < 3; ++i) b2[i] = b2u[i] / n2;
  b3[0] = b1[1] * b2[2] - b1[2] * b2[1];
  b3[1] = b1[2] * b2[0] - b1[0] * b2[2];
  b3[2] = b1[0] * b2[1] - b1[1] * b2[0];
  // m[r][c]: columns are [b1 b2 b3]
  const Dual* col[3] = {b1, b2, b3};
#define M(r, c) col[c][r]
  const Dual t_w = 1.0f + M(0, 0) + M(1, 1) + M(2, 2);
  const Dual t_x = 1.0f + M(0, 0) - M(1, 1) - M(2, 2);
  const Dual t_y = 1.0f - M(0, 0) + M(1, 1) - M(2, 2);
  const Dual t_z = 1.0f - M(0, 0) - M(1, 1) + M(2, 2);
  // First maximum wins, as argmax does.
  const bool is_w = t_w.v >= t_x.v && t_w.v >= t_y.v && t_w.v >= t_z.v;
  const bool is_x = !is_w && t_x.v >= t_y.v && t_x.v >= t_z.v;
  const bool is_y = !is_w && !is_x && t_y.v >= t_z.v;
  Dual q[4];
  if (is_w) {
    const Dual s = dsqrt(dfloor(t_w, 1e-6f));
    q[0] = s; q[1] = (M(2, 1) - M(1, 2)) / s;
    q[2] = (M(0, 2) - M(2, 0)) / s; q[3] = (M(1, 0) - M(0, 1)) / s;
  } else if (is_x) {
    const Dual s = dsqrt(dfloor(t_x, 1e-6f));
    q[0] = (M(2, 1) - M(1, 2)) / s; q[1] = s;
    q[2] = (M(0, 1) + M(1, 0)) / s; q[3] = (M(0, 2) + M(2, 0)) / s;
  } else if (is_y) {
    const Dual s = dsqrt(dfloor(t_y, 1e-6f));
    q[0] = (M(0, 2) - M(2, 0)) / s; q[1] = (M(0, 1) + M(1, 0)) / s;
    q[2] = s; q[3] = (M(1, 2) + M(2, 1)) / s;
  } else {
    const Dual s = dsqrt(dfloor(t_z, 1e-6f));
    q[0] = (M(1, 0) - M(0, 1)) / s; q[1] = (M(0, 2) + M(2, 0)) / s;
    q[2] = (M(1, 2) + M(2, 1)) / s; q[3] = s;
  }
#undef M
  for (int i = 0; i < 4; ++i) q[i] = 0.5f * q[i];
  const Dual qn = dsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / qn;

  const Dual w = q[0];
  const Dual sin_sq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  Dual k;
  if (sin_sq.v > 0.0f) {
    const Dual st = dsqrt(dfloor(sin_sq, 0.0f));
    const Dual two_theta =
        2.0f * (w.v < 0.0f ? datan2(-st, -w) : datan2(st, w));
    k = two_theta / dfloor(st, 1e-30f);
  } else {
    k = constant(2.0f);  // small-angle limit: aa = 2 v
  }
  for (int i = 0; i < 3; ++i) aa[i] = q[i + 1] * k;
}

__global__ void __launch_bounds__(THREADS)
vposer_tail_kernel(const float* __restrict__ o, const float* __restrict__ Do,
                   float* __restrict__ aa, float* __restrict__ D) {
  __shared__ float4 s_Do[ROWS * Z4];       // this frame's Do slab
  __shared__ float s_J[NJ][6 * 3];         // Jt[c][a] at [c*3 + a]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  const float* src = Do + (size_t)b * ROWS * Z;
  for (int i = tid; i < ROWS * Z4; i += THREADS)
    async_copy16(&s_Do[i], src + 4 * i);
  async_commit();

  if (tid < TAILS) {
    const int j = tid / 6, col = tid % 6;
    Dual out[3];
    tail(o + (size_t)b * ROWS + 6 * j, col, out);
    for (int a = 0; a < 3; ++a) {
      s_J[j][col * 3 + a] = out[a].d[0];
      if (col == 0) aa[(size_t)b * OUT + 3 * j + a] = out[a].v;
    }
  }
  async_wait<0>();
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(D + (size_t)b * OUT * Z);
  for (int e = tid; e < OUT * Z4; e += THREADS) {
    const int r = e / Z4, z4 = e % Z4;
    const int j = r / 3, a = r % 3;
    float4 acc = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 6; ++c) {
      const float jt = s_J[j][c * 3 + a];
      const float4 d = s_Do[(6 * j + c) * Z4 + z4];
      acc.x = fmaf(jt, d.x, acc.x);
      acc.y = fmaf(jt, d.y, acc.y);
      acc.z = fmaf(jt, d.z, acc.z);
      acc.w = fmaf(jt, d.w, acc.w);
    }
    dst[e] = acc;
  }
}

}  // namespace

// Do and D must be 16-byte aligned (the wrapper checks).
extern "C" int mvsf_vposer_tail(const float* o, const float* Do, int B,
                                float* aa, float* D, void* stream) {
  if (B <= 0) return 0;
  vposer_tail_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      o, Do, aa, D);
  return (int)cudaGetLastError();
}
