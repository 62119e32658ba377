// Batched analytic joint Jacobian of the reduced SMPL joint model.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/joint_kernel.py:
// joint_jacobian_batched (Pallas body `_core`).  It computes what
// models/joint_jac.py:joint_jacobian computes, for B frames:
//   rodrigues (+1e-8 on each component) and its closed-form derivative,
//   the fused fold (rest joints + per-slot offsets), the 24-joint chain,
//   the rotation generators, and the pose-corrective and beta blocks of
//   every mapped slot, written straight into the JAX block layout:
//     joints (B,K,3), dth (B,72,K,3) [orient = rows 0-2, pose = 3-71],
//     dbe (B,NB,K,3), dsc (B,1,K,3).
//
// Bound on the H100: operations, 0.00564 ms for smpl (Kv=5 vertex slots
// of K=17) and 0.01837 ms for smpllsp (Kv=17) at B=512, counting the
// fp32 multiply-adds that touch a non-zero constant (chip_smoke.py:
// joint_kernel_work): per vertex slot and frame the fold (217 x 72),
// the pose-corrective product (3 x 72 x 207) and the beta blocks.
//
// What held the first design (one 256-thread block per frame) back was
// the constants: every block read all per-model tables (621 KB for smpl)
// from L2, the pose-corrective loads were uncoalesced and most threads
// idled in the per-joint phases.  This design:
//   * A block owns F=8 frames and one vertex slot: grid (B/8, Kv+1), the
//     last block row doing the chain slots, so each constant byte staged
//     in shared memory serves 8 frames and the work splits into enough
//     blocks to fill the card: 384 blocks for smpl at B=512, 3 per SM
//     (192 threads, 71.7 KB of dynamic shared memory each).
//   * A vertex slot's constants stream through a two-buffer cp.async ring
//     in coalesced 16-byte pieces: its beta table Hb2 (72 x NB), its fold
//     slab (217 x 72, 32 rows a chunk), its pose-corrective slab (72 x
//     207, 11 rows a chunk).  The next chunk loads while the current one
//     is used; the first two load during the per-frame prologue.
//   * Every block recomputes the cheap per-frame prologue with one thread
//     per (frame, joint): rodrigues, the rest skeleton and the chain,
//     whose 24 steps stay serial with the 8 frames side by side, 12 lanes
//     each, a frame's lanes inside one warp.
//   * The contractions are register-tiled fp32 products from shared
//     memory.  Fold: a thread owns 8 frames x 1 offset column over every
//     other row, the inputs read as float4.  Pose-corrective: a thread
//     owns 2 frames x 1 joint l x every other slab row, accumulating the
//     3 x 9 block P[a][(l-1)*9+q] for both frames (6 multiply-adds per
//     slab value it loads; neighbouring lanes take neighbouring l, a
//     stride of 9 words, no bank conflicts); P then meets dR and the
//     generator terms in one thread per (frame, joint).  Betas: W . Hb2,
//     where Hb2 folds the rest-offset terms into a per-slot table
//     (ops/joint_kernel.py:kernel_tables).
//   * The chain block writes its slots' rows through shared memory, a
//     warp per output row with lanes on consecutive slots (coalesced);
//     a chain joint's beta block is the sum of its ancestors' terms, one
//     pass down the tree.  A vertex slot's outputs are 3-float runs at
//     stride K*3: the layout interleaves the slots.
//   * fp32 FMA on the CUDA cores (no TF32): the kernel tolerance, RTOL
//     3e-5 / ATOL 1e-5 against the plain version, rules out one-pass TF32.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int J = 24;              // SMPL chain joints
constexpr int J3 = J * 3;          // 72
constexpr int P9 = 9 * (J - 1);    // 207 pose-feature entries
constexpr int KMAX = 24;           // mapped slots
constexpr int NBMAX = 16;          // betas
constexpr int F = 8;               // frames per block
constexpr int THREADS = F * J;     // one thread per (frame, joint)
constexpr float EPS = 1e-8f;       // rodrigues component shift

constexpr int FOLD_ROWS = 32;            // fold rows per ring buffer
constexpr int CHUNK = FOLD_ROWS * J3;    // floats per ring buffer
constexpr int HP_LD = 208;               // pose-corrective row, padded
constexpr int HP_ROWS = CHUNK / HP_LD;   // 11 slab rows per ring buffer
constexpr int HP_CHUNKS = (J3 + HP_ROWS - 1) / HP_ROWS;
constexpr int IN_ROWS = 224;             // >= NBMAX + P9, k-major x F

// Dynamic shared memory, in floats (every offset a multiple of 4).
constexpr int S_RING = 0;                    // 2 x CHUNK
constexpr int S_IN = S_RING + 2 * CHUNK;     // [k][f]: [betas; vec(R - I)]
constexpr int S_R = S_IN + IN_ROWS * F;      // [f][j][9]
constexpr int S_DR = S_R + F * J * 9;        // [f][j][(r*3+c)*3 + A]
constexpr int S_JREST = S_DR + F * J * 27;   // [f][j][3]
constexpr int S_REL = S_JREST + F * J3;      // [f][j][3] local rest offsets
constexpr int S_W = S_REL + F * J3;          // [f][j][r*4+c] world transforms
constexpr int S_OFF = S_W + F * J * 12;      // [f][j*3+b] offsets, then contrib
constexpr int S_Y = S_OFF + F * J3;          // [f][l][3] ancestry-folded contrib
constexpr int S_SCALE = S_Y + F * J3;        // [f]
constexpr int SMEM_FLOATS = S_SCALE + F;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

static_assert(HP_ROWS * HP_LD <= CHUNK, "a pose-corrective chunk fits");
static_assert(IN_ROWS >= NBMAX + P9, "fold inputs fit");
// Once the generators are built, the beta terms and the staged
// generators reuse the space of the ring, the inputs, R and dR.
static_assert(F * J * 3 * NBMAX <= S_JREST, "beta terms fit");
static_assert(F * J * 36 <= S_JREST, "staged generators fit");
static_assert(F * (J - 1) * 27 <= S_R, "pose-corrective products fit");
static_assert(THREADS >= 8 * (J - 1) && F == 8, "two frames a thread");
static_assert(J3 * NBMAX <= CHUNK, "Hb2 fits a ring buffer");
static_assert(16 * F <= THREADS && 16 * F % 32 == 0, "chain lanes fill warps");

// Tables indexed by vertex slot v (0..Kv-1); slot k's v is vslot[k].
struct Consts {
  const float* JBT;        // (NB, J3) rest-joint shape basis, transposed
  const float* fold;       // (Kv, NB+P9, J3) vertex-slot fold, transposed
  const float* Hp;         // (Kv, J3, HP_LD): [v][j*3+b][(l-1)*9+q]
  const float* Hb2;        // (Kv, J3, NB): [v][j*3+b][bt] = Hb - w JB + the
                           // sum over l with parent j of u_l drel_l, so a
                           // vertex slot's beta block is W . Hb2 + u_0 drel_0
  const float* j0;         // (J, 3)
  const float* H0;         // (Kv, J, 4)
  const float* u;          // (Kv, J) ancestry-summed skinning weights
  const float* drel;       // (J, 3, NB) rest-offset shape basis
  const int* parents;      // (J,), root -1, parents before children
  const int* desc;         // (J,) bit j set when l is j or an ancestor of j
  const int* chain_idx;    // (K,) source chain joint
  const int* vslot;        // (K,) vertex slot, -1 for a chain slot
  const int* kslot;        // (Kv,) the slot k of vertex slot v
};

// A vertex slot's constant stream through the ring: chunk 0 its Hb2
// slab, chunks 1..nfold the fold slab, then the pose-corrective slab.
struct Stream {
  const float* hb2;
  int hb2_n;         // floats
  const float* fold;
  int fold_n;
  int nfold;         // chunks of the fold slab
  const float* hp;
  int nchunks;
};

// Issue the ring copy of chunk c (16-byte pieces, consecutive threads on
// consecutive pieces).
__device__ __forceinline__ void issue_chunk(float* ring, int c,
                                            const Stream& st) {
  float* dst = ring + (c & 1) * CHUNK;
  const float* src;
  int n;
  if (c == 0) {
    src = st.hb2;
    n = st.hb2_n;
  } else if (c <= st.nfold) {
    src = st.fold + (c - 1) * CHUNK;
    n = min(CHUNK, st.fold_n - (c - 1) * CHUNK);
  } else {
    const int h = c - 1 - st.nfold;
    src = st.hp + h * HP_ROWS * HP_LD;
    n = min(HP_ROWS * HP_LD, (J3 - h * HP_ROWS) * HP_LD);
  }
  for (int i = threadIdx.x * 4; i < n; i += THREADS * 4)
    async_copy16(dst + i, src + i);
}

// Wait for chunk c (the ring's older group) and make it visible.
__device__ __forceinline__ void ring_wait() {
  async_wait<1>();
  __syncthreads();
}

// Free chunk c's buffer and start chunk c + 2 into it (an empty group
// past the end keeps one group per chunk).
__device__ __forceinline__ void ring_next(float* ring, int c,
                                          const Stream& st) {
  __syncthreads();
  if (c + 2 < st.nchunks) issue_chunk(ring, c + 2, st);
  async_commit();
}

// Rotation generator of joint l for axis A in one frame:
// Grot[i][jx] and Gt[i] (see models/joint_jac.py).
__device__ __forceinline__ void generator(const float* W, const float* R,
                                          const float* dR, const float* rel,
                                          int pl, float inv_f, int A,
                                          float Grot[3][3], float Gt[3]) {
  float Rp[3][3], twp[3];
  if (pl < 0) {
    for (int x = 0; x < 3; ++x) {
      for (int y = 0; y < 3; ++y) Rp[x][y] = (x == y) ? 1.0f : 0.0f;
      twp[x] = 0.0f;
    }
  } else {
    for (int x = 0; x < 3; ++x) {
      for (int y = 0; y < 3; ++y) Rp[x][y] = W[pl * 12 + x * 4 + y];
      twp[x] = W[pl * 12 + x * 4 + 3];
    }
  }
  // Kg[bb][cc] = sum_m dR[bb][m][A] R[cc][m]
  float Kg[3][3];
  for (int bb = 0; bb < 3; ++bb)
    for (int cc = 0; cc < 3; ++cc) {
      float acc = 0.0f;
      for (int m = 0; m < 3; ++m)
        acc += dR[(bb * 3 + m) * 3 + A] * R[cc * 3 + m];
      Kg[bb][cc] = acc;
    }
  for (int i = 0; i < 3; ++i) {
    float G1[3];  // G1[cc] = sum_bb Rp[i][bb] Kg[bb][cc]
    for (int cc = 0; cc < 3; ++cc) {
      float acc = 0.0f;
      for (int bb = 0; bb < 3; ++bb) acc += Rp[i][bb] * Kg[bb][cc];
      G1[cc] = acc;
    }
    for (int jx = 0; jx < 3; ++jx) {  // G1 (Rp^T / s^2)
      float acc = 0.0f;
      for (int cc = 0; cc < 3; ++cc) acc += G1[cc] * (Rp[jx][cc] * inv_f);
      Grot[i][jx] = acc;
    }
    float t1 = 0.0f, t2 = 0.0f;
    for (int d = 0; d < 3; ++d) t1 += Grot[i][d] * twp[d];
    for (int cc = 0; cc < 3; ++cc) t2 += G1[cc] * rel[cc];
    Gt[i] = -(t1 + t2);
  }
}

// Row a of joint l's parent world rotation (the identity at the root).
__device__ __forceinline__ float parent_rot(const float* W, int pl, int a,
                                            int bb) {
  return pl < 0 ? (a == bb ? 1.0f : 0.0f) : W[pl * 12 + a * 4 + bb];
}

// T[f][l][a][bt] = Rp_l[a] . drel_l[:, bt]: how joint l's rest offset
// moves the world under beta bt, for this thread's (frame, joint).
__device__ __forceinline__ void rest_beta_terms(float* s_T, const float* W,
                                                const float* drel, int f,
                                                int l, int pl, int NB) {
  for (int a = 0; a < 3; ++a) {
    float t[NBMAX];
#pragma unroll
    for (int bt = 0; bt < NBMAX; ++bt) t[bt] = 0.0f;
    for (int bb = 0; bb < 3; ++bb) {
      const float rp = parent_rot(W, pl, a, bb);
      const float* d = drel + (l * 3 + bb) * NB;
#pragma unroll
      for (int bt = 0; bt < NBMAX; ++bt)   // all of the row's loads at once
        if (bt < NB) t[bt] += rp * d[bt];
    }
#pragma unroll
    for (int bt = 0; bt < NBMAX; ++bt)
      if (bt < NB) s_T[((f * J + l) * 3 + a) * NB + bt] = t[bt];
  }
}

__global__ void __launch_bounds__(THREADS, 3)
joint_jacobian_kernel(const float* __restrict__ theta,
                      const float* __restrict__ betas,
                      const float* __restrict__ scale, Consts c, int B,
                      int K, int Kv, int NB, float* __restrict__ joints,
                      float* __restrict__ dth, float* __restrict__ dbe,
                      float* __restrict__ dsc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_ring = smem + S_RING;
  float* s_in = smem + S_IN;
  float* s_R = smem + S_R;
  float* s_dR = smem + S_DR;
  float* s_jrest = smem + S_JREST;
  float* s_rel = smem + S_REL;
  float* s_W = smem + S_W;
  float* s_off = smem + S_OFF;
  float* s_Y = smem + S_Y;
  float* s_scale = smem + S_SCALE;
  __shared__ int s_par[J];
  __shared__ int s_desc[J];
  __shared__ int s_vslot[KMAX];
  __shared__ int s_cidx[KMAX];

  const int tid = threadIdx.x;
  const int f = tid / J, j = tid % J;      // this thread's (frame, joint)
  const int b0 = blockIdx.x * F;
  const int b = b0 + f;
  const bool live = b < B;                 // padding frames write nothing
  const int v = blockIdx.y;                // vertex slot, or Kv: the chain
  const bool vertex = v < Kv;
  const int cols = NB + P9;
  const int nfold = (cols * J3 + CHUNK - 1) / CHUNK;
  const size_t slot = vertex ? v : 0;
  const Stream st{c.Hb2 + slot * J3 * NB, J3 * NB,
                  c.fold + slot * cols * J3, cols * J3, nfold,
                  c.Hp + slot * J3 * HP_LD, 1 + nfold + HP_CHUNKS};

  if (vertex) {
    issue_chunk(s_ring, 0, st);
    async_commit();
    issue_chunk(s_ring, 1, st);
    async_commit();
  }
  if (tid < J) {
    s_par[tid] = c.parents[tid];
    s_desc[tid] = c.desc[tid];
  }
  if (tid < K) {
    s_vslot[tid] = c.vslot[tid];
    s_cidx[tid] = c.chain_idx[tid];
  }

  // ---- rodrigues + closed-form dR, one thread per (frame, joint) -----
  {
    float vv[3], a[3];
    for (int i = 0; i < 3; ++i) {
      vv[i] = live ? theta[(size_t)b * J3 + j * 3 + i] : 0.0f;
      a[i] = vv[i] + EPS;
    }
    const float th = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    const float inv_t = 1.0f / th;
    float dth_[3], u[3], du[3][3];
    for (int i = 0; i < 3; ++i) {
      dth_[i] = a[i] * inv_t;
      u[i] = vv[i] * inv_t;
    }
    for (int cc = 0; cc < 3; ++cc)
      for (int i = 0; i < 3; ++i)
        du[cc][i] = ((cc == i ? 1.0f : 0.0f) - u[cc] * dth_[i]) * inv_t;
    float s, cs;
    sincosf(th, &s, &cs);
    const float C = 1.0f - cs;
    float ds[3], dC[3];
    for (int i = 0; i < 3; ++i) {
      ds[i] = cs * dth_[i];
      dC[i] = s * dth_[i];
    }
    const float Km[3][3] = {{0.0f, -u[2], u[1]},
                            {u[2], 0.0f, -u[0]},
                            {-u[1], u[0], 0.0f}};
    float dKm[3][3][3];
    for (int i = 0; i < 3; ++i) {
      dKm[0][0][i] = 0.0f;     dKm[0][1][i] = -du[2][i]; dKm[0][2][i] = du[1][i];
      dKm[1][0][i] = du[2][i]; dKm[1][1][i] = 0.0f;      dKm[1][2][i] = -du[0][i];
      dKm[2][0][i] = -du[1][i]; dKm[2][1][i] = du[0][i]; dKm[2][2][i] = 0.0f;
    }
    float* R = s_R + (f * J + j) * 9;
    float* dR = s_dR + (f * J + j) * 27;
    for (int r = 0; r < 3; ++r) {
      for (int cc = 0; cc < 3; ++cc) {
        float K2 = 0.0f;
        for (int m = 0; m < 3; ++m) K2 += Km[r][m] * Km[m][cc];
        const float Rv = (r == cc ? 1.0f : 0.0f) + s * Km[r][cc] + C * K2;
        R[r * 3 + cc] = Rv;
        if (j >= 1)
          s_in[(NB + (j - 1) * 9 + r * 3 + cc) * F + f] =
              Rv - (r == cc ? 1.0f : 0.0f);
        for (int i = 0; i < 3; ++i) {
          float dK2 = 0.0f;
          for (int m = 0; m < 3; ++m)
            dK2 += dKm[r][m][i] * Km[m][cc] + Km[r][m] * dKm[m][cc][i];
          dR[(r * 3 + cc) * 3 + i] =
              ds[i] * Km[r][cc] + s * dKm[r][cc][i] + dC[i] * K2 + C * dK2;
        }
      }
    }
    if (j < NB) s_in[j * F + f] = live ? betas[(size_t)b * NB + j] : 0.0f;
    if (j == 0) s_scale[f] = live ? scale[b] : 1.0f;
  }
  __syncthreads();

  // ---- rest joints = j0 + JB beta, local rest offsets ------------------
  for (int bb = 0; bb < 3; ++bb) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < NBMAX; ++q)
      if (q < NB) acc = fmaf(c.JBT[q * J3 + j * 3 + bb], s_in[q * F + f], acc);
    s_jrest[(f * J + j) * 3 + bb] = c.j0[j * 3 + bb] + acc;
  }
  __syncthreads();
  for (int d = 0; d < 3; ++d)
    s_rel[(f * J + j) * 3 + d] =
        (j == 0) ? s_jrest[(f * J) * 3 + d]
                 : s_jrest[(f * J + j) * 3 + d] -
                       s_jrest[(f * J + s_par[j]) * 3 + d];
  __syncthreads();

  // ---- kinematic chain: W_j = W_parent . T_j, root rotation scaled ----
  // 12 of 16 lanes per frame, one per entry of the 3x4 world transform;
  // a frame's lanes share a warp (warps 0-3), so a step needs only a
  // warp barrier.
  if (tid < 16 * F) {
    const int fw = tid / 16, e = tid % 16;
    float* Wc = s_W + fw * J * 12;
    const float* R = s_R + fw * J * 9;
    const float* rel = s_rel + fw * J3;
    const int r = e / 4, cc = e % 4;
    for (int jj = 0; jj < J; ++jj) {
      if (e < 12) {
        float val;
        if (jj == 0) {
          val = (cc < 3) ? R[r * 3 + cc] * s_scale[fw] : rel[r];
        } else {
          const int pj = s_par[jj];
          float acc = 0.0f;
          for (int m = 0; m < 3; ++m)
            acc += Wc[pj * 12 + r * 4 + m] *
                   ((cc < 3) ? R[jj * 9 + m * 3 + cc] : rel[jj * 3 + m]);
          if (cc == 3) acc += Wc[pj * 12 + r * 4 + 3];
          val = acc;
        }
        Wc[jj * 12 + r * 4 + cc] = val;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const float* W = s_W + f * J * 12;       // this thread's frame
  const int l = j;                          // as the generator's joint
  const int pl = (l == 0) ? -1 : s_par[l];
  const float inv_f =
      (l == 0) ? 1.0f : 1.0f / fmaxf(s_scale[f] * s_scale[f], 1e-30f);
  const float* Rl = s_R + (f * J + l) * 9;
  const float* dRl = s_dR + (f * J + l) * 27;
  const float* rell = s_rel + (f * J + l) * 3;

  if (!vertex) {
    // ================= chain slots: joints, scale, pose, betas ========
    for (int e = tid; e < F * K * 3; e += THREADS) {
      const int fe = e / (K * 3), k = (e / 3) % K, a = e % 3;
      if (s_vslot[k] >= 0 || b0 + fe >= B) continue;
      const float pos = s_W[(fe * J + s_cidx[k]) * 12 + a * 4 + 3];
      const size_t o = ((size_t)(b0 + fe) * K + k) * 3 + a;
      joints[o] = pos;
      dsc[o] = (pos - s_rel[fe * J3 + a]) * (1.0f / s_scale[fe]);
    }
    // This thread's generators; R and dR are dead once all are built,
    // and their space takes the beta terms, then the generators.
    float Grot[3][3][3], Gt[3][3];
#pragma unroll
    for (int A = 0; A < 3; ++A)
      generator(W, Rl, dRl, rell, pl, inv_f, A, Grot[A], Gt[A]);
    __syncthreads();
    float* s_T = smem;    // [f][l][a][bt]
    rest_beta_terms(s_T, W, c.drel, f, l, pl, NB);
    __syncthreads();
    // A chain joint's beta block is the sum over its ancestors, in
    // ascending order: T[j] += T[parent j], parents first.
    for (int e = tid; e < F * 3 * NB; e += THREADS) {
      const int fe = e / (3 * NB), r = e % (3 * NB);
      for (int jj = 1; jj < J; ++jj)
        s_T[(fe * J + jj) * 3 * NB + r] = s_T[(fe * J + s_par[jj]) * 3 * NB + r] +
                                          s_T[(fe * J + jj) * 3 * NB + r];
    }
    __syncthreads();
    // Output rows, a warp per row, lanes on consecutive slots (coalesced);
    // a lane's entries (lane + 32 i) and their chain joints are fixed.
    const int lane = tid & 31, warp = tid >> 5;
    constexpr int NP = (KMAX * 3 + 31) / 32;
    int pk[NP], pa[NP], pjs[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = lane + 32 * i;
      const int k = p / 3;
      const bool on = p < K * 3 && s_vslot[min(k, K - 1)] < 0;
      pk[i] = on ? p : -1;
      pa[i] = p % 3;
      pjs[i] = on ? s_cidx[k] : 0;
    }
    for (int rr = warp; rr < F * NB; rr += THREADS / 32) {
      const int fe = rr / NB, bt = rr % NB;
      if (b0 + fe >= B) continue;
      float* out = dbe + ((size_t)(b0 + fe) * NB + bt) * K * 3;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (pk[i] >= 0)
          out[pk[i]] = s_T[((fe * J + pjs[i]) * 3 + pa[i]) * NB + bt];
    }
    __syncthreads();
    float* s_G = smem;    // [f][l][A][12]: Grot[a][d] at a*3+d, Gt[a] at 9+a
#pragma unroll
    for (int A = 0; A < 3; ++A)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s_G[((f * J + l) * 3 + A) * 12 + a * 3 + d] = Grot[A][a][d];
        s_G[((f * J + l) * 3 + A) * 12 + 9 + a] = Gt[A][a];
      }
    __syncthreads();
    for (int fe = 0; fe < F && b0 + fe < B; ++fe) {
      const float* Wf = s_W + fe * J * 12;
      float pw[NP][3];
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int d = 0; d < 3; ++d) pw[i][d] = Wf[pjs[i] * 12 + d * 4 + 3];
      float* out = dth + (size_t)(b0 + fe) * J3 * K * 3;
#pragma unroll 4
      for (int row = warp; row < J3; row += THREADS / 32) {
        const float* g = s_G + (fe * J3 + row) * 12;
        const int desc = s_desc[row / 3];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          if (pk[i] < 0) continue;
          const int a = pa[i];
          const float an = ((desc >> pjs[i]) & 1) ? 1.0f : 0.0f;
          float acc = 0.0f;
#pragma unroll
          for (int d = 0; d < 3; ++d) acc += g[a * 3 + d] * pw[i][d];
          out[row * K * 3 + pk[i]] = an * (acc + g[9 + a]);
        }
      }
    }
    return;
  }

  // ================= vertex slot v: fold, contributions ===============
  const int k_out = c.kslot[v];

  // ---- betas block W . Hb2 + u_0 drel_0, Hb2 from ring chunk 0 --------
  ring_wait();
  {
    const float* hb = s_ring;    // [j*3+b][bt]
    const float u0 = c.u[v * J];
    for (int e = tid; e < F * 3 * NB; e += THREADS) {
      const int fe = e / (3 * NB), a = (e / NB) % 3, bt = e % NB;
      const float* Wf = s_W + fe * J * 12 + a * 4;
      const float* hr = hb + bt;
      float acc = 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < J; ++jj) {
        acc = fmaf(Wf[jj * 12], hr[(jj * 3) * NB], acc);
        acc = fmaf(Wf[jj * 12 + 1], hr[(jj * 3 + 1) * NB], acc);
        acc = fmaf(Wf[jj * 12 + 2], hr[(jj * 3 + 2) * NB], acc);
      }
      if (b0 + fe < B)
        dbe[(((size_t)(b0 + fe) * NB + bt) * K + k_out) * 3 + a] =
            acc + u0 * c.drel[a * NB + bt];
    }
  }
  ring_next(s_ring, 0, st);
  {
    // offsets[f][col] = sum_q in[q][f] fold[v][q][col]; a thread owns the
    // 8 frames x 1 column over every other row, and the two row halves
    // meet in shared memory.
    const int h = tid / J3, col = tid % J3;
    float acc[F];
    for (int i = 0; i < F; ++i) acc[i] = 0.0f;
    for (int ch = 1; ch <= nfold; ++ch) {
      ring_wait();
      if (tid < 2 * J3) {
        const float* buf = s_ring + (ch & 1) * CHUNK;
        const int q0 = (ch - 1) * FOLD_ROWS, q1 = min(q0 + FOLD_ROWS, cols);
#pragma unroll 4
        for (int q = q0 + h; q < q1; q += 2) {
          const float4 x = *reinterpret_cast<const float4*>(s_in + q * F);
          const float4 y = *reinterpret_cast<const float4*>(s_in + q * F + 4);
          const float w = buf[(q - q0) * J3 + col];
          acc[0] = fmaf(w, x.x, acc[0]);
          acc[1] = fmaf(w, x.y, acc[1]);
          acc[2] = fmaf(w, x.z, acc[2]);
          acc[3] = fmaf(w, x.w, acc[3]);
          acc[4] = fmaf(w, y.x, acc[4]);
          acc[5] = fmaf(w, y.y, acc[5]);
          acc[6] = fmaf(w, y.z, acc[6]);
          acc[7] = fmaf(w, y.w, acc[7]);
        }
      }
      ring_next(s_ring, ch, st);
    }
    if (tid < 2 * J3 && h == 1)
      for (int i = 0; i < F; ++i) s_off[i * J3 + col] = acc[i];
    __syncthreads();
    if (tid < 2 * J3 && h == 0)
      for (int i = 0; i < F; ++i) s_off[i * J3 + col] = acc[i] + s_off[i * J3 + col];
  }
  __syncthreads();

  const float* h0 = c.H0 + ((size_t)v * J + j) * 4;
  {
    // contrib[f][j][a] = Rw_j (h0 + off - w jrest) + w tw_j, in place of
    // the offsets (each thread reads and writes only its own three).
    const float w = h0[3];
    float q[3];
    for (int bb = 0; bb < 3; ++bb)
      q[bb] = h0[bb] + s_off[f * J3 + j * 3 + bb] -
              w * s_jrest[(f * J + j) * 3 + bb];
    for (int a = 0; a < 3; ++a) {
      float acc = 0.0f;
      for (int bb = 0; bb < 3; ++bb) acc += W[j * 12 + a * 4 + bb] * q[bb];
      s_off[f * J3 + j * 3 + a] = acc + w * W[j * 12 + a * 4 + 3];
    }
  }
  __syncthreads();
  for (int a = 0; a < 3; ++a) {   // Y[l] = sum over l's descendants
    float acc = 0.0f;
    for (int jj = 0; jj < J; ++jj)
      if ((s_desc[l] >> jj) & 1) acc += s_off[f * J3 + jj * 3 + a];
    s_Y[(f * J + l) * 3 + a] = acc;
  }
  __syncthreads();

  // ---- joints and scale column (vertex joint = Y at the root) ---------
  if (tid < F * 3) {
    const int fe = tid / 3, a = tid % 3;
    if (b0 + fe < B) {
      float wk = 0.0f;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) wk += c.H0[((size_t)v * J + jj) * 4 + 3];
      const float pos = s_Y[(fe * J) * 3 + a];
      const size_t o = ((size_t)(b0 + fe) * K + k_out) * 3 + a;
      joints[o] = pos;
      dsc[o] = (pos - wk * s_rel[fe * J3 + a]) * (1.0f / s_scale[fe]);
    }
  }

  // ---- pose-corrective product P[f][a][(l-1)*9+q] over the slab rows --
  // A thread owns two frames x one joint l >= 1 x every other slab row
  // (184 threads): each Hp value it loads feeds 6 multiply-adds.  The two
  // row halves meet in shared memory (ring and inputs are dead by then).
  {
    const int h = tid / (4 * (J - 1)), rem = tid % (4 * (J - 1));
    const int fp = rem / (J - 1), lp = rem % (J - 1);      // l = lp + 1
    const bool works = tid < 8 * (J - 1);
    const float* W0 = s_W + (2 * fp) * J * 12;
    const float* W1 = W0 + J * 12;
    float P0[3][9], P1[3][9];
    for (int a = 0; a < 3; ++a)
      for (int q = 0; q < 9; ++q) P0[a][q] = P1[a][q] = 0.0f;
    for (int ch = 1 + nfold; ch < st.nchunks; ++ch) {
      ring_wait();
      if (works) {
        const float* buf = s_ring + (ch & 1) * CHUNK + lp * 9;
        const int r0 = (ch - 1 - nfold) * HP_ROWS, r1 = min(r0 + HP_ROWS, J3);
        for (int r = r0 + h; r < r1; r += 2) {
          const int o = (r / 3) * 12 + r % 3;
          const float x0 = W0[o], x1 = W0[o + 4], x2 = W0[o + 8];
          const float y0 = W1[o], y1 = W1[o + 4], y2 = W1[o + 8];
          const float* hr = buf + (r - r0) * HP_LD;
          for (int q = 0; q < 9; ++q) {
            const float hq = hr[q];
            P0[0][q] = fmaf(x0, hq, P0[0][q]);
            P0[1][q] = fmaf(x1, hq, P0[1][q]);
            P0[2][q] = fmaf(x2, hq, P0[2][q]);
            P1[0][q] = fmaf(y0, hq, P1[0][q]);
            P1[1][q] = fmaf(y1, hq, P1[1][q]);
            P1[2][q] = fmaf(y2, hq, P1[2][q]);
          }
        }
      }
      ring_next(s_ring, ch, st);
    }
    float* p0 = smem + ((2 * fp) * (J - 1) + lp) * 27;
    float* p1 = p0 + (J - 1) * 27;
    if (works && h == 1)
#pragma unroll
      for (int i = 0; i < 27; ++i) {
        p0[i] = P0[i / 9][i % 9];
        p1[i] = P1[i / 9][i % 9];
      }
    __syncthreads();
    if (works && h == 0)
#pragma unroll
      for (int i = 0; i < 27; ++i) {
        p0[i] = P0[i / 9][i % 9] + p0[i];
        p1[i] = P1[i / 9][i % 9] + p1[i];
      }
    __syncthreads();
  }
  const float* s_P = smem + (f * (J - 1) + max(l, 1) - 1) * 27;  // [a*9+q]

  // ---- pose and orient block, one thread per (frame, joint l) ---------
  if (live) {
    const float ul = c.u[v * J + l];
    const float* Yl = s_Y + (f * J + l) * 3;
    for (int A = 0; A < 3; ++A) {
      float Grot[3][3], Gt[3];
      generator(W, Rl, dRl, rell, pl, inv_f, A, Grot, Gt);
      float* out = dth + (((size_t)b * J3 + l * 3 + A) * K + k_out) * 3;
      for (int a = 0; a < 3; ++a) {
        float acc = 0.0f;
        for (int d = 0; d < 3; ++d) acc += Grot[a][d] * Yl[d];
        float o = acc + ul * Gt[a];
        if (l >= 1) {
          float pc = 0.0f;
          for (int q = 0; q < 9; ++q) pc += s_P[a * 9 + q] * dRl[q * 3 + A];
          o += pc;
        }
        out[a] = o;
      }
    }
  }
}

}  // namespace
extern "C" int mvsf_joint_jacobian(
    const float* theta, const float* betas, const float* scale,
    const float* JBT, const float* fold, const float* Hp, const float* Hb2,
    const float* j0, const float* H0, const float* u, const float* drel,
    const int* parents, const int* desc, const int* chain_idx,
    const int* vslot, const int* kslot, int B, int K, int Kv, int NB,
    float* joints, float* dth, float* dbe, float* dsc, void* stream) {
  if (K < 1 || K > KMAX || Kv < 0 || Kv > K || NB < 0 || NB > NBMAX)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      joint_jacobian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  Consts c{JBT, fold, Hp, Hb2, j0, H0, u, drel, parents, desc, chain_idx,
           vslot, kslot};
  const dim3 grid((B + F - 1) / F, Kv + (Kv < K ? 1 : 0));
  joint_jacobian_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      theta, betas, scale, c, B, K, Kv, NB, joints, dth, dbe, dsc);
  return (int)cudaGetLastError();
}
