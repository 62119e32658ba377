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
// Bound on the H100: operations.  Only the Kv vertex slots (slots whose
// joint is a regressed vertex combination) need fold offsets and the
// pose-corrective and beta products; chain slots (smpl body joints) read
// the chain.  The wrapper passes the vertex-slot tables compacted (the
// chain slots' rows of the fold, H0, Hb and Hp are zero), and the rest
// joints take only the fold's JB columns.  Per smpl frame (Kv=5 of K=17)
// about 0.37 M fp32 multiply-adds (fold 79 k, pose-corrective 233 k,
// beta blocks ~30 k), for smpllsp (Kv=17) about 1.2 M; the output is
// 17 KB per frame.  The TPU layout (lane-major permuted tables,
// pointer-jumping matrices) is not carried over.  Design: one
// 256-thread block per frame, every intermediate in shared memory, fp32
// FMA on the CUDA cores.  The two large contractions (the Kv*72 x 217
// fold and the 72-long pose-corrective dot per (slot, axis, joint, 3x3
// entry)) are spread over the block's threads with the constants read in
// coalesced order (the fold is passed transposed).  The chain walk uses
// 12 lanes of warp 0, one per entry of the 3x4 world transform.  The
// per-model constants are read once per frame from L2; amortizing them
// over several frames per block is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int J = 24;              // SMPL chain joints
constexpr int J3 = J * 3;          // 72
constexpr int P9 = 9 * (J - 1);    // 207 pose-feature entries
constexpr int KMAX = 24;           // mapped slots (shared-memory sizing)
constexpr int NBMAX = 16;          // betas
constexpr int THREADS = 256;
constexpr float EPS = 1e-8f;       // rodrigues component shift

// Tables indexed by vertex slot v (0..Kv-1); slot k's v is vslot[k].
struct Consts {
  const float* JBT;        // (NB, J3) rest-joint shape basis, transposed
  const float* foldT;      // (NB+P9, Kv*J3) vertex-slot fold, transposed
  const float* j0;         // (J, 3)
  const float* H0;         // (Kv, J, 4)
  const float* HpT;        // (Kv, J-1, 9, J3): [v][l-1][q][j*3+b]
  const float* HbW;        // (Kv, J, 3, NB) = Hb - w JB
  const float* u;          // (Kv, J) ancestry-summed skinning weights
  const float* drel;       // (J, 3, NB) rest-offset shape basis
  const float* anc;        // (J, J) anc[l][j] = l is j or an ancestor
  const int* parents;      // (J,), root -1, parents before children
  const int* chain_idx;    // (K,) source chain joint
  const int* vslot;        // (K,) vertex slot, -1 for a chain slot
};

__global__ void __launch_bounds__(THREADS)
joint_jacobian_kernel(const float* __restrict__ theta,
                      const float* __restrict__ betas,
                      const float* __restrict__ scale, Consts c, int B,
                      int K, int Kv, int NB, float* __restrict__ joints,
                      float* __restrict__ dth, float* __restrict__ dbe,
                      float* __restrict__ dsc) {
  const int b = blockIdx.x;
  if (b >= B) return;
  const int tid = threadIdx.x;
  const int rows = Kv * J3;          // vertex-slot fold rows
  const int cols = NB + P9;          // fold input rows

  __shared__ float s_in[NBMAX + P9];         // [betas; vec(R_j - I), j>=1]
  __shared__ float s_off[KMAX * J3];         // vertex-slot offsets
  __shared__ float s_R[J][9];                // local rotations
  __shared__ float s_dR[J][27];              // dR[(r*3+c)*3 + A]
  __shared__ float s_jrest[J][3];
  __shared__ float s_rel[J][3];              // local rest offsets
  __shared__ float s_W[J][12];               // world transforms [r*4+c]
  __shared__ float s_Rp[J][9];               // parent world rotation
  __shared__ float s_Grot[J][27];            // [(a*3+d)*3 + A]
  __shared__ float s_Gt[J][9];               // [a*3 + A]
  __shared__ float s_contrib[KMAX][J][3];    // per vertex slot
  __shared__ float s_Y[KMAX][J][3];          // ancestry-folded contrib
  __shared__ float s_vpre[KMAX][3];          // vertex-slot joints
  __shared__ int s_par[J];
  __shared__ float s_scale;

  // ---- rodrigues + closed-form dR, one thread per joint -------------
  if (tid < J) {
    const int j = tid;
    float v[3], a[3];
    for (int i = 0; i < 3; ++i) {
      v[i] = theta[(size_t)b * J3 + j * 3 + i];
      a[i] = v[i] + EPS;
    }
    const float th = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
    const float inv_t = 1.0f / th;
    float dth_[3], u[3], du[3][3];
    for (int i = 0; i < 3; ++i) {
      dth_[i] = a[i] * inv_t;
      u[i] = v[i] * inv_t;
    }
    for (int cc = 0; cc < 3; ++cc)
      for (int i = 0; i < 3; ++i)
        du[cc][i] = ((cc == i ? 1.0f : 0.0f) - u[cc] * dth_[i]) * inv_t;
    const float s = sinf(th), cs = cosf(th), C = 1.0f - cs;
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
    for (int r = 0; r < 3; ++r) {
      for (int cc = 0; cc < 3; ++cc) {
        float K2 = 0.0f;
        for (int m = 0; m < 3; ++m) K2 += Km[r][m] * Km[m][cc];
        const float R = (r == cc ? 1.0f : 0.0f) + s * Km[r][cc] + C * K2;
        s_R[j][r * 3 + cc] = R;
        if (j >= 1) s_in[NB + (j - 1) * 9 + r * 3 + cc] = R - (r == cc ? 1.0f : 0.0f);
        for (int i = 0; i < 3; ++i) {
          float dK2 = 0.0f;
          for (int m = 0; m < 3; ++m)
            dK2 += dKm[r][m][i] * Km[m][cc] + Km[r][m] * dKm[m][cc][i];
          s_dR[j][(r * 3 + cc) * 3 + i] =
              ds[i] * Km[r][cc] + s * dKm[r][cc][i] + dC[i] * K2 + C * dK2;
        }
      }
    }
    s_par[j] = c.parents[j];
  }
  if (tid < NB) s_in[tid] = betas[(size_t)b * NB + tid];
  if (tid == 0) s_scale = scale[b];
  __syncthreads();

  // ---- fold: rest joints = j0 + JB beta; offsets = fold_v [beta; pf] -
  if (tid < J3) {
    float acc = 0.0f;
    for (int q = 0; q < NB; ++q) acc = fmaf(c.JBT[q * J3 + tid], s_in[q], acc);
    s_jrest[tid / 3][tid % 3] = c.j0[tid] + acc;
  }
  for (int r = tid; r < rows; r += THREADS) {
    float acc = 0.0f;
    for (int q = 0; q < cols; ++q) acc = fmaf(c.foldT[(size_t)q * rows + r], s_in[q], acc);
    s_off[r] = acc;
  }
  __syncthreads();
  if (tid < J3) {
    const int j = tid / 3, d = tid % 3;
    s_rel[j][d] = (j == 0) ? s_jrest[0][d] : s_jrest[j][d] - s_jrest[s_par[j]][d];
  }
  __syncthreads();

  // ---- kinematic chain: W_j = W_parent . T_j, root rotation scaled --
  if (tid < 32) {
    const int r = tid / 4, cc = tid % 4;
    for (int j = 0; j < J; ++j) {
      if (tid < 12) {
        float val;
        if (j == 0) {
          val = (cc < 3) ? s_R[0][r * 3 + cc] * s_scale : s_rel[0][r];
        } else {
          const int pj = s_par[j];
          float acc = 0.0f;
          for (int m = 0; m < 3; ++m)
            acc += s_W[pj][r * 4 + m] * ((cc < 3) ? s_R[j][m * 3 + cc] : s_rel[j][m]);
          if (cc == 3) acc += s_W[pj][r * 4 + 3];
          val = acc;
        }
        s_W[j][r * 4 + cc] = val;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- generators, one thread per (joint l, row i, component A) -----
  if (tid < J * 9) {
    const int l = tid / 9, i = (tid % 9) / 3, A = tid % 3;
    float Rp[3][3], twp[3], inv_f;
    if (l == 0) {
      for (int x = 0; x < 3; ++x) {
        for (int y = 0; y < 3; ++y) Rp[x][y] = (x == y) ? 1.0f : 0.0f;
        twp[x] = 0.0f;
      }
      inv_f = 1.0f;
    } else {
      const int pj = s_par[l];
      for (int x = 0; x < 3; ++x) {
        for (int y = 0; y < 3; ++y) Rp[x][y] = s_W[pj][x * 4 + y];
        twp[x] = s_W[pj][x * 4 + 3];
      }
      inv_f = 1.0f / fmaxf(s_scale * s_scale, 1e-30f);
    }
    // Kg[bb][cc] = sum_m dR[bb][m][A] R[cc][m]
    float Kg[3][3];
    for (int bb = 0; bb < 3; ++bb)
      for (int cc = 0; cc < 3; ++cc) {
        float acc = 0.0f;
        for (int m = 0; m < 3; ++m)
          acc += s_dR[l][(bb * 3 + m) * 3 + A] * s_R[l][cc * 3 + m];
        Kg[bb][cc] = acc;
      }
    float G1[3];  // G1[cc] = sum_bb Rp[i][bb] Kg[bb][cc]
    for (int cc = 0; cc < 3; ++cc) {
      float acc = 0.0f;
      for (int bb = 0; bb < 3; ++bb) acc += Rp[i][bb] * Kg[bb][cc];
      G1[cc] = acc;
    }
    float Grot[3];  // Grot[jx] = sum_cc G1[cc] (Rp^T / s^2)[cc][jx]
    for (int jx = 0; jx < 3; ++jx) {
      float acc = 0.0f;
      for (int cc = 0; cc < 3; ++cc) acc += G1[cc] * (Rp[jx][cc] * inv_f);
      Grot[jx] = acc;
      s_Grot[l][(i * 3 + jx) * 3 + A] = acc;
    }
    float t1 = 0.0f, t2 = 0.0f;
    for (int d = 0; d < 3; ++d) t1 += Grot[d] * twp[d];
    for (int cc = 0; cc < 3; ++cc) t2 += G1[cc] * s_rel[l][cc];
    s_Gt[l][i * 3 + A] = -(t1 + t2);
    if (i == 0 && A == 0)
      for (int x = 0; x < 9; ++x) s_Rp[l][x] = Rp[x / 3][x % 3];
  }

  // ---- vertex-slot contributions, one thread per (v, joint, axis) --
  for (int e = tid; e < rows; e += THREADS) {
    const int v = e / J3, j = (e % J3) / 3, a = e % 3;
    const float* h0 = c.H0 + ((size_t)v * J + j) * 4;
    const float w = h0[3];
    float acc = 0.0f;
    for (int bb = 0; bb < 3; ++bb) {
      const float q = h0[bb] + s_off[(v * J + j) * 3 + bb] - w * s_jrest[j][bb];
      acc += s_W[j][a * 4 + bb] * q;
    }
    s_contrib[v][j][a] = acc + w * s_W[j][a * 4 + 3];
  }
  __syncthreads();
  for (int e = tid; e < rows; e += THREADS) {
    const int v = e / J3, l = (e % J3) / 3, a = e % 3;
    float acc = 0.0f;
    for (int j = 0; j < J; ++j) acc += c.anc[l * J + j] * s_contrib[v][j][a];
    s_Y[v][l][a] = acc;
  }
  if (tid < Kv * 3) {
    const int v = tid / 3, a = tid % 3;
    float acc = 0.0f;
    for (int j = 0; j < J; ++j) acc += s_contrib[v][j][a];
    s_vpre[v][a] = acc;
  }
  __syncthreads();

  const float s_inv = 1.0f / s_scale;

  // ---- joints and scale column, one thread per (slot, axis) ---------
  if (tid < K * 3) {
    const int k = tid / 3, a = tid % 3;
    const int v = c.vslot[k];
    float pos, dscale;
    if (v < 0) {
      pos = s_W[c.chain_idx[k]][a * 4 + 3];
      dscale = (pos - s_rel[0][a]) * s_inv;
    } else {
      float wk = 0.0f;
      for (int j = 0; j < J; ++j) wk += c.H0[((size_t)v * J + j) * 4 + 3];
      pos = s_vpre[v][a];
      dscale = (pos - wk * s_rel[0][a]) * s_inv;
    }
    joints[((size_t)b * K + k) * 3 + a] = pos;
    dsc[((size_t)b * K + k) * 3 + a] = dscale;
  }

  // ---- betas block, one thread per (slot, axis, beta) ---------------
  for (int e = tid; e < K * 3 * NB; e += THREADS) {
    const int k = e / (3 * NB), a = (e / NB) % 3, bt = e % NB;
    const int v = c.vslot[k];
    float acc = 0.0f;
    if (v < 0) {
      const int js = c.chain_idx[k];
      for (int l = 0; l < J; ++l) {
        const float an = c.anc[l * J + js];
        if (an == 0.0f) continue;
        float t = 0.0f;
        for (int bb = 0; bb < 3; ++bb)
          t += s_Rp[l][a * 3 + bb] * c.drel[(l * 3 + bb) * NB + bt];
        acc += an * t;
      }
    } else {
      for (int j = 0; j < J; ++j)
        for (int bb = 0; bb < 3; ++bb)
          acc += s_W[j][a * 4 + bb] * c.HbW[(((size_t)v * J + j) * 3 + bb) * NB + bt];
      for (int l = 0; l < J; ++l) {
        float t = 0.0f;
        for (int bb = 0; bb < 3; ++bb)
          t += s_Rp[l][a * 3 + bb] * c.drel[(l * 3 + bb) * NB + bt];
        acc += c.u[v * J + l] * t;
      }
    }
    dbe[(((size_t)b * NB + bt) * K + k) * 3 + a] = acc;
  }

  // ---- pose and orient block, one thread per (slot, axis, joint) ----
  for (int e = tid; e < K * 3 * J; e += THREADS) {
    const int k = e / (3 * J), a = (e / J) % 3, l = e % J;
    const int v = c.vslot[k];
    float out[3];
    if (v < 0) {
      const int js = c.chain_idx[k];
      const float an = c.anc[l * J + js];
      for (int A = 0; A < 3; ++A) {
        float acc = 0.0f;
        for (int d = 0; d < 3; ++d)
          acc += s_Grot[l][(a * 3 + d) * 3 + A] * s_W[js][d * 4 + 3];
        out[A] = an * (acc + s_Gt[l][a * 3 + A]);
      }
    } else {
      const float ul = c.u[v * J + l];
      for (int A = 0; A < 3; ++A) {
        float acc = 0.0f;
        for (int d = 0; d < 3; ++d)
          acc += s_Grot[l][(a * 3 + d) * 3 + A] * s_Y[v][l][d];
        out[A] = acc + ul * s_Gt[l][a * 3 + A];
      }
      if (l >= 1) {
        // Pose-corrective part: P[v][a][(l-1)*9+q] = sum_{j,b} Rw[j][a][b]
        // Hp[v][j][b][(l-1)*9+q], contracted with dR[l][q][A].
        const float* hp = c.HpT + ((size_t)v * (J - 1) + (l - 1)) * 9 * J3;
        float pc[3] = {0.0f, 0.0f, 0.0f};
        for (int q = 0; q < 9; ++q) {
          float P = 0.0f;
          const float* row = hp + q * J3;
          for (int j = 0; j < J; ++j)
            for (int bb = 0; bb < 3; ++bb)
              P = fmaf(s_W[j][a * 4 + bb], row[j * 3 + bb], P);
          for (int A = 0; A < 3; ++A) pc[A] += P * s_dR[l][q * 3 + A];
        }
        for (int A = 0; A < 3; ++A) out[A] += pc[A];
      }
    }
    for (int A = 0; A < 3; ++A)
      dth[(((size_t)b * J3 + l * 3 + A) * K + k) * 3 + a] = out[A];
  }
}

}  // namespace

extern "C" int mvsf_joint_jacobian(
    const float* theta, const float* betas, const float* scale,
    const float* JBT, const float* foldT, const float* j0, const float* H0,
    const float* HpT, const float* HbW, const float* u, const float* drel,
    const float* anc, const int* parents, const int* chain_idx,
    const int* vslot, int B, int K, int Kv, int NB, float* joints,
    float* dth, float* dbe, float* dsc, void* stream) {
  if (K < 1 || K > KMAX || Kv < 0 || Kv > K || NB < 0 || NB > NBMAX)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Consts c{JBT, foldT, j0, H0, HpT, HbW, u, drel, anc, parents, chain_idx, vslot};
  joint_jacobian_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, betas, scale, c, B, K, Kv, NB, joints, dth, dbe, dsc);
  return (int)cudaGetLastError();
}
