// Per-pair arithmetic of the SDF voxelizers, shared by csrc/sdf_grid.cu
// (brute force) and csrc/sdf_grid_fast.cu (two phases, culled).
//
// Both sources include this header and are compiled with -fmad=false
// and without fast math, so every +, -, *, / and sqrtf below rounds
// once, in IEEE single precision, in the order written.  The plain
// PyTorch version (mvsmplfitting_tpu_torch/ops/sdf.py: _pair_dist_sq,
// _pair_crossing, voxel_line) runs the same operations in the same
// order, one tensor operation at a time.  So the two kernels agree
// bitwise with each other and with the plain version: the parity ray
// can graze a shared edge, and a different rounding there flips a voxel.
//
// Operations per (voxel, triangle) pair, counted from the code below
// (each add, subtract, multiply, divide and compare counts one; selects
// do not):
//   distance  sdf_pair_dist_sq  116 = 89 arithmetic (5 of them divides)
//             + 26 compares + the running minimum
//   crossing  sdf_pair_crossing  60 = 52 arithmetic (1 divide)
//             + 7 compares + the count
//   crossing, row form (sdf_cross_row + sdf_cross_voxel, both kernels;
//             the brute force splits sdf_cross_voxel in two,
//             sdf_cross_pre + sdf_cross_exact, to count the pairs that
//             pass the pre-test): 14 per triangle and x-row of voxels,
//             then 37 per voxel (27 arithmetic + 9 for the pre-test +
//             the count; 5 of them depend on the triangle and x only,
//             and the brute force shares them between rows), and 10
//             more (the divide, 3 products, 1 add, 5 compares) for the
//             few pairs that pass the pre-test
// ops/sdf_kernel.py holds them as DIST_OPS, CROSS_OPS, CROSS_ROW_OPS,
// CROSS_VOXEL_OPS, CROSS_COLUMN_OPS and CROSS_PASS_OPS for the bounds
// that chip_smoke.py computes.
#pragma once

#include "async_copy.cuh"

constexpr int SDF_THREADS = 128;  // threads per block of every SDF kernel
constexpr float SDF_FAR_D2 = 1e6f;

// Voxel-center coordinate -1 + (i + 0.5) * dx (dx = 2/(G-1) in fp32).
__device__ __forceinline__ float sdf_coord(int i, float dx) {
  return -1.0f + ((float)i + 0.5f) * dx;
}

__device__ __forceinline__ float sdf_dot3(float ux, float uy, float uz,
                                          float vx, float vy, float vz) {
  return ux * vx + uy * vy + uz * vz;
}

__device__ __forceinline__ float sdf_safe_div(float a, float b) {
  return a / (fabsf(b) > 1e-30f ? b : 1e-30f);
}

__device__ __forceinline__ float sdf_clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Squared distance from p to triangle t = [a, b, c] (9 floats): the
// Ericson closest-point classification, interior first, then the edges,
// then the vertices overriding (JAX ops/sdf.py:point_triangle_closest).
__device__ __forceinline__ float sdf_pair_dist_sq(const float* t, float px,
                                                  float py, float pz) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float bx = t[3], by = t[4], bz = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = sdf_dot3(abx, aby, abz, apx, apy, apz);
  const float d2 = sdf_dot3(acx, acy, acz, apx, apy, apz);
  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = sdf_dot3(abx, aby, abz, bpx, bpy, bpz);
  const float d4 = sdf_dot3(acx, acy, acz, bpx, bpy, bpz);
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = sdf_dot3(abx, aby, abz, cpx, cpy, cpz);
  const float d6 = sdf_dot3(acx, acy, acz, cpx, cpy, cpz);

  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  const float v_ab = sdf_clamp01(sdf_safe_div(d1, d1 - d3));
  const float w_ac = sdf_clamp01(sdf_safe_div(d2, d2 - d6));
  const float w_bc = sdf_clamp01(sdf_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)));
  const float denom = va + vb + vc;
  float v = sdf_safe_div(vb, denom);
  float w = sdf_safe_div(vc, denom);

  const bool in_a = (d1 <= 0.0f) && (d2 <= 0.0f);
  const bool in_b = (d3 >= 0.0f) && (d4 <= d3);
  const bool in_c = (d6 >= 0.0f) && (d5 <= d6);
  const bool on_ab = (vc <= 0.0f) && (d1 >= 0.0f) && (d3 <= 0.0f);
  const bool on_ac = (vb <= 0.0f) && (d2 >= 0.0f) && (d6 <= 0.0f);
  const bool on_bc = (va <= 0.0f) && ((d4 - d3) >= 0.0f) && ((d5 - d6) >= 0.0f);

  if (on_bc) { v = 1.0f - w_bc; w = w_bc; }
  if (on_ac) { v = 0.0f; w = w_ac; }
  if (on_ab) { v = v_ab; w = 0.0f; }
  if (in_c) { v = 0.0f; w = 1.0f; }
  if (in_b) { v = 1.0f; w = 0.0f; }
  if (in_a) { v = 0.0f; w = 0.0f; }

  const float qx = ax + v * abx + w * acx - px;
  const float qy = ay + v * aby + w * acy - py;
  const float qz = az + v * abz + w * acz - pz;
  return qx * qx + qy * qy + qz * qz;
}

// 1 where the ray from p along (dxr, dyr, dzr) crosses triangle t:
// Moller-Trumbore with |det| > 1e-7, u, v in [0, 1], u + v <= 1, t >= 0
// (the reference's bounds, sdf_cuda_kernel.cu).
__device__ __forceinline__ int sdf_pair_crossing(const float* t, float px,
                                                 float py, float pz,
                                                 float dxr, float dyr,
                                                 float dzr) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float abx = t[3] - ax, aby = t[4] - ay, abz = t[5] - az;
  const float acx = t[6] - ax, acy = t[7] - ay, acz = t[8] - az;
  const float pvx = dyr * acz - dzr * acy;
  const float pvy = dzr * acx - dxr * acz;
  const float pvz = dxr * acy - dyr * acx;
  const float det = sdf_dot3(abx, aby, abz, pvx, pvy, pvz);
  const bool ok = fabsf(det) > 1e-7f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tvx = px - ax, tvy = py - ay, tvz = pz - az;
  const float u = sdf_dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv;
  const float qvx = tvy * abz - tvz * aby;
  const float qvy = tvz * abx - tvx * abz;
  const float qvz = tvx * aby - tvy * abx;
  const float vv = sdf_dot3(dxr, dyr, dzr, qvx, qvy, qvz) * inv;
  const float tt = sdf_dot3(acx, acy, acz, qvx, qvy, qvz) * inv;
  return (ok && u >= 0.0f && u <= 1.0f && vv >= 0.0f && u + vv <= 1.0f &&
          tt >= 0.0f)
             ? 1
             : 0;
}

// Row form of sdf_pair_crossing, for csrc/sdf_grid_fast.cu.  Voxels of
// one x-row share py and pz (so dyr and dzr), and with them every term of
// sdf_pair_crossing that involves only the triangle, py and pz:
// sdf_cross_row computes those once per triangle and row, sdf_cross_voxel
// finishes one voxel of the row.  Each value is the same IEEE operation on
// the same operands as in sdf_pair_crossing (the names say which), so
// the result is the same 0 or 1, bit for bit.  The triangle comes as
// t = [a, ab, ac] with ab = b - a and ac = c - a subtracted once per
// triangle by the wrapper: the same single subtraction.
struct SdfCrossRow {
  float ax, abx, aby, abz, acx, acy, acz;
  float pvx, dzr_acx, dyr_acx;            // pvx; products of pvy, pvz
  float tvy, tvz, qvx, tvz_abx, tvy_abx;  // tv's y, z; qvx; of qvy, qvz
  float abx_pvx, acx_qvx;                 // first products of det and tt
};

__device__ __forceinline__ SdfCrossRow sdf_cross_row(const float* t,
                                                     float py, float pz,
                                                     float dyr, float dzr) {
  SdfCrossRow r;
  r.ax = t[0];
  const float ay = t[1], az = t[2];
  r.abx = t[3], r.aby = t[4], r.abz = t[5];
  r.acx = t[6], r.acy = t[7], r.acz = t[8];
  r.pvx = dyr * r.acz - dzr * r.acy;
  r.dzr_acx = dzr * r.acx;
  r.dyr_acx = dyr * r.acx;
  r.tvy = py - ay;
  r.tvz = pz - az;
  r.qvx = r.tvy * r.abz - r.tvz * r.aby;
  r.tvz_abx = r.tvz * r.abx;
  r.tvy_abx = r.tvy * r.abx;
  r.abx_pvx = r.abx * r.pvx;
  r.acx_qvx = r.acx * r.qvx;
  return r;
}

// sdf_pair_crossing for the voxel (px, py, pz) of row r.  The numerators
// of u, vv and tt and det are computed as there.  A pre-test without the
// divide then rejects the pair when it provably fails: with s the sign
// of det, u >= 0 needs s*un >= -1e-6 |det| (rn(un * inv) can be -0.0
// only when |un| < 2^-150 |det|), u <= 1 needs s*un <= 1.00001 |det|
// (inv = 1/det within 2^-24), and the same for vv, tt and u + vv.  Only
// pairs that pass it take the divide and the exact tests of
// sdf_pair_crossing, so the result is the same.
__device__ __forceinline__ int sdf_cross_voxel(const SdfCrossRow& r,
                                               float px, float dxr,
                                               float dyr, float dzr) {
  const float pvy = r.dzr_acx - dxr * r.acz;
  const float pvz = dxr * r.acy - r.dyr_acx;
  const float det = r.abx_pvx + r.aby * pvy + r.abz * pvz;
  const float tvx = px - r.ax;
  const float un = tvx * r.pvx + r.tvy * pvy + r.tvz * pvz;
  const float qvy = r.tvz_abx - tvx * r.abz;
  const float qvz = tvx * r.aby - r.tvy_abx;
  const float vn = dxr * r.qvx + dyr * qvy + dzr * qvz;
  const float tn = r.acx_qvx + r.acy * qvy + r.acz * qvz;
  const float D = fabsf(det);
  const bool neg = det < 0.0f;
  const float U = neg ? -un : un, V = neg ? -vn : vn, T = neg ? -tn : tn;
  const float lo = -1e-6f * D, hi = D * 1.00001f;
  if (!(D > 1e-7f && U >= lo && V >= lo && T >= lo && U <= hi &&
        U + V <= hi))
    return 0;
  const float inv = 1.0f / det;  // ok holds: as 1.0f / (ok ? det : 1.0f)
  const float u = un * inv, vv = vn * inv, tt = tn * inv;
  return (u >= 0.0f && u <= 1.0f && vv >= 0.0f && u + vv <= 1.0f &&
          tt >= 0.0f)
             ? 1
             : 0;
}

// sdf_cross_voxel in two parts, for csrc/sdf_grid.cu: sdf_cross_pre
// computes det and the numerators and runs the pre-test, sdf_cross_exact
// finishes a pair that passed it.  The operations and their order are
// those of sdf_cross_voxel, so sdf_cross_exact(sdf_cross_pre(...)) where
// `pass` holds, and 0 elsewhere, is its result bit for bit.  A caller
// can thus run the pre-test of several voxels, count the pairs that pass
// and branch once for all of them.  Five of sdf_cross_pre's operations
// depend on the triangle and px only (dxr * acz, dxr * acy, tvx, tvx *
// abz, tvx * aby): a caller that holds voxels of one x in several rows
// computes them once for those rows (the compiler merges the identical
// operations).
struct SdfCrossPre {
  float det, un, vn, tn;
  bool pass;
};

__device__ __forceinline__ SdfCrossPre sdf_cross_pre(const SdfCrossRow& r,
                                                     float px, float dxr,
                                                     float dyr, float dzr) {
  SdfCrossPre q;
  const float pvy = r.dzr_acx - dxr * r.acz;
  const float pvz = dxr * r.acy - r.dyr_acx;
  q.det = r.abx_pvx + r.aby * pvy + r.abz * pvz;
  const float tvx = px - r.ax;
  q.un = tvx * r.pvx + r.tvy * pvy + r.tvz * pvz;
  const float qvy = r.tvz_abx - tvx * r.abz;
  const float qvz = tvx * r.aby - r.tvy_abx;
  q.vn = dxr * r.qvx + dyr * qvy + dzr * qvz;
  q.tn = r.acx_qvx + r.acy * qvy + r.acz * qvz;
  // U, V and T are those of sdf_cross_voxel: the product with
  // copysign(1, det) negates exactly where det < 0 (and at det = -0,
  // where D fails the test either way), in one multiply each.
  const float D = fabsf(q.det), s = copysignf(1.0f, q.det);
  const float U = q.un * s, V = q.vn * s, T = q.tn * s;
  const float lo = -1e-6f * D, hi = D * 1.00001f;
  q.pass = D > 1e-7f && U >= lo && V >= lo && T >= lo && U <= hi &&
           U + V <= hi;
  return q;
}

__device__ __forceinline__ int sdf_cross_exact(const SdfCrossPre& q) {
  const float inv = 1.0f / q.det;  // q.pass implies |det| > 1e-7
  const float u = q.un * inv, vv = q.vn * inv, tt = q.tn * inv;
  return (u >= 0.0f && u <= 1.0f && vv >= 0.0f && u + vv <= 1.0f &&
          tt >= 0.0f)
             ? 1
             : 0;
}
