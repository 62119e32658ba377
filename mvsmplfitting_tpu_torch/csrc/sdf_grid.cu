// Brute-force SDF voxelizer: for every voxel of a G^3 grid, the minimum
// squared distance to all F triangles and the parity of the corner-ray
// crossings, then phi = sqrt(min d^2) at odd parity, else 0.
//
// Replaces the TPU kernel mvsmplfitting_tpu/ops/sdf.py:sdf_grid_pallas
// (pallas_call at :599).  It is off the fits' path (they use
// csrc/sdf_grid_fast.cu) and serves as that kernel's bitwise yardstick
// on the card, as the Pallas version does for its two-phase sibling.
//
// Bound on the H100: operations.  Every (voxel, triangle) pair costs
// ~176 fp32 operations (csrc/sdf_common.cuh); at G=128 and 13776 faces
// that is 2.9e10 pairs, 5.1e12 operations, against a few MB of input.
// Design: one thread per voxel keeps its running minimum and crossing
// count in registers; the block stages SDF_CHUNK triangles at a time in
// shared memory, where all threads read the same triangle at once (a
// broadcast), so device memory is read once per block per triangle.
// A launch voxelizes a batch of meshes: blockIdx.y is the mesh.

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

__global__ void __launch_bounds__(SDF_THREADS)
    sdf_grid_kernel(const float* __restrict__ tri, int F, int G, float dx,
                    float* __restrict__ phi) {
  __shared__ float s_tri[SDF_CHUNK * 9];
  const long N = (long)G * G * G;
  const long vox = (long)blockIdx.x * SDF_THREADS + threadIdx.x;
  const bool valid = vox < N;
  const long v = valid ? vox : 0;
  const float px = sdf_coord((int)(v % G), dx);
  const float py = sdf_coord((int)((v / G) % G), dx);
  const float pz = sdf_coord((int)(v / ((long)G * G)), dx);
  const float dxr = -1.0f - px, dyr = -1.0f - py, dzr = -1.0f - pz;
  const float* mesh = tri + (long)blockIdx.y * F * 9;

  float run_min = SDF_FAR_D2;
  int n_cross = 0;
  for (int f0 = 0; f0 < F; f0 += SDF_CHUNK) {
    const int nf = min(SDF_CHUNK, F - f0);
    __syncthreads();  // the previous chunk is no longer read
    sdf_stage_chunk(s_tri, mesh, f0, nf);
    __syncthreads();
    if (valid) {
      for (int j = 0; j < nf; ++j) {
        const float* t = s_tri + j * 9;
        run_min = fminf(run_min, sdf_pair_dist_sq(t, px, py, pz));
        n_cross += sdf_pair_crossing(t, px, py, pz, dxr, dyr, dzr);
      }
    }
  }
  if (valid)
    phi[(long)blockIdx.y * N + vox] = (n_cross & 1) ? sqrtf(run_min) : 0.0f;
}

}  // namespace

// tri: (M, F, 9) float32 meshes; phi: (M, G, G, G) float32 out, [z, y, x].
extern "C" int mvsf_sdf_grid(const float* tri, int M, int F, int G,
                             float dx, float* phi, void* stream) {
  if (M <= 0) return 0;
  const long N = (long)G * G * G;
  const dim3 grid((unsigned)((N + SDF_THREADS - 1) / SDF_THREADS),
                  (unsigned)M);
  sdf_grid_kernel<<<grid, SDF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, F, G, dx, phi);
  return (int)cudaGetLastError();
}
