// Asynchronous 16-byte copies from device to shared memory (cp.async,
// sm_80+), their commit and their wait, shared by the port's kernels.
// Compiled for the host (the tests' stand-in for the CUDA runtime) they
// are a plain copy and no-ops, so only the card checks the
// synchronization around them.
#pragma once

__device__ __forceinline__ void async_copy16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
#else
  *static_cast<float4*>(smem) = *static_cast<const float4*>(gmem);
#endif
}

__device__ __forceinline__ void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}
