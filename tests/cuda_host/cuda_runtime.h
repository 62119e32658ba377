// Host stand-in for <cuda_runtime.h>: lets the port's CUDA sources
// compile with g++ and run on the CPU in tests
// (tests/test_torch_kernel_sources.py).  Each block runs its threads as
// std::threads; __syncthreads is a barrier over the block and
// __syncwarp one over the 32 threads that call it.  Blocks run one
// after another, so `__shared__` arrays become function statics.  The
// kernel launch `k<<<grid, block, smem, stream>>>(args)` is rewritten by
// the test into `emu_launch(grid, block, [&] { k(args); })`.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)

struct emu_dim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx;
inline emu_dim3 blockIdx;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::barrier<>* emu_warp_barrier = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barrier->arrive_and_wait(); }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class F>
void emu_launch(int grid, int block, F body) {
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> block_barrier(block), warp_barrier(32);
    emu_block_barrier = &block_barrier;
    emu_warp_barrier = &warp_barrier;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
