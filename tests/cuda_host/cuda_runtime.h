// Host stand-in for <cuda_runtime.h>: lets the port's CUDA sources
// compile with g++ and run on the CPU in tests
// (tests/test_torch_kernel_sources.py).  Each block runs its threads as
// std::threads; __syncthreads is a barrier over the block,
// __syncthreads_or one with an or-reduction of the threads' predicates,
// and __syncwarp one over the 32 threads that call it.  Blocks run one
// after another (over blockIdx.y, then x), so `__shared__` arrays become
// function statics.  The kernel launch `k<<<grid, block, smem,
// stream>>>(args)` is rewritten by the test into
// `emu_launch(grid, block, [&] { k(args); })`.
#pragma once
#include <math.h>

#include <algorithm>
#include <atomic>
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
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local emu_dim3 threadIdx;
inline emu_dim3 blockIdx;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::barrier<>* emu_warp_barrier = nullptr;
inline std::atomic<int> emu_or_acc{0};
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barrier->arrive_and_wait(); }
inline int __syncthreads_or(int pred) {
  emu_block_barrier->arrive_and_wait();  // earlier readers are done
  if (threadIdx.x == 0) emu_or_acc.store(0);
  emu_block_barrier->arrive_and_wait();
  if (pred) emu_or_acc.fetch_or(1);
  emu_block_barrier->arrive_and_wait();
  return emu_or_acc.load();
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class F>
void emu_launch(dim3 grid, int block, F body) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx.x = (int)bx;
      blockIdx.y = (int)by;
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
