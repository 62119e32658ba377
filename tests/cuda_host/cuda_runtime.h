// Host stand-in for <cuda_runtime.h>: lets the port's CUDA sources
// compile with g++ and run on the CPU in tests
// (tests/test_torch_kernel_sources.py).  Each block runs its threads as
// std::threads; __syncthreads is a barrier over the block,
// __syncthreads_or one with an or-reduction of the threads' predicates.
// Each warp of 32 threads has its own barrier (__syncwarp) and exchange
// slots, through which the shuffles and the votes pass values (all
// 32 lanes must take part, as with a full mask on the card).  atomicAdd
// is a std::atomic_ref add.  Blocks run one after another (over
// blockIdx.y, then x), so `__shared__` arrays become function statics.
// gridDim is the launch's grid.
// The kernel launch `k<<<grid, block, smem, stream>>>(args)` is
// rewritten by the test into `emu_launch(grid, block, smem, [&] {
// k(args); })`, and a dynamic shared array `extern __shared__ T name[];`
// into a pointer to `emu_dynamic_smem`, a buffer of `smem` bytes per
// block filled with 0xff bytes (NaN as float), so that reading shared
// memory no thread wrote shows in the results.
// cudaFuncSetAttribute does nothing.
// The sources' asynchronous copies (cp.async, behind __CUDA_ARCH__) run
// here as plain copies, so only the card checks their synchronization.
#pragma once
#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
struct alignas(16) float4 {
  float x, y, z, w;
};

struct emu_warp_state {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};

inline thread_local emu_dim3 threadIdx;
inline emu_dim3 blockIdx;
inline emu_dim3 gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;
inline thread_local emu_warp_state* emu_warp = nullptr;
inline std::atomic<int> emu_or_acc{0};
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp->bar.arrive_and_wait();
}
inline int __syncthreads_or(int pred) {
  emu_block_barrier->arrive_and_wait();  // earlier readers are done
  if (threadIdx.x == 0) emu_or_acc.store(0);
  emu_block_barrier->arrive_and_wait();
  if (pred) emu_or_acc.fetch_or(1);
  emu_block_barrier->arrive_and_wait();
  return emu_or_acc.load();
}

// Every lane posts v, then reads the value lane `src` posted.
template <class T>
T emu_exchange(T v, int src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "one slot a lane");
  unsigned long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp->slot[threadIdx.x & 31] = bits;
  emu_warp->bar.arrive_and_wait();
  bits = emu_warp->slot[src & 31];
  emu_warp->bar.arrive_and_wait();  // every lane has read before a repost
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_exchange(v, (threadIdx.x & 31) ^ lane_mask);
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, lane >= (int)delta ? lane - (int)delta : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  emu_warp->slot[threadIdx.x & 31] = pred ? 1 : 0;
  emu_warp->bar.arrive_and_wait();
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= (emu_warp->slot[l] ? 1u : 0u) << l;
  emu_warp->bar.arrive_and_wait();
  return out;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline void* emu_dynamic_smem = nullptr;

template <class F>
void emu_launch(dim3 grid, int block, int smem_bytes, F body) {
  std::vector<float4> dynamic_smem((smem_bytes + 15) / 16 + 1);
  emu_dynamic_smem = dynamic_smem.data();
  gridDim.x = (int)grid.x;
  gridDim.y = (int)grid.y;
  gridDim.z = (int)grid.z;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx.x = (int)bx;
      blockIdx.y = (int)by;
      std::memset(dynamic_smem.data(), 0xff,
                  dynamic_smem.size() * sizeof(float4));
      std::barrier<> block_barrier(block);
      emu_block_barrier = &block_barrier;
      std::vector<std::unique_ptr<emu_warp_state>> warps;
      for (int w = 0; w < (block + 31) / 32; ++w)
        warps.push_back(std::make_unique<emu_warp_state>());
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, t] {
          threadIdx.x = t;
          emu_warp = warps[t / 32].get();
          body();
        });
      for (auto& th : threads) th.join();
    }
}
