// The CUDA runtime as a host build of a kernel source sees it, for the
// CPU tests: tests/test_torch_task_var_exp.py compiles
// hetmogp_tpu_torch/csrc/ve_tasks_kernel.cu with g++ against this header
// in place of CUDA's, after rewriting each launch `K<<<grid, block, 0,
// stream>>>(arg);` as `host_launch(grid, block, [&] { K(arg); });`, and
// tests/test_torch_blocked_chol.py compiles csrc/chol_panel_kernel.cu,
// its launch `K<<<grid, block, bytes, stream>>>(args);` rewritten as
// `host_launch(grid, block, bytes, [&] { K(args); });` and its dynamic
// shared memory (`extern __shared__ ... name[];`) as `host_dynamic_smem`.
//
// A launch runs its blocks one at a time, last block first, each as one
// std::thread a CUDA thread: threadIdx and blockIdx are thread-local, a
// __shared__ variable is a static (one block at a time shares it), the
// dynamic shared memory one buffer of the launch's size, __syncthreads a
// std::barrier of the block's threads and __syncwarp one of its warp's.
// Atomics are std::atomic_ref, __threadfence a sequentially consistent
// fence.  So a kernel's barriers, shared-memory trees and ticket counters
// run as they are written; its arithmetic is the host compiler's.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

using std::min;

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)

struct host_uint3 {
  unsigned x, y, z;
};
inline thread_local host_uint3 threadIdx, blockIdx;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline std::barrier<>* host_block_barrier = nullptr;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline thread_local std::barrier<>* host_warp_barrier = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp_barrier->arrive_and_wait();
}
inline unsigned char* host_dynamic_smem = nullptr;
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __trap() {
  std::fprintf(stderr, "trap\n");
  std::abort();
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
template <typename T>
T __ldcg(const T* p) {
  return *p;
}

template <typename F>
void host_launch(dim3 grid, dim3 block, std::size_t smem_bytes, F kernel) {
  std::vector<double> smem((smem_bytes + sizeof(double) - 1) /
                           sizeof(double));
  host_dynamic_smem = reinterpret_cast<unsigned char*>(smem.data());
  for (int b = (int)grid.x - 1; b >= 0; --b) {
    std::barrier<> bar((std::ptrdiff_t)block.x);
    host_block_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (unsigned w = 0; 32 * w < block.x; ++w) {
      warps.emplace_back(std::make_unique<std::barrier<>>(
          (std::ptrdiff_t)std::min(32u, block.x - 32 * w)));
    }
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([&kernel, &warps, t, b]() {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        host_warp_barrier = warps[t / 32].get();
        kernel();
      });
    }
    for (auto& th : threads) th.join();
  }
  host_dynamic_smem = nullptr;
}

template <typename F>
void host_launch(dim3 grid, dim3 block, F kernel) {
  host_launch(grid, block, 0, kernel);
}
