// The CUDA runtime as a host build of a kernel source sees it, for the
// CPU tests: tests/test_torch_task_var_exp.py compiles
// hetmogp_tpu_torch/csrc/ve_tasks_kernel.cu with g++ against this header
// in place of CUDA's, after rewriting each launch `K<<<grid, block, 0,
// stream>>>(arg);` as `host_launch(grid, block, [&] { K(arg); });`, and
// tests/test_torch_blocked_chol.py compiles csrc/chol_panel_kernel.cu,
// its launch `K<<<grid, block, bytes, stream>>>(args);` rewritten as
// `host_launch(grid, block, bytes, [&] { K(args); });` and its dynamic
// shared memory (`extern __shared__ ... name[];`) as `host_dynamic_smem`,
// and tests/test_torch_chol_blocked_plan.py csrc/chol_blocked_kernel.cu
// (which includes the former) the same way.
// That source keeps its Hopper primitives behind small functions, defined
// there only under nvcc (`__CUDACC__`); this header supplies the host's:
// mbarriers (`mbar_init`, `mbar_arrive`, `mbar_wait` on a phase parity,
// `fence_barrier_init`), per-element asynchronous copies (`cp_async_elem`,
// done at once, and `cp_async_arrive`, an arrival), named barriers with a
// thread count (`named_barrier_sync`), `__shfl_sync` and `rsqrtf`; and
// kernel 10's: acquire loads and release adds on a counter (`ld_acquire`,
// `red_release_add`), a waiting thread's `backoff` (a yield), 16-byte
// asynchronous copies (`cp_async16`, done at once), the float64 mma
// (`dmma_884`, through shuffles), float4, double2, and
// the device queries of a persistent grid (HOST_SMS SMs, one block each).
//
// A launch runs its blocks one at a time, last block first, each as one
// std::thread a CUDA thread: threadIdx and blockIdx are thread-local, a
// __shared__ variable is a static (one block at a time shares it), the
// dynamic shared memory one buffer of the launch's size, __syncthreads a
// std::barrier of the block's threads and __syncwarp one of its warp's.
// Atomics are std::atomic_ref, __threadfence a sequentially consistent
// fence.  An mbarrier is its 64-bit word in shared memory, updated by
// compare-and-swap (pending arrivals, the count, the phase bit); a wait
// blocks until the phase of the other parity is reached, as the card's
// does.  A named barrier blocks until its count of threads has arrived; a
// shuffle goes through a slot a lane in the warp's buffer between two
// warp barriers.  So a kernel's barriers, roles, shared-memory trees and
// ticket counters run as they are written; its arithmetic is the host
// compiler's.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
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
#ifndef HOST_SMS
#define HOST_SMS 3
#endif
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = HOST_SMS;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          std::size_t) {
  *n = 1;
  return cudaSuccess;
}

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) double2 {
  double x, y;
};
inline double2 make_double2(double x, double y) { return double2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
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
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline int ld_acquire(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p)).load(
      std::memory_order_acquire);
}
inline void red_release_add(int* p, int v) {
  std::atomic_ref<int>(*p).fetch_add(v, std::memory_order_release);
}
inline void backoff() { std::this_thread::yield(); }
// 16-byte asynchronous copies, done at once
inline void cp_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}
template <typename T>
T __ldcg(const T* p) {
  return *p;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

// __shfl_sync: each lane puts its value in its slot of the warp's buffer
inline thread_local double* host_warp_slots = nullptr;
template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= sizeof(double), "a slot holds 8 bytes");
  double* slots = host_warp_slots;
  *reinterpret_cast<T*>(slots + threadIdx.x % 32) = v;
  __syncwarp();
  const T out = *reinterpret_cast<const T*>(slots + src % 32);
  __syncwarp();
  return out;
}

// mma.sync m8n8k4 in float64: lane l holds A[l / 4][l % 4], B[l % 4][l /
// 4] and D[l / 4][2 (l % 4) + {0, 1}]; A's and B's values pass through
// the warp's slots, in k order into each D
inline void dmma_884(double (&d)[2], double a, double b) {
  const int lane = threadIdx.x % 32;
  double* slots = host_warp_slots;
  double av[4], b0[4], b1[4];
  slots[lane] = a;
  __syncwarp();
  for (int k = 0; k < 4; ++k) av[k] = slots[(lane / 4) * 4 + k];
  __syncwarp();
  slots[lane] = b;
  __syncwarp();
  for (int k = 0; k < 4; ++k) {
    b0[k] = slots[(2 * (lane % 4)) * 4 + k];
    b1[k] = slots[(2 * (lane % 4) + 1) * 4 + k];
  }
  __syncwarp();
  for (int k = 0; k < 4; ++k) {
    d[0] = std::fma(av[k], b0[k], d[0]);
    d[1] = std::fma(av[k], b1[k], d[1]);
  }
}

// An mbarrier's word: bits 0-31 the arrivals pending, 32-62 the count, 63
// the phase.  Every change notifies the waiters.
inline void mbar_init(std::uint64_t* bar, std::uint32_t count) {
  std::atomic_ref<std::uint64_t>(*bar).store(
      (std::uint64_t(count) << 32) | count);
}
inline void mbar_arrive(std::uint64_t* bar) {
  std::atomic_ref<std::uint64_t> word(*bar);
  std::uint64_t v = word.load(), next;
  do {
    const std::uint32_t pending = std::uint32_t(v) - 1;
    const std::uint64_t count = (v >> 32) & 0x7fffffffu, phase = v >> 63;
    next = pending ? (v & ~0xffffffffull) | pending
                   : ((phase ^ 1) << 63) | (count << 32) | count;
  } while (!word.compare_exchange_weak(v, next));
  word.notify_all();
}
inline void mbar_wait(std::uint64_t* bar, std::uint32_t parity) {
  std::atomic_ref<std::uint64_t> word(*bar);
  for (std::uint64_t v = word.load();; v = word.load()) {
    if ((v >> 63) != parity) return;
    word.wait(v);
  }
}
inline void fence_barrier_init() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
// the copy is done at once; its arrival follows it
template <typename T>
void cp_async_elem(T* dst, const T* src) {
  *dst = *src;
}
inline void cp_async_arrive(std::uint64_t* bar) { mbar_arrive(bar); }

// bar.sync id, count: 16 barriers, each a generation counter
struct host_named_barrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned long generation = 0;
};
inline host_named_barrier host_named[16];
inline void named_barrier_sync(int id, int threads) {
  host_named_barrier& b = host_named[id];
  std::unique_lock<std::mutex> lock(b.m);
  const unsigned long g = b.generation;
  if (++b.arrived == threads) {
    b.arrived = 0;
    ++b.generation;
    b.cv.notify_all();
  } else {
    b.cv.wait(lock, [&] { return b.generation != g; });
  }
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
    std::vector<double> slots(32 * warps.size());
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([&kernel, &warps, &slots, t, b]() {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        host_warp_barrier = warps[t / 32].get();
        host_warp_slots = slots.data() + 32 * (t / 32);
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
