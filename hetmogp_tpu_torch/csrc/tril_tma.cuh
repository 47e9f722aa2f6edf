// Shared machinery of the TMA-fed triangular products, Hopper (sm_90a):
// tril_proj_kernel.cu (kernel A, float32 FFMA), tril_proj3_kernel.cu
// (kernel 3, three bf16 wgmma passes), tril_right_kernel.cu (kernel 4,
// kernel A's mirror) and tril_right3_kernel.cu (kernel 5, kernel 3's
// mirror, which takes the device and host helpers below and walks its own
// schedule, tril_right3_plan.cuh).
//
// Kernels A and 3 compute out[q, n, k] = sum_{m <= k} A[q, n, m] L[q, k, m]
// over a (Q, N, M) x (Q, M, M) batch, kernel 4 the mirror
// out[q, n, k] = sum_{m >= k} A[q, n, m] L[q, m, k], whose column tile
// [k0, k0 + BN) reduces from m = k0 to M (it walks the tiles below with
// ct -> C - 1 - ct, so the heaviest still come first and a pair is still
// C + 1 blocks long; tril_tiles.cuh).  All take the same shape of
// pipeline:
//
//   * one producer thread (lane 0 of the last warp of the block) issues TMA
//     loads (cp.async.bulk.tensor) of A's and L's tiles into a ring of
//     shared-memory stages; each stage has a "full" mbarrier (the producer
//     arms it with the stage's byte count, the TMA unit completes it) and an
//     "empty" mbarrier (each consumer warp arrives once it has read the
//     stage);
//   * the consumer warps wait on "full", compute, and release on "empty";
//     they never stage, transpose or barrier the whole block;
//   * persistent blocks, at most one per SM, walk work units of output
//     tiles in a static snake order: block b takes unit b on its first
//     turn, unit 2G - 1 - b on its second, and so on.  A column tile
//     [k0, k0 + BN) runs its reduction to m = min(M, k0 + BN), so tiles
//     differ in length; a unit is either one tile, heaviest first, or the
//     pair of column tiles C - 1 - p and p of one row tile, which are
//     equally long together (see Tiles).  No tile list and no counter
//     live in device memory, so a launch records into a CUDA graph as it
//     is.
//
// Tiles land 128-byte swizzled: a row of 128 bytes holds eight 16-byte
// chunks, and chunk c of row r sits at chunk c ^ (r % 8).  Consumers read
// with the same XOR; wgmma's descriptors name the layout.  (Kernel 4's L
// tile is the exception: its 512-byte rows land as they are stored.)
//
// The tensor maps are encoded on the host for every launch (they are
// kernel parameters, __grid_constant__, so a captured graph keeps them by
// value) through cuTensorMapEncodeTiled, found with
// cudaGetDriverEntryPoint: no link against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tril_tiles.cuh"  // Tiles: the schedule

namespace tril_tma {

// ---- device side -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the TMA unit and the other
// threads (followed by a __syncthreads() in the caller).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that cannot end (a byte count that never arrives) traps, so a fault shows
// as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// TMA: the box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completes `bytes` of the barrier's transaction.
// Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Byte offset of float32 element (r, c) in a 128-byte-swizzled tile of
// 32 floats a row.
__device__ __forceinline__ uint32_t swz_f32(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2));
}

// The ring's position: stage slot and the parity of its current use.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D tiled map of a (d2, d1, d0) array (d0 innermost, rows `row_bytes`
// apart, planes `plane_bytes` apart) with boxes of (1, box1, box0),
// 128-byte swizzled unless told otherwise (an unswizzled box may have rows
// longer than 128 bytes).  Returns 0, or a negative CUresult.
inline int encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t row_bytes, uint64_t plane_bytes, uint32_t box0,
                     uint32_t box1,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// The schedule of Q latents of R x C tiles on this device's SMs
// (tril_tiles.cuh: make_tiles_on).
inline Tiles make_tiles(int Q, int R, int C) {
  return make_tiles_on(Q, R, C, sm_count());
}

// Persistent grid size: one block per SM, at most one per work unit.
inline int persistent_blocks(const Tiles& t) {
  return persistent_blocks_on(t, sm_count());
}

}  // namespace tril_tma
