// Batched triangular projection in three bf16 tensor-core passes, Hopper
// (sm_90a).
//
//   out[q, n, k] = sum_{m <= k} A[q, n, m] * L[q, k, m]      (A tril(L)^T)
//
// A (Q, N, M) and L (Q, M, M), contiguous float32 row-major, giving out
// (Q, N, M) float32.  L's strictly upper entries are never read.  Each
// float32 operand x is split into two bf16 values:
//
//   hi = x with its low 16 bits cleared (bits & 0xFFFF0000: exact in bf16)
//   lo = bf16_rn(x - hi)                 (x - hi is exact in float32)
//
// and every 16-deep step of the reduction adds lo*hi + hi*lo, then hi*hi,
// to a float32 accumulator on the tensor cores (bf16 operands, f32
// accumulation).  The lo*lo term (below 2^-14 of |a l|) is dropped.  That
// is the "high" precision of the trainer's VE projection P = Kfu iLuu^T:
// ve_fwd_precision="high".  The split is made with integer masks, not with
// a float32 -> bf16 -> float32 round trip, which a compiler may fold away.
//
// Replaces the Pallas TPU kernel tools/probe_pallas_proj.py:
// _proj_kernel_presplit (launched by pallas_proj2), which takes the same
// bit-mask split, but made by XLA before the kernel as four pre-split
// arrays in device memory (~50 MB of extra traffic a call at the trainer's
// shape, which is why the TPU prototype lost to XLA).
//
// What bounds it on an H100: at the trainer's shape (Q=4, N=3072, M=1024)
// the three passes are 3 x 1.29e10 triangular FLOP, 0.039 ms at the card's
// 989 TFLOP/s of dense bf16, against 117 MB of operands and output, 0.035 ms
// at 3.35 TB/s: about balanced, so the design has both wgmma and a TMA
// pipeline.
//
// tril_proj3_tma_kernel (entry hetmogp_tril_proj3_f32), for M % 4 == 0 and
// 16-byte-aligned A (TMA's stride rule; the caller pads a ragged M with
// zeros, ops/cuda_kernels.py::_tma_operands):
//    * a pre-pass, tril_split_bf16_kernel in the same launch, reads L once
//      and writes tril(L)'s hi and lo as two bf16 (Q, M, Mp) arrays (Mp = M
//      rounded up to 8, so rows are 16-byte multiples), the upper triangle
//      as exact zeros: ~0.01 ms at M = 1024, and the diagonal tile needs no
//      mask;
//    * tril_tma.cuh's pipeline: one producer thread issues TMA loads of A's
//      float32 128 x 64 tile (two 128-byte-swizzled boxes of 32 floats a
//      row) and of L's hi and lo 128 x 64 bf16 tiles (128-byte swizzled,
//      wgmma's canonical K-major layout) into a ring of 3 stages of 64 KB;
//    * two consumer warpgroups each own 64 rows of a 128 x 128 output tile
//      (wgmma m64n128k16, a 64-float accumulator a thread); per 16-deep
//      step a warp reads its A fragment (the mma.sync m16n8k16 A layout)
//      from the swizzled float32 tile, splits it in registers, and feeds
//      alo and ahi to wgmma as its register A operand, so A is never
//      written back split; B (L's hi or lo) is read by wgmma from shared
//      memory through a descriptor;
//    * per 64-deep stage the warpgroup issues 12 wgmmas (alo lhi, ahi llo,
//      ahi lhi for each 16-deep step, in that order; each step's fragment
//      is split while the last step's products run) as one commit group,
//      waits on it, and releases the stage; the other warpgroup's products
//      run on the tensor cores meanwhile.  The 64 x 128 accumulator and the
//      fragments fit in the 168 registers a thread of a 288-thread block
//      gets, so no setmaxnreg;
//    * persistent blocks walk the tiles heaviest first; a column tile
//      [k0, k0 + 128) runs its reduction to min(M, k0 + 128) and never
//      loads L's zero blocks; ragged N, and m or k past M, arrive as TMA's
//      zero fill and are clipped in the stores.
// Summation order: per output, a float32 sum over 16-deep steps, each
// step's products summed inside the tensor core.  It is not the plain
// version's order: check both against a float64 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tril_tma.cuh"

// ---- the wgmma and TMA design ----------------------------------------------

namespace tma3 {

constexpr int BM = 128;               // rows n per tile: two warpgroups of 64
constexpr int BN = 128;               // columns k per tile
constexpr int BK = 64;                // reduction depth m per stage
constexpr int STAGES = 3;             // ring depth
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BOX = BM * 32 * 4;    // one box of A: 128 rows x 32 floats
constexpr int L_TILE = BN * BK * 2;   // L's hi or lo: 128 rows x 64 bf16
constexpr int STAGE_BYTES = 2 * A_BOX + 2 * L_TILE;  // 64 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int SPLIT_THREADS = 256;

// The bit-mask split of two float32 (x.x in the low half): hi's and lo's
// bf16 pairs.
__device__ __forceinline__ void split2(float2 x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(x.x) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(x.y) & 0xFFFF0000u;
  hi = (h0 >> 16) | h1;
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - __uint_as_float(h0),
                                                  x.y - __uint_as_float(h1));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// hi and lo of tril(L), two (Q, M, Mp) bf16 arrays: element (q, k, m) is
// the split of L[q, k, m] for m <= k < M and zero elsewhere (m > k, and the
// pad columns M <= m < Mp).
__global__ void __launch_bounds__(SPLIT_THREADS)
tril_split_bf16_kernel(const float* __restrict__ L, uint32_t* __restrict__ hi,
                       uint32_t* __restrict__ lo, int M, int Mp,
                       long long pairs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;
    const long long row = e / Mp;  // q * M + k
    const int m = (int)(e - row * Mp);
    const int k = (int)(row % M);
    const float* src = L + row * M;
    const float2 x = make_float2(m <= k && m < M ? src[m] : 0.0f,
                                 m + 1 <= k && m + 1 < M ? src[m + 1] : 0.0f);
    split2(x, hi[i], lo[i]);
  }
}

// wgmma descriptor of a 128-byte-swizzled K-major tile at p (1024-byte
// aligned): rows of 128 bytes, 8-row groups 1024 bytes apart.  Adding 2
// moves it 16 bf16 deeper along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((tril_tma::smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128 over the warpgroup) += a (64 x 16, bf16 registers) b, with b
// the K-major 16 x 128 bf16 tile named by desc (it holds b^T's rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Kernel 3, out = A tril(L)^T, L's hi and lo tiles K-major (rows k of
// 64 m).
__global__ void __launch_bounds__(THREADS, 1)
tril_proj3_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                      const __grid_constant__ CUtensorMap mapHi,
                      const __grid_constant__ CUtensorMap mapLo,
                      float* __restrict__ out, int N, int M,
                      tril_tma::Tiles tiles) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tril_tma::mbar_init(full + s, 1);
      tril_tma::mbar_init(empty + s, CONSUMERS / 32);
    }
    tril_tma::fence_barrier_init();
  }
  __syncthreads();

  const int units = tiles.units();
  if (warp == CONSUMERS / 32) {  // the producer
    if (lane != 0) return;
    tril_tma::Ring ring;
    for (int turn = 0;; ++turn) {
      const int u = tiles.index(turn, blockIdx.x, gridDim.x);
      if (u >= units) break;
      for (int part = 0; part < tiles.tiles_in(u); ++part) {
        int q, rt, ct;
        tiles.decode(u, part, q, rt, ct);
        const int m_end = min(M, (ct + 1) * BN);
        const int stages = (m_end + BK - 1) / BK;
        for (int s = 0; s < stages; ++s) {
          tril_tma::mbar_wait(empty + ring.slot, ring.phase ^ 1);
          uint8_t* st = smem + ring.slot * STAGE_BYTES;
          uint64_t* bar = full + ring.slot;
          const int m0 = s * BK;
          tril_tma::mbar_expect_tx(bar, STAGE_BYTES);
          tril_tma::tma_load_3d(st, &mapA, bar, m0, rt * BM, q);
          tril_tma::tma_load_3d(st + A_BOX, &mapA, bar, m0 + 32, rt * BM, q);
          uint8_t* lt = st + 2 * A_BOX;
          tril_tma::tma_load_3d(lt, &mapHi, bar, m0, ct * BN, q);
          tril_tma::tma_load_3d(lt + L_TILE, &mapLo, bar, m0, ct * BN, q);
          ring.advance(STAGES);
        }
      }
    }
    return;
  }

  // the warp's 16 rows of its warpgroup's 64: fragment rows r0 and r0 + 8
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + g;
  tril_tma::Ring ring;
  for (int turn = 0;; ++turn) {
    const int u = tiles.index(turn, blockIdx.x, gridDim.x);
    if (u >= units) break;
    for (int part = 0; part < tiles.tiles_in(u); ++part) {
      int q, rt, ct;
      tiles.decode(u, part, q, rt, ct);
      const int n0 = rt * BM;
      const int k0 = ct * BN;
      const int m_end = min(M, k0 + BN);
      const int stages = (m_end + BK - 1) / BK;

      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      fence_acc(acc);

      for (int s = 0; s < stages; ++s) {
        tril_tma::mbar_wait(full + ring.slot, ring.phase);
        const uint8_t* st = smem + ring.slot * STAGE_BYTES;
        // a 16-deep step is 32 bytes on along a K-major row (descriptor
        // units of 16 bytes)
        const uint64_t dhi = sw128_desc(st + 2 * A_BOX);
        const uint64_t dlo = sw128_desc(st + 2 * A_BOX + L_TILE);
        constexpr int STEP = 2;
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16-deep steps: A box kk / 2
          // this step's A fragment, split while the last step's products
          // run; its registers are fresh, so the running ones never see
          // them change
          const uint8_t* box = st + (kk >> 1) * A_BOX;
          const int c = (kk & 1) * 16 + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0, c));
          const float2 x1 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0 + 8, c));
          const float2 x2 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0, c + 8));
          const float2 x3 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0 + 8, c + 8));
          split2(x0, ahi[kk][0], alo[kk][0]);
          split2(x1, ahi[kk][1], alo[kk][1]);
          split2(x2, ahi[kk][2], alo[kk][2]);
          split2(x3, ahi[kk][3], alo[kk][3]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // the small terms first
          wgmma_rs(acc, alo[kk], dhi + STEP * kk);
          wgmma_rs(acc, ahi[kk], dlo + STEP * kk);
          wgmma_rs(acc, ahi[kk], dhi + STEP * kk);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        __syncwarp();
        if (lane == 0) tril_tma::mbar_arrive(empty + ring.slot);
        ring.advance(STAGES);
      }

      // accumulator 4 j + 2 h + e: row r0 + 8 h, column 8 j + 2 t4 + e
      float* outq = out + (size_t)q * N * M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + r0 + 8 * h;
        if (n >= N) continue;
        float* row = outq + (size_t)n * M;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = k0 + 8 * j + 2 * t4;
          if (k < M) {  // M % 4 == 0, k even: k + 1 < M too
            *reinterpret_cast<float2*>(row + k) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

}  // namespace tma3

// Plain C entry points, bound with ctypes.  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success), or a
// negative CUresult when a tensor map cannot be encoded.  The caller checks
// shapes, dtype, contiguity and device; these check only what would make
// the launch itself invalid.

namespace tma3 {

// Kernel 3's wgmma and TMA entry: the split pre-pass, then the kernel,
// which loads L's hi and lo as 64 m x 128 k boxes of rows k.
int launch(const float* A, const float* L, float* out, void* Lhi, void* Llo,
           int Q, int N, int M, cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || M <= 0 || M % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long R = (N + BM - 1) / BM;
  const long long C = (M + BN - 1) / BN;
  if (Q * R * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long Mp = (M + 7) / 8 * 8;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tril_proj3_tma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap mapA, mapHi, mapLo;
  int err = tril_tma::encode_3d(&mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M,
                                N, Q, 4ull * M, 4ull * N * M, 32, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapHi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Lhi, M,
                            M, Q, 2ull * Mp, 2ull * M * Mp, BK, BN);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapLo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Llo, M,
                            M, Q, 2ull * Mp, 2ull * M * Mp, BK, BN);
  if (err != 0) return err;

  const long long pairs = Q * (long long)M * Mp / 2;
  const long long split_blocks = (pairs + SPLIT_THREADS - 1) / SPLIT_THREADS;
  tril_split_bf16_kernel<<<(unsigned)(split_blocks < 4096 ? split_blocks
                                                          : 4096),
                           SPLIT_THREADS, 0, stream>>>(
      L, static_cast<uint32_t*>(Lhi), static_cast<uint32_t*>(Llo), M, (int)Mp,
      pairs);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return (int)split_err;

  const tril_tma::Tiles tiles = tril_tma::make_tiles(Q, (int)R, (int)C);
  tril_proj3_tma_kernel<<<tril_tma::persistent_blocks(tiles), THREADS,
                          SMEM_BYTES, stream>>>(mapA, mapHi, mapLo, out, N, M,
                                                tiles);
  return (int)cudaGetLastError();
}

}  // namespace tma3

// Kernel 3's wgmma and TMA design: M % 4 == 0 and A 16-byte aligned.  Lhi
// and Llo are the caller's scratch, (Q, M, Mp) bf16 each with Mp = M
// rounded up to a multiple of 8, 16-byte aligned; the pre-pass fills them.
extern "C" int hetmogp_tril_proj3_f32(const float* A, const float* L,
                                      float* out, void* Lhi, void* Llo, int Q,
                                      int N, int M, cudaStream_t stream) {
  return tma3::launch(A, L, out, Lhi, Llo, Q, N, M, stream);
}
