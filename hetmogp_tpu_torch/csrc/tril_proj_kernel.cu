// Batched triangular projection on Hopper (sm_90a), full float32.
//
//   out[q, n, k] = sum_{m <= k} A[q, n, m] * L[q, k, m]      (A tril(L)^T)
//
// A (Q, N, M) and L (Q, M, M), contiguous float32 row-major, giving out
// (Q, N, M) float32.  L's strictly upper entries are never read: they count
// as zero whatever they hold.  Full float32 products accumulated in float32
// (FFMA), no TF32, no bf16.
//
// Replaces the Pallas TPU kernel tools/probe_pallas_proj.py: _proj_kernel
// (launched by pallas_proj), which forms the same P = Kfu iLuu^T of the
// trainer's VE projection and the VM solve through the cached inverse.  It
// computes the same function; it is not a block-by-block copy of it (the
// TPU kernel carries the sum in its output block across a sequential grid
// axis and splits f32 into three bf16 passes for the matrix unit).
//
// What bounds it on an H100: arithmetic.  At the trainer's shape (Q=4,
// N=3072, M=1024) the product is 1.29e10 triangular FLOP over 50 MB of
// operands, far above the card's FLOP-per-byte balance, and float32 without
// tensor cores peaks at 67 TFLOP/s.  So the design below spends its
// effort on the FFMA pipe and on not doing work: the reduction of a column
// tile [k0, k0 + 128) stops at m = k0 + 128, so L's zero blocks above the
// diagonal are never loaded or multiplied (half the FLOPs of the dense
// product at M=1024), and the tile that straddles the diagonal masks L's
// upper entries (m > k) to zero.
//
// Summation order: each output is one float32 FMA chain over
// increasing m, starting from zero.  That is cuBLAS's order too, which is
// why the results are bitwise equal to cuBLAS's A @ tril(L)^T on the card.
//
// tril_proj_tma_kernel (entry hetmogp_tril_proj_strided_f32: A and L read
// through their row and plane strides), for M % 4 == 0, 16-byte-aligned A
// and L and strides of a multiple of 16 bytes (TMA's stride rule; the
// caller pads a ragged M with zeros, ops/cuda_kernels.py::_tma_operands):
//    * tril_tma.cuh's pipeline: one producer thread issues TMA loads of A's
//      and L's 128 x 32 float32 tiles, 128-byte swizzled, into a ring of 4
//      stages; the 256 FMA threads wait on each stage's mbarrier and
//      release it, so no thread stages, transposes or waits at a block-wide
//      barrier;
//    * the producer is a whole warpgroup so that setmaxnreg can move its
//      registers to the FMA threads (40 for it, 232 for them): the 8 x 8
//      accumulator tile and two chunks' operands (2 x 64 registers) fit
//      without spills; at the 168 a 384-thread block gets otherwise, the
//      FMAs wait on shared-memory loads;
//    * persistent blocks walk the 128 x 128 output tiles (tril_tma.cuh's
//      schedule); the producer fills the next tile's stages during the
//      epilogue;
//    * each thread keeps an 8 x 8 register tile (rows ty + 16 i, columns
//      tx + 16 j) and reads float4s along m from both swizzled tiles, an
//      outer product of 8 A and 8 L float4s per 4-deep chunk: 16 FMAs per
//      16-byte shared read; the 16 L rows a warp reads hit 8 distinct
//      swizzle phases, so the reads are conflict-free, and the 2 A rows
//      are broadcasts;
//    * ragged N and out-of-range m and k arrive as TMA's zero fill; the
//      diagonal tile's m > k entries are masked as they are read.

#include <cuda_runtime.h>

#include "tril_tma.cuh"

// ---- the TMA-fed design ----------------------------------------------------

namespace tma_a {

constexpr int BM = 128;               // rows n per tile
constexpr int BN = 128;               // columns k per tile
constexpr int BK = 32;                // reduction depth m per stage (128 B)
constexpr int STAGES = 4;             // ring depth
constexpr int CONSUMERS = 256;        // FMA threads: 16 x 16, 8 x 8 each
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
// setmaxnreg: the producer warpgroup drops to 40 registers a thread and
// hands the rest to the FMA threads
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int TILE_BYTES = BM * BK * 4;  // one operand's tile of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// acc[i][j] += A[ty + 16 i][m0 .. m0 + 31] . L[tx + 16 j][m0 .. m0 + 31],
// one FMA at a time in increasing m.  MASK zeroes L[k][m] for m > k.  Row r
// of a swizzled tile holds its 16-byte chunk c at chunk c ^ (r % 8), and
// r % 8 is ty % 8 for every A row a thread reads and tx % 8 for every L
// row, so one XOR a chunk serves all eight rows.  Each 4-deep chunk is an
// outer product of 8 A and 8 L float4s: 256 FMAs for 16 shared reads.
template <bool MASK>
__device__ __forceinline__ void consume(const uint8_t* As, const uint8_t* Ls,
                                        float (&acc)[8][8], int tx, int ty,
                                        int m0, int k0) {
#pragma unroll 2
  for (int c = 0; c < BK / 4; ++c) {
    const uint8_t* ap = As + ty * 128 + (((c ^ ty) & 7) << 4);
    const uint8_t* lp = Ls + tx * 128 + (((c ^ tx) & 7) << 4);
    float4 a[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(ap + i * 16 * 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = *reinterpret_cast<const float4*>(lp + j * 16 * 128);
      if (MASK) {
        const int over = m0 + 4 * c - (k0 + tx + 16 * j);  // m - k
        l[j].x = over + 0 <= 0 ? l[j].x : 0.0f;
        l[j].y = over + 1 <= 0 ? l[j].y : 0.0f;
        l[j].z = over + 2 <= 0 ? l[j].z : 0.0f;
        l[j].w = over + 3 <= 0 ? l[j].w : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(reinterpret_cast<const float*>(&a[i])[e],
                           reinterpret_cast<const float*>(&l[j])[e],
                           acc[i][j]);
  }
}

}  // namespace tma_a

__global__ void __launch_bounds__(tma_a::THREADS, 1)
tril_proj_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                     const __grid_constant__ CUtensorMap mapL,
                     float* __restrict__ out, int N, int M,
                     tril_tma::Tiles tiles) {
  using namespace tma_a;
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
  if (warp >= CONSUMERS / 32) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (warp != CONSUMERS / 32 || lane != 0) return;
    tril_tma::Ring ring;
    for (int turn = 0;; ++turn) {
      const int u = tiles.index(turn, blockIdx.x, gridDim.x);
      if (u >= units) break;
      for (int part = 0; part < tiles.tiles_in(u); ++part) {
        int q, rt, ct;
        tiles.decode(u, part, q, rt, ct);
        const int stages = (min(M, (ct + 1) * BN) + BK - 1) / BK;
        for (int s = 0; s < stages; ++s) {
          tril_tma::mbar_wait(empty + ring.slot, ring.phase ^ 1);
          uint8_t* st = smem + ring.slot * STAGE_BYTES;
          uint64_t* bar = full + ring.slot;
          tril_tma::mbar_expect_tx(bar, STAGE_BYTES);
          tril_tma::tma_load_3d(st, &mapA, bar, s * BK, rt * BM, q);
          tril_tma::tma_load_3d(st + TILE_BYTES, &mapL, bar, s * BK, ct * BN,
                                q);
          ring.advance(STAGES);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty + 16 i
  tril_tma::Ring ring;
  for (int turn = 0;; ++turn) {
    const int u = tiles.index(turn, blockIdx.x, gridDim.x);
    if (u >= units) break;
    for (int part = 0; part < tiles.tiles_in(u); ++part) {
      int q, rt, ct;
      tiles.decode(u, part, q, rt, ct);
      const int n0 = rt * BM;
      const int k0 = ct * BN;
      const int stages = (min(M, k0 + BN) + BK - 1) / BK;

      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

      for (int s = 0; s < stages; ++s) {
        tril_tma::mbar_wait(full + ring.slot, ring.phase);
        const uint8_t* As = smem + ring.slot * STAGE_BYTES;
        const uint8_t* Ls = As + TILE_BYTES;
        const int m0 = s * BK;
        if (m0 + BK <= k0) {  // every m of the stage is below every k
          consume<false>(As, Ls, acc, tx, ty, m0, k0);
        } else {
          consume<true>(As, Ls, acc, tx, ty, m0, k0);
        }
        __syncwarp();
        if (lane == 0) tril_tma::mbar_arrive(empty + ring.slot);
        ring.advance(STAGES);
      }

      float* outq = out + (size_t)q * N * M;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + ty + 16 * i;
        if (n >= N) continue;
        float* row = outq + (size_t)n * M;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          if (k < M) row[k] = acc[i][j];
        }
      }
    }
  }
}

// Plain C entry points, bound with ctypes.  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success), or a
// negative CUresult when a tensor map cannot be encoded.  The caller checks
// shapes, dtype, contiguity and device; these check only what would make
// the launch itself invalid.

// The TMA-fed design: M % 4 == 0, A and L 16-byte aligned, and A's and
// L's rows and planes a_row, a_plane, l_row and l_plane floats apart, each
// a multiple of 4 (a TMA global stride is a multiple of 16 bytes): A may
// be a (Q, N, M) view of a wider array, L a (Q, M, M) one, read where
// they lie; TMA's bounds keep every load inside the view.
extern "C" int hetmogp_tril_proj_strided_f32(
    const float* A, long long a_row, long long a_plane, const float* L,
    long long l_row, long long l_plane, float* out, int Q, int N, int M,
    cudaStream_t stream) {
  using namespace tma_a;
  if (Q <= 0 || N <= 0 || M <= 0 || M % 4 != 0 || a_row < M ||
      l_row < M || a_plane < a_row * N || l_plane < l_row * M) {
    return (int)cudaErrorInvalidValue;
  }
  const long long R = (N + BM - 1) / BM;
  const long long C = (M + BN - 1) / BN;
  if (Q * R * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tril_proj_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap mapA, mapL;
  int err = tril_tma::encode_3d(&mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M,
                                N, Q, 4ull * a_row, 4ull * a_plane, BK, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapL, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, L, M, M,
                            Q, 4ull * l_row, 4ull * l_plane, BK, BN);
  if (err != 0) return err;
  const tril_tma::Tiles tiles = tril_tma::make_tiles(Q, (int)R, (int)C);
  // setmaxnreg.inc waits for registers the block holds: refuse a build
  // that gives it too few to hand over, rather than hang
  cudaFuncAttributes attr;
  const cudaError_t attr_err =
      cudaFuncGetAttributes(&attr, tril_proj_tma_kernel);
  if (attr_err != cudaSuccess) return (int)attr_err;
  if (attr.numRegs * tma_a::THREADS <
      PRODUCER_REGS * (tma_a::THREADS - CONSUMERS) +
          CONSUMER_REGS * CONSUMERS) {
    return (int)cudaErrorInvalidConfiguration;
  }
  tril_proj_tma_kernel<<<tril_tma::persistent_blocks(tiles),
                         tma_a::THREADS, SMEM_BYTES, stream>>>(mapA, mapL, out,
                                                               N, M, tiles);
  return (int)cudaGetLastError();
}
