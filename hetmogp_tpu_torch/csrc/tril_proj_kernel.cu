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
// tensor cores peaks at 67 TFLOP/s.  So both designs below spend their
// effort on the FFMA pipe and on not doing work: the reduction of a column
// tile [k0, k0 + 128) stops at m = k0 + 128, so L's zero blocks above the
// diagonal are never loaded or multiplied (half the FLOPs of the dense
// product at M=1024), and the tile that straddles the diagonal masks L's
// upper entries (m > k) to zero.
//
// Summation order, in both: each output is one float32 FMA chain over
// increasing m, starting from zero.  That is cuBLAS's order too, which is
// why the results are bitwise equal to cuBLAS's A @ tril(L)^T on the card.
//
// 1. tril_proj_tma_kernel (entry hetmogp_tril_proj_f32), the main path's
//    design, for M % 4 == 0 and 16-byte-aligned A (TMA's stride rule):
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
// 2. tril_proj_kernel (entry hetmogp_tril_proj_staged_f32), the previous
//    design, for every other shape (M % 4 != 0 or unaligned bases): one
//    block per tile, the 256 threads stage both tiles through registers
//    transposed into shared memory, one stage ahead, with two block-wide
//    barriers per stage; ragged N and M are masked in loads and stores.

#include <cuda_runtime.h>

#include "tril_tma.cuh"

namespace {

constexpr int BR = 128;   // rows n per block
constexpr int BC = 128;   // columns k per block
constexpr int BD = 16;    // reduction depth m per stage
constexpr int PAD = 4;    // shared-memory row padding (keeps float4 alignment)
constexpr int THREADS = 256;
// float4 groups each thread stages per operand and stage (2)
constexpr int LOADS = BR * BD / 4 / THREADS;

// Four consecutive elements row[c], ..., row[c + 3] with c + j < lim zeroed
// past the limit; one float4 load when the row is 16-byte aligned and all
// four are in range.
__device__ __forceinline__ float4 load4(const float* row, int c, int lim,
                                        bool vec) {
  if (vec && c + 3 < lim) return *reinterpret_cast<const float4*>(row + c);
  float4 v;
  v.x = (c + 0 < lim) ? row[c + 0] : 0.0f;
  v.y = (c + 1 < lim) ? row[c + 1] : 0.0f;
  v.z = (c + 2 < lim) ? row[c + 2] : 0.0f;
  v.w = (c + 3 < lim) ? row[c + 3] : 0.0f;
  return v;
}

__global__ void __launch_bounds__(THREADS)
tril_proj_kernel(const float* __restrict__ A, const float* __restrict__ L,
                 float* __restrict__ out, int N, int M, int col_tiles,
                 bool vec) {
  __shared__ __align__(16) float As[BD][BR + PAD];
  __shared__ __align__(16) float Ls[BD][BC + PAD];

  const int q = blockIdx.y;
  const int bid = blockIdx.x;
  const int ct = col_tiles - 1 - bid % col_tiles;  // heaviest tiles first
  const int n0 = (bid / col_tiles) * BR;
  const int k0 = ct * BC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 + {0..3}, +64
  const int ty = tid / 16;  // row group: rows ty*4 + {0..3}, +64

  const float* Aq = A + (size_t)q * N * M;
  const float* Lq = L + (size_t)q * M * M;

  // m stops at the column tile's end: L[k, m] = 0 for m > k, and k < k0 + BC
  const int m_end = min(M, k0 + BC);
  const int stages = (m_end + BD - 1) / BD;

  // staging map: thread loads rows lr + 64 * i, columns lc .. lc + 3
  const int lr = tid / 4;
  const int lc = (tid % 4) * 4;

  float4 ra[LOADS], rl[LOADS];
  auto fetch = [&](int s) {
    const int m0 = s * BD;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = lr + 64 * i;
      const int n = n0 + r;
      const int k = k0 + r;
      ra[i] = (n < N) ? load4(Aq + (size_t)n * M, m0 + lc, M, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      // L[k, m] for m <= k only: the limit is min(M, k + 1)
      rl[i] = (k < M) ? load4(Lq + (size_t)k * M, m0 + lc, min(M, k + 1), vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = lr + 64 * i;
      As[lc + 0][r] = ra[i].x;
      As[lc + 1][r] = ra[i].y;
      As[lc + 2][r] = ra[i].z;
      As[lc + 3][r] = ra[i].w;
      Ls[lc + 0][r] = rl[i].x;
      Ls[lc + 1][r] = rl[i].y;
      Ls[lc + 2][r] = rl[i].z;
      Ls[lc + 3][r] = rl[i].w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stage();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) fetch(s + 1);
#pragma unroll
    for (int mm = 0; mm < BD; ++mm) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[mm][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[mm][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ls[mm][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ls[mm][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (s + 1 < stages) {
      stage();
      __syncthreads();
    }
  }

  float* outq = out + (size_t)q * N * M;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (n >= N) continue;
    float* row = outq + (size_t)n * M;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + h * 64 + tx * 4;
      if (vec && k + 3 < M) {
        *reinterpret_cast<float4*>(row + k) =
            make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                        acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < M) row[k + j] = acc[i][h * 4 + j];
      }
    }
  }
}

}  // namespace

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

// The TMA-fed design: M % 4 == 0 and A 16-byte aligned (a TMA global
// stride is a multiple of 16 bytes).
extern "C" int hetmogp_tril_proj_f32(const float* A, const float* L,
                                     float* out, int Q, int N, int M,
                                     cudaStream_t stream) {
  using namespace tma_a;
  if (Q <= 0 || N <= 0 || M <= 0 || M % 4 != 0) {
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
                                N, Q, 4ull * M, 4ull * N * M, BK, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapL, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, L, M, M,
                            Q, 4ull * M, 4ull * M * M, BK, BN);
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

// The previous design, for any shape.  `aligned` != 0 promises that
// M % 4 == 0 and that A, L and out start on 16-byte boundaries, which lets
// rows move as float4.
extern "C" int hetmogp_tril_proj_staged_f32(const float* A, const float* L,
                                            float* out, int aligned, int Q,
                                            int N, int M,
                                            cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || M <= 0 || Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long col_tiles = (M + BC - 1) / BC;
  const long long row_tiles = (N + BR - 1) / BR;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(row_tiles * col_tiles), Q);
  tril_proj_kernel<<<grid, THREADS, 0, stream>>>(A, L, out, N, M,
                                                 (int)col_tiles, aligned != 0);
  return (int)cudaGetLastError();
}
