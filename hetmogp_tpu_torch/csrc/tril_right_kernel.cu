// Batched product with a lower-triangular right factor on Hopper (sm_90a),
// full float32, with an optional fused row sum of squares.
//
//   out[q, n, k] = sum_{m >= k} A[q, n, m] * L[q, m, k]      (A tril(L))
//   r[q, n]      = sum_k out[q, n, k]^2                      (quad_diag)
//
// A (Q, N, M) and L (Q, M, M), contiguous float32 row-major; out (Q, N, M)
// and r (Q, N) float32.  L's strictly upper entries are never read: they
// count as zero whatever they hold.  Full float32 products accumulated in
// float32 (FFMA), no TF32, no bf16.
//
// Kernel 4.  It replaces no Pallas kernel: the JAX package forms these
// products at the XLA level, blocked by hand so that L's zero blocks are
// skipped (hetmogp_tpu/ops/linalg.py: matmul_tril, and quad_diag's
// A tril(L) and its square and row sum).  The port runs them here: the
// un-whitened A = P iLuu, quad_diag's A Lq in every ELBO and serving pass,
// and the cached adjoints' products at "highest".
//
// It is kernel A (tril_proj_kernel.cu) mirrored.  Output column tile
// [k0, k0 + 128) reduces over m from k0 to M, where kernel A's runs from 0
// to k0 + 128, so L's zero blocks are never loaded or multiplied: half the
// FLOPs of the dense product at M = 1024.  Each output is one float32 FMA
// chain over increasing m, starting from zero.
//
// Three epilogues behind one entry (`mode`):
//   0: store out (matmul_tril);
//   1: store out and write r (quad_diag when a gradient needs out);
//   2: write r only (quad_diag under no_grad): out never reaches memory,
//      which at the serving chunk (4, 65536, 1024) saves writing and
//      reading back 1.07 GB a request.
// The row sum is deterministic, with no float atomics: each tile writes
// the sums of its 128 columns, per row, into a (Q, N, C) scratch of
// partials (C column tiles; inside a tile, a fixed shuffle tree over the
// 16 threads that share a row), and a second launch adds each row's C
// partials in increasing column-tile order.  Two runs are bitwise equal,
// as a graph replay and the eager step it was captured from must be.
//
// 1. tril_right_tma_kernel (entry hetmogp_tril_right_f32), for M % 4 == 0
//    and 16-byte-aligned operands (TMA's stride rule), the main path's
//    M = 1024: tril_tma.cuh's pipeline as kernel A has it (one producer
//    thread issuing TMA loads into a ring of 4 stages of mbarriers, a
//    producer warpgroup that hands its registers to the 256 FMA threads
//    with setmaxnreg, persistent blocks on the paired snake schedule,
//    mirrored).  A's 128 x 32 tile lands 128-byte swizzled, as in kernel
//    A.  L's tile is rows m and columns k, as stored: a 32 x 128 box whose
//    512-byte rows land unswizzled, so where kernel A reads L's rows as
//    columns, here the 16 threads of a row group read one L row's 128
//    columns as 16 contiguous float4s (conflict-free, no transpose).  Each
//    thread keeps an 8 x 8 register tile: rows ty + 16 i, columns
//    4 tx + c + 64 h; per 4-deep chunk it reads 8 A float4s along m and 8
//    L float4s along k, 256 FMAs for 16 shared reads.  The first 128 rows
//    of a tile's reduction straddle the diagonal and mask L's m < k
//    entries as they are read; ragged N, and m or k past M, arrive as
//    TMA's zero fill.
// 2. tril_right_generic_kernel (entry hetmogp_tril_right_generic_f32), for
//    every other shape (M % 4 != 0 or unaligned bases): one 256-thread
//    block per 64 x 128 tile, both operands staged through shared memory
//    16 deep with L's upper entries and the ragged edges zeroed while
//    staging, two block-wide barriers a stage.  The same FMA order and the
//    same partials (its column tiles are 128 wide too).

#include <cuda_runtime.h>

#include "tril_tma.cuh"

namespace {

constexpr int BN = 128;  // columns k per tile, both designs
constexpr int SUM_THREADS = 256;

// Each thread's register tile is a row group of 16 threads (tx = 0..15, in
// one half of a warp) times some rows; the sum over the group of each
// row's per-thread sum of squares, by a fixed shuffle tree.  Every lane
// takes part; lane tx == 0 holds the result.
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

// r[row] = sum over c of part[row * C + c], in increasing c.
__global__ void __launch_bounds__(SUM_THREADS)
row_sum_kernel(const float* __restrict__ part, float* __restrict__ r,
               long long rows, int C) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < rows; i += (long long)gridDim.x * blockDim.x) {
    const float* p = part + i * C;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += p[c];
    r[i] = s;
  }
}

int launch_row_sum(const float* part, float* r, long long rows, int C,
                   cudaStream_t stream) {
  const long long blocks = (rows + SUM_THREADS - 1) / SUM_THREADS;
  row_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), SUM_THREADS,
                   0, stream>>>(part, r, rows, C);
  return (int)cudaGetLastError();
}

// ---- the generic design ----------------------------------------------------

constexpr int GR = 64;  // rows n per block
constexpr int GD = 16;  // reduction depth m per stage
constexpr int GTHREADS = 256;

__global__ void __launch_bounds__(GTHREADS)
tril_right_generic_kernel(const float* __restrict__ A,
                          const float* __restrict__ L, float* __restrict__ out,
                          float* __restrict__ part, int N, int M, int C,
                          int mode) {
  __shared__ float As[GD][GR + 1];
  __shared__ __align__(16) float Ls[GD][BN];

  const int q = blockIdx.y;
  const int ct = blockIdx.x % C;  // the longest reductions first
  const int n0 = (blockIdx.x / C) * GR;
  const int k0 = ct * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty + 16 i
  const float* Aq = A + (size_t)q * N * M;
  const float* Lq = L + (size_t)q * M * M;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int m0 = k0; m0 < M; m0 += GD) {
#pragma unroll
    for (int p = 0; p < GR * GD / GTHREADS; ++p) {
      const int idx = tid + GTHREADS * p;
      const int r = idx / GD, mm = idx % GD;
      const int n = n0 + r, m = m0 + mm;
      As[mm][r] = (n < N && m < M) ? Aq[(size_t)n * M + m] : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < BN * GD / GTHREADS; ++p) {
      const int idx = tid + GTHREADS * p;
      const int mm = idx / BN, c = idx % BN;
      const int m = m0 + mm, k = k0 + c;
      // tril(L)[m, k]: zero for k > m, and past the edges
      Ls[mm][c] = (m < M && k <= m) ? Lq[(size_t)m * M + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GD; ++mm) {
      float l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) l[j] = Ls[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[mm][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, l[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (mode != 2 && n < N) {
      float* row = out + ((size_t)q * N + n) * M;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + tx + 16 * j;
        if (k < M) row[k] = acc[i][j];
      }
    }
    if (mode != 0) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], acc[i][j], s);
      s = group_sum(s);
      if (tx == 0 && n < N) part[((size_t)q * N + n) * C + ct] = s;
    }
  }
}

}  // namespace

// ---- the TMA-fed design ----------------------------------------------------

namespace tma_r {

constexpr int BM = 128;               // rows n per tile
constexpr int BK = 32;                // reduction depth m per stage
constexpr int STAGES = 4;             // ring depth
constexpr int CONSUMERS = 256;        // FMA threads: 16 x 16, 8 x 8 each
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int A_TILE = BM * BK * 4;   // 128 rows x 32 floats, swizzled
constexpr int L_ROW = BN * 4;         // 512 bytes: one L row of the tile
constexpr int L_TILE = BK * L_ROW;    // 32 rows x 128 floats, as stored
constexpr int STAGE_BYTES = A_TILE + L_TILE;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// acc[i][4 h + c] += sum over the stage's m of A[ty + 16 i][m] *
// L[m][4 tx + c + 64 h], one FMA at a time in increasing m.  MASK zeroes
// L[m][k] for m < k.  A row r of the swizzled tile holds its 16-byte chunk
// c at chunk c ^ (r % 8), and r % 8 is ty % 8 for every A row a thread
// reads.
template <bool MASK>
__device__ __forceinline__ void consume(const uint8_t* As, const uint8_t* Ls,
                                        float (&acc)[8][8], int tx, int ty,
                                        int m0, int k0) {
#pragma unroll 2
  for (int c = 0; c < BK / 4; ++c) {
    const uint8_t* ap = As + ty * 128 + (((c ^ ty) & 7) << 4);
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(ap + i * 16 * 128);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint8_t* lp = Ls + (4 * c + e) * L_ROW + tx * 16;
      float4 l[2];
      l[0] = *reinterpret_cast<const float4*>(lp);
      l[1] = *reinterpret_cast<const float4*>(lp + 256);
      if (MASK) {
        const int under = m0 + 4 * c + e - (k0 + 4 * tx);  // m - k at c = 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = under - 64 * h;
          l[h].x = u >= 0 ? l[h].x : 0.0f;
          l[h].y = u >= 1 ? l[h].y : 0.0f;
          l[h].z = u >= 2 ? l[h].z : 0.0f;
          l[h].w = u >= 3 ? l[h].w : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = reinterpret_cast<const float*>(&a[i])[e];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av,
                           reinterpret_cast<const float*>(&l[j >> 2])[j & 3],
                           acc[i][j]);
      }
    }
  }
}

}  // namespace tma_r

__global__ void __launch_bounds__(tma_r::THREADS, 1)
tril_right_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                      const __grid_constant__ CUtensorMap mapL,
                      float* __restrict__ out, float* __restrict__ part,
                      int N, int M, int mode, tril_tma::Tiles tiles) {
  using namespace tma_r;
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
      for (int p = 0; p < tiles.tiles_in(u); ++p) {
        int q, rt, ct;
        tiles.decode(u, p, q, rt, ct);
        const int k0 = (tiles.C - 1 - ct) * BN;  // mirrored
        const int stages = (M - k0 + BK - 1) / BK;
        for (int s = 0; s < stages; ++s) {
          tril_tma::mbar_wait(empty + ring.slot, ring.phase ^ 1);
          uint8_t* st = smem + ring.slot * STAGE_BYTES;
          uint64_t* bar = full + ring.slot;
          tril_tma::mbar_expect_tx(bar, STAGE_BYTES);
          tril_tma::tma_load_3d(st, &mapA, bar, k0 + s * BK, rt * BM, q);
          tril_tma::tma_load_3d(st + A_TILE, &mapL, bar, k0, k0 + s * BK, q);
          ring.advance(STAGES);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  const int tx = tid % 16;  // columns 4 tx + c + 64 h
  const int ty = tid / 16;  // rows ty + 16 i
  tril_tma::Ring ring;
  for (int turn = 0;; ++turn) {
    const int u = tiles.index(turn, blockIdx.x, gridDim.x);
    if (u >= units) break;
    for (int p = 0; p < tiles.tiles_in(u); ++p) {
      int q, rt, ct;
      tiles.decode(u, p, q, rt, ct);
      ct = tiles.C - 1 - ct;  // mirrored
      const int n0 = rt * BM;
      const int k0 = ct * BN;
      const int stages = (M - k0 + BK - 1) / BK;

      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

      for (int s = 0; s < stages; ++s) {
        tril_tma::mbar_wait(full + ring.slot, ring.phase);
        const uint8_t* As = smem + ring.slot * STAGE_BYTES;
        const uint8_t* Ls = As + A_TILE;
        const int m0 = k0 + s * BK;
        if (m0 - k0 >= BN - 1) {  // every m of the stage is at or past every k
          consume<false>(As, Ls, acc, tx, ty, m0, k0);
        } else {
          consume<true>(As, Ls, acc, tx, ty, m0, k0);
        }
        __syncwarp();
        if (lane == 0) tril_tma::mbar_arrive(empty + ring.slot);
        ring.advance(STAGES);
      }

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + ty + 16 * i;
        if (mode != 2 && n < N) {
          float* row = out + ((size_t)q * N + n) * M;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + 4 * tx + 64 * h;
            if (k < M) {  // M % 4 == 0: k + 3 < M too
              *reinterpret_cast<float4*>(row + k) =
                  make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]);
            }
          }
        }
        if (mode != 0) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], acc[i][j], s);
          s = group_sum(s);
          if (tx == 0 && n < N) part[((size_t)q * N + n) * tiles.C + ct] = s;
        }
      }
    }
  }
}

// Plain C entry points, bound with ctypes.  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success), or a
// negative CUresult when a tensor map cannot be encoded.  The caller checks
// shapes, dtype, contiguity and device; these check only what would make
// the launch itself invalid.  `out` may be null for mode 2; `part` (Q, N,
// ceil(M / 128)) and `r` (Q, N) may be null for mode 0.

static bool bad_args(const float* out, const float* part, const float* r,
                     int mode, int Q, int N, int M) {
  return Q <= 0 || N <= 0 || M <= 0 || mode < 0 || mode > 2 ||
         (mode != 2 && out == nullptr) ||
         (mode != 0 && (part == nullptr || r == nullptr));
}

// The TMA-fed design: M % 4 == 0 and A, L and out 16-byte aligned.
extern "C" int hetmogp_tril_right_f32(const float* A, const float* L,
                                      float* out, float* part, float* r,
                                      int mode, int Q, int N, int M,
                                      cudaStream_t stream) {
  using namespace tma_r;
  if (bad_args(out, part, r, mode, Q, N, M) || M % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long R = (N + BM - 1) / BM;
  const long long C = (M + BN - 1) / BN;
  if (Q * R * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tril_right_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap mapA, mapL;
  int err = tril_tma::encode_3d(&mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M,
                                N, Q, 4ull * M, 4ull * N * M, BK, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapL, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, L, M, M,
                            Q, 4ull * M, 4ull * M * M, BN, BK,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const tril_tma::Tiles tiles = tril_tma::make_tiles(Q, (int)R, (int)C);
  // setmaxnreg.inc waits for registers the block holds: refuse a build
  // that gives it too few to hand over, rather than hang
  cudaFuncAttributes attr;
  const cudaError_t attr_err =
      cudaFuncGetAttributes(&attr, tril_right_tma_kernel);
  if (attr_err != cudaSuccess) return (int)attr_err;
  if (attr.numRegs * THREADS <
      PRODUCER_REGS * (THREADS - CONSUMERS) + CONSUMER_REGS * CONSUMERS) {
    return (int)cudaErrorInvalidConfiguration;
  }
  tril_right_tma_kernel<<<tril_tma::persistent_blocks(tiles), THREADS,
                          SMEM_BYTES, stream>>>(mapA, mapL, out, part, N, M,
                                                mode, tiles);
  const cudaError_t launch_err = cudaGetLastError();
  if (launch_err != cudaSuccess || mode == 0) return (int)launch_err;
  return launch_row_sum(part, r, (long long)Q * N, (int)C, stream);
}

// The generic design, for any shape.
extern "C" int hetmogp_tril_right_generic_f32(const float* A, const float* L,
                                              float* out, float* part,
                                              float* r, int mode, int Q,
                                              int N, int M,
                                              cudaStream_t stream) {
  if (bad_args(out, part, r, mode, Q, N, M) || Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long C = (M + BN - 1) / BN;
  const long long R = (N + GR - 1) / GR;
  if (R * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(R * C), Q);
  tril_right_generic_kernel<<<grid, GTHREADS, 0, stream>>>(
      A, L, out, part, N, M, (int)C, mode);
  const cudaError_t launch_err = cudaGetLastError();
  if (launch_err != cudaSuccess || mode == 0) return (int)launch_err;
  return launch_row_sum(part, r, (long long)Q * N, (int)C, stream);
}
