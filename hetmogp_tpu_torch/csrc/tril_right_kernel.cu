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
// Output column tile [k0, k0 + 128) reduces over m from k0 to M (kernel
// A's, tril_proj_kernel.cu, runs from 0 to k0 + 128: this is its mirror),
// so L's zero blocks are never loaded or multiplied: half the FLOPs of the
// dense product at M = 1024.  Each output is one float32 FMA chain over
// increasing m, starting from zero, as cuBLAS's A @ tril(L) is: the two
// are equal to the bit.
//
// Three epilogues behind one entry (`mode`):
//   0: store out (matmul_tril);
//   1: store out and write r (quad_diag when a gradient needs out);
//   2: write r only (quad_diag under no_grad): out never reaches memory,
//      which at the serving chunk (4, 65536, 1024) saves writing and
//      reading back 1.07 GB a request.
// The row sum is deterministic, with no float atomics: each row's
// partial sums of squares go to a scratch (hetmogp_tril_right_partials a
// row: a fixed shuffle tree over the threads that share a row inside a
// tile), and a second launch adds each row's partials in increasing
// column order: a column tile's in order, then the tiles' sums in order.  Two runs are bitwise equal, as a graph replay
// and the eager step it was captured from must be.
//
// tril_right_tma_kernel (entry hetmogp_tril_right_strided_f32: A and L
// read through their row and plane strides), for M % 4 == 0, 16-byte-
// aligned operands and strides of a multiple of 16 bytes (TMA's stride
// rule; the caller pads a ragged M with zeros,
// ops/cuda_kernels.py::_tma_operands):
//    tril_tma.cuh's pipeline (one producer thread issuing TMA loads into
//    a ring of 4 stages of mbarriers, a producer warpgroup that
//    hands its registers to the 8 FMA warps with setmaxnreg, persistent
//    blocks on the paired snake schedule of tril_tiles.cuh, mirrored).  A
//    stage holds A's 128 x 32 tile, 128-byte swizzled, and L's 32 x 128
//    tile as stored (512-byte rows, unswizzled).  It is bound by FFMA
//    issue: each lane holds an 8 x 8 register tile and reads 8 A float4s
//    along m and 8 L float4s along k for 256 FFMAs a 4-deep chunk.  What
//    it does for that (tril_right_plan.cuh holds its index arithmetic,
//    which the CPU tests walk):
//    * the stage pointers are pointer arithmetic on the dynamic shared
//      array, not a round trip through an integer, so the fragments come
//      by shared loads (LDS) and not by generic ones;
//    * the 8 warps hold 64 x 32 warp tiles, 2 x 4, and a warp skips the
//      stages of a tile's diagonal that lie wholly below its 32 columns
//      and masks only the one stage that straddles them, so the zero half
//      of the diagonal tile is neither multiplied nor selected; the warps
//      that share a sub-partition take warp columns from both ends, so
//      each sub-partition skips as many stages as any other;
//    * a lane's 8 rows share one swizzle key (one XOR a chunk places all
//      eight A reads), its 8 columns are two float4s of an L row, 16
//      apart, and its FFMA nest runs column by column;
//    * each warp writes one partial a row (its 32 columns: a 2-level
//      shuffle tree over the 4 lanes of a row), so a row has 4 C partials.
//    Ragged N, and m or k past M, arrive as TMA's zero fill.  On the card,
//    chip_smoke.py's right_products_phase holds it to cuBLAS (bitwise) and
//    to float64 and times it; probes/tril_right.py times it against
//    another checkout's design (kernels A, 3 and 5 are held to be the same
//    there).

#include <cuda_runtime.h>

#include "tril_right_plan.cuh"
#include "tril_tma.cuh"

namespace {

using tril_right_plan::BN;  // columns k per tile
constexpr int SUM_THREADS = 256;
constexpr int SUM_ROWS = 64;   // rows a block of the row sum
constexpr int SUM_COLS = 32;   // partials a row it stages at a time
static_assert(SUM_COLS == 32, "a warp stages a row's partials");
static_assert(SUM_COLS % tril_right_plan::PARTS == 0, "whole runs a chunk");

// r[row] = the sum of the row's C partials part[row * C + c], in
// increasing c: each run of G partials (one column tile's) added in order,
// then the runs' sums in order.  With G = 1, a plain sum in increasing c.
// G divides C and SUM_COLS.
// One thread a row of a block's SUM_ROWS; the block stages its rows'
// partials SUM_COLS columns at a time through shared memory, a warp a row,
// so the loads are coalesced whatever C is.
__global__ void __launch_bounds__(SUM_THREADS)
row_sum_kernel(const float* __restrict__ part, float* __restrict__ r,
               long long rows, int C, int G) {
  __shared__ float tile[SUM_ROWS][SUM_COLS + 1];
  const long long i0 = blockIdx.x * (long long)SUM_ROWS;
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c0 = 0; c0 < C; c0 += SUM_COLS) {
    for (int rr = threadIdx.x / 32; rr < SUM_ROWS; rr += SUM_THREADS / 32) {
      const long long i = i0 + rr;
      if (i < rows && c0 + lane < C) tile[rr][lane] = part[i * C + c0 + lane];
    }
    __syncthreads();
    if (threadIdx.x < SUM_ROWS) {
      const int n = C - c0 < SUM_COLS ? C - c0 : SUM_COLS;
      for (int c = 0; c < n; c += G) {
        float run = 0.0f;
        for (int g = 0; g < G; ++g) run += tile[threadIdx.x][c + g];
        s += run;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < SUM_ROWS && i0 + threadIdx.x < rows) {
    r[i0 + threadIdx.x] = s;
  }
}

int launch_row_sum(const float* part, float* r, long long rows, int C,
                   int G, cudaStream_t stream) {
  const long long blocks = (rows + SUM_ROWS - 1) / SUM_ROWS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<(unsigned)blocks, SUM_THREADS, 0, stream>>>(part, r, rows,
                                                              C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- the TMA-fed design ----------------------------------------------------

namespace tma_r {

using namespace tril_right_plan;

constexpr int STAGES = 4;             // ring depth
constexpr int CONSUMERS = WARPS * 32;  // FMA threads, 8 x TN each
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
// setmaxnreg: the producer warpgroup keeps 40 registers and hands the
// rest of the block's (ptxas's cap, 65536 / THREADS) to the FMA threads
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS =
    (65536 / THREADS / 8 * 8 * THREADS - PRODUCER_REGS * 128) / CONSUMERS /
    8 * 8;
constexpr int A_TILE = BM * BK * 4;   // BM rows x 32 floats, swizzled
constexpr int L_ROW = BN * 4;         // 512 bytes: one L row of the tile
constexpr int L_TILE = BK * L_ROW;    // 32 rows x 128 floats, as stored
constexpr int STAGE_BYTES = A_TILE + L_TILE;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int CHUNKS = BK / 4;        // 4-deep chunks of a stage
static_assert(CHUNKS % 2 == 0, "chunks go in pairs");
static_assert(LR % 8 == 0 || LR == 4, "the swizzle keys of a lane's rows");

// acc[i][j] += sum over the stage's 32 m of A[row i][m] L[m][col j], one
// FMA at a time in increasing m.  MASK zeroes L[m][k] for m < k (keep);
// m0 is the stage's first m relative to the tile's k0.
//
// A row r of the swizzled A tile holds its 16-byte chunk c (m = 4 c ..
// 4 c + 3) at chunk c ^ (r % 8); a lane's rows r0 + LR i have the keys
// r0 % 8 ^ (LR i % 8), so one XOR a chunk places all eight.  Its L
// columns are GROUPS float4s of an L row, WC / GROUPS apart.  Pairs of
// chunks run as one unrolled body, the FFMA nest column by column (the
// compiler schedules each fragment's loads ahead of its FFMAs: loading
// them a step ahead by hand measured no faster).
template <bool MASK>
__device__ __forceinline__ void consume(const uint8_t* As, const uint8_t* Ls,
                                        float (&acc)[8][TN], int warp,
                                        int lane, int m0) {
  const int r0 = row(warp, lane, 0), col0 = col(warp, lane, 0);
  const uint8_t* ap = As + r0 * 128;
  const uint8_t* lp = Ls + col0 * 4;
  float4 a[8];
  float4 l[GROUPS];
  auto load_a = [&](float4 (&f)[8], int c) {
    const int off = ((c ^ r0) & 7) << 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = *reinterpret_cast<const float4*>(
          ap + i * LR * 128 + (off ^ (((LR * i) & 7) << 4)));
    }
  };
  auto load_l = [&](float4 (&f)[GROUPS], int m) {
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {
      f[h] = *reinterpret_cast<const float4*>(lp + m * L_ROW +
                                              WC / GROUPS * 4 * h);
    }
  };
#pragma unroll 1
  for (int c = 0; c < CHUNKS; c += 2) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // t = 4 (chunk - c) + e
      const int b = t >> 2, e = t & 3;
      if (e == 0) load_a(a, c + b);
      load_l(l, 4 * c + t);
      float lv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        lv[j] = reinterpret_cast<const float*>(&l[j >> 2])[j & 3];
        if (MASK && !keep(m0 + 4 * c + t, col(warp, lane, j))) lv[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = reinterpret_cast<const float*>(&a[i])[e];
          acc[i][j] = fmaf(av, lv[j], acc[i][j]);
        }
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
  // the swizzle pattern repeats every 1024 bytes: stages start on it.
  // Pointer arithmetic on smem_raw, not a round trip through an integer,
  // keeps the stages in the shared address space, so their reads are
  // shared loads (LDS), not generic ones.
  uint8_t* smem =
      smem_raw + ((1024 - (tril_tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tril_tma::mbar_init(full + s, 1);
      tril_tma::mbar_init(empty + s, WARPS);
    }
    tril_tma::fence_barrier_init();
  }
  __syncthreads();

  const int units = tiles.units();
  if (warp >= WARPS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (warp != WARPS || lane != 0) return;
    tril_tma::Ring ring;
    for (int turn = 0;; ++turn) {
      const int u = tiles.index(turn, blockIdx.x, gridDim.x);
      if (u >= units) break;
      for (int p = 0; p < tiles.tiles_in(u); ++p) {
        int q, rt, ct;
        tiles.decode(u, p, q, rt, ct);
        const int k0 = k0_of(tiles.C, ct);
        for (int s = 0; s < stages(M, k0); ++s) {
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
  const int s_first = first_stage(warp), s_full = full_stage(warp);
  const int parts = tiles.C * PARTS;
  tril_tma::Ring ring;
  for (int turn = 0;; ++turn) {
    const int u = tiles.index(turn, blockIdx.x, gridDim.x);
    if (u >= units) break;
    for (int p = 0; p < tiles.tiles_in(u); ++p) {
      int q, rt, ct;
      tiles.decode(u, p, q, rt, ct);
      const int n0 = rt * BM;
      const int k0 = k0_of(tiles.C, ct);

      float acc[8][TN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

      for (int s = 0; s < stages(M, k0); ++s) {
        // a skipped stage is waited for all the same: its release on
        // "empty" must not count towards the slot's previous use
        tril_tma::mbar_wait(full + ring.slot, ring.phase);
        const uint8_t* As = smem + ring.slot * STAGE_BYTES;
        const uint8_t* Ls = As + A_TILE;
        if (s >= s_full) {
          consume<false>(As, Ls, acc, warp, lane, s * BK);
        } else if (s >= s_first) {
          consume<true>(As, Ls, acc, warp, lane, s * BK);
        }
        __syncwarp();
        if (lane == 0) tril_tma::mbar_arrive(empty + ring.slot);
        ring.advance(STAGES);
      }

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + row(warp, lane, i);
        if (mode != 2 && n < N) {
          float* o = out + ((size_t)q * N + n) * M + k0;
#pragma unroll
          for (int h = 0; h < GROUPS; ++h) {
            const int k = col(warp, lane, 4 * h);
            if (k0 + k < M) {  // M % 4 == 0: k + 3 < M too
              *reinterpret_cast<float4*>(o + k) =
                  make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]);
            }
          }
        }
        if (mode != 0) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < TN; ++j) s = fmaf(acc[i][j], acc[i][j], s);
#pragma unroll
          for (int off = LC / 2; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
          }
          if (writes_partial(lane) && n < N) {
            part[((size_t)q * N + n) * parts + partial(k0, warp)] = s;
          }
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
// hetmogp_tril_right_partials(M) floats) and `r` (Q, N) may be null for
// mode 0.

// Row-sum partials a row: PARTS a column tile.
extern "C" int hetmogp_tril_right_partials(int M) {
  return (M + BN - 1) / BN * tril_right_plan::PARTS;
}

static bool bad_args(const float* out, const float* part, const float* r,
                     int mode, int Q, int N, int M) {
  return Q <= 0 || N <= 0 || M <= 0 || mode < 0 || mode > 2 ||
         (mode != 2 && out == nullptr) ||
         (mode != 0 && (part == nullptr || r == nullptr));
}

// The TMA-fed design: M % 4 == 0, A, L and out 16-byte aligned, and A's
// and L's rows and planes a_row, a_plane, l_row and l_plane floats apart,
// each a multiple of 4: A may be a (Q, N, M) view of a wider array, L a
// (Q, M, M) one, read where they lie; TMA's bounds keep every load inside
// the view.
extern "C" int hetmogp_tril_right_strided_f32(
    const float* A, long long a_row, long long a_plane, const float* L,
    long long l_row, long long l_plane, float* out, float* part, float* r,
    int mode, int Q, int N, int M, cudaStream_t stream) {
  using namespace tma_r;
  if (bad_args(out, part, r, mode, Q, N, M) || M % 4 != 0 || a_row < M ||
      l_row < M || a_plane < a_row * N || l_plane < l_row * M) {
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
                                N, Q, 4ull * a_row, 4ull * a_plane, BK, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapL, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, L, M, M,
                            Q, 4ull * l_row, 4ull * l_plane, BN, BK,
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
  return launch_row_sum(part, r, (long long)Q * N, (int)C * PARTS, PARTS,
                        stream);
}
