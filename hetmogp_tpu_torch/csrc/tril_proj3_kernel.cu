// Batched triangular projection in three bf16 tensor-core passes, Hopper
// (sm_90a).
//
//   out[q, n, k] = sum_{m <= k} A[q, n, m] * L[q, k, m]      (A tril(L)^T)
//
// A (Q, N, M) and L (Q, M, M), contiguous float32 row-major, giving out
// (Q, N, M) float32.  L's strictly upper entries are never read.  Each
// float32 operand x is split while it is staged into shared memory:
//
//   hi = x with its low 16 bits cleared (bits & 0xFFFF0000: exact in bf16)
//   lo = bf16_rn(x - hi)                 (x - hi is exact in float32)
//
// and every 16-deep step of the reduction adds hi*lo + lo*hi, then hi*hi,
// to a float32 accumulator on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulation).  The lo*lo term (below 2^-14 of |a l|) is
// dropped.  That is the "high" precision of the trainer's VE projection
// P = Kfu iLuu^T: ve_fwd_precision="high".
//
// Replaces the Pallas TPU kernel tools/probe_pallas_proj.py:
// _proj_kernel_presplit (launched by pallas_proj2), which takes the same
// bit-mask split, but made by XLA before the kernel as four pre-split
// arrays in device memory.  Here the split happens in registers between the
// float32 load and the shared-memory store, so the kernel moves only A, L
// and out: the pre-split copies were ~50 MB of extra traffic a call at the
// trainer's shape, which is why the TPU prototype lost to XLA.  The split
// is made with integer masks, not with a float32 -> bf16 -> float32 round
// trip, which a compiler may fold away.
//
// What bounds it on an H100: at the trainer's shape (Q=4, N=3072, M=1024)
// the three passes are 3 x 1.29e10 triangular FLOP, 0.039 ms at the card's
// 989 TFLOP/s of dense bf16, against 117 MB of operands and output, 0.035 ms
// at 3.35 TB/s: about balanced, so a fast version needs both wgmma and a
// TMA pipeline.  This first version is simple and right:
//   * one 128 x 128 output tile per block of 256 threads (8 warps as 2 x 4,
//     each warp a 64 x 32 sub-tile of 4 x 4 m16n8 accumulators);
//   * the k-loop of a column tile [k0, k0 + 128) stops at m = k0 + 128, so
//     L's zero blocks above the diagonal are never loaded or multiplied;
//     the tile that straddles the diagonal masks L's upper entries (m > k)
//     to zero while staging, and ragged N and M are masked in the loads and
//     the stores;
//   * A and L are both K-contiguous (A[n][m], L[k][m]), which is what
//     mma.sync's row.col operands want: shared-memory tiles [row][m] with a
//     padded row (40 bf16) so that the fragment loads are conflict-free;
//   * the next stage's float32 loads are issued into registers before the
//     current stage's mma (one-stage prefetch); float4 loads only when
//     M % 4 == 0 and the pointers are 16-byte aligned;
//   * one flat grid of N-tiles x M-tiles per latent q with the M tile
//     fastest and the heaviest (rightmost) column tiles first.
// Summation order: per output, a float32 sum over 16-deep steps, each
// step's products summed inside the tensor core.  It is not the plain
// version's order: check both against a float64 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;     // rows n per block
constexpr int BC = 128;     // columns k per block
constexpr int BK = 32;      // reduction depth m per stage
constexpr int LDS = BK + 8; // shared-memory row stride in bf16 (80 bytes)
constexpr int THREADS = 256;
// float4 groups each thread stages per operand and stage (4)
constexpr int LOADS = BR * BK / 4 / THREADS;

// Four consecutive elements row[c], ..., row[c + 3], zero at and past `lim`;
// one float4 load when the row is 16-byte aligned and all four are in range.
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

// The bit-mask split of one float32: hi's bf16 bits and lo's bf16 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t bits = __float_as_uint(x);
  const float h = __uint_as_float(bits & 0xFFFF0000u);
  hi = bits >> 16;
  lo = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x - h));
}

// Split four floats and store them as bf16 at hi[0..3] and lo[0..3]
// (8-byte aligned): element j sits in the low half for even j.
__device__ __forceinline__ void stage4(float4 v, __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(v.x, h0, l0);
  split(v.y, h1, l1);
  split(v.z, h2, l2);
  split(v.w, h3, l3);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0 | (h1 << 16), h2 | (h3 << 16));
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0 | (l1 << 16), l2 | (l3 << 16));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
tril_proj3_kernel(const float* __restrict__ A, const float* __restrict__ L,
                  float* __restrict__ out, int N, int M, int col_tiles,
                  bool vec) {
  __shared__ __align__(16) __nv_bfloat16 Ahi[BR][LDS];
  __shared__ __align__(16) __nv_bfloat16 Alo[BR][LDS];
  __shared__ __align__(16) __nv_bfloat16 Lhi[BC][LDS];
  __shared__ __align__(16) __nv_bfloat16 Llo[BC][LDS];

  const int q = blockIdx.y;
  const int bid = blockIdx.x;
  const int ct = col_tiles - 1 - bid % col_tiles;  // heaviest tiles first
  const int n0 = (bid / col_tiles) * BR;
  const int k0 = ct * BC;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wr = (warp / 4) * 64;  // the warp's first row in the tile
  const int wc = (warp % 4) * 32;  // the warp's first column in the tile
  const int g = lane / 4;          // mma fragment row group
  const int t = lane % 4;          // mma fragment thread in group

  const float* Aq = A + (size_t)q * N * M;
  const float* Lq = L + (size_t)q * M * M;

  // m stops at the column tile's end: L[k, m] = 0 for m > k, and k < k0 + BC
  const int m_end = min(M, k0 + BC);
  const int stages = (m_end + BK - 1) / BK;

  // staging map: thread loads rows lr + 32 * i, columns lc .. lc + 3
  const int lr = tid / 8;
  const int lc = (tid % 8) * 4;

  float4 ra[LOADS], rl[LOADS];
  auto fetch = [&](int s) {
    const int m0 = s * BK;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = lr + 32 * i;
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
      const int r = lr + 32 * i;
      stage4(ra[i], &Ahi[r][lc], &Alo[r][lc]);
      stage4(rl[i], &Lhi[r][lc], &Llo[r][lc]);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  fetch(0);
  stage();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) fetch(s + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B fragments of the warp's four 8-column tiles: (k = 2t.., n = g)
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wc + j * 8 + g;
        bhi[j][0] = ld32(&Lhi[c][kk + 2 * t]);
        bhi[j][1] = ld32(&Lhi[c][kk + 8 + 2 * t]);
        blo[j][0] = ld32(&Llo[c][kk + 2 * t]);
        blo[j][1] = ld32(&Llo[c][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A fragment of the 16-row tile i: rows g and g + 8
        const int r = wr + i * 16 + g;
        uint32_t ahi[4], alo[4];
        ahi[0] = ld32(&Ahi[r][kk + 2 * t]);
        ahi[1] = ld32(&Ahi[r + 8][kk + 2 * t]);
        ahi[2] = ld32(&Ahi[r][kk + 8 + 2 * t]);
        ahi[3] = ld32(&Ahi[r + 8][kk + 8 + 2 * t]);
        alo[0] = ld32(&Alo[r][kk + 2 * t]);
        alo[1] = ld32(&Alo[r + 8][kk + 2 * t]);
        alo[2] = ld32(&Alo[r][kk + 8 + 2 * t]);
        alo[3] = ld32(&Alo[r + 8][kk + 8 + 2 * t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][j], alo, bhi[j]);  // the two small terms first
          mma(acc[i][j], ahi, blo[j]);
          mma(acc[i][j], ahi, bhi[j]);
        }
      }
    }
    __syncthreads();
    if (s + 1 < stages) {
      stage();
      __syncthreads();
    }
  }

  // accumulator (i, j): rows r and r + 8, columns c and c + 1
  float* outq = out + (size_t)q * N * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wr + i * 16 + g + h * 8;
      if (n >= N) continue;
      float* row = outq + (size_t)n * M;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + wc + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h];
        const float v1 = acc[i][j][2 * h + 1];
        if (vec && k + 1 < M) {
          *reinterpret_cast<float2*>(row + k) = make_float2(v0, v1);
        } else {
          if (k < M) row[k] = v0;
          if (k + 1 < M) row[k + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtype, contiguity and device; this checks only what would
// make the launch itself invalid.  `aligned` != 0 promises that M % 4 == 0
// and that A, L and out start on 16-byte boundaries, which lets rows move
// as float4 (loads) and float2 (stores).
extern "C" int hetmogp_tril_proj3_f32(const float* A, const float* L,
                                      float* out, int Q, int N, int M,
                                      int aligned, cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || M <= 0 || Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long col_tiles = (M + BC - 1) / BC;
  const long long row_tiles = (N + BR - 1) / BR;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(row_tiles * col_tiles), Q);
  tril_proj3_kernel<<<grid, THREADS, 0, stream>>>(
      A, L, out, N, M, (int)col_tiles, aligned != 0);
  return (int)cudaGetLastError();
}
