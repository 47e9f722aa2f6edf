// Batched triangular projection on Hopper (sm_90a).
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
// tensor cores peaks at 67 TFLOP/s.  So the design spends its effort on the
// FFMA pipe and on not doing work:
//   * the k-loop of a column tile [k0, k0 + 128) stops at m = k0 + 128, so
//     L's zero blocks above the diagonal are never loaded or multiplied:
//     half the FLOPs of the dense product at M=1024;
//   * the tile that straddles the diagonal masks L's upper entries (m > k)
//     to zero while staging it, so no padding or zeroed copy of L is needed;
//   * 128 x 128 output tiles, 256 threads each holding an 8 x 8 register
//     tile: per 16-deep stage a thread does 1024 FMAs for 16 shared-memory
//     float4 reads;
//   * A and L tiles are staged transposed ([m][row]) in shared memory so
//     that the inner loop reads float4 vectors, conflict-free for L and as
//     a broadcast for A; the next stage's global loads are issued into
//     registers before the current stage's FMAs (one-stage prefetch);
//   * ragged N and M are masked in the loads and the stores;
//   * one flat grid of N-tiles x M-tiles per latent q (up to 2^31 - 1
//     blocks), with the M tile fastest and the heaviest (rightmost) column
//     tiles first: consecutive blocks share the same A row tile in L2, and
//     the long blocks do not trail at the end of the grid.
// Summation order: each output is a sequential float32 sum over m, so it
// differs from cuBLAS's in rounding only; check it against a float64
// product, not against cuBLAS bit for bit.

#include <cuda_runtime.h>

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

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The caller
// checks shapes, dtype, contiguity and device; this checks only what would
// make the launch itself invalid.  `aligned` != 0 promises that M % 4 == 0
// and that A, L and out start on 16-byte boundaries, which lets rows move
// as float4.
extern "C" int hetmogp_tril_proj_f32(const float* A, const float* L,
                                     float* out, int Q, int N, int M,
                                     int aligned, cudaStream_t stream) {
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
