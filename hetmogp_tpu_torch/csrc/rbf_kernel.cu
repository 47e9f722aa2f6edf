// Batched RBF cross-covariance on Hopper (sm_90a).
//
//   K[q, n, m] = var[q] * exp(-0.5 * sum_d ((x[n, d] - z[q, m, d]) * ils[q, d])^2)
//
// X (N, Dx), Z (Q, M, Dx), ils (Q, Dx) = 1 / lengthscale, var (Q,), all
// contiguous float32, giving K (Q, N, M) float32, row-major.
//
// Replaces the Pallas TPU kernel hetmogp_tpu/ops/pallas_kernels.py:
// _rbf_block_kernel (launched by _rbf_forward_impl).  It computes the same
// function, forward only; it is not a block-by-block copy of it.
//
// What bounds it on an H100: the store of the (Q, N, M) float32 output.  A
// serving chunk (Q=4, N=65536, M=1024) writes 1 GiB, about 0.32 ms at the
// card's 3.35 TB/s, while the inputs are a few hundred KiB and the arithmetic
// is Dx multiply-adds and one expf per element.  So the design spends nothing
// on anything but the store:
//   * one pass: the distance, exp and scale of each element happen in
//     registers, and no (Q, N, M, Dx) difference tensor or (Q, N, M) distance
//     tensor is ever written, unlike the plain PyTorch version;
//   * threads run along m, so each warp stores 128 contiguous bytes of a row;
//   * the block's Z tile (BM x Dx) and X rows (BN x Dx) are staged once in
//     shared memory, pre-scaled by ils; Z is stored there as [d][m] so the
//     per-thread reads are conflict-free, X as [n][d] so they broadcast;
//   * ragged edges are masked here, with no padding copy of the inputs;
//   * the N tile is on blockIdx.x (up to 2^31 - 1 blocks): gridDim.y and z stop
//     at 65535, and a call with a million rows would overflow them.
// expf (not __expf) and no fast-math, so the result matches the plain
// version to 2e-6 absolute.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // columns (m) per block, one per thread in x
constexpr int BN = 32;   // rows (n) per block
constexpr int TY = 4;    // thread rows; each thread writes BN / TY elements

__global__ void __launch_bounds__(BM * TY)
rbf_cross_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                 const float* __restrict__ ils, const float* __restrict__ var,
                 float* __restrict__ out, int N, int M, int Dx) {
  extern __shared__ float smem[];
  float* zs = smem;            // [Dx][BM]
  float* xs = smem + Dx * BM;  // [BN][Dx]

  const int q = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.y * BM + threadIdx.x;
  const float* il = ils + (size_t)q * Dx;
  const float* Zq = Z + (size_t)q * M * Dx;

  // Linear index i walks Z's (m, d) elements in memory order: coalesced loads.
  for (int i = tid; i < BM * Dx; i += BM * TY) {
    const int mm = i / Dx, d = i - mm * Dx;
    const int m = m0 + mm;
    zs[d * BM + mm] = (m < M) ? Zq[(size_t)m * Dx + d] * il[d] : 0.0f;
  }
  for (int i = tid; i < BN * Dx; i += BM * TY) {
    const int nn = i / Dx, d = i - nn * Dx;
    const int n = n0 + nn;
    xs[i] = (n < N) ? X[(size_t)n * Dx + d] * il[d] : 0.0f;
  }
  __syncthreads();

  const int mm = threadIdx.x;
  const int m = m0 + mm;
  if (m >= M) return;
  const float v = var[q];
  float* outq = out + (size_t)q * N * M + m;
  for (int nn = threadIdx.y; nn < BN; nn += TY) {
    const int n = n0 + nn;
    if (n >= N) break;
    float acc = 0.0f;
    for (int d = 0; d < Dx; ++d) {
      const float diff = xs[nn * Dx + d] - zs[d * BM + mm];
      acc += diff * diff;
    }
    outq[(size_t)n * M] = v * expf(-0.5f * acc);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The caller
// checks shapes and device; this checks only what would make the launch
// itself invalid.
extern "C" int hetmogp_rbf_cross_f32(const float* X, const float* Z,
                                     const float* ils, const float* var,
                                     float* out, int Q, int N, int M, int Dx,
                                     cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || M <= 0 || Dx <= 0 || Q > 65535 ||
      (M + BM - 1) / BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(BM + BN) * Dx * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(BM, TY);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Q);
  rbf_cross_kernel<<<grid, block, smem, stream>>>(X, Z, ils, var, out, N, M,
                                                  Dx);
  return (int)cudaGetLastError();
}
