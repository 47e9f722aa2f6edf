// Batched RBF cross-covariance on Hopper (sm_90a).
//
//   K[q, n, m] = var[q] * exp(-0.5 * sum_d ((x[n, d] - z[q, m, d]) / ls[q, d])^2)
//
// X (N, Dx), Z (Q, M, Dx), ls (Q, Dx) or isotropic (Q, 1), var (Q,), all
// contiguous float32, giving K (Q, N, M) float32, row-major.
//
// Replaces the Pallas TPU kernel hetmogp_tpu/ops/pallas_kernels.py:
// _rbf_block_kernel (launched by _rbf_forward_impl).  It computes the same
// function, forward only; it is not a block-by-block copy of it.
//
// What bounds it on an H100: the store of the (Q, N, M) float32 output.  A
// serving chunk (Q=4, N=65536, M=1024) writes 1 GiB, about 0.32 ms at the
// card's 3.35 TB/s, while the inputs are a few hundred KiB and the arithmetic
// is Dx multiply-adds and one expf per element.  Two kernels, chosen by shape
// in ops/cuda_kernels.py (rbf_route):
//
// rbf_cross_vec_kernel, for M % 4 == 0, a 16-byte-aligned output and
// Dx <= 4 (the main path: M = 1024, Dx = 2).  Everything is spent on the
// store:
//   * each thread owns four adjacent columns and writes them as one float4,
//     so one store of a warp covers 512 contiguous bytes of a row;
//   * a block stays on one (q, column tile) and walks a contiguous range of
//     rows; the grid is sized to a few blocks per SM, not to the output;
//   * the thread's four Z points, scaled by 1 / ls, live in registers for
//     the whole walk (Dx is a template parameter): Z is read once per block
//     and never staged in shared memory; an X row is one broadcast load;
//   * VEC_ROWS rows are unrolled, so that many independent expf chains and
//     stores are in flight per thread;
//   * 1 / ls is computed here, so the caller launches nothing else.
//
// rbf_cross_kernel, the first design, for every other shape (a ragged M, an
// unaligned output, Dx > 4): a 512-thread block writes a 32 x 128 tile with
// 4-byte stores from Z and X tiles staged in shared memory; ragged edges are
// masked, with no padding copy of the inputs; the N tile is on blockIdx.x
// (up to 2^31 - 1 blocks).
//
// Both round x / ls and z / ls (products with the reciprocal of ls) before
// they subtract (__fmul_rn in the vector kernel, where the compiler would
// otherwise contract the product into the subtraction) and sum the squared
// differences in increasing d.  So they agree to the bit, K(X, X) is
// symmetric to the bit, and its diagonal is var exactly.  expf (not __expf)
// and no fast-math: the result matches the plain version to 2e-6 absolute.

#include <cuda_runtime.h>

namespace {

// ---- the vector kernel ------------------------------------------------------

constexpr int VEC_THREADS = 256;
constexpr int VEC_COLS = 4;  // columns per thread: one float4
constexpr int VEC_ROWS = 8;  // rows unrolled per thread
constexpr int VEC_MAX_DX = 4;
// Blocks per SM that the grid is sized to (measured on the H100: see PERF.md,
// section 6).
constexpr int VEC_BLOCKS_PER_SM = 4;

// Plain stores in the library.  STREAM (st.global.cs) is instantiated only by
// probes/rbf_store_probe.cu: it gained about 2% of this kernel at the serving
// shape alone, too little to carry a second set of kernels and a size
// threshold.
template <bool STREAM>
__device__ __forceinline__ void store4(float* p, const float4& v) {
  if (STREAM) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    *reinterpret_cast<float4*>(p) = v;
  }
}

template <int DX>
__device__ __forceinline__ float4 rbf_row(const float* __restrict__ X, int n,
                                          const float (&il)[DX],
                                          const float (&z)[DX][VEC_COLS],
                                          float v) {
  float acc[VEC_COLS] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    const float xs = __fmul_rn(__ldg(X + (size_t)n * DX + d), il[d]);
#pragma unroll
    for (int c = 0; c < VEC_COLS; ++c) {
      const float diff = xs - z[d][c];
      acc[c] += diff * diff;
    }
  }
  return make_float4(v * expf(-0.5f * acc[0]), v * expf(-0.5f * acc[1]),
                     v * expf(-0.5f * acc[2]), v * expf(-0.5f * acc[3]));
}

// blockDim = (TX, TY), TX * TY = VEC_THREADS: TX threads of four columns
// across, TY rows down.  grid = (row ranges, column tiles, Q).
template <int DX, bool STREAM = false>
__global__ void __launch_bounds__(VEC_THREADS)
rbf_cross_vec_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                     const float* __restrict__ ls,
                     const float* __restrict__ var, float* __restrict__ out,
                     int N, int M, int ls_cols, int rows_per_block) {
  const int q = blockIdx.z;
  const int m = (blockIdx.y * blockDim.x + threadIdx.x) * VEC_COLS;
  if (m >= M) return;  // M % 4 == 0: the thread's four columns are in or out
  const int TY = blockDim.y;
  const int n_begin = blockIdx.x * rows_per_block;
  const int n_end = min(N, n_begin + rows_per_block);

  float il[DX], z[DX][VEC_COLS];
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    il[d] = 1.0f / ls[(size_t)q * ls_cols + (ls_cols == 1 ? 0 : d)];
  }
  const float* Zq = Z + ((size_t)q * M + m) * DX;
#pragma unroll
  for (int c = 0; c < VEC_COLS; ++c) {
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      z[d][c] = __fmul_rn(Zq[c * DX + d], il[d]);
    }
  }
  const float v = var[q];
  float* outq = out + (size_t)q * N * M + m;

  int n = n_begin + threadIdx.y;
  // whole chunks of VEC_ROWS rows: no bounds test between the stores
  for (; n + (VEC_ROWS - 1) * TY < n_end; n += VEC_ROWS * TY) {
    float4 o[VEC_ROWS];
#pragma unroll
    for (int j = 0; j < VEC_ROWS; ++j) {
      o[j] = rbf_row<DX>(X, n + j * TY, il, z, v);
    }
#pragma unroll
    for (int j = 0; j < VEC_ROWS; ++j) {
      store4<STREAM>(outq + (size_t)(n + j * TY) * M, o[j]);
    }
  }
  for (; n < n_end; n += TY) {
    store4<STREAM>(outq + (size_t)n * M, rbf_row<DX>(X, n, il, z, v));
  }
}

// The SM count of the current device, asked at each launch (an attribute
// query, no synchronisation): launches may go to more than one card.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The launch geometry of the vector kernel: the narrowest power-of-two TX
// (at least a warp) whose 4 TX columns cover M, up to the whole block; the
// rows split into as many ranges as give blocks_per_sm blocks per SM, each
// a multiple of TY rows.
struct VecGrid {
  dim3 block, grid;
  int rows_per_block;
};

inline VecGrid vec_grid(int Q, int N, int M,
                        int blocks_per_sm = VEC_BLOCKS_PER_SM) {
  int tx = 32;
  while (tx < VEC_THREADS && tx * VEC_COLS < M) tx *= 2;
  const int ty = VEC_THREADS / tx;
  const int col_tiles = (M + tx * VEC_COLS - 1) / (tx * VEC_COLS);
  const long long want = (long long)blocks_per_sm * sm_count();
  long long splits = want / ((long long)Q * col_tiles);
  if (splits < 1) splits = 1;
  long long rows = (N + splits - 1) / splits;
  rows = (rows + ty - 1) / ty * ty;
  VecGrid g;
  g.block = dim3(tx, ty);
  g.rows_per_block = (int)rows;
  g.grid = dim3((unsigned)((N + rows - 1) / rows), col_tiles, Q);
  return g;
}

template <int DX>
int launch_vec(const float* X, const float* Z, const float* ls,
               const float* var, float* out, int Q, int N, int M, int ls_cols,
               cudaStream_t stream) {
  const VecGrid g = vec_grid(Q, N, M);
  if (g.grid.y > 65535) return (int)cudaErrorInvalidValue;
  rbf_cross_vec_kernel<DX><<<g.grid, g.block, 0, stream>>>(
      X, Z, ls, var, out, N, M, ls_cols, g.rows_per_block);
  return (int)cudaGetLastError();
}

// ---- the scalar kernel ------------------------------------------------------

constexpr int BM = 128;  // columns (m) per block, one per thread in x
constexpr int BN = 32;   // rows (n) per block
constexpr int TY = 4;    // thread rows; each thread writes BN / TY elements

__global__ void __launch_bounds__(BM * TY)
rbf_cross_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                 const float* __restrict__ ls, const float* __restrict__ var,
                 float* __restrict__ out, int N, int M, int Dx, int ls_cols) {
  extern __shared__ float smem[];
  float* zs = smem;            // [Dx][BM]
  float* xs = smem + Dx * BM;  // [BN][Dx]

  const int q = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.y * BM + threadIdx.x;
  const float* lq = ls + (size_t)q * ls_cols;
  const float* Zq = Z + (size_t)q * M * Dx;

  // Linear index i walks Z's (m, d) elements in memory order: coalesced loads.
  for (int i = tid; i < BM * Dx; i += BM * TY) {
    const int mm = i / Dx, d = i - mm * Dx;
    const int m = m0 + mm;
    const float il = 1.0f / lq[ls_cols == 1 ? 0 : d];
    zs[d * BM + mm] = (m < M) ? Zq[(size_t)m * Dx + d] * il : 0.0f;
  }
  for (int i = tid; i < BN * Dx; i += BM * TY) {
    const int nn = i / Dx, d = i - nn * Dx;
    const int n = n0 + nn;
    const float il = 1.0f / lq[ls_cols == 1 ? 0 : d];
    xs[i] = (n < N) ? X[(size_t)n * Dx + d] * il : 0.0f;
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

__global__ void empty_kernel() {}

bool bad_shape(int Q, int N, int M, int Dx, int ls_cols) {
  return Q <= 0 || N <= 0 || M <= 0 || Dx <= 0 || Q > 65535 ||
         (ls_cols != 1 && ls_cols != Dx);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success).  The caller
// checks shapes, device and the route's conditions; these check only what
// would make the launch itself invalid.  ls_cols is Dx, or 1 for an
// isotropic lengthscale.

// The vector kernel: M % 4 == 0, out 16-byte aligned, Dx <= 4.
extern "C" int hetmogp_rbf_cross_vec_f32(const float* X, const float* Z,
                                         const float* ls, const float* var,
                                         float* out, int Q, int N, int M,
                                         int Dx, int ls_cols,
                                         cudaStream_t stream) {
  if (bad_shape(Q, N, M, Dx, ls_cols) || Dx > VEC_MAX_DX || M % VEC_COLS ||
      reinterpret_cast<size_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  switch (Dx) {
    case 1:
      return launch_vec<1>(X, Z, ls, var, out, Q, N, M, ls_cols, stream);
    case 2:
      return launch_vec<2>(X, Z, ls, var, out, Q, N, M, ls_cols, stream);
    case 3:
      return launch_vec<3>(X, Z, ls, var, out, Q, N, M, ls_cols, stream);
    default:
      return launch_vec<4>(X, Z, ls, var, out, Q, N, M, ls_cols, stream);
  }
}

// The scalar kernel: any shape with (128 + 32) * Dx floats of shared memory
// under 48 KiB.
extern "C" int hetmogp_rbf_cross_f32(const float* X, const float* Z,
                                     const float* ls, const float* var,
                                     float* out, int Q, int N, int M, int Dx,
                                     int ls_cols, cudaStream_t stream) {
  if (bad_shape(Q, N, M, Dx, ls_cols) || (M + BM - 1) / BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(BM + BN) * Dx * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(BM, TY);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Q);
  rbf_cross_kernel<<<grid, block, smem, stream>>>(X, Z, ls, var, out, N, M,
                                                  Dx, ls_cols);
  return (int)cudaGetLastError();
}

// A kernel that does nothing: what any launch costs on the device, the floor
// under the times of the small shapes.
extern "C" int hetmogp_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
