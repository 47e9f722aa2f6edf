// Kernel 9: the Cholesky factor of one small SPD panel and the factor's
// inverse, on Hopper (sm_90a), float32 and float64.
//
// For each (n, n) matrix A of the batch (n <= 128; only its lower triangle
// is read): L = chol(A), lower-triangular, and iL = L^{-1}, both written
// with exact zeros above the diagonal.  A pivot that is not positive (or is
// NaN) fills that matrix's L on and below the diagonal, and all of its iL,
// with NaN (what jnp.linalg.cholesky and solve_triangular give the JAX
// package); nothing is read on the host, so the launch sits inside a
// captured CUDA graph.
//
// Replaces no Pallas kernel: it is the serial step of the JAX package's
// blocked factorization, hetmogp_tpu/ops/linalg.py::_blocked_cholesky_panels
// (:411-413), which factors each (nb, nb) diagonal panel with
// jnp.linalg.cholesky and inverts it with solve_triangular against I, XLA's
// serial routines.  ops/linalg.py::blocked_cholesky_inverse runs the rest of
// that algorithm (the panels' updates and the inverse's row strips) as
// products on cuBLAS and kernels A and 4.
//
// What bounds it on an H100: neither bytes nor operations.  At (4, 128, 128)
// the work is 2 * 4 * 128^3 / 3 = 5.6 MFLOP and 0.79 MB, both far under an
// empty launch.  The limit is the serial chain of n pivots on one SM: one
// thread block holds one matrix, so the batch of 4 occupies 4 of 132 SMs.
// The design keeps the whole panel in shared memory (n x 129: 66 KB in
// float32, 132 KB in float64) and cuts the chain into sub-panels of 32
// columns, so that the block's barriers are a few a sub-panel and not a few
// a column:
//   1. one warp factors the sub-panel's (w, w) diagonal block, lane i
//      keeping row i in registers and publishing each column through
//      shared memory (two __syncwarp a column), then inverts it, lane c
//      forming column c of the inverse D in registers;
//   2. while that warp inverts the block, a thread of the other warps a
//      row forms the rows below it, L21 = A21 L11^{-T}, by forward
//      substitution (a triangular solve, as LAPACK's blocked potrf: a
//      product with D would lose up to cond(L11) eps);
//   3. the whole block writes L21 back and subtracts L21 L21^T from the
//      trailing lower triangle (right-looking).
// The inverse is assembled from the same diagonal inverses, a block row at
// a time: iL[s, :s] = -D_s (L[s, :s] iL[:s, :s]), in place over L once L
// is stored.  Every sum runs in a fixed order (no atomics), so two launches
// are bitwise equal.  A simple kernel: tensor cores, several blocks a
// matrix and a persistent kernel for the whole factorization are later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace chol_panel {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NMAX = 128;     // the widest panel
constexpr int SUB = 32;       // a sub-panel: a warp's lanes
constexpr int LD = NMAX + 1;  // the panel's row stride in shared memory
constexpr int TLD = SUB + 1;  // a sub-panel scratch's row stride
constexpr int XLD = NMAX - SUB + 1;  // an inverse strip's row stride
// the panel, the rows below a sub-panel (or an inverse strip), and the
// sub-panels' diagonal inverses
constexpr int SMEM_ELEMS = NMAX * LD + NMAX * TLD + (NMAX / SUB) * SUB * TLD;
static_assert(SUB * XLD <= NMAX * TLD, "an inverse strip fits the scratch");

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T* shared_panel() {
  extern __shared__ __align__(16) unsigned char chol_panel_smem[];
  return reinterpret_cast<T*>(chol_panel_smem);
}

// The (ti, tc) of lower-triangular tile t, tc <= ti: t = ti (ti + 1) / 2 + tc.
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tc) {
  ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tc = t - ti * (ti + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chol_panel_kernel(const T* __restrict__ A, long long a_b, long long a_r,
                  T* __restrict__ L, long long l_b, long long l_r,
                  T* __restrict__ iL, long long i_b, long long i_r, int n) {
  T* S = shared_panel<T>();  // the panel: L, then iL, in place
  T* P = S + NMAX * LD;      // a sub-panel's rows below, or a strip of iL
  T* D = P + NMAX * TLD;     // the sub-panels' diagonal inverses
  __shared__ T rdiag[NMAX];  // 1 / L[j][j]
  __shared__ int failed;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long b = blockIdx.x;
  A += b * a_b;
  L += b * l_b;
  iL += b * i_b;
  if (tid == 0) failed = 0;
  // a warp a row, a lane a column: coalesced, and no division
  for (int r = warp; r < n; r += WARPS) {
    for (int c = lane; c <= r; c += 32) S[r * LD + c] = A[r * a_r + c];
  }
  __syncthreads();

  const int subs = (n + SUB - 1) / SUB;
  for (int s = 0; s < subs; ++s) {
    const int k0 = s * SUB, w = min(SUB, n - k0), rows = n - k0 - w;
    T* Skk = S + k0 * LD + k0;  // the sub-panel's diagonal block
    T* Ds = D + s * SUB * TLD;
    const T* rd = rdiag + k0;
    if (warp == 0) {
      // 1a. factor the diagonal block, right-looking: lane i < w keeps row
      // i in registers and publishes column j through shared memory
      const bool row = lane < w;
      T a[SUB];
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        a[k] = row && k <= lane ? Skk[lane * LD + k] : T(0);
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j < w) {
          if (lane == j) Skk[j * LD + j] = a[j];  // the updated pivot
          __syncwarp();
          const T p = Skk[j * LD + j];
          if (!(p > T(0)) && lane == 0) failed = 1;
          const T d = root(p), r = T(1) / d;
          if (row && lane > j) {
            a[j] *= r;
            Skk[lane * LD + j] = a[j];
          }
          __syncwarp();
          if (lane == j) {
            a[j] = d;
            rdiag[k0 + j] = r;
          }
#pragma unroll
          for (int k = j + 1; k < SUB; ++k) {
            if (row && k <= lane) a[k] -= a[j] * Skk[k * LD + j];
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        if (row && k <= lane) Skk[lane * LD + k] = a[k];
      }
      __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
      // 1b. its inverse, lane c < w forming column c (zero above row c)
      if (lane < w) {
        T x[SUB];
#pragma unroll
        for (int r = 0; r < SUB; ++r) {
          if (r < w) {
            T acc0 = T(0), acc1 = T(0);
#pragma unroll
            for (int m = 0; m + 1 < r; m += 2) {
              acc0 += Skk[r * LD + m] * x[m];
              acc1 += Skk[r * LD + m + 1] * x[m + 1];
            }
            if (r % 2) acc0 += Skk[r * LD + r - 1] * x[r - 1];
            x[r] = ((r == lane ? T(1) : T(0)) - (acc0 + acc1)) * rd[r];
            Ds[r * TLD + lane] = x[r];
          }
        }
      }
    }
    // 2. meanwhile the other warps form the rows below, L21 = A21
    // L11^{-T}, by forward substitution: a thread a row, the row in
    // registers
    for (int i = tid - 32; i >= 0 && i < rows; i += THREADS - 32) {
      const T* arow = S + (k0 + w + i) * LD + k0;
      T y[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j < w) {
          T acc0 = arow[j], acc1 = T(0);
#pragma unroll
          for (int m = 0; m + 1 < j; m += 2) {
            acc0 -= y[m] * Skk[j * LD + m];
            acc1 -= y[m + 1] * Skk[j * LD + m + 1];
          }
          if (j % 2) acc0 -= y[j - 1] * Skk[j * LD + j - 1];
          y[j] = (acc0 + acc1) * rd[j];
          P[i * TLD + j] = y[j];
        }
      }
    }
    __syncthreads();
    // 3. L21 into the panel, and the trailing update A22 -= L21 L21^T in
    // 2 x 2 tiles of the lower triangle
    for (int e = tid; e < rows * w; e += THREADS) {
      const int i = e / w, j = e % w;
      S[(k0 + w + i) * LD + k0 + j] = P[i * TLD + j];
    }
    const int half = (rows + 1) / 2;
    for (int t = tid; t < half * (half + 1) / 2; t += THREADS) {
      int ti, tc;
      tri_tile(t, ti, tc);
      const int i = 2 * ti, c = 2 * tc;
      const T* pi = P + i * TLD;
      const T* pc = P + c * TLD;
      T s00 = T(0), s01 = T(0), s10 = T(0), s11 = T(0);
      for (int j = 0; j < w; ++j) {
        const T a0 = pi[j], a1 = pi[TLD + j], b0 = pc[j], b1 = pc[TLD + j];
        s00 += a0 * b0;
        s01 += a0 * b1;
        s10 += a1 * b0;
        s11 += a1 * b1;
      }
      T* out = S + (k0 + w + i) * LD + k0 + w + c;
      out[0] -= s00;
      if (c < i) out[1] -= s01;
      if (i + 1 < rows) {
        out[LD] -= s10;
        if (c + 1 < rows) out[LD + 1] -= s11;
      }
    }
    __syncthreads();
  }

  const bool bad = failed != 0;
  const T nan = static_cast<T>(NAN);
  for (int r = warp; r < n; r += WARPS) {
    for (int c = lane; c < n; c += 32) {
      L[r * l_r + c] = c <= r ? (bad ? nan : S[r * LD + c]) : T(0);
    }
  }
  __syncthreads();  // L is stored: the inverse overwrites it

  // the inverse: the diagonal blocks are the sub-panels' inverses ...
  for (int r = warp; r < n; r += WARPS) {
    const int c0 = r / SUB * SUB;
    for (int c = c0 + lane; c <= r; c += 32) {
      S[r * LD + c] = D[(r / SUB) * SUB * TLD + (r % SUB) * TLD + c - c0];
    }
  }
  __syncthreads();
  // ... and block row s below them is -D_s (L[s, :s] iL[:s, :s]), both
  // products in 2 x 2 tiles (r0 is even, so a tile's two columns lie
  // below the diagonal but for the first term of its second column)
  for (int s = 1; s < subs; ++s) {
    const int r0 = s * SUB, w = min(SUB, n - r0);
    const T* Ds = D + s * SUB * TLD;
    const int tr = (w + 1) / 2, tiles = tr * (r0 / 2);
    for (int t = tid; t < tiles; t += THREADS) {
      const int r = 2 * (t / (r0 / 2)), c = 2 * (t % (r0 / 2));
      const T* l0 = S + (r0 + r) * LD;
      const T* l1 = l0 + LD;
      T x00 = l0[c] * S[c * LD + c], x10 = l1[c] * S[c * LD + c];
      T x01 = T(0), x11 = T(0);
      for (int d = c + 1; d < r0; ++d) {
        const T a0 = l0[d], a1 = l1[d];
        const T b0 = S[d * LD + c], b1 = S[d * LD + c + 1];
        x00 += a0 * b0;
        x01 += a0 * b1;
        x10 += a1 * b0;
        x11 += a1 * b1;
      }
      P[r * XLD + c] = x00;
      P[r * XLD + c + 1] = x01;
      P[(r + 1) * XLD + c] = x10;
      P[(r + 1) * XLD + c + 1] = x11;
    }
    __syncthreads();
    for (int t = tid; t < tiles; t += THREADS) {
      const int r = 2 * (t / (r0 / 2)), c = 2 * (t % (r0 / 2));
      const T* d0 = Ds + r * TLD;
      const T* d1 = d0 + TLD;
      T y00 = T(0), y01 = T(0), y10 = T(0), y11 = T(0);
      for (int m = 0; m <= r; ++m) {
        const T b0 = P[m * XLD + c], b1 = P[m * XLD + c + 1];
        y00 += d0[m] * b0;
        y01 += d0[m] * b1;
        y10 += d1[m] * b0;
        y11 += d1[m] * b1;
      }
      if (r + 1 < w) {
        const T b0 = P[(r + 1) * XLD + c], b1 = P[(r + 1) * XLD + c + 1];
        y10 += d1[r + 1] * b0;
        y11 += d1[r + 1] * b1;
      }
      S[(r0 + r) * LD + c] = -y00;
      S[(r0 + r) * LD + c + 1] = -y01;
      if (r + 1 < w) {
        S[(r0 + r + 1) * LD + c] = -y10;
        S[(r0 + r + 1) * LD + c + 1] = -y11;
      }
    }
    __syncthreads();
  }
  for (int r = warp; r < n; r += WARPS) {
    for (int c = lane; c < n; c += 32) {
      const T v = c <= r ? S[r * LD + c] : T(0);
      iL[r * i_r + c] = bad ? nan : v;
    }
  }
}

template <typename T>
int launch(const T* A, long long a_b, long long a_r, T* L, long long l_b,
           long long l_r, T* iL, long long i_b, long long i_r, int batch,
           int n, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || n > NMAX || A == nullptr || L == nullptr ||
      iL == nullptr || a_r < n || l_r < n || i_r < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = SMEM_ELEMS * (int)sizeof(T);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  chol_panel_kernel<T><<<batch, THREADS, bytes, stream>>>(
      A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, n);
  return (int)cudaGetLastError();
}

}  // namespace chol_panel

// A (batch, n, n) through a_b (batch stride) and a_r (row stride), in
// elements, its last stride 1; L and iL likewise.  Returns a CUDA error
// code, 0 on success.
extern "C" int hetmogp_chol_panel_f32(const float* A, long long a_b,
                                      long long a_r, float* L, long long l_b,
                                      long long l_r, float* iL, long long i_b,
                                      long long i_r, int batch, int n,
                                      cudaStream_t stream) {
  return chol_panel::launch(A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, batch, n,
                            stream);
}

extern "C" int hetmogp_chol_panel_f64(const double* A, long long a_b,
                                      long long a_r, double* L,
                                      long long l_b, long long l_r,
                                      double* iL, long long i_b,
                                      long long i_r, int batch, int n,
                                      cudaStream_t stream) {
  return chol_panel::launch(A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, batch, n,
                            stream);
}
