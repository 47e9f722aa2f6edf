// Kernel 6: the one-pass Gauss-Hermite sweep on Hopper (sm_90a), float32
// and float64.
//
// For each row n of (m, v) (N, J), y (N, dim_y) and a node table nodes
// (S, J), w (S,): value[n] = sum_s w_s lp(F_ns), and unless only the value
// is asked for, Ed1[n, j] = sum_s w_s d lp / dF_j and Ed2[n, j] =
// sum_s w_s d2 lp / dF_j^2, F_ns = m_n + sqrt(2 v_n) t_s.  The families' log
// densities and the jets that differentiate them are in gh_sweep.cuh.
//
// Replaces no Pallas kernel: it is the JAX package's one fused grid sweep,
// hetmogp_tpu/ops/quadrature.py::make_var_exp's ve_fwd (:129-146), which XLA
// fuses into one program on the TPU ("lp, dlogp and d2logp share their
// transcendental subexpressions").  The plain version, the autograd engine
// of ops/quadrature.py, runs the sweep as a string of elementwise kernels
// over an (N, S, J) node tensor and J + 1 backward passes.
//
// What bounds it on an H100: neither bytes nor operations at the trainer's
// shapes.  A step's sweeps read a few KiB (512 rows a task, 128 in the VM
// step) and do ~20-100 nodes of ~50-300 operations a row: a few
// microseconds of work, below the cost of a launch.  So the design spends
// nothing on the memory side and all on doing the work in one launch:
//   * one warp a row, its 32 lanes taking the nodes s = lane, lane + 32,
//     ...; the lanes' sums meet in a fixed xor-shuffle tree, so the result
//     does not depend on scheduling (no atomics: graphed steps stay bitwise
//     equal to eager ones);
//   * one evaluation of the log density per node gives the value and both
//     derivatives (the jets of gh_sweep.cuh): the shared exp, log and lgamma
//     are computed once;
//   * the value alone (no input needs a gradient) takes the plain scalar
//     instantiation and writes (N,).
// m, v and y are read with a row stride, so the column slices the closed
// forms pass (Gamma's M[:, :1]) need no copy.  No fast-math: expf, logf,
// lgammaf and IEEE division, and the nodes rounded as the plain engine
// rounds them (gh_sweep.cuh: mul_rn, add_rn).

#include <cuda_runtime.h>

#include "gh_sweep.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // warps of a 256-thread block
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename Fam, typename T, bool DERIV>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    gh_sweep_kernel(const T* __restrict__ m, const T* __restrict__ v,
                    const T* __restrict__ y, long long sm, long long sv,
                    long long sy, const T* __restrict__ nodes,
                    const T* __restrict__ w, int S, int N, T* __restrict__ val,
                    T* __restrict__ ed1, T* __restrict__ ed2) {
  constexpr int J = Fam::J;
  constexpr int A = gh::acc_size<Fam, DERIV>();
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp: one row a warp
  T acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = T(0);
  gh::sweep_nodes<Fam, T, DERIV>(m + row * sm, v + row * sv, y + row * sy,
                                 nodes, w, S, lane, gh::LANES, acc);
  // the butterfly of gh::sweep_row: lane l adds lane l ^ off
#pragma unroll
  for (int off = gh::LANES / 2; off > 0; off /= 2) {
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] += __shfl_xor_sync(FULL_MASK, acc[a], off);
  }
  if (lane == 0) {
    val[row] = acc[0];
    if constexpr (DERIV) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ed1[(long long)row * J + j] = acc[1 + j];
        ed2[(long long)row * J + j] = acc[1 + J + j];
      }
    }
  }
}

template <typename Fam, typename T>
int launch(const T* m, const T* v, const T* y, long long sm, long long sv,
           long long sy, const T* nodes, const T* w, int S, int N, T* val,
           T* ed1, T* ed2, cudaStream_t stream) {
  const dim3 grid((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const dim3 block(ROWS_PER_BLOCK * 32);
  if (ed1 != nullptr) {
    gh_sweep_kernel<Fam, T, true><<<grid, block, 0, stream>>>(
        m, v, y, sm, sv, sy, nodes, w, S, N, val, ed1, ed2);
  } else {
    gh_sweep_kernel<Fam, T, false><<<grid, block, 0, stream>>>(
        m, v, y, sm, sv, sy, nodes, w, S, N, val, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// family: 0 Bernoulli (J = 1), 1 Categorical (K = J + 1, J = 1..5),
// 2 LnGamma (J = 1); the codes of ops/quadrature.py::SWEEP_FAMILIES
template <typename T>
int dispatch(int family, int J, const T* m, const T* v, const T* y,
             long long sm, long long sv, long long sy, const T* nodes,
             const T* w, int S, int N, T* val, T* ed1, T* ed2,
             cudaStream_t stream) {
  if (N <= 0 || S <= 0 || N > (1 << 28) || (ed1 == nullptr) != (ed2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  using Cat2 = gh::Categorical<T, 2>;
  using Cat3 = gh::Categorical<T, 3>;
  using Cat4 = gh::Categorical<T, 4>;
  using Cat5 = gh::Categorical<T, 5>;
  using Cat6 = gh::Categorical<T, 6>;
#define GH_LAUNCH(FAM) \
  launch<FAM, T>(m, v, y, sm, sv, sy, nodes, w, S, N, val, ed1, ed2, stream)
  switch (family) {
    case 0:
      if (J == 1) return GH_LAUNCH(gh::Bernoulli<T>);
      break;
    case 1:
      switch (J) {
        case 1: return GH_LAUNCH(Cat2);
        case 2: return GH_LAUNCH(Cat3);
        case 3: return GH_LAUNCH(Cat4);
        case 4: return GH_LAUNCH(Cat5);
        case 5: return GH_LAUNCH(Cat6);
        default: break;
      }
      break;
    case 2:
      if (J == 1) return GH_LAUNCH(gh::LnGamma<T>);
      break;
    default:
      break;
  }
#undef GH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ed1 and ed2 null: the value alone.
extern "C" int hetmogp_gh_sweep_f32(int family, int J, const float* m,
                                    const float* v, const float* y,
                                    long long sm, long long sv, long long sy,
                                    const float* nodes, const float* w, int S,
                                    int N, float* val, float* ed1, float* ed2,
                                    cudaStream_t stream) {
  return dispatch<float>(family, J, m, v, y, sm, sv, sy, nodes, w, S, N, val,
                         ed1, ed2, stream);
}

extern "C" int hetmogp_gh_sweep_f64(int family, int J, const double* m,
                                    const double* v, const double* y,
                                    long long sm, long long sv, long long sy,
                                    const double* nodes, const double* w,
                                    int S, int N, double* val, double* ed1,
                                    double* ed2, cudaStream_t stream) {
  return dispatch<double>(family, J, m, v, y, sm, sv, sy, nodes, w, S, N, val,
                          ed1, ed2, stream);
}
