// The host build of kernel 6's arithmetic (gh_sweep.cuh), for the CPU
// tests: the per-row routine of the per-engine sweep (gh_sweep_kernel.cu),
// each row's 32 lane sums added by its shuffle tree (gh::sweep_row); the
// per-row routine of the task table (ve_tasks_kernel.cu): a row's lanes,
// their fixed tree and the closed form on its jet (gh::task_row); and
// digamma and trigamma, behind a plain C interface that
// tests/test_torch_sweep.py and tests/test_torch_task_var_exp.py load with
// ctypes after compiling this file with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libgh_sweep_host.so gh_sweep_host.cpp
//
// The CUDA build (ops/_build.py) compiles the *.cu sources only.

#include "gh_sweep.cuh"

namespace {

template <typename Fam, typename T>
void rows(const T* m, const T* v, const T* y, long long sm, long long sv,
          long long sy, const T* nodes, const T* w, int S, int N, int deriv,
          T* out) {
  constexpr int J = Fam::J;
  constexpr int A = 1 + 2 * J;
  for (int n = 0; n < N; ++n) {
    T acc[A];
    const T* mn = m + n * sm;
    const T* vn = v + n * sv;
    const T* yn = y + n * sy;
    if (deriv) {
      gh::sweep_row<Fam, T, true>(mn, vn, yn, nodes, w, S, acc);
    } else {
      gh::sweep_row<Fam, T, false>(mn, vn, yn, nodes, w, S, acc);
      for (int a = 1; a < A; ++a) acc[a] = T(0);
    }
    for (int a = 0; a < A; ++a) out[(long long)n * A + a] = acc[a];
  }
}

// the kernel's family codes and J (gh_sweep_kernel.cu: dispatch); out is
// (N, 1 + 2 J): the value, Ed1, Ed2
template <typename T>
int dispatch(int family, int J, const T* m, const T* v, const T* y,
             long long sm, long long sv, long long sy, const T* nodes,
             const T* w, int S, int N, int deriv, T* out) {
  switch (family * 8 + J) {
    case 0 * 8 + 1:
      rows<gh::Bernoulli<T>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv, out);
      return 0;
    case 1 * 8 + 1:
      rows<gh::Categorical<T, 2>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv,
                                  out);
      return 0;
    case 1 * 8 + 2:
      rows<gh::Categorical<T, 3>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv,
                                  out);
      return 0;
    case 1 * 8 + 3:
      rows<gh::Categorical<T, 4>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv,
                                  out);
      return 0;
    case 1 * 8 + 4:
      rows<gh::Categorical<T, 5>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv,
                                  out);
      return 0;
    case 1 * 8 + 5:
      rows<gh::Categorical<T, 6>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv,
                                  out);
      return 0;
    case 2 * 8 + 1:
      rows<gh::LnGamma<T>>(m, v, y, sm, sv, sy, nodes, w, S, N, deriv, out);
      return 0;
    default:
      return 1;
  }
}

template <typename Task, typename T>
void task_rows(const T* m, const T* v, const T* y, long long sm, long long sv,
               long long sy, const T* c, const T* nodes, const T* w, int S,
               const int* sizes, int L, int N, int deriv, T* out) {
  constexpr int J = Task::J;
  constexpr int A = 1 + 2 * J;
  for (int n = 0; n < N; ++n) {
    T* o = out + (long long)n * A;
    for (int a = 0; a < A; ++a) o[a] = T(0);
    const T* mn = m + n * sm;
    const T* vn = v + n * sv;
    const T* yn = y + n * sy;
    if (deriv) {
      gh::task_row<Task, T, true>(mn, vn, yn, c, nodes, w, S, sizes, L, o);
    } else {
      gh::task_row<Task, T, false>(mn, vn, yn, c, nodes, w, S, sizes, L, o);
    }
  }
}

// the task table's family codes and J (ve_tasks_kernel.cu: dispatch_block;
// ops/quadrature.py::TASK_FAMILIES); out is (N, 1 + 2 J): the value, c_m,
// c_v (zeros without deriv)
template <typename T>
int task_dispatch(int family, int J, int L, const T* m, const T* v,
                  const T* y, long long sm, long long sv, long long sy,
                  const T* nodes, const T* w, int S, const int* sizes,
                  const double* consts, int N, int deriv, T* out) {
  if (L < 1) return 1;
  // the kernel's constants: the table's float64 ones in the task's type
  const T c[2] = {T(consts[0]), T(consts[1])};
#define GH_TASK(...)                                                      \
  task_rows<__VA_ARGS__>(m, v, y, sm, sv, sy, c, nodes, w, S, sizes, L, N, \
                         deriv, out);                                      \
  return 0
  switch (family * 8 + J) {
    case 0 * 8 + 1: GH_TASK(gh::BernoulliTask<T>);
    case 1 * 8 + 1: GH_TASK(gh::CategoricalTask<T, 2>);
    case 1 * 8 + 2: GH_TASK(gh::CategoricalTask<T, 3>);
    case 1 * 8 + 3: GH_TASK(gh::CategoricalTask<T, 4>);
    case 1 * 8 + 4: GH_TASK(gh::CategoricalTask<T, 5>);
    case 1 * 8 + 5: GH_TASK(gh::CategoricalTask<T, 6>);
    case 2 * 8 + 2: GH_TASK(gh::HetGaussianTask<T>);
    case 3 * 8 + 1: GH_TASK(gh::PoissonTask<T>);
    case 4 * 8 + 2: GH_TASK(gh::GammaTask<T>);
    case 5 * 8 + 1: GH_TASK(gh::ExponentialTask<T>);
    case 6 * 8 + 2: GH_TASK(gh::BetaTask<T>);
    case 7 * 8 + 1: GH_TASK(gh::BinomialTask<T>);
    case 8 * 8 + 2: GH_TASK(gh::DirichletTask<T, 2>);
    case 8 * 8 + 3: GH_TASK(gh::DirichletTask<T, 3>);
    case 9 * 8 + 2: GH_TASK(gh::ZipTask<T>);
    default: return 1;
  }
#undef GH_TASK
}

}  // namespace

// L: the lanes a row of a swept family (the kernel's, for its order of
// additions); the closed forms ignore it and the nodes.  S: the nodes of
// the table; sizes: each term's node count (a multi-term family's; the
// others ignore it); consts: the task's two float64 constants.
extern "C" int gh_task_rows_f32(int family, int J, int L, const float* m,
                                const float* v, const float* y, long long sm,
                                long long sv, long long sy,
                                const float* nodes, const float* w, int S,
                                const int* sizes, const double* consts,
                                int N, int deriv, float* out) {
  return task_dispatch<float>(family, J, L, m, v, y, sm, sv, sy, nodes, w, S,
                              sizes, consts, N, deriv, out);
}

extern "C" int gh_task_rows_f64(int family, int J, int L, const double* m,
                                const double* v, const double* y,
                                long long sm, long long sv, long long sy,
                                const double* nodes, const double* w, int S,
                                const int* sizes, const double* consts,
                                int N, int deriv, double* out) {
  return task_dispatch<double>(family, J, L, m, v, y, sm, sv, sy, nodes, w,
                               S, sizes, consts, N, deriv, out);
}

extern "C" int gh_sweep_rows_f32(int family, int J, const float* m,
                                 const float* v, const float* y, long long sm,
                                 long long sv, long long sy,
                                 const float* nodes, const float* w, int S,
                                 int N, int deriv, float* out) {
  return dispatch<float>(family, J, m, v, y, sm, sv, sy, nodes, w, S, N,
                         deriv, out);
}

extern "C" int gh_sweep_rows_f64(int family, int J, const double* m,
                                 const double* v, const double* y,
                                 long long sm, long long sv, long long sy,
                                 const double* nodes, const double* w, int S,
                                 int N, int deriv, double* out) {
  return dispatch<double>(family, J, m, v, y, sm, sv, sy, nodes, w, S, N,
                          deriv, out);
}

extern "C" float gh_digamma_f32(float x) { return gh::digamma(x); }
extern "C" double gh_digamma_f64(double x) { return gh::digamma(x); }
extern "C" float gh_trigamma_f32(float x) { return gh::trigamma(x); }
extern "C" double gh_trigamma_f64(double x) { return gh::trigamma(x); }
