// The host build of kernel 6's sweep (gh_sweep.cuh), for the CPU tests: the
// per-row routine the kernel runs, each row's 32 lane sums added by the
// kernel's shuffle tree (gh::sweep_row), and digamma and trigamma, behind a
// plain C interface that tests/test_torch_sweep.py loads with ctypes after
// compiling this file with a host C++ compiler:
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

}  // namespace

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
