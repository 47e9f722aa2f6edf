// The one-pass Gauss-Hermite sweep of kernel 6: per row, the value and the
// reduced first and diagonal second derivatives of a likelihood's
// log-density over the row's quadrature nodes,
//
//   value   = sum_s w_s lp(F_s, y),
//   Ed1[j]  = sum_s w_s d lp / dF_j (F_s, y),
//   Ed2[j]  = sum_s w_s d2 lp / dF_j^2 (F_s, y),     F_s = m + sqrt(2 v) t_s,
//
// (each family's lp(f, y, c) also takes the constants c of a task of the
// task table, below; the per-engine sweep passes none),
//
// written once for the device and for the host: every function here is
// plain C++ behind GH_HD, which is __host__ __device__ under nvcc and empty
// under a host compiler, so tests/test_torch_sweep.py compiles this very
// header with g++ and holds it to the plain engine on the CPU.
//
// No derivative is written by hand.  Each family's log-density is one
// template on a scalar type S: S = T gives the value alone, S = Jet<T, J>
// (a second-order forward-mode jet carrying the value, the J first
// derivatives and the J diagonal second derivatives) gives all three in the
// same evaluation.  The diagonal second derivatives propagate exactly from
// first derivatives and diagonal entries alone:
//   (a b)''_jj = a'' b + 2 a'_j b'_j + a b'',
//   g(a)''_jj  = g''(a) a'_j^2 + g'(a) a''_jj.
//
// The rules at the edges are those of torch's autograd, over which the plain
// engine (ops/quadrature.py::make_var_exp) differentiates: a clamp passes
// the derivative inside its bounds, the bounds included, and gives exactly
// zero outside (a select, not a product); maximum splits it evenly at a tie;
// abs has derivative sign(x), 0 at 0.  Quotients and logarithms are
// differentiated in the forms that never square a large value
// ((a' - q b') / b, a'/a), as autograd's backward formulas do, so that no
// derivative overflows where the plain engine's does not.
//
// The families (the plain versions are in likelihoods/*.py):
//   Bernoulli          likelihoods/bernoulli.py  (J = 1)
//   Categorical<K>     likelihoods/categorical.py (J = K - 1)
//   LnGamma            likelihoods/gamma.py::_lngamma (J = 1): the sweep of
//                      Gamma's closed form, shared by Beta and Dirichlet.
// and, only as terms of the task table's families (below):
//   LnGammaSum<K>      likelihoods/beta.py::_lngamma_sum (K = 2) and
//                      dirichlet.py::_lngamma_sum (J = K)
//   Binomial           likelihoods/binomial.py (J = 1; n a task constant)
//   ZeroInflatedPoisson likelihoods/zipoisson.py (J = 2)
// lgamma's derivatives need digamma and trigamma, which CUDA's math library
// lacks: both are here, by the recurrence up to x >= 10 and the asymptotic
// series (good to a few ulps of float64 over the clip range [1e-9, 1e9]).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GH_HD __host__ __device__
#else
#define GH_HD
#endif

namespace gh {

// ---- scalar functions in float and double -----------------------------------

GH_HD inline float exp_(float x) { return expf(x); }
GH_HD inline double exp_(double x) { return exp(x); }
GH_HD inline float log_(float x) { return logf(x); }
GH_HD inline double log_(double x) { return log(x); }
GH_HD inline float log1p_(float x) { return log1pf(x); }
GH_HD inline double log1p_(double x) { return log1p(x); }
GH_HD inline float lgamma_(float x) { return lgammaf(x); }
GH_HD inline double lgamma_(double x) { return lgamma(x); }
GH_HD inline float sqrt_(float x) { return sqrtf(x); }
GH_HD inline double sqrt_(double x) { return sqrt(x); }
GH_HD inline float abs_(float x) { return fabsf(x); }
GH_HD inline double abs_(double x) { return fabs(x); }

// A product and a sum rounded on their own, never contracted into one fused
// multiply-add: the nodes F = m + sqrt(2 v) t are then the plain engine's to
// the bit.
GH_HD inline float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
GH_HD inline double mul_rn(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
GH_HD inline float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
GH_HD inline double add_rn(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

template <typename T>
GH_HD inline bool isnan_(T x) {
  return x != x;
}

// torch.clamp: NaN stays NaN, else min(max(x, lo), hi)
template <typename T>
GH_HD inline T clamp_(T x, T lo, T hi) {
  return isnan_(x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}
template <typename T>
GH_HD inline T clamp_max_(T x, T hi) {
  return isnan_(x) ? x : (x > hi ? hi : x);
}
// torch.maximum: NaN if either is NaN
template <typename T>
GH_HD inline T maximum_(T a, T b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a < b ? b : a));
}

// digamma(x) for x > 0: psi(x) = psi(x + n) - sum_k 1 / (x + k) up to
// x + n >= 10, then ln x - 1/(2x) - sum_k B_2k / (2k x^2k) to x^-14 (the
// first term left out is below 5e-17 of the result at x = 10)
template <typename T>
GH_HD inline T digamma(T x) {
  T acc = T(0);
  while (x < T(10)) {
    acc -= T(1) / x;
    x += T(1);
  }
  const T r = T(1) / x, z = r * r;
  const T series =
      z * (T(1.0 / 12) -
           z * (T(1.0 / 120) -
                z * (T(1.0 / 252) -
                     z * (T(1.0 / 240) -
                          z * (T(1.0 / 132) -
                               z * (T(691.0 / 32760) - z * T(1.0 / 12)))))));
  return acc + (log_(x) - T(0.5) * r - series);
}

// trigamma(x) for x > 0: psi'(x) = psi'(x + n) + sum_k 1 / (x + k)^2 up to
// x + n >= 10, then 1/x + 1/(2x^2) + sum_k B_2k / x^(2k+1) to x^-15
template <typename T>
GH_HD inline T trigamma(T x) {
  T acc = T(0);
  while (x < T(10)) {
    acc += T(1) / (x * x);
    x += T(1);
  }
  const T r = T(1) / x, z = r * r;
  const T series =
      r * (T(1) + T(0.5) * r +
           z * (T(1.0 / 6) -
                z * (T(1.0 / 30) -
                     z * (T(1.0 / 42) -
                          z * (T(1.0 / 30) -
                               z * (T(5.0 / 66) -
                                    z * (T(691.0 / 2730) -
                                         z * T(7.0 / 6))))))));
  return acc + series;
}

// ---- the jet ------------------------------------------------------------------

template <typename T, int J>
struct Jet {
  T v;
  T d[J];
  T h[J];

  GH_HD Jet() {}
  // a constant: no derivatives
  GH_HD explicit Jet(T c) : v(c) {
    for (int j = 0; j < J; ++j) d[j] = h[j] = T(0);
  }
  // the j-th variable, at x
  GH_HD static Jet variable(T x, int j) {
    Jet r(x);
    r.d[j] = T(1);
    return r;
  }
};

template <typename T, int J>
GH_HD inline Jet<T, J> operator+(const Jet<T, J>& a, const Jet<T, J>& b) {
  Jet<T, J> r;
  r.v = a.v + b.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = a.d[j] + b.d[j];
    r.h[j] = a.h[j] + b.h[j];
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator+(const Jet<T, J>& a, T c) {
  Jet<T, J> r = a;
  r.v = a.v + c;
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator+(T c, const Jet<T, J>& a) {
  Jet<T, J> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator-(const Jet<T, J>& a) {
  Jet<T, J> r;
  r.v = -a.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = -a.d[j];
    r.h[j] = -a.h[j];
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator-(const Jet<T, J>& a, T c) {
  Jet<T, J> r = a;
  r.v = a.v - c;
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator-(const Jet<T, J>& a, const Jet<T, J>& b) {
  Jet<T, J> r;
  r.v = a.v - b.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = a.d[j] - b.d[j];
    r.h[j] = a.h[j] - b.h[j];
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator*(const Jet<T, J>& a, const Jet<T, J>& b) {
  Jet<T, J> r;
  r.v = a.v * b.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = a.d[j] * b.v + a.v * b.d[j];
    r.h[j] = a.h[j] * b.v + T(2) * (a.d[j] * b.d[j]) + a.v * b.h[j];
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator*(T c, const Jet<T, J>& a) {
  Jet<T, J> r;
  r.v = c * a.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = c * a.d[j];
    r.h[j] = c * a.h[j];
  }
  return r;
}
// q = a / b: q' = (a' - q b') / b, q'' = (a'' - 2 q' b' - q b'') / b
template <typename T, int J>
GH_HD inline Jet<T, J> operator/(const Jet<T, J>& a, const Jet<T, J>& b) {
  Jet<T, J> r;
  r.v = a.v / b.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = (a.d[j] - r.v * b.d[j]) / b.v;
    r.h[j] = (a.h[j] - T(2) * (r.d[j] * b.d[j]) - r.v * b.h[j]) / b.v;
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> operator/(T c, const Jet<T, J>& b) {
  Jet<T, J> r;
  r.v = c / b.v;
  for (int j = 0; j < J; ++j) {
    r.d[j] = -(r.v * b.d[j]) / b.v;
    r.h[j] = (-T(2) * (r.d[j] * b.d[j]) - r.v * b.h[j]) / b.v;
  }
  return r;
}

// g(a) with g'(a) = g1 and g''(a) = g2 at a.v
template <typename T, int J>
GH_HD inline Jet<T, J> chain(const Jet<T, J>& a, T g0, T g1, T g2) {
  Jet<T, J> r;
  r.v = g0;
  for (int j = 0; j < J; ++j) {
    r.d[j] = g1 * a.d[j];
    r.h[j] = g2 * a.d[j] * a.d[j] + g1 * a.h[j];
  }
  return r;
}
// the derivatives of a kept (mask true) or exactly zero (mask false), with
// the value v
template <typename T, int J>
GH_HD inline Jet<T, J> select(const Jet<T, J>& a, T v, bool keep) {
  Jet<T, J> r = keep ? a : Jet<T, J>(T(0));
  r.v = v;
  return r;
}

template <typename T, int J>
GH_HD inline Jet<T, J> exp_(const Jet<T, J>& a) {
  const T e = exp_(a.v);
  return chain(a, e, e, e);
}
// (log a)' = a'/a, (log a)'' = a''/a - (a'/a)^2
template <typename T, int J>
GH_HD inline Jet<T, J> log_(const Jet<T, J>& a) {
  Jet<T, J> r;
  r.v = log_(a.v);
  for (int j = 0; j < J; ++j) {
    r.d[j] = a.d[j] / a.v;
    r.h[j] = a.h[j] / a.v - r.d[j] * r.d[j];
  }
  return r;
}
template <typename T, int J>
GH_HD inline Jet<T, J> log1p_(const Jet<T, J>& a) {
  const T g1 = T(1) / (T(1) + a.v);
  return chain(a, log1p_(a.v), g1, -(g1 * g1));
}
template <typename T, int J>
GH_HD inline Jet<T, J> lgamma_(const Jet<T, J>& a) {
  return chain(a, lgamma_(a.v), digamma(a.v), trigamma(a.v));
}
template <typename T, int J>
GH_HD inline Jet<T, J> abs_(const Jet<T, J>& a) {
  const T s = a.v > T(0) ? T(1) : (a.v < T(0) ? T(-1) : T(0));
  return chain(a, abs_(a.v), s, T(0));
}
template <typename T, int J>
GH_HD inline Jet<T, J> clamp_(const Jet<T, J>& a, T lo, T hi) {
  return select(a, clamp_(a.v, lo, hi), a.v >= lo && a.v <= hi);
}
template <typename T, int J>
GH_HD inline Jet<T, J> clamp_max_(const Jet<T, J>& a, T hi) {
  return select(a, clamp_max_(a.v, hi), a.v <= hi);
}
template <typename T, int J>
GH_HD inline Jet<T, J> maximum_(const Jet<T, J>& a, const Jet<T, J>& b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  if (isnan_(a.v) || isnan_(b.v)) {  // autograd passes both derivatives
    Jet<T, J> r = a + b;
    r.v = maximum_(a.v, b.v);
    return r;
  }
  Jet<T, J> r = T(0.5) * (a + b);  // a tie splits the derivative
  r.v = a.v;
  return r;
}

// ---- the first-order jet of the closed forms -----------------------------------
//
// Dual<T, D> carries a value and its D first derivatives.  The closed forms
// of the task table (below) are evaluated on it at (m, v) in the 2J
// directions m_0 .. m_{J-1}, v_0 .. v_{J-1}: their exact gradient, the one
// autograd takes of the plain closed form, by the same edge rules.

template <typename T, int D>
struct Dual {
  T v;
  T d[D];

  GH_HD Dual() {}
  GH_HD explicit Dual(T c) : v(c) {
    for (int k = 0; k < D; ++k) d[k] = T(0);
  }
  GH_HD static Dual variable(T x, int k) {
    Dual r(x);
    r.d[k] = T(1);
    return r;
  }
};

template <typename T, int D>
GH_HD inline Dual<T, D> operator+(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v + b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator+(const Dual<T, D>& a, T c) {
  Dual<T, D> r = a;
  r.v = a.v + c;
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator+(T c, const Dual<T, D>& a) {
  Dual<T, D> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator-(const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = -a.v;
  for (int k = 0; k < D; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator-(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v - b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator-(const Dual<T, D>& a, T c) {
  Dual<T, D> r = a;
  r.v = a.v - c;
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator-(T c, const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = c - a.v;
  for (int k = 0; k < D; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator*(const Dual<T, D>& a, const Dual<T, D>& b) {
  Dual<T, D> r;
  r.v = a.v * b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator*(T c, const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = c * a.v;
  for (int k = 0; k < D; ++k) r.d[k] = c * a.d[k];
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> operator*(const Dual<T, D>& a, T c) {
  Dual<T, D> r;
  r.v = a.v * c;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * c;
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> exp_(const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = exp_(a.v);
  for (int k = 0; k < D; ++k) r.d[k] = r.v * a.d[k];
  return r;
}
template <typename T>
GH_HD inline T square_(T x) {
  return x * x;
}
template <typename T, int D>
GH_HD inline Dual<T, D> square_(const Dual<T, D>& a) {
  Dual<T, D> r;
  r.v = a.v * a.v;
  const T g = T(2) * a.v;
  for (int k = 0; k < D; ++k) r.d[k] = g * a.d[k];
  return r;
}
// a clamp passes the derivative inside its bounds, the bounds included
template <typename T, int D>
GH_HD inline Dual<T, D> clamp_(const Dual<T, D>& a, T lo, T hi) {
  Dual<T, D> r = a.v >= lo && a.v <= hi ? a : Dual<T, D>(T(0));
  r.v = clamp_(a.v, lo, hi);
  return r;
}
template <typename T, int D>
GH_HD inline Dual<T, D> clamp_max_(const Dual<T, D>& a, T hi) {
  Dual<T, D> r = a.v <= hi ? a : Dual<T, D>(T(0));
  r.v = clamp_max_(a.v, hi);
  return r;
}

// ---- the pieces of likelihoods/base.py ----------------------------------------

template <typename T>
struct Limits;
// safe_exp's clip, log(finfo.max) - 1, as likelihoods/base.py computes it
// and safe_square's, sqrt(finfo.max) / 2
template <>
struct Limits<float> {
  GH_HD static float safe_exp() { return float(87.72283905206835); }
  GH_HD static float safe_square() { return float(9.223371761976865e+18); }
};
template <>
struct Limits<double> {
  GH_HD static double safe_exp() { return 708.782712893384; }
  GH_HD static double safe_square() { return 6.703903964971298e+153; }
};

template <typename T, typename S>
GH_HD inline S safe_exp_(const S& x) {
  return exp_(clamp_max_(x, Limits<T>::safe_exp()));
}

// base.safe_square: the square of x clipped to +-sqrt(finfo.max) / 2
template <typename T, typename S>
GH_HD inline S safe_square_(const S& x) {
  const T lim = Limits<T>::safe_square();
  return square_(clamp_(x, -lim, lim));
}

// base.logaddexp: max(a, b) + log1p(e^{-|a - b|})
template <typename S>
GH_HD inline S logaddexp_(const S& a, const S& b) {
  return maximum_(a, b) + log1p_(exp_(-abs_(a - b)));
}

// ---- the families -------------------------------------------------------------

// likelihoods/bernoulli.py: log p = clip(-softplus(-f)), log(1 - p) =
// clip(-softplus(f)) with the clip [log 1e-9, log1p(-1e-9)]
template <typename T, typename S>
GH_HD inline void log_probs_(const S& f, S& log_p, S& log_1mp) {
  const T lo = T(-20.72326583694641), hi = T(-1.0000000005000001e-09);
  const S zero(T(0));
  log_p = clamp_(-logaddexp_(-f, zero), lo, hi);
  log_1mp = clamp_(-logaddexp_(f, zero), lo, hi);
}

// and lp = y log p + (1 - y) log(1 - p)
template <typename T>
struct Bernoulli {
  static constexpr int J = 1;
  template <typename S>
  GH_HD static S lp(const S* f, const T* y, const T*) {
    S log_p, log_1mp;
    log_probs_<T>(f[0], log_p, log_1mp);
    return y[0] * log_p + (T(1) - y[0]) * log_1mp;
  }
};

// likelihoods/categorical.py: p_k = e^{f_k} / (1 + sum_j e^{f_j}) for
// k < K - 1 and 1 / (1 + sum_j e^{f_j}) for the last class, clipped to
// [1e-9, 1 - 1e-9] and renormalized; lp = log p_y for the 1-indexed label y
// (0 for a label outside 1..K, as the one-hot sum gives)
template <typename T, int K>
struct Categorical {
  static constexpr int J = K - 1;
  template <typename S>
  GH_HD static S lp(const S* f, const T* y, const T*) {
    S ef[J];
    for (int j = 0; j < J; ++j) ef[j] = safe_exp_<T>(f[j]);
    S sum = ef[0];
    for (int j = 1; j < J; ++j) sum = sum + ef[j];
    const S den = T(1) + sum;
    S p[K];
    for (int j = 0; j < J; ++j) p[j] = ef[j] / den;
    p[J] = T(1) / den;
    for (int k = 0; k < K; ++k) p[k] = clamp_(p[k], T(1e-9), T(1.0 - 1e-9));
    S total = p[0];
    for (int k = 1; k < K; ++k) total = total + p[k];
    S out(T(0));
    for (int k = 0; k < K; ++k) {
      if (y[0] == T(k + 1)) out = log_(p[k] / total);
    }
    return out;
  }
};

// likelihoods/gamma.py::_lngamma: lgamma(clip(e^f, 1e-9, 1e9)); y unused
template <typename T>
struct LnGamma {
  static constexpr int J = 1;
  template <typename S>
  GH_HD static S lp(const S* f, const T*, const T*) {
    return lgamma_(clamp_(safe_exp_<T>(f[0]), T(1e-9), T(1e9)));
  }
};

// likelihoods/beta.py::_lngamma_sum (K = 2), dirichlet.py::_lngamma_sum:
// lgamma(sum_k clip(e^{f_k}, 1e-9, 1e9)); y unused
template <typename T, int K>
struct LnGammaSum {
  static constexpr int J = K;
  template <typename S>
  GH_HD static S lp(const S* f, const T*, const T*) {
    S sum = clamp_(safe_exp_<T>(f[0]), T(1e-9), T(1e9));
    for (int k = 1; k < K; ++k) {
      sum = sum + clamp_(safe_exp_<T>(f[k]), T(1e-9), T(1e9));
    }
    return lgamma_(sum);
  }
};

// likelihoods/binomial.py: lgamma(n + 1) - lgamma(y + 1) - lgamma(n - y + 1)
// + y log p + (n - y) log(1 - p), with the task's constants c = (n,
// lgamma(n + 1))
template <typename T>
struct Binomial {
  static constexpr int J = 1;
  template <typename S>
  GH_HD static S lp(const S* f, const T* y, const T* c) {
    S log_p, log_1mp;
    log_probs_<T>(f[0], log_p, log_1mp);
    const T n = c[0];
    const T head = c[1] - lgamma_(y[0] + T(1)) - lgamma_(n - y[0] + T(1));
    return head + y[0] * log_p + (n - y[0]) * log_1mp;
  }
};

// likelihoods/zipoisson.py: lambda = clip(e^{f_0}, 1e-9, 1e9), pi the
// Bernoulli probability of f_1; at y = 0 logaddexp(log pi, log(1 - pi) -
// lambda), else log(1 - pi) + y f_0 - lambda - lgamma(y + 1).  The plain
// version's where() passes no derivative to the branch it does not take:
// the row's y picks one, evaluated alone
template <typename T>
struct ZeroInflatedPoisson {
  static constexpr int J = 2;
  template <typename S>
  GH_HD static S lp(const S* f, const T* y, const T*) {
    const S lam = clamp_(safe_exp_<T>(f[0]), T(1e-9), T(1e9));
    S log_pi, log_1mpi;
    log_probs_<T>(f[1], log_pi, log_1mpi);
    if (y[0] == T(0)) return logaddexp_(log_pi, log_1mpi - lam);
    return log_1mpi + ((y[0] * f[0] - lam) - lgamma_(y[0] + T(1)));
  }
};

// ---- the sweep ----------------------------------------------------------------

// Accumulators a row needs: the value, and with the derivatives J + J more.
template <typename Fam, bool DERIV>
GH_HD constexpr int acc_size() {
  return DERIV ? 1 + 2 * Fam::J : 1;
}

// Term<Fam, D...>: the integrand Fam over the latent dimensions D... of a
// row (all of its first Fam::J where D... is empty).
template <int... D>
GH_HD constexpr int nth_(int j) {
  const int d[] = {D...};
  return d[j];
}
template <typename F, int... D>
struct Term {
  using Fam = F;
  static constexpr int J = F::J;
  static_assert(sizeof...(D) == 0 || sizeof...(D) == F::J,
                "a term names its integrand's dims");
  GH_HD static constexpr int dim(int j) {
    if constexpr (sizeof...(D) == 0) {
      return j;
    } else {
      return nth_<D...>(j);
    }
  }
};

// Adds w_s times term Tm's integrand at node s (its coordinates node[0 ..
// Tm::J)) of a row into its accumulators acc (the value, then Ed1, then
// Ed2 over the term's dimensions): m the row's moments, sigma = sqrt(2 v)
// of each of them, y its (dim_y,) observation, c the task's constants.
template <typename Tm, typename T, bool DERIV>
GH_HD inline void term_node(const T* m, const T* sigma, const T* y,
                            const T* c, const T* node, T ws, T* acc) {
  constexpr int J = Tm::J;
  using Fam = typename Tm::Fam;
  if constexpr (DERIV) {
    Jet<T, J> f[J];
    for (int j = 0; j < J; ++j) {
      const int d = Tm::dim(j);
      f[j] = Jet<T, J>::variable(add_rn(m[d], mul_rn(sigma[d], node[j])), j);
    }
    const Jet<T, J> lp = Fam::template lp<Jet<T, J>>(f, y, c);
    acc[0] += ws * lp.v;
    for (int j = 0; j < J; ++j) {
      acc[1 + j] += ws * lp.d[j];
      acc[1 + J + j] += ws * lp.h[j];
    }
  } else {
    T f[J];
    for (int j = 0; j < J; ++j) {
      const int d = Tm::dim(j);
      f[j] = add_rn(m[d], mul_rn(sigma[d], node[j]));
    }
    acc[0] += ws * Fam::template lp<T>(f, y, c);
  }
}

// Adds the nodes s = first, first + step, ... < S of one row into acc (the
// value, then Ed1, then Ed2): m, v the row's (J,) moments, y its (dim_y,)
// observation, nodes (S, J) and w (S,) the table.  The kernel calls it with
// (lane, 32) and adds the 32 lanes' sums by a fixed shuffle tree; sweep_row
// below does the same on the host.
template <typename Fam, typename T, bool DERIV>
GH_HD inline void sweep_nodes(const T* m, const T* v, const T* y,
                              const T* nodes, const T* w, int S, int first,
                              int step, T* acc) {
  constexpr int J = Fam::J;
  T sigma[J];
  for (int j = 0; j < J; ++j) sigma[j] = sqrt_(mul_rn(T(2), v[j]));
  for (int s = first; s < S; s += step) {
    term_node<Term<Fam>, T, DERIV>(m, sigma, y, nullptr,
                                   nodes + (long long)s * J, w[s], acc);
  }
}

constexpr int LANES = 32;

// One row on the host, in the kernel's order: 32 lane sums, then the
// butterfly (lane l adds lane l ^ off for off = 16, 8, 4, 2, 1) as lane 0
// sees it.  out: acc_size<Fam, DERIV>() values.
template <typename Fam, typename T, bool DERIV>
inline void sweep_row(const T* m, const T* v, const T* y, const T* nodes,
                      const T* w, int S, T* out) {
  constexpr int A = acc_size<Fam, DERIV>();
  T part[LANES][A];
  for (int l = 0; l < LANES; ++l) {
    for (int a = 0; a < A; ++a) part[l][a] = T(0);
    sweep_nodes<Fam, T, DERIV>(m, v, y, nodes, w, S, l, LANES, part[l]);
  }
  for (int off = LANES / 2; off > 0; off /= 2) {
    T next[LANES][A];
    for (int l = 0; l < LANES; ++l) {
      for (int a = 0; a < A; ++a) next[l][a] = part[l][a] + part[l ^ off][a];
    }
    for (int l = 0; l < LANES; ++l) {
      for (int a = 0; a < A; ++a) part[l][a] = next[l][a];
    }
  }
  for (int a = 0; a < A; ++a) out[a] = part[0][a];
}

// ---- the task table: a likelihood's whole variational expectation ----------------
//
// What ve_tasks_kernel.cu computes for a row of a task: the value of
// E_q[log p(y | f)] and its gradient coefficients (c_m, c_v) = (dve/dm,
// dve/dv), each (J,).  A task is a list of terms (Terms, empty for a
// closed form alone), each an integrand of the families above over some of
// the task's latent dimensions (Term) swept on a node table of its own,
// and a closed form value(m, v, y, c, E) of the moments, the observation,
// the task's constants c and the terms' values E, one a term.  The closed
// form is written once, as a template on the scalar S: S = T gives the
// value alone, S = Dual<T, 2J> its gradient.  Each E[k] enters it as a
// Dual whose derivatives are term k's Bonnet/Price forms, E[d1] in the m_j
// directions of its dimensions and E[d2] / 2 in the v_j ones, so that
//   c = (closed form's own partial derivatives) + (the terms', through E),
// which is what the plain engines give: autograd of the closed form, with
// make_var_exp's backward where a sweep enters it.  The closed forms keep
// likelihoods/*.py's order of operations.
//
// A row's node list is its terms' lists one after another (the task's
// sizes give each term's node count), one node a lane where the block has
// room; each node adds into its own term's accumulators (the value, then
// E[d1] and E[d2] over the term's dimensions), which meet in one fixed
// tree.  The node table is (S, W), W the widest term's J: a term's node
// coordinates in its first Term::J columns.
//
// The families (the plain versions' var_exp, likelihoods/*.py):
//   BernoulliTask      J = 1, the sweep alone
//   CategoricalTask<K> J = K - 1, the sweep alone
//   HetGaussianTask    J = 2, closed (hetgaussian.py)
//   PoissonTask        J = 1, closed (poisson.py)
//   GammaTask          J = 2, closed with LnGamma's sweep on f_0 (gamma.py)
//   ExponentialTask    J = 1, closed (exponential.py)
//   BetaTask           J = 2, lnG(a), lnG(b) on the 1-D T = 20 grid and
//                      lnG(a + b) on the 2-D T = 10 grid (beta.py)
//   BinomialTask       J = 1, the log-density on the 1-D T = 20 grid,
//                      c = (n, lgamma(n + 1)) (binomial.py)
//   DirichletTask<K>   J = K in {2, 3}, K lnG(a_k) on the 1-D T = 20 grid
//                      and lnG(sum a) on the K-D grid (dirichlet.py)
//   ZipTask            J = 2, the log-density on the 2-D T = 10 grid
//                      (zipoisson.py)
// The codes are ops/quadrature.py::TASK_FAMILIES'.

constexpr double HALF_LOG_2PI = 0.9189385332046727;

// A task's terms, in their order
template <typename... Ts>
struct Terms {
  static constexpr int count = 0, width = 0;
  template <bool DERIV>
  GH_HD static constexpr int acc_size() {
    return 0;
  }
};
template <typename H, typename... R>
struct Terms<H, R...> {
  using Head = H;
  using Rest = Terms<R...>;
  static constexpr int count = 1 + sizeof...(R);
  // the node table's columns: the widest term's J
  static constexpr int width = H::J > Rest::width ? H::J : Rest::width;
  // accumulators of the head term, and of the whole list
  template <bool DERIV>
  GH_HD static constexpr int head_size() {
    return DERIV ? 1 + 2 * H::J : 1;
  }
  template <bool DERIV>
  GH_HD static constexpr int acc_size() {
    return head_size<DERIV>() + Rest::template acc_size<DERIV>();
  }
};

// e^{m + v/2}, the lognormal mean, clipped to [1e-9, 1e9]
template <typename T, typename S>
GH_HD inline S lognormal_mean_(const S& m, const S& v) {
  return clamp_(safe_exp_<T>(m + T(0.5) * v), T(1e-9), T(1e9));
}

// a product of the closed forms' value rounded on its own, as the plain
// version's own multiply rounds it: never contracted into the sum it
// enters, so that the value alone (S = T) and the derivative launch's
// (S = Dual) round their sums of two products alike
template <typename T, int D>
GH_HD inline Dual<T, D> mul_rn(const Dual<T, D>& a, T c) {
  Dual<T, D> r;
  r.v = mul_rn(a.v, c);
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * c;
  return r;
}

template <typename T>
struct BernoulliTask {
  static constexpr int J = 1;
  using Terms = gh::Terms<Term<Bernoulli<T>>>;
  template <typename S>
  GH_HD static S value(const S*, const S*, const T*, const T*, const S* E) {
    return E[0];
  }
};

template <typename T, int K>
struct CategoricalTask {
  static constexpr int J = K - 1;
  using Terms = gh::Terms<Term<Categorical<T, K>>>;
  template <typename S>
  GH_HD static S value(const S*, const S*, const T*, const T*, const S* E) {
    return E[0];
  }
};

// -log(2 pi)/2 - m2/2 - precision squares / 2, precision =
// clip(e^{-m2 + v2/2}, +-1e9), squares = clip(y^2 + m1^2 + v1 - 2 m1 y,
// +-1e9), the squares through safe_square
template <typename T>
struct HetGaussianTask {
  static constexpr int J = 2;
  using Terms = gh::Terms<>;
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S*) {
    const S precision =
        clamp_(safe_exp_<T>(-m[1] + T(0.5) * v[1]), T(-1e9), T(1e9));
    const T y2 = safe_square_<T>(y[0]);
    const S squares = clamp_(
        y2 + safe_square_<T>(m[0]) + v[0] - T(2) * m[0] * y[0], T(-1e9),
        T(1e9));
    return T(-HALF_LOG_2PI) - T(0.5) * m[1] - T(0.5) * precision * squares;
  }
};

// y m - e^{m + v/2} - lgamma(y + 1)
template <typename T>
struct PoissonTask {
  static constexpr int J = 1;
  using Terms = gh::Terms<>;
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S*) {
    return y[0] * m[0] - safe_exp_<T>(m[0] + T(0.5) * v[0]) -
           lgamma_(y[0] + T(1));
  }
};

// -E[lgamma(a)] + E[a] m2 + (E[a] - 1) log y - E[b] y, E[a], E[b] the
// lognormal means clipped to [1e-9, 1e9]; E[lgamma(a)] LnGamma's sweep
// on f_0
template <typename T>
struct GammaTask {
  static constexpr int J = 2;
  using Terms = gh::Terms<Term<LnGamma<T>>>;
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S* E) {
    const S Ea = lognormal_mean_<T>(m[0], v[0]);
    const S Eb = lognormal_mean_<T>(m[1], v[1]);
    return -E[0] + Ea * m[1] + (Ea - T(1)) * log_(y[0]) - Eb * y[0];
  }
};

// m - y clip(e^{m + v/2}, 1e-9, 1e9)
template <typename T>
struct ExponentialTask {
  static constexpr int J = 1;
  using Terms = gh::Terms<>;
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S*) {
    return m[0] - y[0] * lognormal_mean_<T>(m[0], v[0]);
  }
};

template <typename T>
struct BetaTask {
  static constexpr int J = 2;
  using Terms = gh::Terms<Term<LnGamma<T>, 0>, Term<LnGamma<T>, 1>,
                          Term<LnGammaSum<T, 2>, 0, 1>>;
  // (E[a] - 1) ln y + (E[b] - 1) log1p(-y) - E0 - E1 + E2, E[a], E[b] the
  // lognormal means clipped to [1e-9, 1e9]
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S* E) {
    const S Ea = lognormal_mean_<T>(m[0], v[0]);
    const S Eb = lognormal_mean_<T>(m[1], v[1]);
    return mul_rn(Ea - T(1), log_(y[0])) + mul_rn(Eb - T(1), log1p_(-y[0])) -
           E[0] - E[1] + E[2];
  }
};

template <typename T>
struct BinomialTask {
  static constexpr int J = 1;
  using Terms = gh::Terms<Term<Binomial<T>>>;
  template <typename S>
  GH_HD static S value(const S*, const S*, const T*, const T*, const S* E) {
    return E[0];
  }
};

template <typename T, int K>
struct DirichletTerms;
template <typename T>
struct DirichletTerms<T, 2> {
  using type = Terms<Term<LnGamma<T>, 0>, Term<LnGamma<T>, 1>,
                     Term<LnGammaSum<T, 2>, 0, 1>>;
};
template <typename T>
struct DirichletTerms<T, 3> {
  using type = Terms<Term<LnGamma<T>, 0>, Term<LnGamma<T>, 1>,
                     Term<LnGamma<T>, 2>, Term<LnGammaSum<T, 3>, 0, 1, 2>>;
};

template <typename T, int K>
struct DirichletTask {
  static constexpr int J = K;
  using Terms = typename DirichletTerms<T, K>::type;
  // E[lnG(sum a)] - sum_k E[lnG(a_k)] + sum_k (E[a_k] - 1) ln y_k
  template <typename S>
  GH_HD static S value(const S* m, const S* v, const T* y, const T*,
                       const S* E) {
    S lga = E[0];
    S lin = mul_rn(lognormal_mean_<T>(m[0], v[0]) - T(1), log_(y[0]));
    for (int k = 1; k < K; ++k) {
      lga = lga + E[k];
      lin = lin + mul_rn(lognormal_mean_<T>(m[k], v[k]) - T(1), log_(y[k]));
    }
    return E[K] - lga + lin;
  }
};

template <typename T>
struct ZipTask {
  static constexpr int J = 2;
  using Terms = gh::Terms<Term<ZeroInflatedPoisson<T>>>;
  template <typename S>
  GH_HD static S value(const S*, const S*, const T*, const T*, const S* E) {
    return E[0];
  }
};

// Whether a task sweeps nodes: it has terms
template <typename Task>
GH_HD constexpr bool task_sweeps() {
  return Task::Terms::count > 0;
}

// The accumulators a lane keeps: its terms' together, 1 (unused) where the
// task has none.
template <typename Task, bool DERIV>
GH_HD constexpr int task_acc_size() {
  return task_sweeps<Task>() ? Task::Terms::template acc_size<DERIV>() : 1;
}

// Adds term k of the list at a node into its accumulators (term_node): acc
// the list's, its head term's first.
template <typename List, typename T, bool DERIV>
GH_HD inline void terms_node(int k, const T* m, const T* sigma, const T* y,
                             const T* c, const T* node, T ws, T* acc) {
  if constexpr (List::count > 0) {
    if (k == 0) {
      term_node<typename List::Head, T, DERIV>(m, sigma, y, c, node, ws, acc);
    } else {
      terms_node<typename List::Rest, T, DERIV>(
          k - 1, m, sigma, y, c, node, ws,
          acc + List::template head_size<DERIV>());
    }
  }
}

// Adds the nodes s = first, first + step, ... < S of a row's node list
// into acc (every term's accumulators, in the list's order): c the task's
// constants, nodes (S, W) and w (S,) the table, sizes the terms' node
// counts (read where there are several terms).
template <typename Task, typename T, bool DERIV>
GH_HD inline void task_nodes(const T* m, const T* v, const T* y, const T* c,
                             const T* nodes, const T* w, int S,
                             const int* sizes, int first, int step, T* acc) {
  using List = typename Task::Terms;
  constexpr int J = Task::J, W = List::width;
  T sigma[J];
  for (int j = 0; j < J; ++j) sigma[j] = sqrt_(mul_rn(T(2), v[j]));
  if constexpr (List::count == 1) {
    for (int s = first; s < S; s += step) {
      term_node<typename List::Head, T, DERIV>(
          m, sigma, y, c, nodes + (long long)s * W, w[s], acc);
    }
  } else {
    int k = 0, end = sizes[0];
    for (int s = first; s < S; s += step) {
      while (s >= end) end += sizes[++k];
      terms_node<List, T, DERIV>(k, m, sigma, y, c, nodes + (long long)s * W,
                                 w[s], acc);
    }
  }
}

// Each term's expectation as a Dual in the task's 2J directions, from its
// accumulators (value, E[d1], E[d2] over its dimensions)
template <typename List, typename T, int J>
GH_HD inline void term_duals(const T* acc, Dual<T, 2 * J>* E) {
  if constexpr (List::count > 0) {
    using H = typename List::Head;
    E[0] = Dual<T, 2 * J>(acc[0]);
    for (int j = 0; j < H::J; ++j) {
      E[0].d[H::dim(j)] = acc[1 + j];
      E[0].d[J + H::dim(j)] = T(0.5) * acc[1 + H::J + j];
    }
    term_duals<typename List::Rest, T, J>(
        acc + List::template head_size<true>(), E + 1);
  }
}

// The fixed tree that adds the L lanes of a row: for off = the largest
// power of two below L, then off / 2, ... 1, lane l < off adds lane
// l + off where that is < L.  The kernel runs it in shared memory, one
// level between two barriers; task_row below on the host.
GH_HD inline int tree_top(int L) {
  int off = 1;
  while (2 * off < L) off *= 2;
  return L > 1 ? off : 0;
}

// The row's value, and with DERIV its coefficients coef[0 .. 2J) =
// (c_m, c_v), from the moments m, v (J,), the observation y, the task's
// constants c and the terms' node sums acc (value, E[d1], E[d2], a term's
// after another's; unread where there are none).
template <typename Task, typename T, bool DERIV>
GH_HD inline T finish_row(const T* m, const T* v, const T* y, const T* c,
                          const T* acc, T* coef) {
  constexpr int J = Task::J;
  constexpr int K = Task::Terms::count;
  if constexpr (!DERIV) {
    T E[K > 0 ? K : 1];
    for (int k = 0; k < K; ++k) E[k] = acc[k];
    return Task::template value<T>(m, v, y, c, E);
  } else {
    using D = Dual<T, 2 * J>;
    D md[J], vd[J];
    for (int j = 0; j < J; ++j) {
      md[j] = D::variable(m[j], j);
      vd[j] = D::variable(v[j], J + j);
    }
    D E[K > 0 ? K : 1];
    term_duals<typename Task::Terms, T, J>(acc, E);
    const D r = Task::template value<D>(md, vd, y, c, E);
    for (int k = 0; k < 2 * J; ++k) coef[k] = r.d[k];
    return r.v;
  }
}

// One row on the host, in the kernel's order: L lanes each add the nodes
// s = lane, lane + L, ... (task_nodes), the lanes meet in tree_top's
// tree, then finish_row.  out: the value, then with DERIV coef (2J,).
template <typename Task, typename T, bool DERIV>
inline void task_row(const T* m, const T* v, const T* y, const T* c,
                     const T* nodes, const T* w, int S, const int* sizes,
                     int L, T* out) {
  constexpr int A = task_acc_size<Task, DERIV>();
  T acc[A];
  for (int a = 0; a < A; ++a) acc[a] = T(0);
  if constexpr (task_sweeps<Task>()) {
    T* part = new T[(size_t)L * A];
    for (int l = 0; l < L; ++l) {
      for (int a = 0; a < A; ++a) part[(size_t)l * A + a] = T(0);
      task_nodes<Task, T, DERIV>(m, v, y, c, nodes, w, S, sizes, l, L,
                                 part + (size_t)l * A);
    }
    for (int off = tree_top(L); off > 0; off /= 2) {
      for (int l = 0; l < off; ++l) {
        if (l + off < L) {
          for (int a = 0; a < A; ++a) {
            part[(size_t)l * A + a] += part[(size_t)(l + off) * A + a];
          }
        }
      }
    }
    for (int a = 0; a < A; ++a) acc[a] = part[a];
    delete[] part;
  }
  out[0] = finish_row<Task, T, DERIV>(m, v, y, c, acc, out + 1);
}

}  // namespace gh
