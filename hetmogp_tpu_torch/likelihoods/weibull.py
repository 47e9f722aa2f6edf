"""Weibull likelihood for durations: scale b = e^{-f}, shape k.

Counterpart of ``hetmogp_tpu/likelihoods/weibull.py``, with the
Exponential's link (b = clip(e^{-f}, 1e-9, 1e9)):
log p(y | f) = log k - log b + (k - 1) log(y / b) - (y / b)^k,
E[y] = b Gamma(1 + 1/k), Var[y] = b^2 (Gamma(1 + 2/k) - Gamma(1 + 1/k)^2);
``Weibull(k=1)`` is the Exponential.  ``learn_k=True`` trains
theta = [log k].
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, log_of,
                                                on_generator, safe_exp,
                                                safe_square, theta_array)

_LOG_LO, _LOG_HI = math.log(1e-9), math.log(1e9)


def _scale(f):
    return torch.clamp(safe_exp(-f), 1e-9, 1e9)


@dataclasses.dataclass(frozen=True)
class Weibull(Likelihood):
    """``analytic=True`` (default) computes var_exp in closed form: with
    b = e^{-f} the logpdf is log k + k f + (k-1) log y - y^k e^{k f}, so
    E[log p] = log k + k m + (k-1) log y - e^{k (log y + m) + k^2 v / 2},
    the scale expectation e^{m + k v / 2} clipped to [1e-9, 1e9] as the
    engine clips b at every node; analytic in theta too.  The predictive
    is closed: E[y*] = Gamma(1+1/k) E[b],
    V[y*] = Gamma(1+2/k) E[b^2] - Gamma(1+1/k)^2 E[b]^2.
    ``analytic=False`` takes the GH engines (the theta engine for theta)."""

    k: float = 1.5  # shape; k = 1 is the Exponential
    learn_k: bool = False
    analytic: bool = True

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"shape k must be > 0, got {self.k}")

    @property
    def n_theta(self):  # type: ignore[override]
        return 1 if self.learn_k else 0

    def default_theta(self, dtype=np.float64):
        return np.array([np.log(self.k)], dtype)

    def with_theta(self, theta) -> "Weibull":
        return dataclasses.replace(
            self, k=float(np.exp(theta_array(theta)[0])))

    def var_exp(self, Y, M, V, theta=None, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, theta, use_kernel)
        k = (torch.exp(theta[0]) if theta is not None and self.n_theta
             else self.k)
        log_y = torch.log(torch.clamp(Y[:, 0], min=1e-30))
        m, v = M[:, 0], V[:, 0]
        log_scale = torch.clamp(m + 0.5 * k * v, _LOG_LO, _LOG_HI)
        return (log_of(k) + k * m + (k - 1.0) * log_y
                - safe_exp(k * (log_y + log_scale)))

    def _logpdf_k(self, F, Y, k):
        b = _scale(F[..., 0])
        log_yb = torch.log(torch.clamp(Y[..., 0], min=1e-30)) - torch.log(b)
        return (log_of(k) - torch.log(b) + (k - 1.0) * log_yb
                - safe_exp(k * log_yb))

    def logpdf(self, F, Y):
        return self._logpdf_k(F, Y, self.k)

    def logpdf_t(self, F, Y, theta):
        return self._logpdf_k(F, Y, torch.exp(theta[..., 0]))

    def _gammas(self):
        return (math.exp(math.lgamma(1.0 + 1.0 / self.k)),
                math.exp(math.lgamma(1.0 + 2.0 / self.k)))

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        g1, g2 = self._gammas()
        Eb = torch.clamp(safe_exp(-M + 0.5 * V), 1e-9, 1e9)
        Eb2 = torch.clamp(safe_exp(-2.0 * M + 2.0 * V), 1e-18, 1e18)
        return g1 * Eb, g2 * Eb2 - g1 * g1 * torch.square(Eb)

    def conditional_moments(self, F):
        b = _scale(F[..., :1])
        g1, g2 = self._gammas()
        return b * g1, safe_square(b) * (g2 - g1 * g1)

    def sample(self, generator, F):
        # inverse CDF: y = b (-log U)^{1/k}
        (b,) = on_generator(generator, _scale(F[:, :1]))
        e = torch.empty_like(b).exponential_(generator=generator)
        return (b * torch.pow(e, 1.0 / self.k)).to(F.device)
