"""Log-normal likelihood: log y ~ N(f, sigma^2), y > 0.

Counterpart of ``hetmogp_tpu/likelihoods/lognormal.py``.  Everything is
analytic, the model being a Gaussian in log y:
var_exp E[log p] = -log y - log sigma - 1/2 log 2 pi
- ((log y - m)^2 + v) / (2 sigma^2); E[y*] = e^{m + v/2 + sigma^2/2},
V[y*] = e^{2m + 2v + 2 sigma^2} - E[y*]^2.  ``learn_sigma=True`` trains
theta = [log sigma], with var_exp analytic in theta.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, safe_exp,
                                                theta_array)
from hetmogp_tpu_torch.ops import quadrature

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _log_y(y):
    return torch.log(torch.clamp(y, min=1e-30))


@dataclasses.dataclass(frozen=True)
class LogNormal(Likelihood):
    sigma: float = 0.5
    learn_sigma: bool = False

    def __post_init__(self):
        if self.sigma <= 0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")

    @property
    def n_theta(self):  # type: ignore[override]
        return 1 if self.learn_sigma else 0

    def default_theta(self, dtype=np.float64):
        return np.array([np.log(self.sigma)], dtype)

    def with_theta(self, theta) -> "LogNormal":
        return dataclasses.replace(
            self, sigma=float(np.exp(theta_array(theta)[0])))

    def _logpdf_s2(self, F, Y, s2, log_s2):
        ly = _log_y(Y[..., 0])
        return (-ly - 0.5 * log_s2 - _HALF_LOG_2PI
                - 0.5 * torch.square(ly - F[..., 0]) / s2)

    def logpdf(self, F, Y):
        s2 = self.sigma ** 2
        return self._logpdf_s2(F, Y, s2, math.log(s2))

    def logpdf_t(self, F, Y, theta):
        s2 = torch.exp(2.0 * theta[..., 0])
        return self._logpdf_s2(F, Y, s2, torch.log(s2))

    def var_exp(self, Y, M, V, theta=None, use_kernel=True):
        if theta is not None and self.n_theta:
            s2 = torch.exp(2.0 * theta[0])
            log_s2 = torch.log(s2)
        else:
            s2 = self.sigma ** 2
            log_s2 = math.log(s2)
        ly = _log_y(Y[:, 0])
        m, v = M[:, 0], V[:, 0]
        return (-ly - 0.5 * log_s2 - _HALF_LOG_2PI
                - 0.5 * (torch.square(ly - m) + v) / s2)

    def conditional_moments(self, F):
        s2 = self.sigma ** 2
        mean = safe_exp(F[..., :1] + 0.5 * s2)
        var = (math.exp(s2) - 1.0) * safe_exp(2.0 * F[..., :1] + s2)
        return mean, var

    def predictive(self, M, V):
        s2 = self.sigma ** 2
        mean = safe_exp(M + 0.5 * V + 0.5 * s2)
        return mean, safe_exp(2.0 * M + 2.0 * V + 2.0 * s2) - torch.square(
            mean)

    def sample(self, generator, F):
        mean = F[:, :1]
        z = quadrature.standard_normal(mean.shape, generator, mean)
        return safe_exp(mean + self.sigma * z)
