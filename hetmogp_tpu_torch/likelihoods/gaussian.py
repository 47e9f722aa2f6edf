"""Homoscedastic Gaussian likelihood, noise sigma.

Counterpart of ``hetmogp_tpu/likelihoods/gaussian.py``.  ``var_exp`` and
``predictive`` are analytic, E[log N(y; f, sigma^2)] and (m, sigma^2 + v).
The reference's quirk is kept on purpose: ``logpdf`` is a standard normal
at y - f, whatever sigma, so the Monte-Carlo ``log_predictive`` does not
depend on sigma either.  ``learn_sigma=True`` makes theta = [log sigma]
trainable (``params.lik_theta`` with ``TrainConfig.learn_lik_params``),
with var_exp still analytic in theta.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood, theta_array
from hetmogp_tpu_torch.ops import quadrature

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Gaussian(Likelihood):
    sigma: float = 0.5
    learn_sigma: bool = False

    @property
    def n_theta(self):  # type: ignore[override]
        return 1 if self.learn_sigma else 0

    def default_theta(self, dtype=np.float64):
        return np.array([np.log(self.sigma)], dtype)

    def with_theta(self, theta) -> "Gaussian":
        return dataclasses.replace(
            self, sigma=float(np.exp(theta_array(theta)[0])))

    def logpdf(self, F, Y):
        return -_HALF_LOG_2PI - 0.5 * torch.square(Y[..., 0] - F[..., 0])

    def var_exp(self, Y, M, V, theta=None, use_kernel=True):
        if theta is not None and self.n_theta:
            lik_v = torch.exp(2.0 * theta[0])
            log_v = torch.log(lik_v)
        else:
            lik_v = self.sigma ** 2
            log_v = math.log(lik_v)
        y, m, v = Y[:, 0], M[:, 0], V[:, 0]
        return (-_HALF_LOG_2PI - 0.5 * log_v
                - 0.5 * (torch.square(y) + torch.square(m) + v - 2.0 * m * y)
                / lik_v)

    def conditional_moments(self, F):
        return F[..., :1], torch.full_like(F[..., :1], self.sigma ** 2)

    def predictive(self, M, V):
        return M, self.sigma ** 2 + V

    def sample(self, generator, F):
        mean = F[:, :1]
        return mean + self.sigma * quadrature.standard_normal(
            mean.shape, generator, mean)
