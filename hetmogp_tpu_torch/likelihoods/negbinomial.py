"""Negative-binomial likelihood (NB2): overdispersed counts, mean
mu = e^f, dispersion r.

Counterpart of ``hetmogp_tpu/likelihoods/negbinomial.py``:
p(y | f) = Gamma(y + r) / (Gamma(r) y!) (r / (r + mu))^r (mu / (r + mu))^y,
E[y] = mu, Var[y] = mu + mu^2 / r, mu clipped to [1e-9, 1e9].  var_exp
and the predictive by the GH engines (T=20); ``learn_r=True`` trains
theta = [log r] through the theta engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, lgamma_of,
                                                log_of, on_generator,
                                                safe_exp, theta_array)


def _mean(f):
    return torch.clamp(safe_exp(f), 1e-9, 1e9)


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(Likelihood):
    r: float = 2.0  # dispersion; Var = mu + mu^2 / r
    learn_r: bool = False

    def __post_init__(self):
        if self.r <= 0:
            raise ValueError(f"dispersion r must be > 0, got {self.r}")

    @property
    def n_theta(self):  # type: ignore[override]
        return 1 if self.learn_r else 0

    def default_theta(self, dtype=np.float64):
        return np.array([np.log(self.r)], dtype)

    def with_theta(self, theta) -> "NegativeBinomial":
        return dataclasses.replace(
            self, r=float(np.exp(theta_array(theta)[0])))

    def _logpdf_r(self, F, Y, r):
        mu = _mean(F[..., 0])
        y = Y[..., 0]
        log_rmu = torch.log(r + mu)
        return (torch.lgamma(y + r) - lgamma_of(r) - torch.lgamma(y + 1.0)
                + r * (log_of(r) - log_rmu) + y * (torch.log(mu) - log_rmu))

    def logpdf(self, F, Y):
        return self._logpdf_r(F, Y, self.r)

    def logpdf_t(self, F, Y, theta):
        # r = e^theta stays positive under unconstrained steps
        return self._logpdf_r(F, Y, torch.exp(theta[..., 0]))

    def conditional_moments(self, F):
        mu = _mean(F[..., :1])
        return mu, mu + torch.square(mu) / self.r

    def sample(self, generator, F):
        # gamma-Poisson mixture: lambda ~ Gamma(r, scale mu / r),
        # y | lambda ~ Poisson(lambda) is NB(mu, r)
        (mu,) = on_generator(generator, _mean(F[:, :1]))
        lam = torch._standard_gamma(torch.full_like(mu, self.r),
                                    generator=generator) * (mu / self.r)
        return torch.poisson(lam, generator=generator).to(F.device)
