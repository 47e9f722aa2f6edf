"""Student-t likelihood with latent mean f1 and latent log-scale f2.

Counterpart of ``hetmogp_tpu/likelihoods/student.py``, df degrees of
freedom, scale clip(e^{f2}, 1e-9, 1e9):
logpdf = lgamma((df+1)/2) - lgamma(df/2) - 1/2 log(df pi) - log scale
- (df+1)/2 log(1 + ((y - f1) / scale)^2 / df).
var_exp by the GH engine on the 2-D T=20 grid; ``learn_df=True`` trains
theta = [log df] through the theta engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, lgamma_of,
                                                log_of, on_generator,
                                                safe_exp, theta_array)


@dataclasses.dataclass(frozen=True)
class StudentT(Likelihood):
    """``analytic=True`` (default) closes the predictive moments:
    E[y*] = m1, V[y*] = df/(df-2) E[e^{2 f2}] + v1 with
    E[e^{2 f2}] = e^{2 m2 + 2 v2} capped at 1e18; df <= 2 gives an
    infinite variance, as ``conditional_moments`` does.
    ``analytic=False`` takes the 2-D T=20 grid engine."""

    dim_f: ClassVar[int] = 2
    df: float = 4.0
    learn_df: bool = False
    analytic: bool = True

    @property
    def n_theta(self):  # type: ignore[override]
        return 1 if self.learn_df else 0

    def default_theta(self, dtype=np.float64):
        return np.array([np.log(self.df)], dtype)

    def with_theta(self, theta) -> "StudentT":
        return dataclasses.replace(
            self, df=float(np.exp(theta_array(theta)[0])))

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        if self.df <= 2.0:
            return M[:, :1], torch.full_like(M[:, :1], math.inf)
        c = self.df / (self.df - 2.0)
        Es2 = torch.clamp(safe_exp(2.0 * M[:, 1:] + 2.0 * V[:, 1:]), 0.0,
                          1e18)
        return M[:, :1], c * Es2 + V[:, :1]

    def _logpdf_df(self, F, Y, v):
        # -log(scale), not -f2: the two agree where the clip is inactive,
        # and this one saturates with the residual where it is
        scale = torch.clamp(safe_exp(F[..., 1]), 1e-9, 1e9)
        r = (Y[..., 0] - F[..., 0]) / scale
        return (lgamma_of((v + 1.0) / 2.0) - lgamma_of(v / 2.0)
                - 0.5 * log_of(v * math.pi) - torch.log(scale)
                - (v + 1.0) / 2.0 * torch.log1p(torch.square(r) / v))

    def logpdf(self, F, Y):
        return self._logpdf_df(F, Y, self.df)

    def logpdf_t(self, F, Y, theta):
        # df = e^theta stays positive under unconstrained steps
        return self._logpdf_df(F, Y, torch.exp(theta[..., 0]))

    def conditional_moments(self, F):
        v = self.df
        scale = safe_exp(F[..., 1:2])
        var = (torch.square(scale) * (v / (v - 2.0)) if v > 2.0
               else torch.full_like(scale, math.inf))
        return F[..., :1], var  # the mean is defined for df > 1

    def sample(self, generator, F):
        # t = z / sqrt(chi2_df / df), chi2_df = 2 Gamma(df / 2)
        scale = safe_exp(F[:, 1:2])
        (like,) = on_generator(generator, scale)
        z = torch.randn(like.shape, generator=generator, dtype=like.dtype,
                        device=like.device)
        g = torch._standard_gamma(torch.full_like(like, 0.5 * self.df),
                                  generator=generator)
        t = z / torch.sqrt(2.0 * g / self.df)
        return F[:, :1] + scale * t.to(F.device)
