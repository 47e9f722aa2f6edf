"""Poisson likelihood, rate lambda = e^f.

Counterpart of ``hetmogp_tpu/likelihoods/poisson.py``:
logpdf = -e^f + y f - ln Gamma(y + 1).
"""

from __future__ import annotations

import dataclasses

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp)


@dataclasses.dataclass(frozen=True)
class Poisson(Likelihood):
    """``analytic=True`` (default) gives var_exp and the predictive moments
    in closed form: E[log p] = y m - e^{m+v/2} - ln Gamma(y + 1), whose
    autodiff is the reference's derivative form; E[y*] = e^{m+v/2} and
    V[y*] = E[e^f] + E[e^{2f}] - E[e^f]^2, with the rate moments capped at
    1e9 and 1e18 so serving stays finite at any moments.
    ``analytic=False`` takes the GH engines (T=20)."""

    analytic: bool = True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form."""
        return "poisson" if self.analytic else None

    def var_exp(self, Y, M, V, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, use_kernel=use_kernel)
        y, m, v = Y[:, 0], M[:, 0], V[:, 0]
        return y * m - safe_exp(m + 0.5 * v) - torch.lgamma(y + 1.0)

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        Em = torch.clamp(safe_exp(M + 0.5 * V), 0.0, 1e9)
        Em2 = torch.clamp(safe_exp(2.0 * M + 2.0 * V), 0.0, 1e18)
        return Em, Em + Em2 - torch.square(Em)

    def logpdf(self, F, Y):
        f, y = F[..., 0], Y[..., 0]
        return -safe_exp(f) + y * f - torch.lgamma(y + 1.0)

    def conditional_moments(self, F):
        lam = safe_exp(F[..., :1])
        return lam, lam

    def sample(self, generator, F):
        (lam,) = on_generator(generator, safe_exp(F[:, :1]))
        return torch.poisson(lam, generator=generator).to(F.device)
