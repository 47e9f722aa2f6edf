"""Heteroscedastic Gaussian: f1 = mean, f2 = log-variance.

Counterpart of ``hetmogp_tpu/likelihoods/hetgaussian.py``, predictive only.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood, safe_exp


@dataclasses.dataclass(frozen=True)
class HetGaussian(Likelihood):
    """``analytic=True`` (default) closes the predictive moments:
    E[y*] = m1, V[y*] = E[e^{f2}] + Var[f1] = e^{m2+v2/2} + v1, with the
    scale expectation clipped at 1e9.  ``analytic=False`` takes the GH
    engine (T=20)."""

    dim_f: ClassVar[int] = 2

    analytic: bool = True

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        Evar = torch.clamp(safe_exp(M[:, 1:] + 0.5 * V[:, 1:]), 0.0, 1e9)
        return M[:, :1], Evar + V[:, :1]

    def conditional_moments(self, F):
        return F[..., :1], safe_exp(F[..., 1:2])
