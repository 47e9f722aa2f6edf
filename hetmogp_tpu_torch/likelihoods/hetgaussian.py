"""Heteroscedastic Gaussian: f1 = mean, f2 = log-variance.

Counterpart of ``hetmogp_tpu/likelihoods/hetgaussian.py``.  var_exp is
analytic (the reference's own closed form, precision e^{-m2+v2/2} clipped
at 1e9); autodiff of it gives the reference's derivatives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, safe_exp,
                                                safe_square)
from hetmogp_tpu_torch.ops import quadrature

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class HetGaussian(Likelihood):
    """``analytic=True`` (default) closes the predictive moments:
    E[y*] = m1, V[y*] = E[e^{f2}] + Var[f1] = e^{m2+v2/2} + v1, with the
    scale expectation clipped at 1e9.  ``analytic=False`` takes the GH
    engine (T=20)."""

    dim_f: ClassVar[int] = 2

    analytic: bool = True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form."""
        return "hetgaussian" if self.analytic else None

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        Evar = torch.clamp(safe_exp(M[:, 1:] + 0.5 * V[:, 1:]), 0.0, 1e9)
        return M[:, :1], Evar + V[:, :1]

    def logpdf(self, F, Y):
        # the variance floor guards exp-underflow at extreme nodes
        e_var = torch.clamp(safe_exp(F[..., 1]), min=1e-9)
        ym = Y[..., 0] - F[..., 0]
        return (-_HALF_LOG_2PI - 0.5 * torch.log(e_var)
                - 0.5 * safe_square(ym) / e_var)

    def var_exp(self, Y, M, V, use_kernel=True):
        y = Y[:, 0]
        m1, m2 = M[:, 0], M[:, 1]
        v1, v2 = V[:, 0], V[:, 1]
        precision = torch.clamp(safe_exp(-m2 + 0.5 * v2), -1e9, 1e9)
        squares = torch.clamp(safe_square(y) + safe_square(m1) + v1
                              - 2.0 * m1 * y, -1e9, 1e9)
        return -_HALF_LOG_2PI - 0.5 * m2 - 0.5 * precision * squares

    def conditional_moments(self, F):
        return F[..., :1], safe_exp(F[..., 1:2])

    def sample(self, generator, F):
        std = torch.sqrt(safe_exp(F[:, 1:2]))
        return F[:, :1] + std * quadrature.standard_normal(std.shape,
                                                           generator, std)
