"""Gamma likelihood, shape a = e^{f1}, rate b = e^{f2}.

Counterpart of ``hetmogp_tpu/likelihoods/gamma.py``, predictive only:
a, b = clip(e^f, 1e-9, 1e9).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood, safe_exp


def _ab(F):
    ef = safe_exp(F)
    return (torch.clamp(ef[..., 0], 1e-9, 1e9),
            torch.clamp(ef[..., 1], 1e-9, 1e9))


@dataclasses.dataclass(frozen=True)
class Gamma(Likelihood):
    """``analytic=True`` (default) gives the predictive moments in closed
    form: with a and b independent lognormals under q,
    E[y*] = E[a] E[1/b] and V[y*] = (E[a] + E[a^2]) E[1/b^2] - E[y*]^2, the
    node clips carried onto the expectations.  ``analytic=False`` takes the
    GH engine (T=20 on a 2-D grid)."""

    dim_f: ClassVar[int] = 2

    analytic: bool = True

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        m1, v1 = M[:, :1], V[:, :1]
        m2, v2 = M[:, 1:], V[:, 1:]
        Ea = torch.clamp(safe_exp(m1 + 0.5 * v1), 1e-9, 1e9)
        Ea2 = torch.clamp(safe_exp(2.0 * m1 + 2.0 * v1), 1e-18, 1e18)
        Eib = torch.clamp(safe_exp(-m2 + 0.5 * v2), 1e-9, 1e9)
        Eib2 = torch.clamp(safe_exp(-2.0 * m2 + 2.0 * v2), 1e-18, 1e18)
        mean = Ea * Eib
        return mean, (Ea + Ea2) * Eib2 - torch.square(mean)

    def conditional_moments(self, F):
        a, b = _ab(F)
        return (a / b)[..., None], (a / torch.square(b))[..., None]
