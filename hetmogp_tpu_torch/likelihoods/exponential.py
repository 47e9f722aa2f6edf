"""Exponential likelihood, scale b = e^{-f}.

Counterpart of ``hetmogp_tpu/likelihoods/exponential.py``, predictive
only: b = clip(e^{-f}, 1e-9, 1e9).
"""

from __future__ import annotations

import dataclasses

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, safe_exp,
                                                safe_square)


def _scale(f):
    return torch.clamp(safe_exp(-f), 1e-9, 1e9)


@dataclasses.dataclass(frozen=True)
class Exponential(Likelihood):
    """``analytic=True`` (default) gives the predictive moments in closed
    form, E[y*] = E[b] = e^{-m+v/2} and V[y*] = 2 E[b^2] - E[b]^2, with the
    node clips of b and b^2 carried onto the expectations.
    ``analytic=False`` takes the GH engine (T=20)."""

    analytic: bool = True

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        Eb = torch.clamp(safe_exp(-M + 0.5 * V), 1e-9, 1e9)
        Eb2 = torch.clamp(safe_exp(-2.0 * M + 2.0 * V), 1e-18, 1e18)
        return Eb, 2.0 * Eb2 - torch.square(Eb)

    def conditional_moments(self, F):
        b = _scale(F[..., :1])
        return b, safe_square(b)
