"""Bernoulli likelihood with the logistic link.

Counterpart of ``hetmogp_tpu/likelihoods/bernoulli.py``, predictive only:
p = e^f / (1 + e^f) clipped to [1e-9, 1 - 1e-9], and the predictive
moments by the generic GH engine with T=20.
"""

from __future__ import annotations

import dataclasses

import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood, safe_exp


def _prob(f):
    ef = safe_exp(f)
    return torch.clamp(ef / (1.0 + ef), 1e-9, 1.0 - 1e-9)


@dataclasses.dataclass(frozen=True)
class Bernoulli(Likelihood):

    def conditional_moments(self, F):
        p = _prob(F[..., :1])
        return p, p * (1.0 - p)
