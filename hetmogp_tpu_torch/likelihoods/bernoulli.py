"""Bernoulli likelihood with the logistic link.

Counterpart of ``hetmogp_tpu/likelihoods/bernoulli.py``: p = e^f / (1 + e^f)
clipped to [1e-9, 1 - 1e-9]; var_exp and the predictive moments by the
generic GH engines with T=20.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, logaddexp,
                                                on_generator, safe_exp)


def _prob(f):
    ef = safe_exp(f)
    return torch.clamp(ef / (1.0 + ef), 1e-9, 1.0 - 1e-9)


# The probability clip [1e-9, 1 - 1e-9] applied in log space, as the JAX
# package does it: log p = -softplus(-f) and log(1 - p) = -softplus(f) are
# exact at any f, where log1p(-p) through a float32 p rounds p to 1 for
# f >~ 17 and gives log(0) = -inf, then 0 * -inf = NaN in the y-weighted
# sum.  softplus as the stable logaddexp(f, 0) of ``base``, exact like
# jax.nn.softplus (torch's softplus turns linear past its threshold) and
# with a finite second derivative at any f.
_LOG_LO = math.log(1e-9)
_LOG_HI = math.log1p(-1e-9)


def _log_probs(f):
    zero = torch.zeros_like(f)
    log_p = torch.clamp(-logaddexp(-f, zero), _LOG_LO, _LOG_HI)
    log_1mp = torch.clamp(-logaddexp(f, zero), _LOG_LO, _LOG_HI)
    return log_p, log_1mp


@dataclasses.dataclass(frozen=True)
class Bernoulli(Likelihood):
    sweep: ClassVar[str] = "bernoulli"
    task: ClassVar[str] = "bernoulli"

    def logpdf(self, F, Y):
        log_p, log_1mp = _log_probs(F[..., 0])
        y = Y[..., 0]
        return y * log_p + (1.0 - y) * log_1mp

    def conditional_moments(self, F):
        p = _prob(F[..., :1])
        return p, p * (1.0 - p)

    def sample(self, generator, F):
        (p,) = on_generator(generator, _prob(F[:, :1]))
        return torch.bernoulli(p, generator=generator).to(F.device)
