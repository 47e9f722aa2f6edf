"""Binomial likelihood: y successes in n trials, logistic link p = sigma(f).

Counterpart of ``hetmogp_tpu/likelihoods/binomial.py``: the log-space
probabilities of the Bernoulli (log p = -softplus(-f)) with the binomial
coefficient; ``Binomial(n=1)`` is the Bernoulli.  var_exp and the
predictive moments by the generic GH engines with T=20.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood, on_generator
from hetmogp_tpu_torch.likelihoods.bernoulli import _log_probs, _prob


@dataclasses.dataclass(frozen=True)
class Binomial(Likelihood):
    n: int = 1  # trials per observation; y counts successes
    # kernel 6's task table takes var_exp: its log-density's one sweep
    task: ClassVar[Optional[str]] = "binomial"

    def __post_init__(self):
        if int(self.n) < 1 or int(self.n) != self.n:
            raise ValueError(f"n must be a positive integer, got {self.n}")

    def task_grid(self):
        """The one term: the log-density on the engine's 1-D T=20 grid."""
        return [(self.T_var_exp, 1, 0)]

    def task_consts(self):
        """n and lgamma(n + 1), as ``logpdf`` forms them."""
        n = float(self.n)
        return n, math.lgamma(n + 1.0)

    def logpdf(self, F, Y):
        log_p, log_1mp = _log_probs(F[..., 0])
        n, y = float(self.n), Y[..., 0]
        return (math.lgamma(n + 1.0) - torch.lgamma(y + 1.0)
                - torch.lgamma(n - y + 1.0) + y * log_p + (n - y) * log_1mp)

    def conditional_moments(self, F):
        p = _prob(F[..., :1])
        n = float(self.n)
        return n * p, n * p * (1.0 - p)

    def sample(self, generator, F):
        (p,) = on_generator(generator, _prob(F[:, :1]))
        return torch.binomial(torch.full_like(p, float(self.n)), p,
                              generator=generator).to(F.device)
