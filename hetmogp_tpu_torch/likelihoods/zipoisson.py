"""Zero-inflated Poisson: f1 -> rate lambda = e^{f1}, f2 -> inflation
probability pi = sigma(f2).

Counterpart of ``hetmogp_tpu/likelihoods/zipoisson.py``:
p(y | f) = pi [y = 0] + (1 - pi) Poisson(y; lambda), lambda clipped to
[1e-9, 1e9].  The y = 0 branch is logaddexp(log pi, log(1 - pi) - lambda),
finite in float32 at any f.  var_exp and the predictive on the 2-D T=10
tensor GH grid (100 nodes a row).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, logaddexp,
                                                on_generator, safe_exp)
from hetmogp_tpu_torch.likelihoods.bernoulli import _log_probs, _prob
from hetmogp_tpu_torch.ops import quadrature


def _rate(f):
    return torch.clamp(safe_exp(f), 1e-9, 1e9)


@dataclasses.dataclass(frozen=True)
class ZeroInflatedPoisson(Likelihood):
    dim_f: ClassVar[int] = 2
    T_var_exp: ClassVar[int] = quadrature.MULTI_T
    T_pred: ClassVar[int] = quadrature.MULTI_T
    # kernel 6's task table takes var_exp: its log-density's one sweep
    task: ClassVar[Optional[str]] = "zipoisson"

    def task_grid(self):
        """The one term: the log-density on the engine's 2-D T=10 grid."""
        return [(self.T_var_exp, 2, 0)]

    def logpdf(self, F, Y):
        f1, y = F[..., 0], Y[..., 0]
        lam = _rate(f1)
        log_pi, log_1mpi = _log_probs(F[..., 1])
        pois = y * f1 - lam - torch.lgamma(y + 1.0)
        # both branches are finite for every y (where evaluates both)
        zero_branch = logaddexp(log_pi, log_1mpi - lam)
        return torch.where(y == 0, zero_branch, log_1mpi + pois)

    def conditional_moments(self, F):
        lam = _rate(F[..., :1])
        pi = _prob(F[..., 1:2])
        # Var[y] = (1 - pi) lam (1 + pi lam)
        return (1.0 - pi) * lam, (1.0 - pi) * lam * (1.0 + pi * lam)

    def sample(self, generator, F):
        lam, pi = on_generator(generator, _rate(F[:, :1]), _prob(F[:, 1:2]))
        on = 1.0 - torch.bernoulli(pi, generator=generator)
        return (on * torch.poisson(lam, generator=generator)).to(F.device)
