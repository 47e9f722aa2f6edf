"""Exponential likelihood, scale b = e^{-f}.

Counterpart of ``hetmogp_tpu/likelihoods/exponential.py``:
b = clip(e^{-f}, 1e-9, 1e9), logpdf = -log b - y / b.
"""

from __future__ import annotations

import dataclasses

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp, safe_square)


def _scale(f):
    return torch.clamp(safe_exp(-f), 1e-9, 1e9)


@dataclasses.dataclass(frozen=True)
class Exponential(Likelihood):
    """``analytic=True`` (default) gives var_exp and the predictive moments
    in closed form.  With b = e^{-f} the logpdf is f - y e^f, so
    E[log p] = m - y E[e^f], E[e^f] = e^{m+v/2} clipped to [1e-9, 1e9] like
    the engine's node clip (without it a transient m + v/2 > ~88 overflows
    in float32); E[y*] = E[b] = e^{-m+v/2} and V[y*] = 2 E[b^2] - E[b]^2,
    with the node clips of b and b^2 carried onto the expectations.
    ``analytic=False`` takes the GH engines (T=20)."""

    analytic: bool = True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form."""
        return "exponential" if self.analytic else None

    def var_exp(self, Y, M, V, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, use_kernel=use_kernel)
        y, m, v = Y[:, 0], M[:, 0], V[:, 0]
        return m - y * torch.clamp(safe_exp(m + 0.5 * v), 1e-9, 1e9)

    def predictive(self, M, V):
        if not self.analytic:
            return Likelihood.predictive(self, M, V)
        Eb = torch.clamp(safe_exp(-M + 0.5 * V), 1e-9, 1e9)
        Eb2 = torch.clamp(safe_exp(-2.0 * M + 2.0 * V), 1e-18, 1e18)
        return Eb, 2.0 * Eb2 - torch.square(Eb)

    def logpdf(self, F, Y):
        b = _scale(F[..., 0])
        return -torch.log(b) - Y[..., 0] / b

    def conditional_moments(self, F):
        b = _scale(F[..., :1])
        return b, safe_square(b)

    def sample(self, generator, F):
        (b,) = on_generator(generator, _scale(F[:, :1]))
        e = torch.empty_like(b).exponential_(generator=generator)
        return (b * e).to(F.device)
