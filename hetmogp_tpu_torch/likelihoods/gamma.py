"""Gamma likelihood, shape a = e^{f1}, rate b = e^{f2}.

Counterpart of ``hetmogp_tpu/likelihoods/gamma.py``: a, b = clip(e^f,
1e-9, 1e9), logpdf = -ln Gamma(a) + a log b + (a - 1) log y - b y.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp)
from hetmogp_tpu_torch.ops import quadrature


def _ab(F):
    ef = safe_exp(F)
    return (torch.clamp(ef[..., 0], 1e-9, 1e9),
            torch.clamp(ef[..., 1], 1e-9, 1e9))


def _lngamma(F, Y):
    del Y
    return torch.lgamma(torch.clamp(safe_exp(F[..., 0]), 1e-9, 1e9))


@functools.lru_cache(maxsize=None)
def _lngamma_engine(T: int):
    """E_{N(m,v)}[ln Gamma(clip(e^f, 1e-9, 1e9))] on a T-node 1-D GH grid,
    through the shared engine so its (m, v)-gradients are Bonnet/Price:
    autodiff of the sweep through the nodes m + sqrt(2v) t is singular as
    v -> 0.  Its device function is kernel 6's ``"lngamma"``."""
    return quadrature.make_var_exp(_lngamma, J=1, T=T, sweep="lngamma")


@dataclasses.dataclass(frozen=True)
class Gamma(Likelihood):
    """``analytic=True`` (default) gives var_exp and the predictive moments
    in closed form.  With a = e^{f1} and b = e^{f2} independent lognormals
    under q, E[log p] = -E[ln Gamma(a)] + E[a] m2 + (E[a] - 1) ln y - y E[b],
    where E[ln Gamma(a)] is one 1-D T=20 GH sweep and E[a], E[b] are
    lognormal means clipped to [1e-9, 1e9]; E[y*] = E[a] E[1/b] and
    V[y*] = (E[a] + E[a^2]) E[1/b^2] - E[y*]^2, the node clips carried onto
    the expectations.  ``analytic=False`` takes the GH engines (var_exp on
    the 2-D T=10 grid, the predictive on the 2-D T=20 grid)."""

    dim_f: ClassVar[int] = 2
    T_var_exp: ClassVar[int] = quadrature.MULTI_T

    analytic: bool = True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form."""
        return "gamma" if self.analytic else None

    def task_grid(self):
        """The closed form's one sweep: E[ln Gamma(a)] on the 1-D T=20
        grid (``_lngamma_engine``)."""
        return quadrature.DEFAULT_T, 1, 0

    def var_exp(self, Y, M, V, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, use_kernel=use_kernel)
        y = Y[:, 0]
        m1, m2 = M[:, 0], M[:, 1]
        v1, v2 = V[:, 0], V[:, 1]
        Ea = torch.clamp(safe_exp(m1 + 0.5 * v1), 1e-9, 1e9)
        Eb = torch.clamp(safe_exp(m2 + 0.5 * v2), 1e-9, 1e9)
        E_gammaln = _lngamma_engine(quadrature.DEFAULT_T)(Y, M[:, :1],
                                                          V[:, :1],
                                                          use_kernel)
        return -E_gammaln + Ea * m2 + (Ea - 1.0) * torch.log(y) - Eb * y

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

    def logpdf(self, F, Y):
        a, b = _ab(F)
        y = Y[..., 0]
        return (-torch.lgamma(a) + a * torch.log(b) + (a - 1.0) * torch.log(y)
                - b * y)

    def conditional_moments(self, F):
        a, b = _ab(F)
        return (a / b)[..., None], (a / torch.square(b))[..., None]

    def sample(self, generator, F):
        a, b = on_generator(generator, *_ab(F[:, None, :]))
        return (torch._standard_gamma(a, generator=generator) / b).to(
            F.device)
