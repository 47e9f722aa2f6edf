"""Beta likelihood, a = e^{f1}, b = e^{f2}.

Counterpart of ``hetmogp_tpu/likelihoods/beta.py``: a, b = clip(e^f, 1e-9,
1e9), logpdf = (a - 1) log y + (b - 1) log(1 - y) - ln B(a, b).  The
predictive keeps GPy's default T=20 while var_exp's grid is T=10 (the
reference's own mix, kept for parity).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp)
from hetmogp_tpu_torch.likelihoods.gamma import _ab, _lngamma_engine
from hetmogp_tpu_torch.ops import quadrature


def _lngamma_sum(F, Y):
    del Y
    a, b = _ab(F)
    return torch.lgamma(a + b)


@functools.lru_cache(maxsize=None)
def _lngamma_sum_engine(T: int):
    """E[ln Gamma(a + b)] on the T^2 tensor grid, through the shared engine
    for its Bonnet/Price gradients (see ``gamma._lngamma_engine``)."""
    return quadrature.make_var_exp(_lngamma_sum, J=2, T=T)


@dataclasses.dataclass(frozen=True)
class Beta(Likelihood):
    """``analytic=True`` (default) reduces the 2-D T=10 grid: with a, b
    independent lognormals under q,
    E[log p] = (E[a] - 1) ln y + (E[b] - 1) ln(1 - y) - E[ln Gamma(a)]
    - E[ln Gamma(b)] + E[ln Gamma(a + b)], E[a] = e^{m1+v1/2} clipped to
    [1e-9, 1e9], the two separable terms on 1-D T=20 sweeps and only the
    coupled ln Gamma(a + b) on the 2-D T=10 grid.  ``analytic=False`` takes
    the grid engine for the whole logpdf."""

    dim_f: ClassVar[int] = 2
    T_var_exp: ClassVar[int] = quadrature.MULTI_T

    analytic: bool = True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form."""
        return "beta" if self.analytic else None

    def task_grid(self):
        """The closed form's three sweeps, one grid a term: E[ln Gamma(a)]
        and E[ln Gamma(b)] on the 1-D T=20 grid, E[ln Gamma(a + b)] on the
        2-D T=10 grid."""
        return [(quadrature.DEFAULT_T, 1, 0), (quadrature.DEFAULT_T, 1, 0),
                (quadrature.MULTI_T, 2, 0)]

    def var_exp(self, Y, M, V, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, use_kernel=use_kernel)
        y = Y[:, 0]
        Ea = torch.clamp(safe_exp(M[:, 0] + 0.5 * V[:, 0]), 1e-9, 1e9)
        Eb = torch.clamp(safe_exp(M[:, 1] + 0.5 * V[:, 1]), 1e-9, 1e9)
        lg = _lngamma_engine(quadrature.DEFAULT_T)
        E_lga = lg(Y, M[:, :1], V[:, :1], use_kernel)
        E_lgb = lg(Y, M[:, 1:], V[:, 1:], use_kernel)
        E_lgab = _lngamma_sum_engine(quadrature.MULTI_T)(Y, M, V)
        return ((Ea - 1.0) * torch.log(y) + (Eb - 1.0) * torch.log1p(-y)
                - E_lga - E_lgb + E_lgab)

    def logpdf(self, F, Y):
        a, b = _ab(F)
        y = Y[..., 0]
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return (a - 1.0) * torch.log(y) + (b - 1.0) * torch.log1p(-y) - betaln

    def conditional_moments(self, F):
        a, b = _ab(F)
        mean = a / (a + b)
        var = a * b / (torch.square(a + b) * (a + b + 1.0))
        return mean[..., None], var[..., None]

    def sample(self, generator, F):
        a, b = on_generator(generator, *_ab(F[:, None, :]))
        ga = torch._standard_gamma(a, generator=generator)
        gb = torch._standard_gamma(b, generator=generator)
        return (ga / (ga + gb)).to(F.device)
