"""Dirichlet likelihood over K-dimensional probability vectors.

Counterpart of ``hetmogp_tpu/likelihoods/dirichlet.py``: concentrations
alpha_k = clip(e^{f_k}, 1e-9, 1e9), y a point on the simplex,
logpdf = ln Gamma(sum a) - sum ln Gamma(a_k) + sum (a_k - 1) log y_k.
The tensor grids are T^K: T=10 for K <= 2, else T=5, for var_exp and the
predictive alike; ``mc_samples`` > 0 takes that many quasi-MC nodes
instead.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp)
from hetmogp_tpu_torch.likelihoods.gamma import _lngamma_engine
from hetmogp_tpu_torch.ops import quadrature


def _alpha(F):
    return torch.clamp(safe_exp(F), 1e-9, 1e9)


def _lngamma_sum(F, Y):
    del Y
    return torch.lgamma(torch.sum(_alpha(F), dim=-1))


@functools.lru_cache(maxsize=None)
def _lngamma_sumK_engine(K: int, T: int, mc_samples: int):
    """E[ln Gamma(sum_k alpha_k)], the only K-dimensional term of the
    Dirichlet var_exp, through the shared engine for its Bonnet/Price
    gradients (see ``gamma._lngamma_engine``)."""
    return quadrature.make_var_exp(_lngamma_sum, J=K, T=T,
                                   mc_samples=mc_samples)


@dataclasses.dataclass(frozen=True)
class Dirichlet(Likelihood):
    """``analytic=True`` (default) reduces the T^K grid as Beta does:
    E[log p] = E[ln Gamma(sum a)] (the K-D grid, one lgamma a node)
    - sum_k E[ln Gamma(a_k)] (K 1-D T=20 sweeps in one engine call)
    + sum_k (E[a_k] - 1) ln y_k (E[a_k] = e^{m_k+v_k/2} clipped to
    [1e-9, 1e9]).  ``analytic=False`` takes the grid engine for the whole
    logpdf."""

    K: int = 3
    mc_samples: int = 0
    analytic: bool = True

    @property
    def dim_y(self):  # type: ignore[override]
        return self.K

    @property
    def dim_f(self):  # type: ignore[override]
        return self.K

    @property
    def dim_p(self):  # type: ignore[override]
        return self.K

    @property
    def T_var_exp(self):  # type: ignore[override]
        return quadrature.MULTI_T if self.K <= 2 else 5

    @property
    def T_pred(self):  # type: ignore[override]
        # T=20 would make the predictive a 20^K grid
        return self.T_var_exp

    def ismulti(self) -> bool:
        return True

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the closed form on the tensor grids
        of K = 2 and 3; quasi-MC nodes, another K or ``analytic=False``
        keep the engines."""
        if self.analytic and not self.mc_samples and self.K in (2, 3):
            return "dirichlet"
        return None

    def task_grid(self):
        """The closed form's K + 1 sweeps, one grid a term: E[ln Gamma(a_k)]
        on the 1-D T=20 grid for each k, then E[ln Gamma(sum a)] on the
        K-D grid."""
        return ([(quadrature.DEFAULT_T, 1, 0)] * self.K
                + [(self.T_var_exp, self.K, 0)])

    def var_exp(self, Y, M, V, use_kernel=True):
        if not self.analytic:
            return Likelihood.var_exp(self, Y, M, V, use_kernel=use_kernel)
        n = M.shape[0]
        Ea = torch.clamp(safe_exp(M + 0.5 * V), 1e-9, 1e9)  # (N, K)
        # the K separable sweeps as one call on the flattened axis (the
        # engine's y operand is unused by the integrand)
        flat_m, flat_v = M.reshape(-1, 1), V.reshape(-1, 1)
        E_lga = _lngamma_engine(quadrature.DEFAULT_T)(
            flat_m, flat_m, flat_v, use_kernel).reshape(n, self.K)
        E_lgsum = _lngamma_sumK_engine(self.K, self.T_var_exp,
                                       self.mc_samples)(Y, M, V)
        lin = torch.sum((Ea - 1.0) * torch.log(Y), dim=1)
        return E_lgsum - torch.sum(E_lga, dim=1) + lin

    def logpdf(self, F, Y):
        a = _alpha(F)
        return (torch.lgamma(torch.sum(a, dim=-1))
                - torch.sum(torch.lgamma(a), dim=-1)
                + torch.sum((a - 1.0) * torch.log(Y), dim=-1))

    def conditional_moments(self, F):
        a = _alpha(F)
        a0 = torch.sum(a, dim=-1, keepdim=True)
        return a / a0, a * (a0 - a) / (torch.square(a0) * (a0 + 1.0))

    def sample(self, generator, F):
        (a,) = on_generator(generator, _alpha(F))
        return torch._sample_dirichlet(a, generator=generator).to(F.device)
