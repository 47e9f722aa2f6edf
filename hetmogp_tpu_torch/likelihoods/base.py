"""Likelihood protocol.

Counterpart of ``hetmogp_tpu/likelihoods/base.py`` without the trainable
likelihood parameters (theta) and sampling.  A likelihood
gives ``logpdf`` of y given its parameter functions f and the
``conditional_moments`` of y; ``var_exp`` integrates ``logpdf`` against the
posterior moments (M, V) of f, and ``predictive`` pushes (M, V) through the
conditional moments: both by the generic Gauss-Hermite engines of
``ops/quadrature.py``, or in closed form where a subclass has one;
``log_predictive`` is the Monte-Carlo test density behind NLPD.

Instances are frozen dataclasses, hashable, so the GH engines are cached
per likelihood.  Array conventions: ``Y`` is (N, dim_y), ``M``/``V`` are
(N, dim_f); ``var_exp`` returns (N,) and ``predictive`` two (N, dim_p)
tensors.  ``logpdf`` and ``conditional_moments`` are batched where the JAX
package's are per point: they take F with any leading dims, (..., dim_f),
``logpdf`` a Y that broadcasts against it, (..., dim_y), and return (...)
and two (..., dim_p) tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar

import torch

from hetmogp_tpu_torch.ops import quadrature


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with the argument clipped to log(dtype max) - 1: saturates
    instead of producing inf."""
    lim = math.log(torch.finfo(x.dtype).max) - 1.0
    return torch.exp(torch.clamp(x, max=lim))


def safe_square(x: torch.Tensor) -> torch.Tensor:
    lim = torch.finfo(x.dtype).max ** 0.5 / 2.0
    return torch.square(torch.clamp(x, -lim, lim))


@functools.lru_cache(maxsize=None)
def _var_exp_engine(lik):
    return quadrature.make_var_exp(lik.logpdf, J=lik.dim_f, T=lik.T_var_exp)


@functools.lru_cache(maxsize=None)
def _predictive_engine(lik):
    return quadrature.make_predictive(lik.conditional_moments, J=lik.dim_f,
                                      T=lik.T_pred)


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """Base class; subclasses set the class attributes, ``logpdf`` and
    ``conditional_moments``."""

    # the reference's get_metadata() triple (dim_y, dim_f, dim_p)
    dim_y: ClassVar[int] = 1
    dim_f: ClassVar[int] = 1
    dim_p: ClassVar[int] = 1
    T_var_exp: ClassVar[int] = quadrature.DEFAULT_T
    T_pred: ClassVar[int] = quadrature.DEFAULT_T

    def logpdf(self, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(y | f): (..., dim_f), (..., dim_y) -> (...)."""
        raise NotImplementedError

    def conditional_moments(self, F: torch.Tensor):
        """(mean, var) of y given f: (..., dim_f) -> two (..., dim_p)."""
        raise NotImplementedError

    def get_metadata(self):
        return self.dim_y, self.dim_f, self.dim_p

    def var_exp(self, Y: torch.Tensor, M: torch.Tensor,
                V: torch.Tensor) -> torch.Tensor:
        """E_{N(f; M, V)}[log p(Y | f)] per data point -> (N,), with the
        engine's Bonnet/Price (m, v)-gradients."""
        return _var_exp_engine(self)(Y, M, V)

    def predictive(self, M: torch.Tensor, V: torch.Tensor):
        """Observation-space predictive moments -> ((N, dim_p), (N, dim_p))."""
        return _predictive_engine(self)(M, V)

    def log_predictive(self, generator, Ytest: torch.Tensor,
                       M_star: torch.Tensor, V_star: torch.Tensor,
                       num_samples: int, reference_scaling: bool = True,
                       eps=None) -> torch.Tensor:
        """Monte-Carlo log-predictive density of Ytest (N, dim_y) under
        (M_star, V_star), each (N, dim_f), with draws from ``generator``
        (where the JAX package takes a key).  ``reference_scaling=True``
        keeps the reference's extra 1/num_samples factor (see
        ``quadrature.mc_log_predictive``); ``eps`` injects the (N, S, J)
        standard-normal draws."""
        return quadrature.mc_log_predictive(
            self.logpdf, generator, Ytest, M_star, V_star, num_samples,
            reference_scaling=reference_scaling, eps=eps)
