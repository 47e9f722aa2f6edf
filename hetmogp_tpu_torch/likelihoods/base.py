"""Likelihood protocol, serving subset.

Counterpart of ``hetmogp_tpu/likelihoods/base.py``.  A likelihood gives
``conditional_moments`` of y given its parameter functions f, and
``predictive`` pushes the posterior moments (M, V) of f through them: by
the generic Gauss-Hermite engine, or in closed form where a subclass has
one.  ``logpdf`` and ``var_exp`` come with the trainer (ROADMAP.md
section 1, item 6).

Instances are frozen dataclasses, hashable, so the GH engine is cached per
likelihood.  Array conventions: ``M``/``V`` are (N, dim_f); ``predictive``
returns two (N, dim_p) tensors.  ``conditional_moments`` takes F with any
leading dims, (..., dim_f), and returns two (..., dim_p) tensors.
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
def _predictive_engine(lik):
    return quadrature.make_predictive(lik.conditional_moments, J=lik.dim_f,
                                      T=lik.T_pred)


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """Base class; subclasses set the class attributes and
    ``conditional_moments``."""

    # the reference's get_metadata() triple (dim_y, dim_f, dim_p)
    dim_y: ClassVar[int] = 1
    dim_f: ClassVar[int] = 1
    dim_p: ClassVar[int] = 1
    T_pred: ClassVar[int] = quadrature.DEFAULT_T

    def conditional_moments(self, F: torch.Tensor):
        """(mean, var) of y given f: (..., dim_f) -> two (..., dim_p)."""
        raise NotImplementedError

    def get_metadata(self):
        return self.dim_y, self.dim_f, self.dim_p

    def predictive(self, M: torch.Tensor, V: torch.Tensor):
        """Observation-space predictive moments -> ((N, dim_p), (N, dim_p))."""
        return _predictive_engine(self)(M, V)
