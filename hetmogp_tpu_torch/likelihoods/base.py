"""Likelihood protocol.

Counterpart of ``hetmogp_tpu/likelihoods/base.py``.  A likelihood
gives ``logpdf`` of y given its parameter functions f and the
``conditional_moments`` of y; ``var_exp`` integrates ``logpdf`` against the
posterior moments (M, V) of f, and ``predictive`` pushes (M, V) through the
conditional moments: both by the generic Gauss-Hermite engines of
``ops/quadrature.py``, or in closed form where a subclass has one;
``log_predictive`` is the Monte-Carlo test density behind NLPD, and
``sample`` draws observations from a ``torch.Generator``.

Trainable likelihood parameters: a family with ``n_theta`` > 0 takes a
vector theta (``params.lik_theta[t]``) in ``var_exp(theta=)`` and
``logpdf_t``; ``default_theta`` is the theta of its constructor constants
and ``with_theta`` the static instance of a trained theta (for
prediction).

Instances are frozen dataclasses, hashable, so the GH engines are cached
per likelihood.  Array conventions: ``Y`` is (N, dim_y), ``M``/``V`` are
(N, dim_f); ``var_exp`` returns (N,) and ``predictive`` two (N, dim_p)
tensors.  ``logpdf`` and ``conditional_moments`` are batched where the JAX
package's are per point: they take F with any leading dims, (..., dim_f),
``logpdf`` a Y that broadcasts against it, (..., dim_y), and return (...)
and two (..., dim_p) tensors; ``logpdf_t``'s theta broadcasts the same
way, (..., P).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar, Optional

import numpy as np
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


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b) as max(a, b) + log1p(e^{-|a - b|}), the form of
    ``jnp.logaddexp``: its first and second derivatives are built from
    e^{-|a - b|} <= 1, finite at any arguments.  ``torch.logaddexp``'s
    backward divides by 1 + e^{b - a}, and its second derivative is
    inf / inf = NaN once |a - b| passes ~88 in float32 (a GH node far
    out, as the engine's diagonal second derivative reaches)."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def log_of(x):
    """log of a tensor or of a Python float (a static constant)."""
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def lgamma_of(x):
    """lgamma of a tensor or of a Python float (a static constant)."""
    return torch.lgamma(x) if isinstance(x, torch.Tensor) else math.lgamma(x)


def theta_array(theta) -> np.ndarray:
    """A theta vector (tensor on any device, array or sequence) as a
    float64 numpy array, for the static constants of ``with_theta``."""
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().to("cpu", torch.float64)
    return np.asarray(theta, np.float64)


def on_generator(generator, *tensors):
    """``tensors`` moved to ``generator``'s device, for a draw there: the
    samplers draw on the generator's own device (a CPU generator serves a
    model on the card) and move the draw back."""
    if generator is None:
        raise ValueError("random draws need a torch.Generator: the port "
                         "reads no global seed")
    return tuple(t.to(generator.device) for t in tensors)


@functools.lru_cache(maxsize=None)
def _var_exp_engine(lik):
    return quadrature.make_var_exp(lik.logpdf, J=lik.dim_f, T=lik.T_var_exp,
                                   mc_samples=getattr(lik, "mc_samples", 0),
                                   sweep=lik.sweep)


@functools.lru_cache(maxsize=None)
def _var_exp_engine_theta(lik):
    return quadrature.make_var_exp_theta(
        lik.logpdf_t, J=lik.dim_f, T=lik.T_var_exp,
        mc_samples=getattr(lik, "mc_samples", 0))


@functools.lru_cache(maxsize=None)
def _predictive_engine(lik):
    return quadrature.make_predictive(
        lik.conditional_moments, J=lik.dim_f, T=lik.T_pred,
        mc_samples=getattr(lik, "mc_samples", 0))


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
    # size of the trainable likelihood-parameter vector theta (0: none)
    n_theta: ClassVar[int] = 0
    # the device function of ``logpdf`` in ``quadrature.SWEEP_FAMILIES``
    # (kernel 6), or None: the GH engine's sweep on the card
    sweep: ClassVar[Optional[str]] = None
    # the device function of the whole ``var_exp`` in
    # ``quadrature.TASK_FAMILIES`` (kernel 6's task table), or None: the
    # ELBO calls ``var_exp`` itself
    task: ClassVar[Optional[str]] = None

    def logpdf(self, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(y | f): (..., dim_f), (..., dim_y) -> (...)."""
        raise NotImplementedError

    def conditional_moments(self, F: torch.Tensor):
        """(mean, var) of y given f: (..., dim_f) -> two (..., dim_p)."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator,
               F: torch.Tensor) -> torch.Tensor:
        """One observation per row of F: (N, dim_f) -> (N, dim_y), drawn
        from ``generator`` on its own device, returned on F's."""
        raise NotImplementedError

    def get_metadata(self):
        return self.dim_y, self.dim_f, self.dim_p

    def ismulti(self) -> bool:
        return False

    def logpdf_t(self, F: torch.Tensor, Y: torch.Tensor,
                 theta: torch.Tensor) -> torch.Tensor:
        """``logpdf`` with an explicit theta (..., P); families without
        theta ignore it."""
        return self.logpdf(F, Y)

    def default_theta(self, dtype=np.float64) -> np.ndarray:
        """theta (n_theta,) of the constructor constants."""
        return np.zeros((0,), dtype)

    def with_theta(self, theta) -> "Likelihood":
        """A static instance whose constructor constants are ``theta``."""
        if self.n_theta:
            raise NotImplementedError(
                f"{type(self).__name__} must override with_theta")
        return self

    def var_exp(self, Y: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
                theta=None, use_kernel: bool = True) -> torch.Tensor:
        """E_{N(f; M, V)}[log p(Y | f)] per data point -> (N,), with the
        engine's Bonnet/Price (m, v)-gradients.  ``theta`` (n_theta,): the
        trainable likelihood parameters, with their gradient; None (or
        n_theta == 0) keeps the constructor constants.  ``use_kernel=False``
        takes the GH engine's plain sweep on any device (a CUDA tensor of a
        family with a ``sweep`` otherwise takes kernel 6)."""
        if theta is not None and self.n_theta:
            return _var_exp_engine_theta(self)(Y, M, V, theta)
        return _var_exp_engine(self)(Y, M, V, use_kernel)

    def task_grid(self):
        """(T, J, mc_samples) of the GH nodes the task table sweeps for
        ``var_exp`` (a family whose ``task`` holds a sweep): its engine's.
        A multi-term family (``quadrature.TERMS``) gives a list, one grid a
        term, in the order its device function takes them."""
        return self.T_var_exp, self.dim_f, getattr(self, "mc_samples", 0)

    def task_consts(self) -> tuple:
        """The constants of the family that the task table's device
        function reads (at most two floats; none by default)."""
        return ()

    def var_exp_derivatives(self, Y: torch.Tensor, M: torch.Tensor,
                            V: torch.Tensor):
        """(dVE/dM, dVE/dV), each (N, dim_f): the engine's gradient forms
        (or autograd of a closed form)."""
        with torch.enable_grad():
            M = M.detach().requires_grad_()
            V = V.detach().requires_grad_()
            return torch.autograd.grad(self.var_exp(Y, M, V).sum(), (M, V))

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
