"""Gauss-Hermite predictive moments.

Counterpart of the serving subset of ``hetmogp_tpu/ops/quadrature.py``.
The nodes and weights come from numpy's ``hermgauss``, so they are the
JAX package's to the bit.  ``make_var_exp`` and the Monte-Carlo nodes come
with the trainer (ROADMAP.md section 1, item 5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_T = 20  # GPy Likelihood._gh_points() default
MULTI_T = 10  # multi-latent likelihoods (categorical)


@functools.lru_cache(maxsize=None)
def gh_points(T: int):
    """Hermite-Gauss nodes and weights as float64 numpy constants."""
    return np.polynomial.hermite.hermgauss(T)


@functools.lru_cache(maxsize=None)
def tensor_grid(T: int, J: int):
    """Tensor-product GH grid over J dims.

    Returns:
      nodes: (T^J, J) float64; weights: (T^J,) already normalized by
      pi^(J/2) so that sum_s w_s g(f_s) approximates E_{N(m,v)}[g].
    """
    f, w = gh_points(T)
    grids = np.meshgrid(*([f] * J), indexing="ij")
    nodes = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wgrids = np.meshgrid(*([w] * J), indexing="ij")
    weights = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1),
                      axis=-1)
    return nodes, weights / (np.pi ** (J / 2.0))


def make_predictive(cond_moments, J: int, T: int):
    """Observation-space predictive moments by GH quadrature.

    E[y*] = E_q[mean(f)],  V[y*] = E_q[var(f)] + E_q[mean(f)^2] - E[y*]^2.

    Args:
      cond_moments: (F: (..., J)) -> (mean, var), each (..., dim_p).
    Returns:
      predictive(m, v) with m, v (N, J) -> (mean, var), each (N, dim_p).
    """
    nodes_np, weights_np = tensor_grid(T, J)

    def predictive(m, v):
        nodes = torch.as_tensor(nodes_np, dtype=m.dtype, device=m.device)
        w = torch.as_tensor(weights_np, dtype=m.dtype, device=m.device)
        sigma = torch.sqrt(2.0 * v)
        F = m[:, None, :] + sigma[:, None, :] * nodes[None, :, :]  # (N, S, J)
        cm, cv = cond_moments(F)  # (N, S, dim_p) each
        Em = torch.einsum("nsp,s->np", cm, w)
        Em2 = torch.einsum("nsp,s->np", torch.square(cm), w)
        Ev = torch.einsum("nsp,s->np", cv, w)
        return Em, Ev + Em2 - torch.square(Em)

    return predictive
