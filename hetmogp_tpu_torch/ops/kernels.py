"""Stationary kernels, batched over the Q latent GPs.

Counterpart of ``hetmogp_tpu/ops/kernels.py``: the RBF, Matern-3/2,
Matern-5/2, exponential and rational-quadratic kernels, and the diagonal
of the LMC coregionalization matrices.

Batching is written out: every function takes leading batch dimensions
(the Q axis) on its inputs and broadcasts them, where the JAX package vmaps
an unbatched function.  ``K_batched("rbf", ...)`` sends CUDA float32
tensors to the hand-written kernel (``ops/cuda_kernels.py``) and CPU
tensors to the plain version below; ``ops/cuda_dispatch.py`` decides.  The
other kernels are plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from hetmogp_tpu_torch.ops import cuda_dispatch

_DIRECT_DIST_MAX_DIM = 4


def _sq_dists(X1: torch.Tensor, X2: torch.Tensor,
              lengthscale: torch.Tensor) -> torch.Tensor:
    """Scaled squared distances r2[..., i, j] = sum_d ((x1_id - x2_jd) / ls_d)^2.

    X1: (..., N, Dx), X2: (..., M, Dx), lengthscale: (..., Dx) or (..., 1).

    For Dx <= 4 the direct difference form: it is free of cancellation (the
    |a|^2 + |b|^2 - 2ab form loses digits on near-coincident points that
    feed an ill-conditioned Gram).  Wider inputs use the matmul form.
    """
    S1 = X1 / lengthscale[..., None, :]
    S2 = X2 / lengthscale[..., None, :]
    if X1.shape[-1] <= _DIRECT_DIST_MAX_DIM:
        d = S1[..., :, None, :] - S2[..., None, :, :]
        return torch.sum(torch.square(d), dim=-1)
    n1 = torch.sum(torch.square(S1), dim=-1)
    n2 = torch.sum(torch.square(S2), dim=-1)
    r2 = n1[..., :, None] + n2[..., None, :] - 2.0 * (S1 @ S2.mT)
    return torch.clamp(r2, min=0.0)


def rbf(X1, X2, lengthscale, variance):
    """sigma^2 exp(-r2/2), the GPy RBF convention (K(x, x) = variance).

    variance: (...,), broadcast against the batch dimensions of the inputs.
    """
    return variance[..., None, None] * torch.exp(
        -0.5 * _sq_dists(X1, X2, lengthscale))


def _dists(X1, X2, lengthscale):
    """Scaled distances r, with the JAX package's 1e-36 under the root: the
    gradient stays finite at coincident points."""
    return torch.sqrt(_sq_dists(X1, X2, lengthscale) + 1e-36)


def matern32(X1, X2, lengthscale, variance):
    s3r = 3.0 ** 0.5 * _dists(X1, X2, lengthscale)
    return variance[..., None, None] * (1.0 + s3r) * torch.exp(-s3r)


def matern52(X1, X2, lengthscale, variance):
    r2 = _sq_dists(X1, X2, lengthscale)
    s5r = 5.0 ** 0.5 * torch.sqrt(r2 + 1e-36)
    return (variance[..., None, None] * (1.0 + s5r + (5.0 / 3.0) * r2)
            * torch.exp(-s5r))


def exponential_kernel(X1, X2, lengthscale, variance):
    """Ornstein-Uhlenbeck / Matern-1/2: sigma^2 exp(-r)."""
    return variance[..., None, None] * torch.exp(
        -_dists(X1, X2, lengthscale))


def rq(X1, X2, lengthscale, variance, alpha: float = 2.0):
    """Rational quadratic with fixed alpha (scale-mixture of RBFs)."""
    r2 = _sq_dists(X1, X2, lengthscale)
    return variance[..., None, None] * (1.0 + r2 / (2.0 * alpha)) ** (-alpha)


_KERNELS = {"rbf": rbf, "matern32": matern32, "matern52": matern52,
            "exponential": exponential_kernel, "rq": rq}
KERNEL_NAMES = tuple(sorted(_KERNELS))


def kern_fn(kind: str):
    try:
        return _KERNELS[kind]
    except KeyError:
        raise ValueError(f"unknown kernel {kind!r}; have "
                         f"{sorted(_KERNELS)}") from None


def K_batched(kind: str, X: torch.Tensor, Z: torch.Tensor,
              lengthscale: torch.Tensor, variance: torch.Tensor, *,
              use_kernel: bool = True) -> torch.Tensor:
    """Cross-covariances for all Q latent GPs at once.

    Args:
      X: (N, Dx) shared inputs.
      Z: (Q, M, Dx) per-latent inducing inputs.
      lengthscale: (Q, Dx), or isotropic (Q, 1).
      variance: (Q,).
      use_kernel: False takes the plain PyTorch version on any device (the
        reference that the kernel is checked against).
    Returns:
      (Q, N, M)
    """
    if kind == "rbf":
        return cuda_dispatch.rbf_K_batched(X, Z, lengthscale, variance,
                                           use_kernel=use_kernel)
    return kern_fn(kind)(X, Z, lengthscale, variance)


def K_gram_batched(kind: str, Z: torch.Tensor, lengthscale: torch.Tensor,
                   variance: torch.Tensor) -> torch.Tensor:
    """Per-latent Gram matrices Kuu: (Q, M, Dx) -> (Q, M, M)."""
    return kern_fn(kind)(Z, Z, lengthscale, variance)


def K_self_batched(kind: str, X: torch.Tensor, lengthscale: torch.Tensor,
                   variance: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """K_q(X, X) of shared inputs for every latent GP: (N, Dx) -> (Q, N, N),
    what the JAX package takes from ``K_gram_batched`` on a broadcast X.

    It goes through ``K_batched`` with Z = X, so CUDA float32 "rbf" runs
    the hand-written kernel instead of the plain version's (Q, N, N, Dx)
    difference tensor (512 MiB at N = 4096).  Both scale x_n and x_m alike
    and square their difference, so the result is symmetric to the bit and
    its diagonal is the variance.
    """
    Z = X[None].expand(variance.shape[0], *X.shape)
    return K_batched(kind, X, Z, lengthscale, variance, use_kernel=use_kernel)


def Kdiag_batched(kind: str, X: torch.Tensor,
                  variance: torch.Tensor) -> torch.Tensor:
    """Diagonal of K(X, X) for each latent GP: (Q, N).

    All supported stationary kernels have Kdiag = variance.
    """
    return variance[:, None].expand(variance.shape[0], X.shape[0])


def lmc_coregionalization(W: torch.Tensor,
                          kappa: torch.Tensor) -> torch.Tensor:
    """B_q = w_q w_q^T + diag(kappa_q) diagonal entries, (Q, D): only
    B_q[d, d] = w_qd^2 + kappa_qd is ever consumed by the model."""
    return torch.square(W) + kappa
