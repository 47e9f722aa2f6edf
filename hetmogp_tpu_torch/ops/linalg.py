"""Dense linear algebra of the serving path.

Counterpart of the serving subset of ``hetmogp_tpu/ops/linalg.py``.  The
JAX package blocks these by hand for the TPU's matrix unit; here they start
as plain PyTorch calls (cuSOLVER and cuBLAS on the card).  Each becomes a
hand kernel only where a profile on the card puts it on top.  Float32
matmuls must run in full float32: TF32 ruins the projection
P = Kfu @ iLuu^T (see ``models/elbo.py``), so nothing here may run under
``torch.set_float32_matmul_precision("high")``.
"""

from __future__ import annotations

import torch


def blocked_cholesky_inverse(K: torch.Tensor):
    """(chol(K), inv(chol(K))) for (..., M, M) SPD K.

    The contract of the JAX ``blocked_cholesky_inverse``: both factors come
    back lower-triangular, and a factorization that fails surfaces as NaNs
    in both, not as an exception (and without a host synchronisation).
    """
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    iL = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L, iL


def matmul_tril_t(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """A @ L^T for lower-triangular L: (..., N, M), (..., M, M) -> (..., N, M).

    Dense for now; the JAX package skips L's zero blocks.
    """
    return A @ L.mT


def matmul_tril(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """A @ L for lower-triangular L (dense for now)."""
    return A @ L


def quad_diag(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """diag(A L L^T A^T), batched: (..., N, M), (..., M, M) -> (..., N).

    Only the lower triangle of L is read.
    """
    return torch.sum(torch.square(A @ torch.tril(L)), dim=-1)
