"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``hetmogp_tpu/ops/pallas_dispatch.py``.  The policy, the
same for every kernel:

* every tensor goes through the kernel's ``autograd.Function`` and its
  ``hetmogp::`` operator, whose CUDA implementation launches the kernel
  and whose CPU implementation is the plain PyTorch version;
* a CUDA float32 tensor goes to the kernel, at every size: there is no
  size gate until a measurement on the card sets one;
* a CUDA tensor of another dtype raises: the RBF and triangular kernels
  are float32-only, and a silent switch to the plain version would hide
  that from the caller (kernels 6 and 7, the GH sweep and the adam update,
  take float32 and float64: ``ops/quadrature.py`` and ``train.py`` route
  to them);
* ``use_kernel=False`` takes the plain PyTorch version on any device,
  outside the operators (what the kernels are checked against).

The triangular products have two kernels each, chosen by ``precision``:
the projection A tril(L)^T (``matmul_tril_t``, at the config's
``ve_fwd_precision``) is kernel A in float32 at ``"highest"`` and kernel 3
in three bf16 tensor-core passes at ``"high"``; the right product
A tril(L) (``matmul_tril``, and ``tril_t_matmul`` through it) is kernel 4
in float32 and kernel 5 in three bf16 passes (the VM step's cached
adjoints at ``"high"``).  ``quad_diag`` is kernel 4 with its row sum of
squares fused: the row sums alone when no input needs a gradient (the
product never reaches memory), the product and the row sums otherwise,
in an ``autograd.Function`` whose backward is kernel A (gA) and kernel 8
(gL at ``precision``).  ``t_matmul_tril_out``, tril(A^T B) with only the
lower tiles formed, is kernel 8 in float32 and in three bf16 passes at
``"high"``.  ``"high"`` on float64 takes the full-precision route: the
3-pass split is a float32 scheme, and the JAX package's
``Precision.HIGH`` is a no-op in float64 as well.

Kernel 9 (``chol_panel``), the Cholesky factor and inverse of one
diagonal panel of the blocked factorization, takes float32 and float64;
it writes into the views it is given, so it is a launcher, not an
operator (no exported program reaches it).  Kernel 10
(``chol_blocked``), the blocked factor and inverse of a float32 stack
whose width is a multiple of 128 in one launch, is a launcher too.
"""

from __future__ import annotations

import torch


def _use_kernel(t: torch.Tensor, use_kernel: bool, what: str) -> bool:
    if not use_kernel or not t.is_cuda:
        return False
    if t.dtype != torch.float32:
        raise TypeError(
            f"the CUDA {what} kernel takes float32 only, got {t.dtype}; pass "
            "use_kernel=False for the plain PyTorch version")
    return True


def use_rbf_kernel(X: torch.Tensor, use_kernel: bool = True) -> bool:
    """Whether ``X`` (and the tensors that come with it) go to the kernel."""
    return _use_kernel(X, use_kernel, "RBF")


def use_tril_kernel(A: torch.Tensor, use_kernel: bool = True) -> bool:
    """Whether ``A`` (and L) go to the triangular projection kernel."""
    return _use_kernel(A, use_kernel, "triangular projection")


def rbf_K_batched(X, Z, lengthscale, variance, *, use_kernel: bool = True):
    # imported here: cuda_kernels builds on ops.kernels, which imports this
    from hetmogp_tpu_torch.ops import cuda_kernels

    if not use_kernel:
        return cuda_kernels.rbf_K_batched_plain(X, Z, lengthscale, variance)
    use_rbf_kernel(X)  # a CUDA tensor of another dtype raises
    return cuda_kernels.RBFCrossCovariance.apply(X, Z, lengthscale, variance)


PRECISIONS = ("highest", "high")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def matmul_tril_t(A, L, *, precision: str = "highest",
                  use_kernel: bool = True):
    from hetmogp_tpu_torch.ops import cuda_kernels

    _check_precision(precision)
    use_tril_kernel(A, use_kernel)  # a CUDA tensor of another dtype raises
    if precision == "high" and A.dtype == torch.float32:
        return cuda_kernels.TrilProjection3Pass.apply(A, L, use_kernel)
    if use_kernel:
        return cuda_kernels.TrilProjection.apply(A, L)
    return cuda_kernels.tril_projection_plain(A, L)


def matmul_tril(A, L, *, precision: str = "highest", use_kernel: bool = True):
    from hetmogp_tpu_torch.ops import cuda_kernels

    _check_precision(precision)
    use_tril_kernel(A, use_kernel)  # a CUDA tensor of another dtype raises
    if precision == "high" and A.dtype == torch.float32:
        return cuda_kernels.MatmulTril3Pass.apply(A, L, use_kernel)
    if use_kernel:
        return cuda_kernels.MatmulTril.apply(A, L)
    return cuda_kernels.matmul_tril_plain(A, L)


def quad_diag(A, L, *, precision: str = "highest", use_kernel: bool = True):
    from hetmogp_tpu_torch.ops import cuda_kernels

    _check_precision(precision)
    use_tril_kernel(A, use_kernel)  # a CUDA tensor of another dtype raises
    if not use_kernel:
        return cuda_kernels.quad_diag_plain(A, L)
    if torch.is_grad_enabled() and (A.requires_grad or L.requires_grad):
        return cuda_kernels.QuadDiag.apply(A, L, precision)
    return torch.ops.hetmogp.quad_diag(A, L)


def t_matmul_tril_out(A, B, *, precision: str = "highest",
                      use_kernel: bool = True):
    from hetmogp_tpu_torch.ops import cuda_kernels

    _check_precision(precision)
    use_tril_kernel(A, use_kernel)  # a CUDA tensor of another dtype raises
    if use_kernel:
        return cuda_kernels._tril_out_op(A, B, precision)
    if precision == "high" and A.dtype == torch.float32:
        return cuda_kernels.t_matmul_tril_out_3pass_plain(A, B)
    return cuda_kernels.t_matmul_tril_out_plain(A, B)


def chol_panel(A, L=None, iL=None):
    """(L, L^{-1}) of the (batch, n, n) SPD ``A``, n <= 128, written into
    ``L`` and ``iL`` where given: kernel 9 for a CUDA tensor (float32 or
    float64; another dtype raises), its plain version for a CPU tensor."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    if A.is_cuda:
        return cuda_kernels.chol_panel(A, L, iL)
    Lp, iLp = cuda_kernels.chol_panel_plain(A)
    return (Lp if L is None else L.copy_(Lp),
            iLp if iL is None else iL.copy_(iLp))


def chol_blocked(K):
    """(L, L^{-1}) of the (batch, M, M) SPD ``K``, M a multiple of 128:
    kernel 10 for a CUDA tensor (float32; another dtype raises), its plain
    version for a CPU tensor."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    if K.is_cuda:
        return cuda_kernels.chol_blocked(K)
    return cuda_kernels.chol_blocked_plain(K)
