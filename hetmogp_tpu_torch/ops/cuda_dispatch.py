"""Dispatch between the hand-written CUDA kernel and its plain version.

Counterpart of ``hetmogp_tpu/ops/pallas_dispatch.py``.  The policy:

* a CUDA float32 tensor goes to the kernel, at every size: there is no
  N*M gate until a measurement on the card sets one;
* a CUDA tensor of another dtype raises: the kernel is float32-only, and a
  silent switch to the plain version would hide that from the caller;
* a CPU tensor, or ``use_kernel=False``, takes the plain PyTorch version.
"""

from __future__ import annotations

import torch


def use_rbf_kernel(X: torch.Tensor, use_kernel: bool = True) -> bool:
    """Whether ``X`` (and the tensors that come with it) go to the kernel."""
    if not use_kernel or not X.is_cuda:
        return False
    if X.dtype != torch.float32:
        raise TypeError(
            f"the CUDA RBF kernel takes float32 only, got {X.dtype}; pass "
            "use_kernel=False for the plain PyTorch version")
    return True


def rbf_K_batched(X, Z, lengthscale, variance, *, use_kernel: bool = True):
    # imported here: cuda_kernels builds on ops.kernels, which imports this
    from hetmogp_tpu_torch.ops import cuda_kernels

    if use_rbf_kernel(X, use_kernel):
        return cuda_kernels.rbf_K_batched(X, Z, lengthscale, variance)
    return cuda_kernels.rbf_K_batched_plain(X, Z, lengthscale, variance)
