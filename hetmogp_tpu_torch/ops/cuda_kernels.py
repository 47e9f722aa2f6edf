"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``hetmogp_tpu/ops/pallas_kernels.py``.  The RBF
cross-covariance kernel is ``csrc/rbf_kernel.cu``, built by
``ops/_build.py`` when a CUDA tensor first reaches ``rbf_K_batched`` and
bound with ``ctypes``.  Importing this module builds and loads nothing.

``rbf_K_batched_plain`` is ``ops/kernels.py``'s ``rbf`` batched over Q:
what CPU tensors take, and what the kernel is checked against on the card.

The backward of the kernel (an ``autograd.Function`` with the algebra of
``pallas_kernels._rbf_bwd``) comes with the trainer; until then the
wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hetmogp_tpu_torch.ops import _build, kernels

# The kernel stages (128 + 32) * Dx floats of shared memory per block and
# stays under the 48 KiB that needs no opt-in (csrc/rbf_kernel.cu).
MAX_DX = 64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build()))
    fn = lib.hetmogp_rbf_cross_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library now, not at first use."""
    _library()


def rbf_K_batched_plain(X, Z, lengthscale, variance):
    """Plain version of the kernel: (N, Dx), (Q, M, Dx) -> (Q, N, M)."""
    return kernels.rbf(X, Z, lengthscale, variance)


def rbf_K_batched(X: torch.Tensor, Z: torch.Tensor, lengthscale: torch.Tensor,
                  variance: torch.Tensor) -> torch.Tensor:
    """Batched RBF cross-covariance on the card: (Q, N, M) float32.

    X: (N, Dx), Z: (Q, M, Dx), lengthscale: (Q, Dx) or isotropic (Q, 1),
    variance: (Q,); all float32 on one CUDA device.  Launches on the current
    stream and does not synchronise.  ``rbf_K_batched.launches`` counts the
    launches.
    """
    tensors = (X, Z, lengthscale, variance)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA RBF kernel has no backward yet (ROADMAP.md section 1, "
            "item 8); call it under torch.no_grad() or inference_mode()")
    if not all(t.is_cuda and t.device == X.device for t in tensors):
        raise ValueError("rbf_K_batched takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("rbf_K_batched takes float32 only, got "
                        f"{[t.dtype for t in tensors]}")
    if X.ndim != 2 or Z.ndim != 3 or Z.shape[-1] != X.shape[-1]:
        raise ValueError(f"X must be (N, Dx) and Z (Q, M, Dx); got "
                         f"{tuple(X.shape)} and {tuple(Z.shape)}")
    (N, Dx), (Q, M, _) = X.shape, Z.shape
    if variance.shape != (Q,) or lengthscale.shape not in ((Q, Dx), (Q, 1)):
        raise ValueError(
            f"lengthscale must be ({Q}, {Dx}) or ({Q}, 1) and variance "
            f"({Q},); got {tuple(lengthscale.shape)} and "
            f"{tuple(variance.shape)}")
    if not 0 < Dx <= MAX_DX or Q > 65535 or max(N, M) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: Q={Q}, N={N}, "
                         f"M={M}, Dx={Dx} (Dx <= {MAX_DX}, Q <= 65535)")
    out = torch.empty((Q, N, M), dtype=torch.float32, device=X.device)
    if out.numel() == 0:
        return out
    X = X.contiguous()
    Z = Z.contiguous()
    ils = (1.0 / lengthscale.expand(Q, Dx)).contiguous()
    var = variance.contiguous()
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.hetmogp_rbf_cross_f32(
            X.data_ptr(), Z.data_ptr(), ils.data_ptr(), var.data_ptr(),
            out.data_ptr(), Q, N, M, Dx, stream)
    if err != 0:
        raise RuntimeError(f"rbf_K_batched launch failed: CUDA error {err}")
    rbf_K_batched.launches += 1
    return out


rbf_K_batched.launches = 0
