"""Posterior moments of the latent functions, serving subset.

Counterpart of the serving subset of ``hetmogp_tpu/models/elbo.py``: the
prior factorization (Luu, Luu^{-1}), the per-latent projections on the
cached-inverse path, and the mixing of those into one task's q(f) moments.
The triangular-solve path, ``cache_grad`` and the ELBO itself come with
the trainer (ROADMAP.md section 1, item 7).
"""

from __future__ import annotations

import torch

from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.models.params import SVMOGPParams
from hetmogp_tpu_torch.ops import kernels, linalg


def prior_cholesky_inverse(params: SVMOGPParams, config: ModelConfig):
    """(Luu, Luu^{-1}) of Kuu + jitter I, each (Q, M, M), fixed jitter."""
    Kuu = kernels.K_gram_batched(config.kernel, params.Z, params.lengthscale,
                                 params.variance)
    eye = torch.eye(Kuu.shape[-1], dtype=Kuu.dtype, device=Kuu.device)
    return linalg.blocked_cholesky_inverse(Kuu + config.jitter * eye)


def latent_projections(params: SVMOGPParams, config: ModelConfig,
                       Luu: torch.Tensor, X: torch.Tensor, iLuu: torch.Tensor,
                       *, use_kernel: bool = True):
    """Per-latent projection terms at inputs X, through the cached inverse.

    Returns:
      mean_q:  (Q, N)  posterior mean of each latent projection
      gamma_q: (Q, N)  kdiag_q + diag(A S A^T) - diag(A Kuf), the per-latent
               variance before the mixing weights
      kdiag:   (Q, N)  prior diagonal per latent

    Whitened: P = (Luu^{-1} Kuf)^T = Kfu @ iLuu^T.  Un-whitened:
    A = P @ iLuu = Kfu Kuu^{-1}.  Luu is not read on this path; it stays in
    the signature of the JAX function.

    P feeds the kdiag - |P|^2 cancellation, so its matmul must run in full
    float32: at reduced precision the JAX package measured a relative error
    of 1.5e0 in P at M=1024, against 2.3e-4 at full precision.
    """
    del Luu
    Kfu = kernels.K_batched(config.kernel, X, params.Z, params.lengthscale,
                            params.variance, use_kernel=use_kernel)  # (Q, N, M)
    kdiag = kernels.Kdiag_batched(config.kernel, X, params.variance)
    m_u, Lq = params.q_mu, torch.tril(params.q_sqrt)
    P = linalg.matmul_tril_t(Kfu, iLuu)
    if config.whiten:
        mean_q = torch.einsum("qnm,qm->qn", P, m_u)
        gamma_q = (kdiag + linalg.quad_diag(P, Lq)
                   - torch.sum(torch.square(P), dim=-1))
    else:
        A = linalg.matmul_tril(P, iLuu)
        mean_q = torch.einsum("qnm,qm->qn", A, m_u)
        gamma_q = (kdiag + linalg.quad_diag(A, Lq)
                   - torch.sum(A * Kfu, dim=-1))
    return mean_q, gamma_q, kdiag


def task_qf_moments(params: SVMOGPParams, config: ModelConfig,
                    Luu: torch.Tensor, X: torch.Tensor, task: int, *,
                    iLuu: torch.Tensor, clip_variance: bool = True,
                    var_floor: float = 0.0, use_kernel: bool = True):
    """Marginal moments (m_F, v_F), each (N, F_t), of q(f_d) for every
    parameter function d of one task."""
    mean_q, gamma_q, kdiag = latent_projections(
        params, config, Luu, X, iLuu, use_kernel=use_kernel)
    return _mix_task(mean_q, gamma_q, kdiag, params, config, task,
                     clip_variance=clip_variance, var_floor=var_floor)


def _mix_task(mean_q, gamma_q, kdiag, params, config, task,
              clip_variance: bool = True, var_floor: float = 0.0):
    """Coregionalization mixing of per-latent projections into one task's
    (m_F, v_F): m_fd = sum_q w_qd mean_q,
    v_fd = sum_q (w_qd^2 gamma_q + kappa_qd kdiag_q)."""
    start, stop = config.task_function_slices[task]
    Wt = params.W[:, start:stop]  # (Q, F_t)
    Kt = params.kappa[:, start:stop]
    m_F = torch.einsum("qn,qj->nj", mean_q, Wt)
    v_F = (torch.einsum("qn,qj->nj", gamma_q, torch.square(Wt))
           + torch.einsum("qn,qj->nj", kdiag, Kt))
    if clip_variance:
        v_F = torch.clamp(v_F, min=var_floor)
    return m_F, v_F
