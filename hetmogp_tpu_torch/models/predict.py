"""Prediction paths, serving subset: latent f and observation space.

Counterpart of the serving subset of ``hetmogp_tpu/models/predict.py``.
Every path here goes through the cached-inverse projection
(``elbo.latent_projections``).  Where the JAX ``predict_f`` and
``predictive`` factorize Kuu and use triangular solves, these compute
(Luu, Luu^{-1}) and use matmuls; the two agree to rounding (the tests hold
them to 1e-8 relative in float64).  Full covariances, sampling, the
projected and stochastic paths and NLPD come later (ROADMAP.md section 1,
item 10).  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import SVMOGPParams


def _as_inputs(Xnew, config: ModelConfig, device) -> torch.Tensor:
    """Prediction inputs as an (N, input_dim) tensor of the config's dtype on
    the parameters' device.  The kernels broadcast, so a wrong column count
    would give finite but wrong covariances: it raises here instead."""
    X = torch.as_tensor(Xnew, dtype=config.torch_dtype, device=device)
    if X.ndim != 2 or X.shape[-1] != config.input_dim:
        raise ValueError(
            f"prediction inputs must be (N, {config.input_dim}) for this "
            f"model (input_dim={config.input_dim}); got {tuple(X.shape)}")
    return X


def make_serving_predictive(params: SVMOGPParams, config: ModelConfig,
                            task: int, *, use_kernel: bool = True):
    """Observation-space predictive for one task of a fixed model.

    Computes (Luu, Luu^{-1}) once and returns ``X -> (m_pred, v_pred)``,
    each (N, dim_p), which projects every request through the cached
    inverse.  The inverse's error grows with cond(Kuu): keep a jitter floor
    (``ModelConfig.jitter``).  ``use_kernel=False`` takes the plain PyTorch
    RBF in place of the CUDA kernel (the reference it is checked against).
    """
    with torch.inference_mode():
        Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
    lik = config.likelihoods[task]
    device = params.Z.device

    def serve(Xnew):
        with torch.inference_mode():
            X = _as_inputs(Xnew, config, device)
            m_F, v_F = elbo_mod.task_qf_moments(
                params, config, Luu, X, task, iLuu=iLuu,
                use_kernel=use_kernel)
            return lik.predictive(m_F, v_F)

    return serve


def predict_f_all(params: SVMOGPParams, config: ModelConfig,
                  X_list: Sequence) -> list:
    """q(f) moments for every task: [(m_F_t, v_F_t)], each (N_t, F_t)."""
    device = params.Z.device
    with torch.inference_mode():
        Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
        return [elbo_mod.task_qf_moments(params, config, Luu,
                                         _as_inputs(X_t, config, device), t,
                                         iLuu=iLuu)
                for t, X_t in enumerate(X_list)]


def predict_f(params: SVMOGPParams, config: ModelConfig, Xnew,
              output_function_ind: int = 0):
    """Posterior moments (mean, var), each (N,), of one output parameter
    function f_d at Xnew (diagonal only)."""
    d = output_function_ind
    t, j = config.function_index[d], config.d_index[d]
    with torch.inference_mode():
        Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
        m_F, v_F = elbo_mod.task_qf_moments(
            params, config, Luu, _as_inputs(Xnew, config, params.Z.device),
            t, iLuu=iLuu)
    return m_F[:, j], v_F[:, j]


def predictive(params: SVMOGPParams, config: ModelConfig, X_list: Sequence):
    """Observation-space predictive moments per task, on the direct
    inducing-point path.  Returns (m_pred, v_pred): lists of (N_t, dim_p)."""
    moments = predict_f_all(params, config, X_list)
    m_pred, v_pred = [], []
    with torch.inference_mode():
        for lik, (m_F, v_F) in zip(config.likelihoods, moments):
            m, v = lik.predictive(m_F, v_F)
            m_pred.append(m)
            v_pred.append(v)
    return m_pred, v_pred
