"""Heterogeneous likelihood dispatcher.

Counterpart of ``hetmogp_tpu/likelihoods/heterogeneous.py``: wraps a list
of per-output likelihoods, builds the task and function index metadata,
and fans var_exp, its derivatives, the predictive moments, sampling and
NLPD out per task, lists in and lists out.  The model itself reads the
likelihood tuple of ``ModelConfig``; this class serves the list-of-arrays
API and data generation.  Random draws come from a ``torch.Generator``
(where the JAX package takes a key), used for the tasks in turn.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import Likelihood


def _column(Y) -> torch.Tensor:
    Y = torch.as_tensor(Y)
    return Y[:, None] if Y.ndim == 1 else Y


class HetLikelihood:
    def __init__(self, likelihoods_list: Sequence[Likelihood]):
        self.likelihoods_list = list(likelihoods_list)

    def generate_metadata(self) -> dict:
        """Index metadata mapping tasks, outputs and parameter functions,
        with the JAX package's keys and contents."""
        t_index = np.arange(len(self.likelihoods_list))
        y_index: List[int] = []
        f_index: List[int] = []
        d_index: List[int] = []
        p_index: List[int] = []
        for t, lik in enumerate(self.likelihoods_list):
            dim_y, dim_f, dim_p = lik.get_metadata()
            y_index.extend([t] * dim_y)
            f_index.extend([t] * dim_f)
            d_index.extend(range(dim_f))
            p_index.extend([t] * dim_p)
        return {
            "task_index": t_index,
            "y_index": np.asarray(y_index, dtype=np.int64),
            "function_index": np.asarray(f_index, dtype=np.int64),
            "d_index": np.asarray(d_index, dtype=np.int64),
            "pred_index": np.asarray(p_index, dtype=np.int64),
        }

    def logpdf(self, F, Y, Y_metadata=None):
        """Per-task log-densities: lists of (N_t, dim_f) and (N_t, dim_y)
        (or (N_t,)) in, a list of (N_t,) out."""
        return [lik.logpdf(torch.as_tensor(F[t]), _column(Y[t]))
                for t, lik in enumerate(self.likelihoods_list)]

    def pdf(self, F, Y, Y_metadata=None):
        return [torch.exp(lp) for lp in self.logpdf(F, Y)]

    def num_output_functions(self, Y_metadata=None) -> int:
        """D, the total number of parameter functions."""
        return sum(lik.dim_f for lik in self.likelihoods_list)

    def ismulti(self, task: int) -> bool:
        return self.likelihoods_list[task].ismulti()

    def var_exp(self, Y, mu_F, v_F, Y_metadata=None, use_kernel=True):
        return [lik.var_exp(Y[t], mu_F[t], v_F[t], use_kernel=use_kernel)
                for t, lik in enumerate(self.likelihoods_list)]

    def var_exp_derivatives(self, Y, mu_F, v_F, Y_metadata=None):
        dms, dvs = [], []
        for t, lik in enumerate(self.likelihoods_list):
            dm, dv = lik.var_exp_derivatives(Y[t], mu_F[t], v_F[t])
            dms.append(dm)
            dvs.append(dv)
        return dms, dvs

    def predictive(self, mu_F_pred, v_F_pred, Y_metadata=None):
        m_pred, v_pred = [], []
        for t, lik in enumerate(self.likelihoods_list):
            m, v = lik.predictive(mu_F_pred[t], v_F_pred[t])
            m_pred.append(m)
            v_pred.append(v)
        return m_pred, v_pred

    def negative_log_predictive(self, generator, Ytest, mu_F_star, v_F_star,
                                num_samples: int = 1000):
        """Summed Monte-Carlo NLPD over the tasks, with the reference's
        1/num_samples factor (``Likelihood.log_predictive``)."""
        logpred = 0.0
        for t, lik in enumerate(self.likelihoods_list):
            logpred = logpred + lik.log_predictive(
                generator, _column(Ytest[t]), mu_F_star[t], v_F_star[t],
                num_samples)
        return -logpred

    def samples(self, generator, F, Y_metadata=None):
        """One sampled observation set per task, (N_t, dim_y) each."""
        return [lik.sample(generator, torch.as_tensor(F[t]))
                for t, lik in enumerate(self.likelihoods_list)]
