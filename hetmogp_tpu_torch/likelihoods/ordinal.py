"""Ordinal (cumulative-logit) likelihood over K ordered categories.

Counterpart of ``hetmogp_tpu/likelihoods/ordinal.py``: one latent function
f and K - 1 increasing thresholds b_1 < ... < b_{K-1},
P(y <= k) = sigmoid(b_k - f), P(y = k) = P(y <= k) - P(y <= k - 1),
clipped to [1e-9, 1].  Labels are 1-indexed.  Thresholds default to evenly
spaced in [-(K-2)/2, (K-2)/2].  The thresholds are the trainable theta,
always: theta = (b_1, log(b_2 - b_1), ..., log(b_{K-1} - b_{K-2})), so
unconstrained steps can never cross two cut-points.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                theta_array)


@functools.lru_cache(maxsize=None)
def _thresholds(b: Tuple[float, ...], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Static thresholds as a tensor on ``device``, made once (a copy from
    host memory per call could not be captured in a CUDA graph), outside
    inference mode so that autograd can save it."""
    with torch.inference_mode(False):
        return torch.tensor(b, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Ordinal(Likelihood):
    K: int = 3
    thresholds: Optional[Tuple[float, ...]] = None

    @property
    def dim_p(self):  # type: ignore[override]
        return self.K

    @property
    def n_theta(self):  # type: ignore[override]
        return self.K - 1

    def _b_np(self) -> np.ndarray:
        if self.thresholds is not None:
            return np.asarray(self.thresholds, np.float64)
        return np.linspace(-(self.K - 2) / 2.0, (self.K - 2) / 2.0,
                           self.K - 1)

    def _b(self, like: torch.Tensor) -> torch.Tensor:
        return _thresholds(tuple(float(x) for x in self._b_np()), like.dtype,
                           like.device)

    def _probs_from_b(self, F, b):
        cdf = torch.sigmoid(b - F[..., :1])  # (..., K - 1)
        p = torch.diff(cdf, dim=-1, prepend=torch.zeros_like(cdf[..., :1]),
                       append=torch.ones_like(cdf[..., :1]))
        return torch.clamp(p, 1e-9, 1.0)

    def _class_probs(self, F):
        return self._probs_from_b(F, self._b(F))

    def _log_prob_of(self, p, Y):
        classes = torch.arange(1, self.K + 1, dtype=Y.dtype, device=Y.device)
        onehot = (classes == Y).to(p.dtype)  # Y (..., 1) -> (..., K)
        return torch.sum(onehot * torch.log(p), dim=-1)

    def logpdf(self, F, Y):
        return self._log_prob_of(self._class_probs(F), Y)

    @staticmethod
    def _b_from_theta(theta):
        return torch.cumsum(torch.cat([theta[..., :1],
                                       torch.exp(theta[..., 1:])], dim=-1),
                            dim=-1)

    def default_theta(self, dtype=np.float64):
        b = self._b_np()
        d = np.diff(b)
        if np.any(d <= 0):
            raise ValueError(f"thresholds must be increasing, got {b}")
        return np.concatenate([b[:1], np.log(d)]).astype(dtype)

    def logpdf_t(self, F, Y, theta):
        p = self._probs_from_b(F, self._b_from_theta(theta).to(F.dtype))
        return self._log_prob_of(p, Y)

    def with_theta(self, theta) -> "Ordinal":
        # in float64 numpy: the thresholds become static constants
        th = theta_array(theta)
        b = np.cumsum(np.concatenate([th[:1], np.exp(th[1:])]))
        return dataclasses.replace(self,
                                   thresholds=tuple(float(x) for x in b))

    def conditional_moments(self, F):
        p = self._class_probs(F)
        return p, p * (1.0 - p)

    def sample(self, generator, F):
        (probs,) = on_generator(generator, self._class_probs(F))
        labels = torch.multinomial(probs, 1, generator=generator) + 1
        return labels.to(F.device, F.dtype)
