"""Categorical(K) likelihood via logistic-softmax with an implicit base class.

Counterpart of ``hetmogp_tpu/likelihoods/categorical.py``.  K - 1 latent
functions drive the class probabilities p_k = e^{f_k} / (1 + sum_j e^{f_j})
for k < K and p_K = 1 / (1 + sum_j e^{f_j}), clipped to [1e-9, 1 - 1e-9]
and renormalized.  Labels are 1-indexed, y in {1, ..., K}.  var_exp and the
predictive use a (K-1)-dim T=10 tensor GH grid, or ``mc_samples`` fixed
quasi-MC nodes where that is > 0 (the grid is T^(K-1) nodes a row).
``predictive`` returns the K - 1 class-probability means; its variance is
zeros unless ``exact_predictive_variance`` (the reference leaves it
unimplemented).
"""

from __future__ import annotations

import dataclasses

import torch

from hetmogp_tpu_torch.likelihoods.base import (Likelihood, on_generator,
                                                safe_exp)
from hetmogp_tpu_torch.ops import quadrature


@dataclasses.dataclass(frozen=True)
class Categorical(Likelihood):
    K: int = 3
    exact_predictive_variance: bool = False
    # > 0: that many fixed quasi-MC nodes in place of the tensor grid
    mc_samples: int = 0

    # beyond this many grid nodes a row the grid path is an out-of-memory
    # error, not a slow run: refuse it when the likelihood is made
    MAX_GRID_NODES = 100_000

    def __post_init__(self):
        if self.K < 2:
            raise ValueError(f"Categorical needs K >= 2 classes, got {self.K}")
        if self.mc_samples == 0:
            nodes = self.T_var_exp ** self.dim_f
            if nodes > self.MAX_GRID_NODES:
                raise ValueError(
                    f"Categorical(K={self.K}) with the exact tensor-product "
                    f"grid needs T^(K-1) = {self.T_var_exp}^{self.dim_f} = "
                    f"{nodes:.3g} quadrature nodes PER DATA POINT (limit "
                    f"{self.MAX_GRID_NODES:g}).  Pass mc_samples>0 (e.g. "
                    f"Categorical(K={self.K}, mc_samples=64)) to use O(K)-"
                    f"cost quasi-MC expectations instead of the grid.")

    @property
    def dim_f(self):  # type: ignore[override]
        return self.K - 1

    @property
    def dim_p(self):  # type: ignore[override]
        return self.K - 1

    @property
    def T_var_exp(self):  # type: ignore[override]
        return quadrature.MULTI_T

    @property
    def T_pred(self):  # type: ignore[override]
        return quadrature.MULTI_T

    @property
    def sweep(self):  # type: ignore[override]
        """Kernel 6's device function, built for K - 1 <= 5 latent
        dimensions (every grid the constructor admits at T = 10)."""
        ok = self.dim_f in quadrature.SWEEP_FAMILIES["categorical"][1]
        return "categorical" if ok else None

    @property
    def task(self):  # type: ignore[override]
        """Kernel 6's task table takes the var_exp its sweep takes."""
        return "categorical" if self.sweep is not None else None

    def ismulti(self) -> bool:
        return True

    def logpdf(self, F, Y):
        ef = safe_exp(F)
        den = 1.0 + torch.sum(ef, dim=-1, keepdim=True)
        p = torch.cat([ef / den, 1.0 / den], dim=-1)
        p = torch.clamp(p, 1e-9, 1.0 - 1e-9)
        p = p / torch.sum(p, dim=-1, keepdim=True)
        classes = torch.arange(1, self.K + 1, dtype=Y.dtype, device=Y.device)
        onehot = (classes == Y).to(F.dtype)  # Y (..., 1) -> (..., K)
        return torch.sum(onehot * torch.log(p), dim=-1)

    def conditional_moments(self, F):
        # mean over dim_p = the first K - 1 class probabilities
        ef = safe_exp(F)
        rho = ef / (1.0 + torch.sum(ef, dim=-1, keepdim=True))
        rho = torch.clamp(rho, 1e-9, 1.0 - 1e-9)
        rho = rho / torch.sum(rho, dim=-1, keepdim=True)
        return rho, rho * (1.0 - rho)

    def predictive(self, M, V):
        mean, var = super().predictive(M, V)
        if not self.exact_predictive_variance:
            var = torch.zeros_like(mean)
        return mean, var

    def sample(self, generator, F):
        logits = torch.cat([F, torch.zeros_like(F[:, :1])], dim=1)
        (probs,) = on_generator(generator, torch.softmax(logits, dim=1))
        labels = torch.multinomial(probs, 1, generator=generator) + 1
        return labels.to(F.device, F.dtype)
