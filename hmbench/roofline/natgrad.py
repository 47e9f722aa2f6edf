"""The least time of the model's products in one step of each kind of the
natural-gradient trainer (``natgrad_adam``, the exact retraction) at a
configuration's shapes: what ``step.mfu`` counts in a natural-gradient
cell.  As in ``svmogp.py``, the products are the model's, each at the
precision the configuration states for it, not a route's.

* VE (the natural-gradient step on q(u)): the RBF cross-covariance
  (bytes-bound); the projection P = Kfu iLuu^T at the VE precision;
  quad_diag's product; the contraction g_S = P^T diag(c) P, its lower half
  only, Q M (M + 1) N operations at "highest"; and one attempt's reversed
  factorization of A and its inverse, Q M^3 / 3 operations each in
  float32.  The backoff's second attempt is insurance, not needed work,
  and g_S is symmetric: neither is counted, so that a SYRK or an attempt
  computed only on need cannot read above the peak.
* VM: the adam trainer's VM step (``svmogp.py``), which this trainer
  shares.
"""

from __future__ import annotations

from hmbench.roofline import kernels as k
from hmbench.roofline import svmogp


def step_products(cfg: dict) -> dict:
    """{"ve": ms, "vm": ms}: the least time of a step's products."""
    t = cfg["train"]
    Q, M, Dx = cfg["num_latent"], cfg["num_inducing"], cfg["input_dim"]
    prec = "high" if t["ve_fwd_precision"] == "high" else "highest"
    n_ve = len(cfg["likelihoods"]) * t["batch_per_task"]
    tri = Q * M * (M + 1) * n_ve  # a triangular product over the VE rows, all q
    ve = (k.rbf(Q, n_ve, M, Dx)[0] + k.flops_least(tri, prec)
          + k.flops_least(tri, "highest") + k.flops_least(tri, "highest")
          + k.flops_least(2 * Q * M ** 3 / 3, "highest"))
    return {"ve": ve, "vm": svmogp.step_products(cfg)["vm"]}
