"""The least time of the model's products in one training step of each
kind at a configuration's shapes, each at the precision the configuration
states for it: what ``step.mfu`` counts.  The products are the model's, not
a route's: which kernels run them is read from the program's launches
(``launchers.py``).

A step of the whitened, cached-inverse trainer with fused task rows
(VE: q(u) free; VM: the hypers, Z, W and theta free, on the first
``vm_batch_fraction`` of each task's rows, then the refresh of the cached
(Luu, Luu^{-1})):

* VE: the RBF cross-covariance (bytes-bound); the projection
  P = Kfu iLuu^T at the VE precision; quad_diag's product; its gL.
* VM: the RBF; P and quad_diag at "highest"; quad_diag's gA; the cached
  solve's four adjoint products, three at (Q, M, M) and one at the VM rows,
  and its Lbar, at the VE precision; the refresh's factor and inverse
  (2 Q M^3 / 3 operations in float32).

"high" is three bf16 passes, "highest" float32.
"""

from __future__ import annotations

import math

from hmbench.roofline import kernels as k


def step_products(cfg: dict) -> dict:
    """{"ve": ms, "vm": ms}: the least time of a step's products."""
    t = cfg["train"]
    Q, M, Dx = cfg["num_latent"], cfg["num_inducing"], cfg["input_dim"]
    T = len(cfg["likelihoods"])
    prec = "high" if t["ve_fwd_precision"] == "high" else "highest"
    n_ve = T * t["batch_per_task"]
    n_vm = T * max(1, math.ceil(t["batch_per_task"] * t["vm_batch_fraction"]))
    tri = Q * M * (M + 1)  # a triangular product's operations a row, all q

    def least(rows, precision):
        return k.flops_least(tri * rows, precision)

    ve = (k.rbf(Q, n_ve, M, Dx)[0] + least(n_ve, prec) + least(n_ve, "highest")
          + least(n_ve, prec))
    vm = (k.rbf(Q, n_vm, M, Dx)[0] + 3 * least(n_vm, "highest")
          + 3 * least(M, prec) + least(n_vm, prec) + least(n_vm, prec)
          + k.flops_least(2 * Q * M ** 3 / 3, "highest"))
    return {"ve": ve, "vm": vm}
