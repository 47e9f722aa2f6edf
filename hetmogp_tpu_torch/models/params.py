"""Model parameters as a dataclass of tensors.

Counterpart of ``hetmogp_tpu/models/params.py``, with the same field names
and shapes (Q kernel groups, R the coregionalization rank, Qe = Q*R latent
copies, M inducing, D output functions, Dx input dims):

  Z:               (Qe, M, Dx)  inducing inputs per latent copy
  q_mu:            (Qe, M)      variational means (whitened by default)
  q_sqrt:          (Qe, M, M)   variational Cholesky factors, lower triangle used
  log_lengthscale: (Q, Dx_ls)   RBF lengthscales (log), Dx_ls = Dx if ARD else 1
  log_variance:    (Q,)         RBF variances (log)
  W:               (Qe, D)      LMC mixing weights
  kappa:           (Qe, D)      coregionalization diagonal, fixed at 0
  lik_theta:       None, or one (n_theta_t,) tensor per task: the trainable
                   likelihood parameters (``default_lik_theta``), trained
                   when ``TrainConfig.learn_lik_params`` is on
  rank:            R, an int and not a trained leaf: ``lengthscale`` and
                   ``variance`` repeat each group's hypers over its R
                   copies, so autograd sums the tied gradients over them

Trained parameters cross from the JAX package with ``params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.config import ModelConfig

FIELDS = ("Z", "q_mu", "q_sqrt", "log_lengthscale", "log_variance", "W",
          "kappa")


@dataclasses.dataclass
class SVMOGPParams:
    Z: torch.Tensor
    q_mu: torch.Tensor
    q_sqrt: torch.Tensor
    log_lengthscale: torch.Tensor
    log_variance: torch.Tensor
    W: torch.Tensor
    kappa: torch.Tensor
    lik_theta: Optional[Tuple[torch.Tensor, ...]] = None
    rank: int = 1

    @property
    def lengthscale(self) -> torch.Tensor:
        ls = torch.exp(self.log_lengthscale)
        return ls.repeat_interleave(self.rank, 0) if self.rank > 1 else ls

    @property
    def variance(self) -> torch.Tensor:
        v = torch.exp(self.log_variance)
        return v.repeat_interleave(self.rank, 0) if self.rank > 1 else v

    def to(self, device=None, dtype=None) -> "SVMOGPParams":
        return from_leaves(self, [t.to(device=device, dtype=dtype)
                                  for _, t in leaves(self)])


def leaves(params: SVMOGPParams) -> List[Tuple[str, torch.Tensor]]:
    """The tensors of ``params`` in a fixed order, by leaf name: the seven
    fields, then one ``"lik_theta"`` entry per task where there is theta."""
    return ([(f, getattr(params, f)) for f in FIELDS]
            + [("lik_theta", t) for t in params.lik_theta or ()])


def from_leaves(like: SVMOGPParams, tensors) -> SVMOGPParams:
    """The params of ``like``'s structure with ``tensors`` in the order of
    ``leaves(like)``."""
    tensors = list(tensors)
    theta = None if like.lik_theta is None else tuple(tensors[len(FIELDS):])
    return SVMOGPParams(*tensors[:len(FIELDS)], lik_theta=theta,
                        rank=like.rank)


def default_lik_theta(config: ModelConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> tuple:
    """Initial ``lik_theta``: each task's ``default_theta()``, a (0,)
    tensor for a family without theta, on ``device`` (the card unless the
    caller names another) in the config's dtype unless ``dtype``."""
    dtype = dtype or config.torch_dtype
    return tuple(torch.tensor(lik.default_theta(), dtype=dtype, device=device)
                 for lik in config.likelihoods)


def random_W(rng: np.random.Generator, Q: int, D: int,
             rank: int = 1) -> np.ndarray:
    """Random sign-mixed mixing weights: with probability 1/2 each entry is
    N(0.5, 0.5^2), else N(-0.5, 0.5^2), scaled by 1/sqrt(rank) (the JAX
    ``random_W``'s distribution; pass Q*R rows at rank R)."""
    p = rng.random((Q, D)) < 0.5
    n1 = 0.5 + 0.5 * rng.standard_normal((Q, D))
    n2 = -0.5 + 0.5 * rng.standard_normal((Q, D))
    return np.where(p, n1, n2) / np.sqrt(float(rank))


def init_params(rng: np.random.Generator, config: ModelConfig, Z, *,
                W=None, lengthscale=1.0, variance=1.0,
                q_mu_scale: float = 2.5, with_lik_theta: bool = False,
                device="cuda") -> SVMOGPParams:
    """Initial parameters, drawn from ``rng``.

    Args:
      Z: (M, Dx) shared inducing inputs, tiled to all Qe = Q*R latent
        copies, (Q, M, Dx) per kernel group (repeated over its R copies),
        or (Qe, M, Dx) per copy.
      W: optional (Qe, D) mixing weights, or (Q, D, R) in the reference's
        rank-R layout (copies ordered q0r0, q0r1, ..., q1r0, ...);
        random_W(rng, Qe, D, rank=R) otherwise.
      lengthscale, variance: scalars or per-q arrays.
      q_mu_scale: std of the q(u) mean init.
      with_lik_theta: give ``lik_theta`` its ``default_lik_theta``.
      device: where the tensors go; the card unless the caller names
        another.
    q_sqrt starts at the identity.
    """
    Q, M, Dx = config.num_latent, config.num_inducing, config.input_dim
    R, Qe = config.rank, config.num_latent_eff
    D = config.num_output_functions
    Z = np.asarray(Z, np.float64)
    if Z.ndim == 2:
        if Z.shape != (M, Dx):
            raise ValueError(f"Z has shape {Z.shape}; expected (num_inducing, "
                             f"input_dim) = ({M}, {Dx}) or (Qe, M, Dx)")
        Z = np.broadcast_to(Z[None], (Qe, M, Dx))
    elif R > 1 and Z.shape == (Q, M, Dx):
        Z = np.repeat(Z, R, axis=0)  # one Z per kernel group -> per copy
    if Z.shape != (Qe, M, Dx):
        raise ValueError(f"Z has shape {Z.shape}; expected (Qe, M, Dx) = "
                         f"{(Qe, M, Dx)}")
    q_mu = q_mu_scale * rng.standard_normal((Qe, M))
    if W is None:
        W = random_W(rng, Qe, D, rank=R)
    W = np.asarray(W)
    if W.ndim == 3:  # (Q, D, R) -> per-copy rows q0r0, q0r1, ..., q1r0, ...
        W = np.transpose(W, (0, 2, 1))
    W = W.reshape(Qe, D)
    ls = np.broadcast_to(np.asarray(lengthscale, np.float64),
                         (Q, Dx if config.ard else 1))
    var = np.broadcast_to(np.asarray(variance, np.float64), (Q,))
    arrays = (Z, q_mu, np.broadcast_to(np.eye(M), (Qe, M, M)), np.log(ls),
              np.log(var), W, np.zeros((Qe, D)))
    theta = (default_lik_theta(config, device) if with_lik_theta else None)
    # row-major, as a checkpoint's and the JAX package's arrays are (numpy
    # would keep the broadcast inputs' strides): kernel 7 walks a leaf in
    # memory order and copies a gradient of another layout
    return SVMOGPParams(*(torch.tensor(np.ascontiguousarray(a),
                                       dtype=config.torch_dtype,
                                       device=device) for a in arrays),
                        lik_theta=theta, rank=R)


def params_from_jax(src, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> SVMOGPParams:
    """Parameters trained by the JAX package, as tensors on ``device`` (the
    card unless the caller names another).

    src: the JAX ``SVMOGPParams`` with its leaves converted to numpy (or
      anything else with the seven fields as arrays, ``lik_theta`` None or
      one array per task, and ``rank``), or the path of an ``.npz`` written
      by ``hetmogp_tpu.checkpoint.save_checkpoint``, which stores them as
      ``param_0`` ... ``param_6`` in field order, then ``param_7`` ... one
      per task where the params held ``lik_theta``.
    dtype: None keeps each leaf's dtype.
    The coregionalization rank is read off the shapes: Q*R rows of q_mu
    over Q of log_variance (an npz does not store it).
    """
    if isinstance(src, (str, os.PathLike)):
        with np.load(src, allow_pickle=False) as z:
            arrays = [z[f"param_{i}"] for i in range(len(FIELDS))]
            theta = []
            while f"param_{len(FIELDS) + len(theta)}" in z.files:
                theta.append(z[f"param_{len(FIELDS) + len(theta)}"])
            theta = tuple(theta) or None
    else:
        arrays = [np.asarray(getattr(src, f)) for f in FIELDS]
        theta = getattr(src, "lik_theta", None)
        if theta is not None:
            theta = tuple(np.asarray(t) for t in theta)

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    rank = arrays[1].shape[0] // max(arrays[4].shape[0], 1)

    return SVMOGPParams(*(tensor(a) for a in arrays),
                        lik_theta=None if theta is None else tuple(
                            tensor(t) for t in theta), rank=rank)
