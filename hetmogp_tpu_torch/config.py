"""Static model and training configuration.

Counterpart of ``hetmogp_tpu/config.py``'s ``ModelConfig`` and
``TrainConfig``, with the same field names, defaults and derived
properties, so that a config written by the JAX package (``to_dict()``, or
``dataclasses.asdict`` of a ``TrainConfig``) loads here with ``from_dict``.
Every field of the JAX package's configs runs here: coregionalization
rank R >= 1, the float64 factorization island (``chol_dtype``), all
sixteen likelihood families, every optimizer, schedule and sampler; a JAX
config with its defaults loads as it is.  A bad rank or ``chol_dtype``, an
unknown kernel family and a forward projection below ``"high"`` precision
are refused when the config is made.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# the stationary kernel families of ``ops/kernels.py`` (its ``KERNEL_NAMES``;
# named here so that the configuration imports nothing of the ops)
KERNEL_NAMES = ("exponential", "matern32", "matern52", "rbf", "rq")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
CHOL_DTYPES = ("same", "float64")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static structure of an SVMOGP model.

    Attributes (as in the JAX package):
      likelihoods: per-task likelihood objects, one per output.
      num_latent: Q, number of latent GPs.
      num_inducing: M, inducing points per latent GP.
      input_dim: Dx, dimensionality of X.
      rank: coregionalization rank R: B_q = W_q W_q^T of rank R is R
        latent copies per kernel, Q*R latent GPs in all, each group of R
        sharing one (lengthscale, variance); Z, q_mu, q_sqrt, W and kappa
        have Q*R rows (``num_latent_eff``).
      whiten: q(u_q) parameterized in the whitened space u_q = Luu_q v_q.
      jitter: fixed jitter added to Kuu before its Cholesky.
      adaptive_jitter: escalating jitter (GPy's ``jitchol``): the
        factorization reads its ``info`` on the host, so the graphed
        trainer refuses it on the card (``make_scan_trainer``).
      dtype: "float32" or "float64".
      kernel: latent kernel family: "rbf" (the hand-written CUDA kernel on
        the card), "matern32", "matern52", "exponential" or "rq".
      ard: per-dimension lengthscales.
      chol_dtype: "same", or "float64": a float32 model factorizes Kuu in
        float64 and casts the factor down (``linalg.chol_mixed``), an
        accuracy island for large M.  The island takes the fixed
        ``jitter`` only: ``adaptive_jitter`` does not apply to it, as in
        the JAX package.  A float64 model ignores it.
      ve_fwd_precision: the VE projection P = Kfu iLuu^T's precision:
        "high" is three bf16 passes of the bit-mask split (the 3-pass
        tensor-core kernel on the card); every other value runs at
        "highest", full float32, as the JAX package runs every value but
        "high" at HIGHEST (``projection_precision``; the value itself is
        kept, so a JAX config round-trips).  The VM step's cached solve
        stays at "highest" either way.
      fuse_task_rows: the ELBO projects all tasks' rows at once.
    """

    likelihoods: Tuple[Any, ...]
    num_latent: int
    num_inducing: int
    input_dim: int
    rank: int = 1
    whiten: bool = True
    jitter: float = 0.0
    adaptive_jitter: bool = True
    dtype: str = "float32"
    kernel: str = "rbf"
    ard: bool = False
    chol_dtype: str = "same"
    ve_fwd_precision: str = "highest"
    fuse_task_rows: bool = True

    def __post_init__(self):
        if self.kernel not in KERNEL_NAMES:
            raise NotImplementedError(
                f"kernel={self.kernel!r}; the port has {list(KERNEL_NAMES)}")
        if isinstance(self.rank, bool) or not isinstance(self.rank, int) \
                or self.rank < 1:
            raise ValueError(f"rank must be an integer >= 1, got "
                             f"{self.rank!r}")
        if self.chol_dtype not in CHOL_DTYPES:
            raise ValueError(f"chol_dtype={self.chol_dtype!r}; use one of "
                             f"{CHOL_DTYPES}")
        if self.dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype={self.dtype!r}; the port has {sorted(_DTYPES)}: a "
                "bfloat16 model would form the projection P = Kfu iLuu^T in "
                "bf16, which ruins it as one TF32 pass does (the float32 "
                "model runs it in full float32 or three bf16 passes)")

    # ---- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """The JAX package's format: likelihoods by class name plus fields."""
        d = dataclasses.asdict(self)
        d["likelihoods"] = [{"cls": type(lik).__name__,
                             **dataclasses.asdict(lik)}
                            for lik in self.likelihoods]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Inverse of ``to_dict``, of this package or the JAX one; likelihood
        classes are resolved in ``hetmogp_tpu_torch.likelihoods``."""
        from hetmogp_tpu_torch import likelihoods as lik_mod

        liks = []
        for spec in d["likelihoods"]:
            spec = dict(spec)
            name = spec.pop("cls")
            if name not in lik_mod.__all__:
                raise ValueError(f"unknown likelihood class {name!r}")
            liks.append(getattr(lik_mod, name)(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in spec.items()}))
        kw = {k: v for k, v in d.items() if k != "likelihoods"}
        return cls(likelihoods=tuple(liks), **kw)

    # ---- derived static metadata --------------------------------------------
    @property
    def num_latent_eff(self) -> int:
        """Q*R: latent-function count including coregionalization copies."""
        return self.num_latent * self.rank

    @property
    def num_tasks(self) -> int:
        return len(self.likelihoods)

    @property
    def task_dim_f(self) -> Tuple[int, ...]:
        """Latent parameter-function count per task."""
        return tuple(lik.dim_f for lik in self.likelihoods)

    @property
    def num_output_functions(self) -> int:
        """D = total parameter functions f_d across all tasks."""
        return sum(self.task_dim_f)

    @property
    def function_index(self) -> Tuple[int, ...]:
        """Map d -> task t."""
        return tuple(t for t, lik in enumerate(self.likelihoods)
                     for _ in range(lik.dim_f))

    @property
    def d_index(self) -> Tuple[int, ...]:
        """Map d -> within-task column."""
        return tuple(j for lik in self.likelihoods for j in range(lik.dim_f))

    @property
    def task_function_slices(self) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) into the global d axis for each task's functions."""
        out, start = [], 0
        for lik in self.likelihoods:
            out.append((start, start + lik.dim_f))
            start += lik.dim_f
        return tuple(out)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def projection_precision(self) -> str:
        """The precision the triangular products run at: "high" for
        ``ve_fwd_precision="high"``, "highest" for every other value."""
        return "high" if self.ve_fwd_precision == "high" else "highest"

    def metadata(self) -> dict:
        """The reference's Y_metadata dict: task, y, function, d and pred
        indices, as numpy arrays."""
        import numpy as np

        y_index, f_index, d_index, p_index = [], [], [], []
        for t, lik in enumerate(self.likelihoods):
            y_index.extend([t] * lik.dim_y)
            f_index.extend([t] * lik.dim_f)
            d_index.extend(range(lik.dim_f))
            p_index.extend([t] * lik.dim_p)
        return {
            "task_index": np.arange(self.num_tasks),
            "y_index": np.asarray(y_index, dtype=np.int64),
            "function_index": np.asarray(f_index, dtype=np.int64),
            "d_index": np.asarray(d_index, dtype=np.int64),
            "pred_index": np.asarray(p_index, dtype=np.int64),
        }

    def with_trained_likelihoods(self, params) -> "ModelConfig":
        """A config whose likelihoods take the trained ``params.lik_theta``
        as their static constants (``Likelihood.with_theta``), for
        prediction after training with ``TrainConfig.learn_lik_params``.
        The same config when ``lik_theta`` is None.  Reads theta on the
        host."""
        if getattr(params, "lik_theta", None) is None:
            return self
        liks = tuple(lik.with_theta(theta) if lik.n_theta else lik
                     for lik, theta in zip(self.likelihoods,
                                           params.lik_theta))
        return dataclasses.replace(self, likelihoods=liks)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters, with the JAX package's fields and defaults.

    Every field is read as the JAX package reads it: ``optimizer`` is
    ``"adadelta"`` (climin's rule with its momentum lookahead),
    ``"adam"`` or ``"natgrad_adam"`` (natural gradients on q(u) by
    ``natgrad_retraction``, adam on the rest); ``lr_schedule`` and
    ``clip_grad_norm`` shape adam's step (adadelta refuses them, as the
    JAX ``make_optimizer`` does); ``minibatch`` is ``"gather"`` (iid rows)
    or ``"slice"`` (a contiguous wraparound block); ``fast_projection``
    picks the cached inverse or the solve path.
    """

    vem_iters: int = 5
    batch_inner_iters: int = 100
    step_rate: float = 0.01
    momentum: float = 0.9
    adadelta_decay: float = 0.9
    adadelta_offset: float = 1e-4
    ve_steps_per_vm: int = 4
    optimizer: str = "adadelta"
    natgrad_lr: float = 0.1
    natgrad_retraction: str = "cholesky"
    natgrad_trust: float = 0.3
    lr_schedule: Optional[str] = None
    lr_schedule_kwargs: Tuple = ()
    clip_grad_norm: Optional[float] = None
    learn_inducing: bool = True
    learn_W: bool = True
    shuffle: bool = True
    seed: int = 0
    fast_projection: bool = True
    minibatch: str = "gather"
    vm_batch_fraction: float = 1.0
    learn_lik_params: bool = False
    skip_nonfinite_steps: bool = False

    def __post_init__(self):
        if self.optimizer not in ("adadelta", "adam", "natgrad_adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.natgrad_retraction not in ("exact", "cholesky"):
            raise ValueError(f"unknown natgrad retraction "
                             f"{self.natgrad_retraction!r}; use 'exact' or "
                             "'cholesky'")
        if self.minibatch not in ("gather", "slice"):
            raise ValueError(f"unknown minibatch sampler {self.minibatch!r}")
        if not 0.0 < self.vm_batch_fraction <= 1.0:
            raise ValueError("vm_batch_fraction must be in (0, 1], got "
                             f"{self.vm_batch_fraction}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        """Inverse of ``to_dict``; also takes ``dataclasses.asdict`` of the
        JAX package's ``TrainConfig``.  JSON turns tuples into lists, so
        ``lr_schedule_kwargs`` is re-tupled."""
        d = dict(d)
        d["lr_schedule_kwargs"] = tuple(
            tuple(kv) for kv in d.get("lr_schedule_kwargs", ()))
        return cls(**d)
