"""Static model configuration.

Counterpart of ``hetmogp_tpu/config.py``'s ``ModelConfig``, with the same
field names, defaults and derived properties, so that a config written by
the JAX package (``ModelConfig.to_dict()``) loads here with ``from_dict``.
What the port cannot run yet raises ``NotImplementedError`` when the
config is made: a kernel other than RBF, coregionalization rank > 1,
adaptive jitter, the float64 factorization island and the reduced
precision forward projection.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# JAX likelihood families that the port does not have yet
_UNPORTED_FAMILIES = ("Gaussian", "Beta", "Binomial", "Dirichlet", "LogNormal",
                      "Ordinal", "NegativeBinomial", "StudentT", "Weibull",
                      "ZeroInflatedPoisson")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md section 1, item {item})")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static structure of an SVMOGP model.

    Attributes (as in the JAX package):
      likelihoods: per-task likelihood objects, one per output.
      num_latent: Q, number of latent GPs.
      num_inducing: M, inducing points per latent GP.
      input_dim: Dx, dimensionality of X.
      rank: coregionalization rank; 1 only, for now.
      whiten: q(u_q) parameterized in the whitened space u_q = Luu_q v_q.
      jitter: fixed jitter added to Kuu before its Cholesky.
      adaptive_jitter: escalating jitter; must be False for now.
      dtype: "float32" or "float64".
      kernel: latent kernel family; "rbf" only, for now.
      ard: per-dimension lengthscales.
      chol_dtype: "same" only, for now.
      ve_fwd_precision: "highest" only: full float32 matmuls.
      fuse_task_rows: a training option; accepted and not read here.
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
        if self.kernel != "rbf":
            raise _not_ported(f"kernel={self.kernel!r}", 3)
        if self.rank != 1:
            raise _not_ported(f"rank={self.rank}", 2)
        if self.adaptive_jitter:
            raise _not_ported("adaptive_jitter=True (pass False and a fixed "
                              "jitter)", 4)
        if self.chol_dtype != "same":
            raise _not_ported(f"chol_dtype={self.chol_dtype!r}", 4)
        if self.ve_fwd_precision != "highest":
            raise NotImplementedError(
                f"ve_fwd_precision={self.ve_fwd_precision!r}: the port runs "
                "the projection in full float32 only (TF32 ruins it)")
        if self.dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype={self.dtype!r}; the port has {sorted(_DTYPES)}")

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
            if name in _UNPORTED_FAMILIES:
                raise _not_ported(f"likelihood {name}", 11)
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
