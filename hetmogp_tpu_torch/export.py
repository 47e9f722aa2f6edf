"""Serialized prediction functions for serving, on ``torch.export``.

Counterpart of ``hetmogp_tpu/export.py``: each ``export_*`` traces one
prediction path of a trained model into an ``ExportedProgram`` and
returns it as bytes (``torch.export.save`` into a buffer), and
``load_predictive(blob)`` returns a callable with the JAX package's flat
signature, so a serving process runs it without the model code:

    blob = export_predictive(params, config, example_X_list)
    Path("model.pt2").write_bytes(blob)
    # in the server:
    import hetmogp_tpu_torch  # registers the hetmogp:: operators
    fn = load_predictive(Path("model.pt2").read_bytes())
    m1, v1, m2, v2, ... = fn(*params_args(params), *X_list)

The hand kernels are custom operators (``hetmogp::rbf_K_batched``,
``hetmogp::tril_projection``, ``hetmogp::tril_projection_3pass``,
``hetmogp::quad_diag`` and the others of ``ops/cuda_kernels.py``), and an
exported graph holds them as nodes: on CUDA tensors the loaded program
launches the same kernels as the eager path.  Loading therefore needs
``import hetmogp_tpu_torch`` first, which registers them, but no training
code and no JAX.

The exported functions are specialized to the example's shapes, dtype and
device (export one per serving shape).  Tracing runs under
``torch.no_grad()`` through the undecorated bodies of
``models/predict.py``.  The adaptive ``jitchol`` of the solve paths reads
each factorization's ``info`` on the host, which a traced program cannot;
the export takes ``linalg.device_side_jitchol``, which factorizes at every
jitter level and selects on the device: the same factor as the eager path,
at up to six factorizations a call where ``config.adaptive_jitter`` (and,
always, for the projected path's function-space factor).
``export_serving_predictive`` takes the precomputed ``serving_state`` and
factorizes nothing.
"""

from __future__ import annotations

import io
from typing import Sequence

import torch

from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models import predict as predict_mod
from hetmogp_tpu_torch.models.params import SVMOGPParams
from hetmogp_tpu_torch.ops import linalg


def params_args(params: SVMOGPParams):
    """The seven parameter tensors, in the exported functions' order."""
    return (params.Z, params.q_mu, params.q_sqrt, params.log_lengthscale,
            params.log_variance, params.W, params.kappa)


class _Flat(torch.nn.Module):
    """A function of flat positional tensors as the module export takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _params(config: ModelConfig, Z, q_mu, q_sqrt, log_ls, log_var, W, kappa):
    return SVMOGPParams(Z=Z, q_mu=q_mu, q_sqrt=q_sqrt, log_lengthscale=log_ls,
                        log_variance=log_var, W=W, kappa=kappa,
                        rank=config.rank)


def _inputs(config: ModelConfig, params: SVMOGPParams, *xs):
    return tuple(torch.as_tensor(x, dtype=config.torch_dtype,
                                 device=params.Z.device) for x in xs)


def _export(fn, args) -> bytes:
    """Trace ``fn(*args)`` into an ExportedProgram and serialize it.  One
    eager call first fills the process-wide caches (quadrature grids) with
    real tensors, which the trace then holds as constants."""
    with torch.no_grad(), linalg.device_side_jitchol():
        fn(*args)
        program = torch.export.export(_Flat(fn), tuple(args), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_predictive(blob: bytes):
    """A callable of the exported function's flat signature.  Import
    ``hetmogp_tpu_torch`` first: it registers the ``hetmogp::``
    operators that the program calls."""
    return torch.export.load(io.BytesIO(blob)).module()


def exported_ops(blob: bytes) -> dict:
    """{operator name: node count} of an exported program's graph, e.g.
    ``{"hetmogp::rbf_K_batched": 1, ...}``."""
    program = torch.export.load(io.BytesIO(blob))
    counts: dict = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            name = node.target.name()
            counts[name] = counts.get(name, 0) + 1
    return counts


def export_predictive(params: SVMOGPParams, config: ModelConfig,
                      example_X_list: Sequence) -> bytes:
    """The observation-space predictive of every task (the solve path).
    Loaded, it takes ``(*params_args(params), *X_list)`` and returns
    (m_1, v_1, m_2, v_2, ...)."""
    def f(Z, q_mu, q_sqrt, log_ls, log_var, W, kappa, *X_list):
        p = _params(config, Z, q_mu, q_sqrt, log_ls, log_var, W, kappa)
        m_pred, v_pred = predict_mod._predictive(p, config, list(X_list))
        return tuple(a for mv in zip(m_pred, v_pred) for a in mv)

    return _export(f, (*params_args(params),
                       *_inputs(config, params, *example_X_list)))


def export_predict_f(params: SVMOGPParams, config: ModelConfig,
                     example_X, output_function_ind: int = 0,
                     full_cov: bool = False) -> bytes:
    """The latent-f predictive of one output function: (mean (N,), var
    (N,)), or (mean, cov (N, N)) with ``full_cov=True`` for correlated
    draws in the serving process.  Loaded, it takes
    ``(*params_args(params), X)``."""
    def f(Z, q_mu, q_sqrt, log_ls, log_var, W, kappa, X):
        p = _params(config, Z, q_mu, q_sqrt, log_ls, log_var, W, kappa)
        return predict_mod._predict_f(p, config, X, output_function_ind,
                                      full_cov=full_cov)

    return _export(f, (*params_args(params),
                       *_inputs(config, params, example_X)))


def export_predict_f_projected(params: SVMOGPParams, config: ModelConfig,
                               example_Xtrain, example_Xnew,
                               task: int = 0) -> bytes:
    """The reference's ``_raw_predict_f`` projection for every output
    function of one task (``predict.predict_f_projected_task``): (mu
    (F_t, Ns), var (F_t, Ns)).  Loaded, it takes
    ``(*params_args(params), Xtrain_t, Xnew)``."""
    def f(Z, q_mu, q_sqrt, log_ls, log_var, W, kappa, Xtr, Xs):
        p = _params(config, Z, q_mu, q_sqrt, log_ls, log_var, W, kappa)
        anchors = (None,) * task + (Xtr,)
        return predict_mod._predict_f_projected_task(p, config, anchors, Xs,
                                                     task)

    return _export(f, (*params_args(params),
                       *_inputs(config, params, example_Xtrain,
                                example_Xnew)))


def serving_state(params: SVMOGPParams, config: ModelConfig):
    """(Luu, Luu^{-1}) for the serving path: computed once per trained
    model and passed to the function ``export_serving_predictive`` made."""
    with torch.no_grad():
        return elbo_mod.prior_cholesky_inverse(params, config)


def export_serving_predictive(params: SVMOGPParams, config: ModelConfig,
                              example_X, task: int) -> bytes:
    """The serving path of one task (``predict.make_serving_predictive``):
    every call projects through the precomputed inverse and runs the
    likelihood's predictive moments; nothing is factorized.  Loaded, it
    takes ``(*params_args(params), *serving_state(params, config), X)``."""
    lik = config.likelihoods[task]

    def f(Z, q_mu, q_sqrt, log_ls, log_var, W, kappa, Luu, iLuu, X):
        p = _params(config, Z, q_mu, q_sqrt, log_ls, log_var, W, kappa)
        m_F, v_F = elbo_mod.task_qf_moments(p, config, Luu, X, task,
                                            iLuu=iLuu)
        return lik.predictive(m_F, v_F)

    return _export(f, (*params_args(params), *serving_state(params, config),
                       *_inputs(config, params, example_X)))
