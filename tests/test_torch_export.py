"""The port's ``torch.export`` serving against the JAX package's
``jax.export`` one, on the CPU, in float64.

* The four export round trips (``export_predictive``, ``export_predict_f``
  with and without ``full_cov``, ``export_predict_f_projected``,
  ``export_serving_predictive``): each loaded program against the JAX
  package's loaded program on the same inputs (normwise 1e-8, the
  prediction API's tolerance) and against the port's eager path (bitwise:
  the graph calls the same operators in the same order).
* The exported graphs hold the ``hetmogp::`` operators, as many as the
  path has kernel calls, so a program loaded on the card launches the
  hand kernels.
* ``adaptive_jitter=True`` exports: the jitter level is selected on the
  device among every level's factorization, and the loaded program picks
  the eager path's level and factor on a Gram that needs it.
* A loaded program runs in a fresh process that imports only
  ``hetmogp_tpu_torch`` (for the operators) and never JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import export as jexport
from hetmogp_tpu.models.params import init_params as jinit

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import export
from hetmogp_tpu_torch.models import predict as tpredict
from hetmogp_tpu_torch.ops import kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
Q, M, DX = 2, 8, 2


def _model(adaptive=False, jitter=1e-5, Z=None):
    jcfg = jhet.ModelConfig(likelihoods=(jhet.HetGaussian(), jhet.Bernoulli(),
                                         jhet.Categorical(K=3)),
                            num_latent=Q, num_inducing=M, input_dim=DX,
                            dtype="float64", jitter=jitter,
                            adaptive_jitter=adaptive)
    rng = np.random.RandomState(0)
    Z = rng.rand(M, DX) if Z is None else Z
    jp = jinit(jax.random.PRNGKey(1), jcfg, Z, lengthscale=0.4, variance=0.8)
    q_sqrt = 0.5 * np.eye(M) + 0.05 * np.tril(rng.randn(Q, M, M))
    jp = jp.replace(q_sqrt=jnp.asarray(q_sqrt))
    tcfg = tp.ModelConfig.from_dict(jcfg.to_dict())
    params = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    X = [rng.rand(n, DX) for n in (9, 7, 6)]
    return jcfg, jp, tcfg, params, X


def _normwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _run_jax(blob, jp, *xs):
    fn = jexport.load_predictive(blob)
    return fn(*jexport.params_args(jp), *(jnp.asarray(x) for x in xs))


def _run_port(blob, params, *xs):
    fn = export.load_predictive(blob)
    return fn(*export.params_args(params), *(torch.as_tensor(x)
                                             for x in xs))


def _own(blob):
    return {k: v for k, v in export.exported_ops(blob).items()
            if k.startswith("hetmogp::")}


def _check(got, jax_out, eager):
    assert len(got) == len(jax_out) == len(eager)
    for g, j, e in zip(got, jax_out, eager):
        assert tuple(g.shape) == np.shape(j)
        assert _normwise(g.detach().numpy(), j) < 1e-8
        assert torch.equal(g, e)


@pytest.fixture(scope="module")
def model():
    return _model()


def test_export_predictive_round_trip(model):
    jcfg, jp, tcfg, params, X = model
    blob = export.export_predictive(params, tcfg, X)
    assert isinstance(blob, bytes)
    assert _own(blob) == {"hetmogp::rbf_K_batched": 3,
                          "hetmogp::quad_diag": 3}
    m, v = tpredict.predictive(params, tcfg, X)
    eager = [a for mv in zip(m, v) for a in mv]
    _check(_run_port(blob, params, *X),
           _run_jax(jexport.export_predictive(jp, jcfg, X), jp, *X), eager)


@pytest.mark.parametrize("full_cov", [False, True])
def test_export_predict_f_round_trip(model, full_cov):
    jcfg, jp, tcfg, params, X = model
    blob = export.export_predict_f(params, tcfg, X[0], 3, full_cov=full_cov)
    # the marginal variance is quad_diag's; the full covariance is not
    assert _own(blob) == ({"hetmogp::rbf_K_batched": 2} if full_cov else
                          {"hetmogp::rbf_K_batched": 1,
                           "hetmogp::quad_diag": 1})
    eager = tpredict.predict_f(params, tcfg, X[0], 3, full_cov=full_cov)
    jblob = jexport.export_predict_f(jp, jcfg, X[0], 3, full_cov=full_cov)
    _check(_run_port(blob, params, X[0]), _run_jax(jblob, jp, X[0]), eager)


def test_export_predict_f_projected_round_trip(model):
    jcfg, jp, tcfg, params, X = model
    Xs = np.random.RandomState(3).rand(5, DX)
    blob = export.export_predict_f_projected(params, tcfg, X[2], Xs, task=2)
    assert _own(blob) == {"hetmogp::rbf_K_batched": 3}
    eager = tpredict.predict_f_projected_task(params, tcfg, X, Xs, 2)
    jblob = jexport.export_predict_f_projected(jp, jcfg, X[2], Xs, task=2)
    _check(_run_port(blob, params, X[2], Xs), _run_jax(jblob, jp, X[2], Xs),
           eager)


@pytest.mark.parametrize("task", [0, 2])
def test_export_serving_predictive_round_trip(model, task):
    jcfg, jp, tcfg, params, X = model
    blob = export.export_serving_predictive(params, tcfg, X[task], task)
    assert _own(blob) == {"hetmogp::rbf_K_batched": 1,
                          "hetmogp::tril_projection": 1,
                          "hetmogp::quad_diag": 1}
    Luu, iLuu = export.serving_state(params, tcfg)
    got = export.load_predictive(blob)(*export.params_args(params), Luu,
                                       iLuu, torch.from_numpy(X[task]))
    jblob = jexport.export_serving_predictive(jp, jcfg, X[task], task)
    jL, jiL = jexport.serving_state(jp, jcfg)
    want = jexport.load_predictive(jblob)(*jexport.params_args(jp), jL, jiL,
                                          jnp.asarray(X[task]))
    eager = tpredict.make_serving_predictive(params, tcfg, task)(X[task])
    _check(got, want, eager)


def test_export_serving_at_high_holds_the_3pass_operator():
    import dataclasses

    _, _, tcfg, params, X = _model()
    c32 = dataclasses.replace(tcfg, dtype="float32", ve_fwd_precision="high")
    p32 = params.to(dtype=torch.float32)
    blob = export.export_serving_predictive(p32, c32, X[1], 1)
    assert _own(blob) == {"hetmogp::rbf_K_batched": 1,
                          "hetmogp::tril_projection_3pass": 1,
                          "hetmogp::quad_diag": 1}
    Luu, iLuu = export.serving_state(p32, c32)
    got = export.load_predictive(blob)(*export.params_args(p32), Luu, iLuu,
                                       torch.tensor(X[1], dtype=torch.float32))
    want = tpredict.make_serving_predictive(p32, c32, 1)(X[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_adaptive_jitter_is_selected_on_the_device():
    """Duplicated inducing points and no base jitter: Kuu is singular, the
    eager ``jitchol`` escalates on the host, and the exported program
    (every level factorized, the first that succeeds selected) reproduces
    its level and factor bit for bit."""
    Z = np.random.RandomState(7).rand(M, DX)
    Z[1] = Z[0]
    _, _, tcfg, params, X = _model(adaptive=True, jitter=0.0, Z=Z)
    Kuu = kernels.K_gram_batched(tcfg.kernel, params.Z, params.lengthscale,
                                 params.variance)
    assert bool((torch.linalg.cholesky_ex(Kuu)[1] != 0).any())
    blob = export.export_predictive(params, tcfg, X)
    ops = export.exported_ops(blob)
    assert ops["aten::linalg_cholesky_ex"] >= 6  # every jitter level
    m, v = tpredict.predictive(params, tcfg, X)
    got = _run_port(blob, params, *X)
    for g, e in zip(got, [a for mv in zip(m, v) for a in mv]):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, e)


def test_loaded_program_runs_without_jax(model, tmp_path):
    _, _, tcfg, params, X = model
    blob = export.export_serving_predictive(params, tcfg, X[1], 1)
    (tmp_path / "serve.pt2").write_bytes(blob)
    torch.save({"args": export.params_args(params)
                + export.serving_state(params, tcfg),
                "X": torch.from_numpy(X[1]),
                "want": tpredict.make_serving_predictive(params, tcfg,
                                                         1)(X[1])},
               tmp_path / "inputs.pt")
    script = f"""
import sys
import torch
import hetmogp_tpu_torch  # registers the hetmogp:: operators
from hetmogp_tpu_torch.export import load_predictive
d = torch.load({str(tmp_path / "inputs.pt")!r})
fn = load_predictive(open({str(tmp_path / "serve.pt2")!r}, "rb").read())
got = fn(*d["args"], d["X"])
assert all(torch.equal(a, b) for a, b in zip(got, d["want"]))
assert not any(m.split(".")[0] in ("jax", "hetmogp_tpu") for m in sys.modules)
print("SERVED")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVED" in proc.stdout
