"""``ve_fwd_precision="high"`` against the JAX package, and the device
defaults of the port's entry points.

The six-likelihood bench model cut to Q=2, M=256, six tasks of 64 rows, at
jitter 1e-4, on the same numpy inputs.  In float64 "high" is full
precision in both packages, so they agree as at "highest": 1e-12 normwise
for the projections, rtol 1e-9 for the ELBO (the reasons are
``tests/test_torch_elbo.py``'s).  In float32 the JAX package on the CPU
ignores the precision and multiplies in full float32, while the port forms
P in three bf16 passes: the bound is then the 3-pass error, which the JAX
package measured at 6.3e-3 relative in P at these conditions (iLuu entries
~1e2 cancelling in P = Kfu iLuu^T); mean_q = P m inherits it (bound 2e-2
normwise), and the variance gamma_q, a sum of squares, sits lower (5e-3).
"""

import dataclasses
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import SVMOGPParams as JParams

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import data as tdata
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models import params as tparams_mod

torch.set_num_threads(1)

Q, M, DX, ROWS = 2, 256, 2, 64
NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
         "Exponential")
F32_MEAN, F32_GAMMA, F32_ELBO = 2e-2, 5e-3, 1e-3


def _observations(rng, n):
    return [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
            rng.randint(1, 4, (n, 1)).astype(float),
            rng.poisson(3.0, (n, 1)).astype(float),
            rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
            rng.exponential(1.0, (n, 1)) + 1e-3]


def _model(dtype, precision="high"):
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)()
                                             for n in NAMES),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype=dtype, jitter=1e-4, adaptive_jitter=False,
                           ard=True, ve_fwd_precision=precision)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    leaves = dict(Z=np.broadcast_to(rng.rand(M, DX), (Q, M, DX)).copy(),
                  q_mu=0.3 * rng.randn(Q, M),
                  q_sqrt=0.5 * np.eye(M) + 0.01 * np.tril(rng.randn(Q, M, M)),
                  log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.zeros((Q, D)))
    leaves = {k: v.astype(dtype) for k, v in leaves.items()}
    X = [rng.rand(ROWS, DX).astype(dtype) for _ in NAMES]
    Y = _observations(rng, ROWS)
    jp = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tpar = tp.params_from_jax(types.SimpleNamespace(**leaves), device="cpu")
    return cfg, jp, tcfg, tpar, X, Y


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_high_config_roundtrips_with_jax():
    cfg, _, tcfg, _, _, _ = _model("float32")
    assert tcfg.ve_fwd_precision == "high"
    assert tcfg.to_dict() == cfg.to_dict()
    assert tp.ModelConfig.from_dict(tcfg.to_dict()) == tcfg
    back = jhet.ModelConfig.from_dict(tcfg.to_dict())
    assert back.ve_fwd_precision == "high" and back.to_dict() == cfg.to_dict()


def _projections(dtype, precision="high"):
    cfg, jp, tcfg, tpar, X, _ = _model(dtype, precision)
    jL, jiL = jelbo.prior_cholesky_inverse(jp, cfg)
    Xa = np.concatenate(X)
    want = jelbo.latent_projections(jp, cfg, jL, jnp.asarray(Xa), iLuu=jiL)
    got = telbo.latent_projections(tpar, tcfg,
                                   torch.from_numpy(np.array(jL)),
                                   torch.from_numpy(Xa),
                                   torch.from_numpy(np.array(jiL)))
    return [_normwise(g, w) for g, w in zip(got, want)]


def test_latent_projections_high_match_jax_f64():
    assert max(_projections("float64")) < 1e-12


def test_latent_projections_high_f32_within_the_3pass_error():
    mean, gamma, kdiag = _projections("float32")
    assert mean < F32_MEAN and gamma < F32_GAMMA and kdiag == 0.0
    # and the route is the 3-pass one: "highest" sits far closer to JAX
    full = _projections("float32", "highest")
    assert full[0] < mean / 4 and full[1] < gamma / 4


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9),
                                        ("float32", F32_ELBO)])
def test_elbo_fn_high_matches_jax(dtype, rtol):
    cfg, jp, tcfg, tpar, X, Y = _model(dtype)
    scales = np.linspace(50.0, 150.0, len(NAMES)).astype(dtype)
    jdata = tuple(jelbo.task_data(x, y) for x, y in zip(X, Y))
    jL, jiL = jelbo.prior_cholesky_inverse(jp, cfg)
    want, jaux = jax.jit(lambda p: jelbo.elbo_fn(
        p, jdata, jnp.asarray(scales), cfg, Luu=jL, iLuu=jiL))(jp)
    tL, tiL = telbo.prior_cholesky_inverse(tpar, tcfg)
    got, aux = telbo.elbo_fn(tpar, tp.make_dataset(X, Y, tcfg, device="cpu"),
                             torch.from_numpy(scales), tcfg, Luu=tL,
                             iLuu=tiL)
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    np.testing.assert_allclose(aux["ve"].numpy(), np.asarray(jaux["ve"]),
                               rtol=rtol)


def test_serving_follows_the_config_precision():
    """make_serving_predictive forms P at the config's precision, as the
    JAX one does: "high" and "highest" differ in float32 only."""
    for dtype in ("float32", "float64"):
        _, _, tcfg, tpar, X, _ = _model(dtype)
        Xs = torch.from_numpy(X[0])
        high = tp.make_serving_predictive(tpar, tcfg, 0)(Xs)
        full = tp.make_serving_predictive(tpar, dataclasses.replace(
            tcfg, ve_fwd_precision="highest"), 0)(Xs)
        same = all(torch.equal(a, b) for a, b in zip(high, full))
        assert same == (dtype == "float64"), dtype


@pytest.mark.parametrize("fn,name", [
    (tparams_mod.init_params, "device"),
    (tparams_mod.params_from_jax, "device"),
    (telbo.task_data, "device"),
    (ttrain.make_dataset, "device"),
    (tdata.full_batch, "device"),
    (ttrain.prepare_dataset_on_device, "device"),
    (ttrain.make_batch_sampler, "device"),
    (ttrain.check_dataset_fits_hbm, "device"),
], ids=lambda x: getattr(x, "__name__", x))
def test_entry_points_default_to_the_card(fn, name):
    assert inspect.signature(fn).parameters[name].default == "cuda"
