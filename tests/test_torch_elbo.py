"""The port's ELBO against the JAX package's ``elbo_fn`` on the same numpy
inputs, in float64: the six-likelihood bench model cut to Q=2, M=256,
six tasks of 64 rows, on the cached-inverse path the trainer runs.

* the value, fused and per-task rows, with and without a given cache;
* the VE gradients (q_mu, q_sqrt) against the frozen cache;
* the VM gradients (hypers, Z, W) through the cached-inverse adjoints
  (``cache_grad=True``), against ``jax.grad`` of the same.

Tolerances: rtol 1e-9 (normwise for gradients).  Between the two sit a
factorization and products with the explicit inverse of Luu, whose entries
reach ~1e2 at jitter 1e-4 (cond(Kuu) ~ 1e5 at M=256), so the packages'
rounding differs by about cond * eps ~ 1e-11 relative, and the gradients
sum that over 384 rows.
"""

import dataclasses
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
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models.params import FIELDS

torch.set_num_threads(1)

Q, M, DX, ROWS = 2, 256, 2, 64
NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
         "Exponential")
HYPERS = ("log_lengthscale", "log_variance", "Z", "W")


def _observations(rng, n):
    return [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
            rng.randint(1, 4, (n, 1)).astype(float),
            rng.poisson(3.0, (n, 1)).astype(float),
            rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
            rng.exponential(1.0, (n, 1)) + 1e-3]


@pytest.fixture(scope="module")
def model():
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)()
                                             for n in NAMES),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype="float64", jitter=1e-4,
                           adaptive_jitter=False, ard=True)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    leaves = dict(Z=np.broadcast_to(rng.rand(M, DX), (Q, M, DX)).copy(),
                  q_mu=0.3 * rng.randn(Q, M),
                  q_sqrt=0.5 * np.eye(M) + 0.01 * np.tril(rng.randn(Q, M, M)),
                  log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.zeros((Q, D)))
    X = [rng.rand(ROWS, DX) for _ in NAMES]
    Y = _observations(rng, ROWS)
    scales = np.linspace(50.0, 150.0, len(NAMES))
    jp = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jdata = tuple(jelbo.task_data(x, y) for x, y in zip(X, Y))
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(types.SimpleNamespace(**leaves),
                                 device="cpu")
    tdata = tp.make_dataset(X, Y, tcfg, device="cpu")
    return cfg, jp, jdata, tcfg, tparams, tdata, scales


def _normwise(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_task"])
@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no_cache"])
def test_elbo_value_matches_jax(model, fuse, cached):
    cfg, jp, jdata, tcfg, tparams, tdata, scales = model
    cfg = dataclasses.replace(cfg, fuse_task_rows=fuse)
    tcfg = dataclasses.replace(tcfg, fuse_task_rows=fuse)
    jL, jiL = jelbo.prior_cholesky_inverse(jp, cfg)
    want, jaux = jax.jit(lambda p: jelbo.elbo_fn(
        p, jdata, jnp.asarray(scales), cfg, Luu=jL, iLuu=jiL))(jp)
    kw = {}
    if cached:
        kw = dict(zip(("Luu", "iLuu"),
                      telbo.prior_cholesky_inverse(tparams, tcfg)))
    got, aux = telbo.elbo_fn(tparams, tdata, torch.from_numpy(scales), tcfg,
                             **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-9)
    np.testing.assert_allclose(aux["ve"].numpy(), np.asarray(jaux["ve"]),
                               rtol=1e-9)
    np.testing.assert_allclose(aux["kl"].item(), float(jaux["kl"]),
                               rtol=1e-12)


def _port_grad(tparams, tcfg, tdata, scales, names, **kw):
    leaves = {f: getattr(tparams, f).clone().requires_grad_(f in names)
              for f in FIELDS}
    e, _ = telbo.elbo_fn(tp.SVMOGPParams(**leaves), tdata,
                         torch.from_numpy(scales), tcfg, **kw)
    return dict(zip(names, torch.autograd.grad(e, [leaves[n]
                                                   for n in names])))


def test_ve_gradients_match_jax(model):
    cfg, jp, jdata, tcfg, tparams, tdata, scales = model
    jL, jiL = jelbo.prior_cholesky_inverse(jp, cfg)

    @jax.jit
    def jgrad(q_mu, q_sqrt):
        def f(q_mu, q_sqrt):
            return jelbo.elbo_fn(jp.replace(q_mu=q_mu, q_sqrt=q_sqrt), jdata,
                                 jnp.asarray(scales), cfg, Luu=jL,
                                 iLuu=jiL)[0]
        return jax.grad(f, argnums=(0, 1))(q_mu, q_sqrt)

    want = dict(zip(("q_mu", "q_sqrt"), jgrad(jp.q_mu, jp.q_sqrt)))
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    got = _port_grad(tparams, tcfg, tdata, scales, ("q_mu", "q_sqrt"),
                     Luu=tL, iLuu=tiL)
    for n in want:
        assert _normwise(got[n], want[n]) < 1e-9, n


def test_vm_gradients_match_jax(model):
    """cache_grad=True: through chol_cached and solve_tri_cached."""
    cfg, jp, jdata, tcfg, tparams, tdata, scales = model
    jL, jiL = jelbo.prior_cholesky_inverse(jp, cfg)

    @jax.jit
    def jgrad(hyper):
        def f(hyper):
            return jelbo.elbo_fn(jp.replace(**hyper), jdata,
                                 jnp.asarray(scales), cfg, Luu=jL, iLuu=jiL,
                                 cache_grad=True)[0]
        return jax.grad(f)(hyper)

    want = jgrad({n: getattr(jp, n) for n in HYPERS})
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    got = _port_grad(tparams, tcfg, tdata, scales, HYPERS, Luu=tL, iLuu=tiL,
                     cache_grad=True)
    for n in HYPERS:
        assert _normwise(got[n], want[n]) < 1e-9, n
    # the cached adjoints are the exact gradient of the factorization path
    direct = _port_grad(tparams, tcfg, tdata, scales, HYPERS)
    for n in HYPERS:
        assert _normwise(direct[n], want[n]) < 1e-7, n


def test_task_data_and_kl_checks(model):
    cfg, jp, _, tcfg, tparams, _, _ = model
    td = telbo.task_data(np.zeros((3, DX)), np.arange(3.0),
                         dtype=torch.float64, device="cpu")
    assert td.Y.shape == (3, 1) and torch.equal(td.mask, torch.ones(3,
                                                dtype=torch.float64))
    np.testing.assert_allclose(
        telbo.kl_divergence(tparams, tcfg).item(),
        float(jelbo.kl_divergence(jp, cfg, None)), rtol=1e-12)
    # the un-whitened KL, by solves against Luu (1e-9: the factorization's
    # rounding, as above)
    uw, tuw = (dataclasses.replace(c, whiten=False) for c in (cfg, tcfg))
    tL = telbo.prior_cholesky(tparams, tuw)
    np.testing.assert_allclose(
        telbo.kl_divergence(tparams, tuw, tL).item(),
        float(jelbo.kl_divergence(jp, uw, jelbo.prior_cholesky(jp, uw))),
        rtol=1e-9)
    with pytest.raises(ValueError, match="needs Luu"):
        telbo.kl_divergence(tparams, tuw)
    with pytest.raises(ValueError, match="Luu and iLuu"):
        telbo.elbo_fn(tparams, (), torch.ones(6), tcfg, cache_grad=True)
