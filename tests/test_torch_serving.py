"""The port's serving path against the JAX package, module by module and
as a whole, on the same numpy inputs.

Float64 on the CPU, where both packages run the same algebra: the port's
plain RBF, its dense matmuls and its GH engine against the JAX package's
XLA kernels, blocked factorization (M=256 runs its nb=128 panels) and
quadrature.  Tolerances: rtol 1e-8 / atol 1e-10 where a factorization and
a projection through an explicit inverse sit between the two (their
rounding differs by about cond(Kuu) * eps), rtol 1e-10 for the
likelihoods, which are elementwise on identical moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import checkpoint as jcheckpoint
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models import predict as jpredict
from hetmogp_tpu.models.params import SVMOGPParams as JParams

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import likelihoods as tliks
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.ops import cuda_kernels

torch.set_num_threads(1)

RTOL, ATOL = 1e-8, 1e-10
Q, M, DX, N_ROWS = 2, 256, 2, 300
LIK_NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
             "Exponential")
# (class name, constructor kwargs): the six serving families, plus the GH
# engine modes of the closed-form ones and Categorical's exact variance
LIK_CASES = [(n, {}) for n in LIK_NAMES] + [
    ("HetGaussian", {"analytic": False}), ("Poisson", {"analytic": False}),
    ("Gamma", {"analytic": False}), ("Exponential", {"analytic": False}),
    ("Categorical", {"exact_predictive_variance": True}),
]


def _lik_pair(name, kw):
    return getattr(jliks, name)(**kw), getattr(tliks, name)(**kw)


def _model(whiten=True):
    """The six-likelihood serving model, cut to Q=2 and M=256, in float64,
    with a non-identity q_sqrt (identity cancels the variance term)."""
    liks = tuple(getattr(jliks, n)() for n in LIK_NAMES)
    cfg = jhet.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                           input_dim=DX, dtype="float64", jitter=1e-4,
                           adaptive_jitter=False, whiten=whiten, ard=True)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    Z = np.broadcast_to(rng.rand(M, DX), (Q, M, DX))
    q_sqrt = 0.5 * np.eye(M) + 0.01 * np.tril(rng.randn(Q, M, M))
    leaves = dict(Z=Z, q_mu=0.1 * rng.randn(Q, M), q_sqrt=q_sqrt,
                  log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.zeros((Q, D)))
    jparams = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    X_list = [rng.rand(N_ROWS, DX) for _ in LIK_NAMES]
    return cfg, jparams, X_list


def _port(cfg, jparams):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    return tcfg, tparams


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module", params=[True, False],
                ids=["whiten", "unwhiten"])
def model(request):
    cfg, jparams, X_list = _model(whiten=request.param)
    tcfg, tparams = _port(cfg, jparams)
    return cfg, jparams, X_list, tcfg, tparams


# ---- likelihoods ----------------------------------------------------------

@pytest.mark.parametrize("name,kw", LIK_CASES,
                         ids=[f"{n}{'-' + '-'.join(kw) if kw else ''}"
                              for n, kw in LIK_CASES])
def test_likelihood_predictive_matches_jax_f64(name, kw):
    jlik, tlik = _lik_pair(name, kw)
    rng = np.random.RandomState(1)
    m = rng.randn(50, jlik.dim_f)
    v = 0.01 + rng.rand(50, jlik.dim_f)
    jm, jv = jlik.predictive(jnp.asarray(m), jnp.asarray(v))
    tm, tv = tlik.predictive(torch.from_numpy(m), torch.from_numpy(v))
    assert tlik.get_metadata() == jlik.get_metadata()
    _close(tm, jm, rtol=1e-10, atol=0)
    _close(tv, jv, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", LIK_NAMES)
def test_likelihood_predictive_f32_extremes_finite_where_jax_is(name):
    """f32 at m = +-50 and v in {0, 30}: the port is finite wherever the
    JAX package is, and its means agree there."""
    jlik, tlik = _lik_pair(name, {})
    grid = np.array([(m, v) for m in (-50.0, 50.0) for v in (0.0, 30.0)])
    m = np.repeat(grid[:, :1], jlik.dim_f, 1).astype(np.float32)
    v = np.repeat(grid[:, 1:], jlik.dim_f, 1).astype(np.float32)
    j_out = jlik.predictive(jnp.asarray(m), jnp.asarray(v))
    t_out = tlik.predictive(torch.from_numpy(m), torch.from_numpy(v))
    for j, t in zip(j_out, t_out):
        j, t = np.asarray(j), t.numpy()
        assert t.dtype == np.float32
        assert np.all(np.isfinite(t) | ~np.isfinite(j)), (name, j, t)
    jm, tm = np.asarray(j_out[0]), t_out[0].numpy()
    both = np.isfinite(jm) & np.isfinite(tm)
    np.testing.assert_allclose(tm[both], jm[both], rtol=1e-5, atol=1e-30)


# ---- latent moments --------------------------------------------------------

def test_prior_cholesky_inverse_matches_jax(model):
    cfg, jparams, _, tcfg, tparams = model
    jL, jiL = jelbo.prior_cholesky_inverse(jparams, cfg)
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    _close(tL, jL)
    _close(tiL, jiL, atol=1e-8)  # entries up to ~1e2 (jitter 1e-4)


def test_latent_projections_match_jax(model):
    cfg, jparams, X_list, tcfg, tparams = model
    jL, jiL = jelbo.prior_cholesky_inverse(jparams, cfg)
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    X = X_list[0]
    want = jelbo.latent_projections(jparams, cfg, jL, jnp.asarray(X),
                                    iLuu=jiL)
    got = telbo.latent_projections(tparams, tcfg, tL, torch.from_numpy(X),
                                   tiL)
    for g, w in zip(got, want):
        _close(g, w)


def test_task_qf_moments_match_jax(model):
    cfg, jparams, X_list, tcfg, tparams = model
    jL, jiL = jelbo.prior_cholesky_inverse(jparams, cfg)
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    for t, X in enumerate(X_list):
        jm, jv = jelbo.task_qf_moments(jparams, cfg, jL, jnp.asarray(X), t,
                                       iLuu=jiL)
        tm, tv = telbo.task_qf_moments(tparams, tcfg, tL, torch.from_numpy(X),
                                       t, iLuu=tiL)
        _close(tm, jm)
        _close(tv, jv)


# ---- the slice as a whole --------------------------------------------------

def test_serving_predictive_matches_jax(model):
    cfg, jparams, X_list, tcfg, tparams = model
    before = cuda_kernels.launch_counts()
    for t, X in enumerate(X_list):
        jm, jv = jpredict.make_serving_predictive(jparams, cfg, t)(
            jnp.asarray(X))
        tm, tv = tp.make_serving_predictive(tparams, tcfg, t)(X)
        assert tm.shape == jm.shape and tv.shape == jv.shape
        _close(tm, jm)
        _close(tv, jv)
    assert cuda_kernels.launch_counts() == before


def test_predictive_matches_jax(model):
    """The port's direct path against the JAX direct path: both factorize
    Kuu and solve against the factor."""
    cfg, jparams, X_list, tcfg, tparams = model
    jm, jv = jpredict.predictive(jparams, cfg, X_list)
    tm, tv = tp.predictive(tparams, tcfg, X_list)
    for t in range(cfg.num_tasks):
        _close(tm[t], jm[t])
        _close(tv[t], jv[t])


def test_predict_f_matches_jax(model):
    cfg, jparams, X_list, tcfg, tparams = model
    for d in (0, cfg.num_output_functions - 1):
        jm, jv = jpredict.predict_f(jparams, cfg, X_list[0], d)
        tm, tv = tp.predict_f(tparams, tcfg, X_list[0], d)
        _close(tm, jm)
        _close(tv, jv)


def test_serving_refuses_wrong_input_width():
    cfg, jparams, _ = _model()
    tcfg, tparams = _port(cfg, jparams)
    serve = tp.make_serving_predictive(tparams, tcfg, 0)
    with pytest.raises(ValueError, match="input_dim"):
        serve(np.zeros((5, DX + 1)))


# ---- config and parameters crossing from the JAX package ------------------

def test_params_npz_roundtrip(tmp_path):
    cfg, jparams, X_list = _model()
    path = tmp_path / "ckpt.npz"
    jcheckpoint.save_checkpoint(path, jparams, step=3)
    tcfg, direct = _port(cfg, jparams)
    loaded = tp.params_from_jax(path, device="cpu")
    for f in ("Z", "q_mu", "q_sqrt", "log_lengthscale", "log_variance", "W",
              "kappa"):
        torch.testing.assert_close(getattr(loaded, f), getattr(direct, f),
                                   rtol=0, atol=0)
    jm, jv = jpredict.make_serving_predictive(jparams, cfg, 2)(
        jnp.asarray(X_list[2]))
    tm, tv = tp.make_serving_predictive(loaded, tcfg, 2)(X_list[2])
    _close(tm, jm)
    _close(tv, jv)


def test_config_from_jax_dict_roundtrips():
    cfg, _, _ = _model()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    assert tcfg.to_dict() == cfg.to_dict()
    for prop in ("num_latent_eff", "num_tasks", "task_dim_f",
                 "num_output_functions", "function_index", "d_index",
                 "task_function_slices"):
        assert getattr(tcfg, prop) == getattr(cfg, prop), prop
    assert tcfg.torch_dtype == torch.float64


# one of each of the JAX package's sixteen families, non-default fields set
SIXTEEN = (jliks.Gaussian(sigma=0.3, learn_sigma=True), jliks.HetGaussian(),
           jliks.Bernoulli(), jliks.Binomial(n=7), jliks.Categorical(K=4),
           jliks.Beta(analytic=False), jliks.Gamma(), jliks.Exponential(),
           jliks.LogNormal(sigma=0.7), jliks.NegativeBinomial(r=3.0),
           jliks.Poisson(), jliks.StudentT(df=6.0, learn_df=True),
           jliks.Ordinal(K=4, thresholds=(-1.0, 0.5, 2.0)),
           jliks.Dirichlet(K=3, mc_samples=16),
           jliks.Weibull(k=2.0, learn_k=True), jliks.ZeroInflatedPoisson())


@pytest.mark.parametrize("change,match", [
    (dict(likelihoods=SIXTEEN), None),
    (dict(kernel="periodic"), "the port has"),
    (dict(adaptive_jitter=True), None),
    (dict(rank=2), None),
    (dict(chol_dtype="float64"), None),
    (dict(ve_fwd_precision="default"), None),
    (dict(dtype="bfloat16"), "bfloat16 model would form the projection"),
], ids=["family", "kernel", "adaptive", "rank", "chol_dtype", "precision",
        "bfloat16"])
def test_config_refuses_what_is_not_ported(change, match):
    """Each refusal says what the port runs instead; the ``family``,
    ``adaptive``, ``rank``, ``chol_dtype`` and ``precision`` cases pin
    that those refusals are gone: a JAX config of all sixteen families,
    with adaptive jitter, at rank 2, with the float64 island or with a
    ``ve_fwd_precision`` other than "high" and "highest", loads, field for
    field (and runs the last at "highest", as the JAX package does:
    ``tests/test_torch_vem.py``).  ``bfloat16`` stays refused, with its
    reason."""
    cfg, _, _ = _model()
    d = dataclasses.replace(cfg, **change).to_dict()
    if match is None:
        tcfg = tp.ModelConfig.from_dict(d)
        assert tcfg.to_dict() == d
        if "ve_fwd_precision" in change:
            assert tcfg.projection_precision == "highest"
        if "likelihoods" in change:
            assert [type(lik).__name__ for lik in tcfg.likelihoods] == [
                type(lik).__name__ for lik in SIXTEEN]
            assert tcfg.likelihoods[12].thresholds == (-1.0, 0.5, 2.0)
        return
    with pytest.raises(NotImplementedError, match=match):
        tp.ModelConfig.from_dict(d)


def test_init_params_is_seeded():
    cfg, _, _ = _model()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    Z = np.random.RandomState(0).rand(M, DX)
    a = tp.init_params(np.random.default_rng(5), tcfg, Z, lengthscale=0.2,
                       variance=0.5, q_mu_scale=0.1, device="cpu")
    b = tp.init_params(np.random.default_rng(5), tcfg, Z, lengthscale=0.2,
                       variance=0.5, q_mu_scale=0.1, device="cpu")
    D = tcfg.num_output_functions
    shapes = dict(Z=(Q, M, DX), q_mu=(Q, M), q_sqrt=(Q, M, M),
                  log_lengthscale=(Q, DX), log_variance=(Q,), W=(Q, D),
                  kappa=(Q, D))
    for f, shape in shapes.items():
        assert tuple(getattr(a, f).shape) == shape, f
        assert getattr(a, f).dtype == torch.float64
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0)
    torch.testing.assert_close(a.q_sqrt[0], torch.eye(M, dtype=torch.float64))
