"""The port against the numpy oracle (``tests/oracle_numpy.py``): its
variational expectations and its predictive path (ROADMAP item 15).

The oracle integrates the reference's log densities on the same GH grid
(``gh_var_exp``) and takes their derivatives from hand-derived formulas
(``gh_var_exp_derivs``), independent of both packages' autodiff.  The
cases and tolerances are those that hold the JAX package to it
(``tests/test_likelihoods.py``): ``logpdf`` to 1e-10, ``var_exp`` to 5e-8
(the closed forms of (Het)Gaussian against their own quadrature) and
(dm, dv) to 1e-8 absolute, float64, on the CPU.  Beside them, the three
engines that kernel 6 sweeps on the card are held to the oracle in their own
forms: Bernoulli and Categorical(K=3) are cases below, and Gamma's closed
form sweeps E[lgamma(clip(e^f, 1e-9, 1e9))], whose derivatives are written
out here from scipy's digamma and trigamma, in the oracle's manner.

The predictive path, in float64 on the CPU (``device="cpu"``), with the
cases and tolerances that hold the JAX package to the oracle
(``tests/test_predict_oracle.py``): q(f_d)'s moments against
``qf_moments`` and the observation-space ``predictive`` against
``gh_predictive`` to 1e-9, ``predict_f_projected`` and
``predict_f_stochastic`` against ``raw_predict_f`` (the reference's
Woodbury projection) to 1e-8, whitened and not, and the Monte-Carlo
log-predictive against ``mc_log_predictive`` on shared draws to 1e-10
relative.  Kernel 4's function (quad_diag's A tril(L) and its row sum)
sits inside q(f)'s variance; on the CPU it is its plain version.
"""

import dataclasses

import numpy as np
import pytest
import scipy.special as ssp
import torch

from hetmogp_tpu_torch import likelihoods as L
from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.likelihoods import gamma as tgamma
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models import predict as tpredict
from hetmogp_tpu_torch.models.params import SVMOGPParams
from tests import oracle_numpy as oracle

torch.set_num_threads(1)


def _moments(rng, n, j, vmax=0.6):
    m = rng.randn(n, j)
    v = vmax * rng.rand(n, j) + 0.05
    return m, v


CASES = [
    # (likelihood, oracle logpdf, dlogp, d2logp, data generator, dim_f, T);
    # sigma=1 so the closed-form var_exp is the quadrature of the
    # (sigma-independent, reference-quirk) logpdf
    (L.Gaussian(sigma=1.0), oracle.logpdf_gaussian,
     oracle.dlogp_gaussian, oracle.d2logp_gaussian,
     lambda rng, n: rng.randn(n, 1), 1, 20),
    (L.HetGaussian(), oracle.logpdf_hetgaussian,
     oracle.dlogp_hetgaussian, oracle.d2logp_hetgaussian,
     lambda rng, n: rng.randn(n, 1), 2, 20),
    (L.Bernoulli(), oracle.logpdf_bernoulli,
     oracle.dlogp_bernoulli, oracle.d2logp_bernoulli,
     lambda rng, n: (rng.rand(n, 1) > 0.5).astype(float), 1, 20),
    (L.Poisson(analytic=False), oracle.logpdf_poisson,
     oracle.dlogp_poisson, oracle.d2logp_poisson,
     lambda rng, n: rng.poisson(3.0, (n, 1)).astype(float), 1, 20),
    (L.Exponential(analytic=False), oracle.logpdf_exponential,
     oracle.dlogp_exponential, oracle.d2logp_exponential,
     lambda rng, n: rng.exponential(1.0, (n, 1)) + 1e-3, 1, 20),
    (L.Beta(analytic=False), oracle.logpdf_beta,
     oracle.dlogp_beta, oracle.d2logp_beta,
     lambda rng, n: np.clip(rng.rand(n, 1), 0.05, 0.95), 2, 10),
    (L.Gamma(analytic=False), oracle.logpdf_gamma,
     oracle.dlogp_gamma, oracle.d2logp_gamma,
     lambda rng, n: rng.gamma(2.0, 1.0, (n, 1)) + 1e-3, 2, 10),
    (L.Categorical(K=3), lambda F, y: oracle.logpdf_categorical(F, y, 3),
     lambda F, y: oracle.dlogp_categorical(F, y, 3),
     lambda F, y: oracle.d2logp_categorical(F, y, 3),
     lambda rng, n: rng.randint(1, 4, (n, 1)).astype(float), 2, 10),
]
IDS = [type(c[0]).__name__ for c in CASES]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.mark.parametrize("lik,olp,odl,od2,gen,j,t", CASES, ids=IDS)
def test_logpdf_matches_oracle(lik, olp, odl, od2, gen, j, t):
    rng = np.random.RandomState(0)
    n = 13
    F = rng.randn(n, j)
    Y = gen(rng, n)
    got = lik.logpdf(_t(F), _t(Y)).numpy()
    np.testing.assert_allclose(got, olp(F, Y), atol=1e-10)


@pytest.mark.parametrize("lik,olp,odl,od2,gen,j,t", CASES, ids=IDS)
def test_var_exp_matches_oracle(lik, olp, odl, od2, gen, j, t):
    rng = np.random.RandomState(1)
    n = 11
    m, v = _moments(rng, n, j)
    Y = gen(rng, n)
    got = lik.var_exp(_t(Y), _t(m), _t(v)).numpy()
    np.testing.assert_allclose(got, oracle.gh_var_exp(olp, Y, m, v, t),
                               atol=5e-8)


@pytest.mark.parametrize("lik,olp,odl,od2,gen,j,t", CASES, ids=IDS)
def test_var_exp_derivatives_match_reference_form(lik, olp, odl, od2, gen, j,
                                                  t):
    rng = np.random.RandomState(2)
    n = 7
    m, v = _moments(rng, n, j)
    Y = gen(rng, n)
    dm, dv = lik.var_exp_derivatives(_t(Y), _t(m), _t(v))
    edm, edv = oracle.gh_var_exp_derivs(odl, od2, Y, m, v, t)
    np.testing.assert_allclose(dm.numpy(), edm, atol=1e-8)
    np.testing.assert_allclose(dv.numpy(), edv, atol=1e-8)


# ---- Gamma's closed form: the lngamma sweep ---------------------------------

def _lngamma(F, y):
    return ssp.gammaln(np.clip(np.exp(F[:, 0]), 1e-9, 1e9))


def _dlngamma(F, y):
    """d/df lgamma(e^f) = psi(a) a, zero where the clip holds a."""
    a = np.exp(F[:, :1])
    inside = (a >= 1e-9) & (a <= 1e9)
    return np.where(inside, ssp.digamma(a) * a, 0.0)


def _d2lngamma(F, y):
    """d2/df2 lgamma(e^f) = psi'(a) a^2 + psi(a) a, zero where clipped."""
    a = np.exp(F[:, :1])
    inside = (a >= 1e-9) & (a <= 1e9)
    return np.where(inside, ssp.polygamma(1, a) * a * a + ssp.digamma(a) * a,
                    0.0)


@pytest.mark.parametrize("spread", [1.0, 8.0], ids=["moderate", "wide"])
def test_lngamma_sweep_matches_oracle(spread):
    """The engine of Gamma's closed form (and Beta's and Dirichlet's) on
    its 1-D T=20 grid: value to 5e-8, (dm, dv) to 1e-8 relative to the
    largest (the wide moments reach a ~ e^20, where lgamma's derivatives
    are ~1e9)."""
    rng = np.random.RandomState(4)
    n = 9
    m, v = _moments(rng, n, 1)
    m = spread * m
    Y = rng.rand(n, 1)
    M, V = _t(m).requires_grad_(), _t(v).requires_grad_()
    ve = tgamma._lngamma_engine(20)
    val = ve(_t(Y), M, V)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    want = oracle.gh_var_exp(_lngamma, Y, m, v, 20)
    edm, edv = oracle.gh_var_exp_derivs(_dlngamma, _d2lngamma, Y, m, v, 20)
    np.testing.assert_allclose(val.detach().numpy(), want,
                               atol=5e-8 * max(1.0, np.abs(want).max()))
    for got, exp in ((dm, edm), (dv, edv)):
        np.testing.assert_allclose(got.numpy(), exp,
                                   atol=1e-8 * max(1.0, np.abs(exp).max()))


# ---- the predictive path ----------------------------------------------------

def _predict_setup(seed=0, M=6, Q=2):
    """The JAX package's oracle model (``tests/test_predict_oracle.py``):
    Gaussian(0.6), HetGaussian, Bernoulli, un-whitened, float64, on the
    CPU; and the oracle's arguments."""
    rng = np.random.RandomState(seed)
    liks = (L.Gaussian(sigma=0.6), L.HetGaussian(), L.Bernoulli())
    D = 4  # 1 + 2 + 1
    Z = np.linspace(0, 1, M)[None, :, None] + 0.02 * rng.randn(Q, M, 1)
    W = rng.randn(Q, D)
    ls = 0.15 + 0.1 * rng.rand(Q, 1)
    var = 0.5 + rng.rand(Q)
    m_u = rng.randn(Q, M)
    L_u = np.tril(0.3 * rng.randn(Q, M, M)) + np.eye(M)[None]
    cfg = ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                      input_dim=1, whiten=False, dtype="float64")
    params = SVMOGPParams(
        Z=_t(Z), q_mu=_t(m_u), q_sqrt=_t(L_u),
        log_lengthscale=torch.log(_t(ls)), log_variance=torch.log(_t(var)),
        W=_t(W), kappa=torch.zeros(Q, D, dtype=torch.float64))
    oa = dict(Z=Z, W=W, kappa=np.zeros((Q, D)), lengthscales=ls,
              variances=var, m_u=m_u, L_u=L_u)
    return cfg, params, oa


def _anchors(rng):
    """Small, well-separated training inputs: the N x N prior Gram the
    projection inverts stays well conditioned."""
    return [np.linspace(0, 1, 8)[:, None] + 0.01 * rng.randn(8, 1),
            np.linspace(0, 1, 7)[:, None] + 0.01 * rng.randn(7, 1),
            np.linspace(0, 1, 8)[:, None] + 0.01 * rng.randn(8, 1)]


def _oracle_moments(oa, X, d):
    return oracle.qf_moments(X, oa["Z"], oa["W"], oa["kappa"],
                             oa["lengthscales"], oa["variances"], oa["m_u"],
                             oa["L_u"], d)


def _oracle_projected(oa, Xtrain, Xnew, d):
    return oracle.raw_predict_f(Xtrain, Xnew, oa["Z"], oa["W"], oa["kappa"],
                                oa["lengthscales"], oa["variances"],
                                oa["m_u"], oa["L_u"], d)


def _whitened(cfg, params):
    """The same posterior in the whitened coordinates v = Luu^-1 u."""
    return (dataclasses.replace(cfg, whiten=True),
            telbo.whiten_params(params, cfg))


@pytest.mark.parametrize("whiten", [False, True], ids=["raw", "whitened"])
def test_qf_moments_match_oracle(whiten):
    """predict_f's (mean, var) of every output function against the
    reference's calculate_q_f equations."""
    cfg, params, oa = _predict_setup()
    if whiten:
        cfg, params = _whitened(cfg, params)
    X = np.random.RandomState(9).rand(10, 1)
    for d in range(cfg.num_output_functions):
        m, v = tpredict.predict_f(params, cfg, X, d)
        em, ev = _oracle_moments(oa, X, d)
        np.testing.assert_allclose(m.numpy(), em, atol=1e-9,
                                   err_msg=f"mean d={d}")
        np.testing.assert_allclose(v.numpy(), ev, atol=1e-9,
                                   err_msg=f"var d={d}")


@pytest.mark.parametrize("whiten", [False, True], ids=["raw", "whitened"])
def test_projected_prediction_matches_woodbury_oracle(whiten):
    """predict_f_projected against the reference's _raw_predict_f (the GPy
    Posterior's Woodbury projection)."""
    cfg, params, oa = _predict_setup()
    rng = np.random.RandomState(5)
    Xtrain = _anchors(rng)
    Xnew = rng.rand(11, 1)
    if whiten:
        cfg, params = _whitened(cfg, params)
    for d in range(cfg.num_output_functions):
        t = cfg.function_index[d]
        em, ev = _oracle_projected(oa, Xtrain[t], Xnew, d)
        m, v = tpredict.predict_f_projected(params, cfg, Xtrain, Xnew, d)
        np.testing.assert_allclose(m.numpy(), em, atol=1e-8,
                                   err_msg=f"mean d={d}")
        np.testing.assert_allclose(v.numpy(), ev, atol=1e-8,
                                   err_msg=f"var d={d}")


def test_predict_f_stochastic_minibatch_anchor_matches_oracle():
    """predict_f_stochastic: with the full anchors it is
    predict_f_projected, with a minibatch anchor the oracle's projection
    on that anchor set."""
    cfg, params, oa = _predict_setup(seed=3)
    rng = np.random.RandomState(8)
    Xtrain = _anchors(rng)
    Xbatch = [x[::2] for x in Xtrain]
    Xnew = rng.rand(9, 1)
    for d in range(cfg.num_output_functions):
        t = cfg.function_index[d]
        m0, v0 = tpredict.predict_f_projected(params, cfg, Xtrain, Xnew, d)
        m1, v1 = tpredict.predict_f_stochastic(params, cfg, Xtrain, Xnew, d)
        assert torch.equal(m1, m0) and torch.equal(v1, v0)
        em, ev = _oracle_projected(oa, Xbatch[t], Xnew, d)
        mb, vb = tpredict.predict_f_stochastic(params, cfg, Xbatch, Xnew, d)
        np.testing.assert_allclose(mb.numpy(), em, atol=1e-8)
        np.testing.assert_allclose(vb.numpy(), ev, atol=1e-8)


def test_observation_space_predictive_matches_oracle():
    """predictive() against the oracle's q(f) moments pushed through the
    GH law of total variance: analytic Gaussian, the 2-D grid of
    HetGaussian, GH Bernoulli."""
    cfg, params, oa = _predict_setup()
    rng = np.random.RandomState(6)
    X_list = [rng.rand(9, 1), rng.rand(8, 1), rng.rand(7, 1)]
    m_pred, v_pred = tpredict.predictive(params, cfg, X_list)

    def moments(t, dim_f, d0):
        mv = [_oracle_moments(oa, X_list[t], d0 + j) for j in range(dim_f)]
        return (np.stack([m for m, _ in mv], -1),
                np.stack([v for _, v in mv], -1))

    mF, vF = moments(0, 1, 0)
    np.testing.assert_allclose(m_pred[0].numpy(), mF, atol=1e-9)
    np.testing.assert_allclose(v_pred[0].numpy(), 0.6 ** 2 + vF, atol=1e-9)

    mF, vF = moments(1, 2, 1)
    em, ev = oracle.gh_predictive(
        lambda F: (F[:, :1], np.exp(F[:, 1:2])), mF, vF, T=20)
    np.testing.assert_allclose(m_pred[1].numpy(), em, atol=1e-9)
    np.testing.assert_allclose(v_pred[1].numpy(), ev, atol=1e-9)

    mF, vF = moments(2, 1, 3)

    def bern_moments(F):
        p = np.clip(np.exp(F) / (1 + np.exp(F)), 1e-9, 1 - 1e-9)
        return p, p * (1 - p)

    em, ev = oracle.gh_predictive(bern_moments, mF, vF, T=20)
    np.testing.assert_allclose(m_pred[2].numpy(), em, atol=1e-9)
    np.testing.assert_allclose(v_pred[2].numpy(), ev, atol=1e-9)


NLPD_CASES = [
    (L.Gaussian(sigma=0.6), oracle.logpdf_gaussian, 1,
     lambda rng, n: rng.randn(n, 1)),
    (L.HetGaussian(), oracle.logpdf_hetgaussian, 2,
     lambda rng, n: rng.randn(n, 1)),
    (L.Bernoulli(), oracle.logpdf_bernoulli, 1,
     lambda rng, n: (rng.rand(n, 1) > 0.5).astype(float)),
    (L.Poisson(), oracle.logpdf_poisson, 1,
     lambda rng, n: rng.poisson(2.0, (n, 1)).astype(float)),
]


@pytest.mark.parametrize("lik,olp,J,gen", NLPD_CASES,
                         ids=[type(c[0]).__name__ for c in NLPD_CASES])
@pytest.mark.parametrize("scaling", [True, False],
                         ids=["reference_scaling", "plain_sum"])
def test_nlpd_matches_oracle_with_shared_draws(lik, olp, J, gen, scaling):
    """The MC log-predictive against the reference formula (logsumexp
    average, and the 1/S quirk unless reference_scaling=False) on the same
    injected draws."""
    rng = np.random.RandomState(7)
    n, S = 12, 64
    Y = gen(rng, n)
    M_ = 0.5 * rng.randn(n, J)
    V_ = 0.1 + 0.3 * rng.rand(n, J)
    eps = rng.randn(n, S, J)
    got = lik.log_predictive(None, _t(Y), _t(M_), _t(V_), S,
                             reference_scaling=scaling, eps=eps)
    want = oracle.mc_log_predictive(olp, eps, Y, M_, V_,
                                    reference_scaling=scaling)
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
