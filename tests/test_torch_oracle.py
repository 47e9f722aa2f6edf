"""The port's variational expectations against the numpy oracle
(``tests/oracle_numpy.py``): the var_exp half of ROADMAP item 15.

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
"""

import numpy as np
import pytest
import scipy.special as ssp
import torch

from hetmogp_tpu_torch import likelihoods as L
from hetmogp_tpu_torch.likelihoods import gamma as tgamma
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
