"""The port's variational expectations against the JAX package's, on the
same numpy inputs: the GH engine ``make_var_exp`` with its Bonnet/Price
gradients, and ``logpdf`` and ``var_exp`` of the six bench likelihoods in
their closed-form (``analytic=True``) and grid modes.

Tolerances: rtol 1e-10 in float64.  Both packages evaluate the same
closed forms and the same GH nodes and weights (numpy's ``hermgauss``);
what differs is the order of the node sums and the autodiff of the
per-node derivatives, a few ulps per node over at most 100 nodes.  One
exception: Gamma's dv = 1/2 E[d2 logp] holds the second derivative of
lgamma, and torch's float64 trigamma (``polygamma(1, x)``, what autograd
gives) is accurate to about 5e-10 relative against scipy where JAX's is
to 2e-16, so Gamma's dv is held to rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.ops import quadrature as jquad
from hetmogp_tpu_torch import likelihoods as tliks
from hetmogp_tpu_torch.ops import quadrature as tquad

torch.set_num_threads(1)

NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
         "Exponential")
CASES = [(n, {}) for n in NAMES] + [
    ("Poisson", {"analytic": False}), ("Gamma", {"analytic": False}),
    ("Exponential", {"analytic": False}),
]
IDS = [n + ("-grid" if kw else "") for n, kw in CASES]


def _observations(name, rng, n):
    return {
        "HetGaussian": lambda: rng.randn(n, 1),
        "Bernoulli": lambda: (rng.rand(n, 1) > 0.5).astype(float),
        "Categorical": lambda: rng.randint(1, 4, (n, 1)).astype(float),
        "Poisson": lambda: rng.poisson(3.0, (n, 1)).astype(float),
        "Gamma": lambda: rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
        "Exponential": lambda: rng.exponential(1.0, (n, 1)) + 1e-3,
    }[name]()


def _moments(rng, n, j):
    return 0.7 * rng.randn(n, j), 0.01 + rng.rand(n, j)


def _port_var_exp(lik, Y, m, v):
    m = torch.from_numpy(m).requires_grad_()
    v = torch.from_numpy(v).requires_grad_()
    val = lik.var_exp(torch.from_numpy(Y), m, v)
    dm, dv = torch.autograd.grad(val.sum(), (m, v))
    return val.detach().numpy(), dm.numpy(), dv.numpy()


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_var_exp_and_derivatives_match_jax_f64(name, kw):
    jlik, tlik = getattr(jliks, name)(**kw), getattr(tliks, name)(**kw)
    rng = np.random.RandomState(0)
    Y = _observations(name, rng, 40)
    m, v = _moments(rng, 40, jlik.dim_f)
    args = (jnp.asarray(Y), jnp.asarray(m), jnp.asarray(v))
    want = jax.jit(jlik.var_exp)(*args)
    want_dm, want_dv = jax.jit(jlik.var_exp_derivatives)(*args)
    got, dm, dv = _port_var_exp(tlik, Y, m, v)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dm, np.asarray(want_dm), rtol=1e-10,
                               atol=1e-12)
    rtol_dv = 1e-8 if name == "Gamma" else 1e-10  # torch's trigamma
    np.testing.assert_allclose(dv, np.asarray(want_dv), rtol=rtol_dv,
                               atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_logpdf_matches_jax_f64(name):
    jlik, tlik = getattr(jliks, name)(), getattr(tliks, name)()
    rng = np.random.RandomState(1)
    Y = _observations(name, rng, 30)
    F = 2.0 * rng.randn(30, jlik.dim_f)
    want = jax.vmap(jlik.logpdf)(jnp.asarray(F), jnp.asarray(Y))
    got = tlik.logpdf(torch.from_numpy(F), torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_engine_matches_jax_on_a_two_dim_grid():
    """make_var_exp with a logpdf whose Hessian has off-diagonal terms: the
    engine keeps only its diagonal, as the JAX engine does."""
    def j_lp(f, y):
        return jnp.sin(f[0]) * f[1] ** 2 - y[0] * jnp.exp(0.3 * f[0] * f[1])

    def t_lp(F, Y):
        f0, f1 = F[..., 0], F[..., 1]
        return torch.sin(f0) * f1 ** 2 - Y[..., 0] * torch.exp(0.3 * f0 * f1)

    rng = np.random.RandomState(2)
    Y = rng.rand(25, 1)
    m, v = _moments(rng, 25, 2)
    j_ve = jquad.make_var_exp(j_lp, J=2, T=7)

    @jax.jit
    def ref(a, b):
        val, vjp = jax.vjp(lambda a, b: j_ve(jnp.asarray(Y), a, b), a, b)
        return (val,) + vjp(jnp.ones(25))

    want, want_dm, want_dv = ref(jnp.asarray(m), jnp.asarray(v))
    got, dm, dv = _port_var_exp(
        type("Lik", (), {"var_exp": staticmethod(
            tquad.make_var_exp(t_lp, J=2, T=7))}), Y, m, v)
    for a, b in ((got, want), (dm, want_dm), (dv, want_dv)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-12)


def test_engine_value_alone_builds_no_derivatives():
    """Without grad the engine returns the plain GH sum."""
    lik = tliks.Bernoulli()
    rng = np.random.RandomState(3)
    Y = torch.from_numpy(_observations("Bernoulli", rng, 10))
    m, v = (torch.from_numpy(a) for a in _moments(rng, 10, 1))
    with torch.no_grad():
        got = lik.var_exp(Y, m, v)
    assert not got.requires_grad
    nodes, w = tquad.tensor_grid(20, 1)
    F = m[:, None, :] + torch.sqrt(2 * v)[:, None, :] * torch.from_numpy(nodes)
    want = lik.logpdf(F, Y[:, None, :]) @ torch.from_numpy(w)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)


# kernel 6's multi-term families too (a y inside each support; the ZIP at
# y = 0 and y > 0)
@pytest.mark.parametrize("name,yval", [("Poisson", 7.0), ("Exponential", 3.0),
                                       ("Gamma", 4.0), ("Beta", 0.3),
                                       ("Binomial", 1.0), ("Dirichlet", 0.25),
                                       ("ZeroInflatedPoisson", 0.0),
                                       ("ZeroInflatedPoisson", 3.0)])
def test_analytic_finite_at_extreme_f32_moments(name, yval):
    """Mirror of the JAX package's regression: at m = +-200, v = 50 in
    float32 the closed forms and their moment-gradients stay finite (the
    [1e-9, 1e9] scale clips), where e^{m+v/2} alone overflows."""
    lik = getattr(tliks, name)()
    for mval in (-200.0, 200.0):
        m = np.full((4, lik.dim_f), mval, np.float32)
        v = np.full((4, lik.dim_f), 50.0, np.float32)
        Y = np.full((4, lik.dim_y), yval, np.float32)
        for arr in _port_var_exp(lik, Y, m, v):
            assert arr.dtype == np.float32
            assert np.isfinite(arr).all(), (name, mval, arr)


@pytest.mark.parametrize("name,yval", [("Gamma", 2.0), ("Poisson", 3.0),
                                       ("Exponential", 1.0), ("Beta", 0.3),
                                       ("Binomial", 1.0), ("Dirichlet", 0.25),
                                       ("ZeroInflatedPoisson", 0.0),
                                       ("ZeroInflatedPoisson", 3.0)])
def test_analytic_gradients_finite_at_v_zero(name, yval):
    """Mirror of the JAX package's regression: at v == 0 in float32 the
    values and both moment-gradients are finite (Gamma's gammaln sweep goes
    through the engine's Bonnet/Price backward, not autodiff through
    m + sqrt(2v) t, whose 1/sqrt(2v) is singular)."""
    lik = getattr(tliks, name)()
    m = np.full((3, lik.dim_f), 0.3, np.float32)
    v = np.zeros((3, lik.dim_f), np.float32)
    Y = np.full((3, lik.dim_y), yval, np.float32)
    for arr in _port_var_exp(lik, Y, m, v):
        assert np.isfinite(arr).all(), (name, arr)


# ---- the Monte-Carlo log-predictive density ---------------------------------

@pytest.mark.parametrize("reference_scaling", [True, False],
                         ids=["reference", "plain"])
@pytest.mark.parametrize("name", NAMES)
def test_log_predictive_matches_jax_on_injected_draws(name, reference_scaling):
    """``Likelihood.log_predictive`` with the same (N, S, J) draws on both
    sides, float64: the same logpdf values through the same logsumexp
    (rtol 1e-10), the reference's extra 1/S factor included or not."""
    jlik, tlik = getattr(jliks, name)(), getattr(tliks, name)()
    rng = np.random.RandomState(2)
    n, S = 25, 30
    Y = _observations(name, rng, n)
    m, v = _moments(rng, n, jlik.dim_f)
    eps = rng.randn(n, S, jlik.dim_f)
    want = jlik.log_predictive(None, jnp.asarray(Y), jnp.asarray(m),
                               jnp.asarray(v), S,
                               reference_scaling=reference_scaling, eps=eps)
    got = tlik.log_predictive(None, torch.from_numpy(Y), torch.from_numpy(m),
                              torch.from_numpy(v), S,
                              reference_scaling=reference_scaling, eps=eps)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    if reference_scaling:
        plain = tlik.log_predictive(None, torch.from_numpy(Y),
                                    torch.from_numpy(m), torch.from_numpy(v),
                                    S, reference_scaling=False, eps=eps)
        np.testing.assert_allclose(float(got) * S, float(plain), rtol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_log_predictive_f32_extremes_finite_where_jax_is(name):
    """float32 at m = +-50, v = 30, where the clipped likelihoods saturate
    and a row's logpdf may be -inf at every draw: the port is finite
    wherever the JAX package is, -inf where it is -inf, and never NaN
    unless the reference is."""
    jlik, tlik = getattr(jliks, name)(), getattr(tliks, name)()
    rng = np.random.RandomState(3)
    n, S = 8, 16
    Y = _observations(name, rng, n).astype(np.float32)
    m = np.repeat(np.where(np.arange(n) % 2, 50.0, -50.0)[:, None],
                  jlik.dim_f, 1).astype(np.float32)
    v = np.full_like(m, 30.0)
    eps = rng.randn(n, S, jlik.dim_f).astype(np.float32)
    want = float(jlik.log_predictive(None, jnp.asarray(Y), jnp.asarray(m),
                                     jnp.asarray(v), S, eps=eps))
    got = tlik.log_predictive(None, torch.from_numpy(Y), torch.from_numpy(m),
                              torch.from_numpy(v), S, eps=eps)
    assert got.dtype == torch.float32
    got = float(got)
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        assert got == want or (np.isnan(want) and np.isnan(got))


def test_log_predictive_needs_a_generator_or_draws():
    lik = tliks.Poisson()
    Y, m, v = torch.ones(4, 1), torch.zeros(4, 1), torch.ones(4, 1)
    with pytest.raises(ValueError, match="Generator"):
        lik.log_predictive(None, Y, m, v, 10)
    a = lik.log_predictive(torch.Generator().manual_seed(1), Y, m, v, 10)
    b = lik.log_predictive(torch.Generator().manual_seed(1), Y, m, v, 10)
    assert float(a) == float(b) and np.isfinite(float(a))


def test_grid_made_under_inference_mode_serves_autograd_later():
    """A prediction (inference mode) that is the first to ask for a GH grid
    must not leave an inference tensor in the cache: the trainer's
    ``var_exp`` saves the grid for its backward."""
    tquad._grid_tensors.cache_clear()
    lik = tliks.Bernoulli()
    rng = np.random.RandomState(0)
    m, v = (torch.from_numpy(a) for a in _moments(rng, 6, 1))
    with torch.inference_mode():
        lik.predictive(m, v)
    nodes, w = tquad._grid_tensors(lik.T_pred, 1, m.dtype, m.device)
    assert not nodes.is_inference() and not w.is_inference()
    Y = torch.from_numpy(_observations("Bernoulli", rng, 6))
    m.requires_grad_()
    v.requires_grad_()  # sqrt(2 v) * nodes saves the grid
    for g in torch.autograd.grad(lik.var_exp(Y, m, v).sum(), (m, v)):
        assert bool(torch.isfinite(g).all())
