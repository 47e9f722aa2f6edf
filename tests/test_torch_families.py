"""The ten likelihood families the port added, and the quasi-MC mode of
Categorical, against the JAX package on the same numpy inputs.

Per family and mode (``analytic=`` both ways where the JAX class has it,
``mc_samples`` where it takes quasi-MC nodes): ``logpdf`` and
``conditional_moments`` at random f, ``var_exp`` with its engine (dm, dv),
``predictive``, and ``log_predictive`` on injected draws, in float64.

Tolerances: rtol 1e-10 (atol 1e-12), as for the six serving families
(``tests/test_torch_likelihoods.py``): the same closed forms, the same GH
and quasi-MC nodes, summed in another order.  Beta's and Dirichlet's
dv = 1/2 E[d2 logp] hold the second derivative of lgamma of e^f, where
torch's float64 trigamma is good to about 5e-10 relative (JAX's to 2e-16)
and the lgamma terms cancel: dv is held normwise (max |a - b| / max |b|)
to 1e-8 there.

Float32 at extreme moments (ROADMAP.md queue 3, hazards): the closed forms
stay finite with finite gradients at m = +-200, v = 50 and at v = 0, and
the port in float32 agrees with the JAX package in float32 where the JAX
package in float64 shows the float32 answer is itself off (Dirichlet's
cancelling lgamma terms, Ordinal's differences of saturated sigmoids).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu_torch import likelihoods as tliks

torch.set_num_threads(1)

CASES = [
    ("Gaussian", {"sigma": 0.7}),
    ("LogNormal", {"sigma": 0.4}),
    ("Binomial", {"n": 5}),
    ("ZeroInflatedPoisson", {}),
    ("Beta", {}), ("Beta", {"analytic": False}),
    ("Dirichlet", {}), ("Dirichlet", {"analytic": False}),
    ("Dirichlet", {"K": 2}), ("Dirichlet", {"mc_samples": 32}),
    ("NegativeBinomial", {"r": 3.0}),
    ("StudentT", {}), ("StudentT", {"analytic": False}),
    ("Weibull", {}), ("Weibull", {"analytic": False}),
    ("Ordinal", {"K": 4}), ("Ordinal", {"K": 3, "thresholds": (-0.5, 0.8)}),
    ("Categorical", {"mc_samples": 64}),
    ("Categorical", {"K": 5, "mc_samples": 33}),
]
IDS = [n + "".join(f"-{k}={v}" for k, v in kw.items()) for n, kw in CASES]
TRIGAMMA = ("Beta", "Dirichlet")  # dv through lgamma of e^f


def observations(name, lik, rng, n):
    """n observations of the family's support, (n, dim_y)."""
    return {
        "Gaussian": lambda: rng.randn(n, 1),
        "LogNormal": lambda: np.exp(rng.randn(n, 1)),
        "Binomial": lambda: rng.binomial(getattr(lik, "n", 1), 0.4,
                                         (n, 1)).astype(float),
        "ZeroInflatedPoisson": lambda: (rng.poisson(2.0, (n, 1))
                                        * (rng.rand(n, 1) > 0.3)).astype(
                                            float),
        "Beta": lambda: np.clip(rng.beta(2.0, 3.0, (n, 1)), 1e-3, 1 - 1e-3),
        "Dirichlet": lambda: rng.dirichlet(np.ones(lik.dim_y), n),
        "NegativeBinomial": lambda: rng.poisson(3.0, (n, 1)).astype(float),
        "StudentT": lambda: rng.standard_t(4.0, (n, 1)),
        "Weibull": lambda: rng.weibull(1.5, (n, 1)) + 1e-3,
        "Ordinal": lambda: rng.randint(1, lik.K + 1, (n, 1)).astype(float),
        "Categorical": lambda: rng.randint(1, lik.K + 1, (n, 1)).astype(
            float),
    }[name]()


def moments(rng, n, j):
    return 0.7 * rng.randn(n, j), 0.01 + rng.rand(n, j)


def normwise(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _pair(name, kw):
    return getattr(jliks, name)(**kw), getattr(tliks, name)(**kw)


def _jax_var_exp_and_vjp(lik, Y, m, v):
    @jax.jit
    def ref(Y, m, v):
        val, vjp = jax.vjp(lambda a, b: lik.var_exp(Y, a, b), m, v)
        return (val,) + vjp(jnp.ones_like(val))

    return [np.asarray(a) for a in ref(*(jnp.asarray(x) for x in (Y, m, v)))]


def _port_var_exp_and_grads(lik, Y, m, v, dtype=torch.float64):
    M = torch.tensor(m, dtype=dtype, requires_grad=True)
    V = torch.tensor(v, dtype=dtype, requires_grad=True)
    val = lik.var_exp(torch.tensor(Y, dtype=dtype), M, V)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    return [a.detach().numpy() for a in (val, dm, dv)]


N, S = 25, 16


@functools.lru_cache(maxsize=None)
def _case(i):
    """Case i's numpy inputs and the JAX package's outputs on them, from
    one jitted program (one compile a case, shared by the tests below):
    var_exp with its (dm, dv), logpdf and conditional_moments at F,
    predictive, and log_predictive with and without the reference's
    1/S factor on injected draws."""
    name, kw = CASES[i]
    lik = getattr(jliks, name)(**kw)
    rng = np.random.RandomState(i)
    x = dict(Y=observations(name, lik, rng, N),
             F=1.5 * rng.randn(N, lik.dim_f),
             eps=rng.randn(N, S, lik.dim_f))
    x["m"], x["v"] = moments(rng, N, lik.dim_f)

    @jax.jit
    def ref(Y, F, eps, m, v):
        val, vjp = jax.vjp(lambda a, b: lik.var_exp(Y, a, b), m, v)
        dm, dv = vjp(jnp.ones_like(val))
        lp = [lik.log_predictive(None, Y, m, v, S, reference_scaling=r,
                                 eps=eps) for r in (True, False)]
        return dict(ve=val, dm=dm, dv=dv, logpdf=jax.vmap(lik.logpdf)(F, Y),
                    cm=jax.vmap(lik.conditional_moments)(F),
                    pred=lik.predictive(m, v), log_pred=lp)

    out = jax.tree_util.tree_map(np.asarray, ref(**{
        k: jnp.asarray(a) for k, a in x.items()}))
    return x, out


def _inputs(x, *keys):
    return [torch.from_numpy(x[k]) for k in keys]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_var_exp_and_derivatives_match_jax_f64(i):
    name, kw = CASES[i]
    tlik = getattr(tliks, name)(**kw)
    x, want = _case(i)
    got, dm, dv = _port_var_exp_and_grads(tlik, x["Y"], x["m"], x["v"])
    np.testing.assert_allclose(got, want["ve"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dm, want["dm"], rtol=1e-10, atol=1e-12)
    if name in TRIGAMMA:
        assert normwise(dv, want["dv"]) < 1e-8
    else:
        np.testing.assert_allclose(dv, want["dv"], rtol=1e-10, atol=1e-12)
    # var_exp_derivatives is the same gradient
    for a, b in zip(tlik.var_exp_derivatives(*_inputs(x, "Y", "m", "v")),
                    (dm, dv)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_logpdf_moments_and_predictive_match_jax_f64(i):
    name, kw = CASES[i]
    tlik = getattr(tliks, name)(**kw)
    x, want = _case(i)
    F, Y, m, v = _inputs(x, "F", "Y", "m", "v")
    got = [tlik.logpdf(F, Y), *tlik.conditional_moments(F),
           *tlik.predictive(m, v)]
    for a, b in zip(got, [want["logpdf"], *want["cm"], *want["pred"]]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_log_predictive_matches_jax_on_injected_draws(i):
    name, kw = CASES[i]
    tlik = getattr(tliks, name)(**kw)
    x, want = _case(i)
    Y, m, v = _inputs(x, "Y", "m", "v")
    for scaling, b in zip((True, False), want["log_pred"]):
        got = tlik.log_predictive(None, Y, m, v, S,
                                  reference_scaling=scaling, eps=x["eps"])
        np.testing.assert_allclose(float(got), float(b), rtol=1e-10)


def test_student_t_predictive_is_infinite_at_df_two_or_less():
    m = torch.zeros(3, 2, dtype=torch.float64)
    v = torch.ones(3, 2, dtype=torch.float64)
    for df in (1.5, 2.0):
        mean, var = tliks.StudentT(df=df).predictive(m, v)
        assert torch.isinf(var).all() and torch.equal(mean, m[:, :1])
        assert torch.isinf(tliks.StudentT(df=df).conditional_moments(m)[1]
                           ).all()
    _, var = tliks.StudentT(df=2.5).predictive(m, v)
    assert torch.isfinite(var).all()


def test_constructors_refuse_what_the_jax_ones_refuse():
    for make, match in ((lambda: tliks.Binomial(n=0), "positive integer"),
                        (lambda: tliks.Binomial(n=2.5), "positive integer"),
                        (lambda: tliks.Weibull(k=0.0), "k must be"),
                        (lambda: tliks.NegativeBinomial(r=-1.0), "r must be"),
                        (lambda: tliks.LogNormal(sigma=0.0), "sigma must be"),
                        (lambda: tliks.Categorical(K=7), "mc_samples"),
                        (lambda: tliks.Categorical(K=1), "K >= 2")):
        with pytest.raises(ValueError, match=match):
            make()
    tliks.Categorical(K=7, mc_samples=64)  # the escape the message names


def test_special_cases_reduce_to_the_bench_families():
    """Binomial(n=1) is the Bernoulli and Weibull(k=1) the Exponential, as
    in the JAX package."""
    rng = np.random.RandomState(4)
    F = torch.from_numpy(2.0 * rng.randn(13, 1))
    m, v = (torch.from_numpy(a) for a in moments(rng, 13, 1))
    Yb = torch.from_numpy((rng.rand(13, 1) > 0.5).astype(float))
    Ye = torch.from_numpy(rng.exponential(1.0, (13, 1)) + 1e-3)
    pairs = ((tliks.Binomial(n=1), tliks.Bernoulli(), Yb),
             (tliks.Weibull(k=1.0), tliks.Exponential(), Ye))
    for a, b, Y in pairs:
        torch.testing.assert_close(a.logpdf(F, Y), b.logpdf(F, Y),
                                   rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(a.var_exp(Y, m, v), b.var_exp(Y, m, v),
                                   rtol=1e-10, atol=1e-10)


# ---- float32 hazards --------------------------------------------------------

# the new closed forms of var_exp, and a y in each family's support
CLOSED = [("Gaussian", {}, 0.4), ("LogNormal", {}, 1.5), ("Weibull", {}, 1.2),
          ("Beta", {}, 0.3), ("Dirichlet", {}, None)]


def _y(lik, yval, n):
    if yval is None:  # a point inside the simplex
        return np.full((n, lik.dim_y), 1.0 / lik.dim_y, np.float32)
    return np.full((n, lik.dim_y), yval, np.float32)


@pytest.mark.parametrize("name,kw,yval", CLOSED,
                         ids=[c[0] for c in CLOSED])
def test_closed_forms_finite_at_extreme_f32_moments(name, kw, yval):
    """Mirror of the JAX package's regression for the bench families: at
    m = +-200, v = 50 in float32 the closed forms and their moment
    gradients stay finite (the [1e-9, 1e9] clips of the expectations)."""
    lik = getattr(tliks, name)(**kw)
    for mval in (-200.0, 200.0):
        m = np.full((4, lik.dim_f), mval, np.float32)
        v = np.full((4, lik.dim_f), 50.0, np.float32)
        for arr in _port_var_exp_and_grads(lik, _y(lik, yval, 4), m, v,
                                           torch.float32):
            assert arr.dtype == np.float32
            assert np.isfinite(arr).all(), (name, mval, arr)


@pytest.mark.parametrize("name,kw,yval", CLOSED,
                         ids=[c[0] for c in CLOSED])
def test_closed_form_gradients_finite_at_v_zero(name, kw, yval):
    """At v == 0 in float32 the values and both gradients are finite: the
    lgamma sweeps of Beta and Dirichlet go through the engine's
    Bonnet/Price backward, not through m + sqrt(2 v) t."""
    lik = getattr(tliks, name)(**kw)
    m = np.full((3, lik.dim_f), 0.3, np.float32)
    v = np.zeros((3, lik.dim_f), np.float32)
    for arr in _port_var_exp_and_grads(lik, _y(lik, yval, 3), m, v,
                                       torch.float32):
        assert np.isfinite(arr).all(), (name, arr)


# the families of the hazard list, at extreme moments: a y in the support
EXTREME = [("Ordinal", {"K": 4}, 2.0), ("StudentT", {}, 0.5),
           ("ZeroInflatedPoisson", {}, 3.0), ("NegativeBinomial", {}, 3.0),
           ("Binomial", {"n": 5}, 2.0), ("LogNormal", {}, 1.5),
           ("Dirichlet", {}, None), ("Beta", {"analytic": False}, 0.3),
           ("Bernoulli", {}, 1.0),
           # the flagship's families that kernel 6 sweeps or that had no
           # such test: Categorical's 2-D grid, Gamma on its 2-D grid and in
           # its closed form (the lngamma sweep), HetGaussian's closed form
           ("Categorical", {"K": 3}, 2.0), ("Gamma", {"analytic": False}, 1.5),
           ("Gamma", {}, 1.5), ("HetGaussian", {}, 0.4)]
EXTREME_IDS = [name + ("-grid" if name == "Gamma" and kw else "")
               for name, kw, _ in EXTREME]
# kernel 6's multi-term families as its task table takes them: Beta's
# closed form, Binomial at the ten-family model's n, Dirichlet at K = 2, the
# ZIP at y = 0
EXTREME_TABLE = [("Beta", {}, 0.3), ("Binomial", {"n": 10}, 4.0),
                 ("Dirichlet", {"K": 2}, None),
                 ("ZeroInflatedPoisson", {}, 0.0)]
EXTREME += EXTREME_TABLE
EXTREME_IDS += [name + "-table" for name, _, _ in EXTREME_TABLE]
EXTREME_MV = ((-200.0, 50.0), (200.0, 50.0), (-20.0, 5.0), (20.0, 5.0))
# (family, m, output): where float32 itself is off against float64, by the
# formula the two packages share, so that neither package is right there
F32_OFF = {
    # E[lgamma(sum a)] - sum E[lgamma(a_k)] cancels terms of ~1e10
    ("Dirichlet", 200.0, "value"): "cancellation",
    # P(y = 2) is the difference of two sigmoids that both round to 1
    ("Ordinal", -20.0, "value"): "saturated sigmoids",
    ("Ordinal", -20.0, "dm"): "saturated sigmoids",
    # at a clipped scale of 1e-9 the f1-curvature is a sum of node terms
    # of alternating sign, ~1e-5 of their size
    ("StudentT", -200.0, "dv"): "cancellation",
    # safe_exp clips e^f at e^87.7 in float32 (e^708.8 in float64): every
    # node of m = 200, v = 50 clips, so p = (1/2, 1/2, 0) and the
    # derivatives vanish, where float64 still tells the classes apart
    ("Categorical", 200.0, "value"): "safe_exp's float32 clip",
    ("Categorical", 200.0, "dm"): "safe_exp's float32 clip",
    ("Categorical", 200.0, "dv"): "safe_exp's float32 clip",
}


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-4)


@pytest.mark.parametrize("name,kw,yval", EXTREME, ids=EXTREME_IDS)
def test_f32_at_extreme_moments_against_jax(name, kw, yval):
    """The port in float32 against the JAX package in float64, value and
    (dm, dv), at m = +-200, v = 50 and m = +-20, v = 5: finite everywhere,
    and within 1e-3 normwise per output (over a floor of 1e-4, the float32
    noise of the node sums) except where ``F32_OFF`` names a shared
    float32 failure, and there the JAX package in float32 is off by more
    than that too."""
    jlik, tlik = _pair(name, kw)
    m = np.repeat(np.array([mv[0] for mv in EXTREME_MV], np.float32), 2)
    v = np.repeat(np.array([mv[1] for mv in EXTREME_MV], np.float32), 2)
    m = np.repeat(m[:, None], jlik.dim_f, 1)
    v = np.repeat(v[:, None], jlik.dim_f, 1)
    Y = _y(jlik, yval, m.shape[0])
    ref = _jax_var_exp_and_vjp(jlik, *(a.astype(np.float64)
                                       for a in (Y, m, v)))
    ref32 = _jax_var_exp_and_vjp(jlik, Y, m, v)
    got = _port_var_exp_and_grads(tlik, Y, m, v, torch.float32)
    for i, (mval, _) in enumerate(EXTREME_MV):
        rows = slice(2 * i, 2 * i + 2)
        for what, a, b, b32 in zip(("value", "dm", "dv"), got, ref, ref32):
            a, b, b32 = a[rows], b[rows], b32[rows]
            assert np.isfinite(a).all(), (name, mval, what, a)
            if (name, mval, what) in F32_OFF:
                assert _rel(b32, b) > 1e-3, (name, mval, what, b32, b)
            else:
                assert _rel(a, b) < 1e-3, (name, mval, what, a, b)
