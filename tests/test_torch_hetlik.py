"""``HetLikelihood`` and the samplers of the port, against the JAX package.

* ``generate_metadata``, ``num_output_functions`` and ``ismulti`` over all
  sixteen families: equal to the JAX package's, key for key.
* The per-task fan-outs against JAX's ``HetLikelihood`` on the same numpy
  inputs in float64: ``logpdf`` and ``pdf`` over the sixteen families,
  ``var_exp``, ``var_exp_derivatives`` and ``predictive`` over five of
  them (each family's own parity is ``tests/test_torch_families.py``'s):
  rtol 1e-10, dv normwise to 1e-8 where it holds the trigamma of lgamma
  of e^f (torch's float64 trigamma; see there).
* ``negative_log_predictive``: the sum of the tasks' ``log_predictive``
  with the generator's draws in task order, and within Monte-Carlo noise
  of the JAX package's at 4,000 draws.
* ``sample``/``samples``: the random streams differ from JAX's, so each
  family's sampler is held by the moments of 200,000 draws at a fixed f
  against its ``conditional_moments`` (for the label families, the class
  frequencies against the class probabilities), in the manner of
  ``tests/test_more_likelihoods.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu_torch import likelihoods as tliks

torch.set_num_threads(1)

SIXTEEN = [("Gaussian", {}), ("HetGaussian", {}), ("Bernoulli", {}),
           ("Binomial", {"n": 5}), ("Categorical", {"K": 4}), ("Beta", {}),
           ("Gamma", {}), ("Exponential", {}), ("LogNormal", {}),
           ("NegativeBinomial", {}), ("Poisson", {}), ("StudentT", {}),
           ("Ordinal", {"K": 4}), ("Dirichlet", {"K": 3}),
           ("Weibull", {}), ("ZeroInflatedPoisson", {})]
N = 20


def _observations(name, rng, n):
    return {
        "Gaussian": lambda: rng.randn(n, 1),
        "HetGaussian": lambda: rng.randn(n, 1),
        "Bernoulli": lambda: (rng.rand(n, 1) > 0.5).astype(float),
        "Binomial": lambda: rng.binomial(5, 0.4, (n, 1)).astype(float),
        "Categorical": lambda: rng.randint(1, 5, (n, 1)).astype(float),
        "Beta": lambda: np.clip(rng.beta(2.0, 3.0, (n, 1)), 1e-3, 1 - 1e-3),
        "Gamma": lambda: rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
        "Exponential": lambda: rng.exponential(1.0, (n, 1)) + 1e-3,
        "LogNormal": lambda: np.exp(rng.randn(n, 1)),
        "NegativeBinomial": lambda: rng.poisson(3.0, (n, 1)).astype(float),
        "Poisson": lambda: rng.poisson(3.0, (n, 1)).astype(float),
        "StudentT": lambda: rng.standard_t(4.0, (n, 1)),
        "Ordinal": lambda: rng.randint(1, 5, (n, 1)).astype(float),
        "Dirichlet": lambda: rng.dirichlet(np.ones(3), n),
        "Weibull": lambda: rng.weibull(1.5, (n, 1)) + 1e-3,
        "ZeroInflatedPoisson": lambda: (rng.poisson(2.0, (n, 1))
                                        * (rng.rand(n, 1) > 0.3)).astype(
                                            float),
    }[name]()


# the expensive fan-outs run over five families: a closed form, a theta
# family, a 2-D grid, the K-D Dirichlet reduction and a label family
FANOUT = [("Gaussian", {"learn_sigma": True}), ("NegativeBinomial", {}),
          ("ZeroInflatedPoisson", {}), ("Dirichlet", {"K": 3}),
          ("Ordinal", {"K": 4})]


def _pair(families=SIXTEEN):
    return (jliks.HetLikelihood([getattr(jliks, n)(**kw)
                                 for n, kw in families]),
            tliks.HetLikelihood([getattr(tliks, n)(**kw)
                                 for n, kw in families]))


def _inputs(jhl, seed=0, families=SIXTEEN):
    rng = np.random.RandomState(seed)
    Y = [_observations(n, rng, N) for n, _ in families]
    F = [1.2 * rng.randn(N, lik.dim_f) for lik in jhl.likelihoods_list]
    m = [0.7 * rng.randn(N, lik.dim_f) for lik in jhl.likelihoods_list]
    v = [0.01 + rng.rand(N, lik.dim_f) for lik in jhl.likelihoods_list]
    return Y, F, m, v


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_metadata_and_dimensions_match_jax():
    jhl, thl = _pair()
    want, got = jhl.generate_metadata(), thl.generate_metadata()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert thl.num_output_functions() == jhl.num_output_functions() == 25
    assert [thl.ismulti(t) for t in range(len(SIXTEEN))] == [
        jhl.ismulti(t) for t in range(len(SIXTEEN))]
    assert [lik.get_metadata() for lik in thl.likelihoods_list] == [
        lik.get_metadata() for lik in jhl.likelihoods_list]
    assert [lik.n_theta for lik in thl.likelihoods_list] == [
        lik.n_theta for lik in jhl.likelihoods_list]


def test_logpdf_and_pdf_fan_out_as_jax():
    jhl, thl = _pair()
    Y, F, _, _ = _inputs(jhl)
    # a 1-D Y is taken as a column, as JAX does
    Y1 = [y[:, 0] if y.shape[1] == 1 else y for y in Y]
    for fn in ("logpdf", "pdf"):
        want = getattr(jhl, fn)([jnp.asarray(f) for f in F],
                                [jnp.asarray(y) for y in Y1])
        got = getattr(thl, fn)(_t(F), _t(Y1))
        for t, (a, b) in enumerate(zip(got, want)):
            assert a.shape == (N,)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12, err_msg=f"{fn} {t}")


def test_var_exp_derivatives_and_predictive_fan_out_as_jax():
    jhl, thl = _pair(FANOUT)
    Y, _, m, v = _inputs(jhl, seed=1, families=FANOUT)
    ja = [[jnp.asarray(a) for a in arrs] for arrs in (Y, m, v)]
    ta = [_t(arrs) for arrs in (Y, m, v)]

    @jax.jit
    def ref(Y, m, v):
        return (jhl.var_exp(Y, m, v), jhl.var_exp_derivatives(Y, m, v),
                jhl.predictive(m, v))

    want_ve, want_d, want_p = ref(*ja)
    for a, b in zip(thl.var_exp(*ta), want_ve):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    got, want = thl.var_exp_derivatives(*ta), want_d
    for which in (0, 1):
        for t, (a, b) in enumerate(zip(got[which], want[which])):
            a, b = a.numpy(), np.asarray(b)
            if which == 1 and FANOUT[t][0] == "Dirichlet":
                assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-8
            else:
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                           err_msg=f"{which} {t}")
    got, want = thl.predictive(*ta[1:]), want_p
    for which in (0, 1):
        for a, b in zip(got[which], want[which]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12)


def test_negative_log_predictive_sums_the_tasks_draws():
    jhl, thl = _pair(FANOUT)
    Y, _, m, v = _inputs(jhl, seed=2, families=FANOUT)
    S = 4000
    got = thl.negative_log_predictive(torch.Generator().manual_seed(3),
                                      _t(Y), _t(m), _t(v), num_samples=S)
    gen = torch.Generator().manual_seed(3)
    parts = [lik.log_predictive(gen, y, a, b, S) for lik, y, a, b in
             zip(thl.likelihoods_list, _t(Y), _t(m), _t(v))]
    assert float(got) == float(-sum(parts))
    want = jax.jit(lambda *a: jhl.negative_log_predictive(*a, num_samples=S))(
        jax.random.PRNGKey(0), [jnp.asarray(y) for y in Y],
        [jnp.asarray(a) for a in m], [jnp.asarray(a) for a in v])
    # two Monte-Carlo estimates of the same density, 4,000 draws each
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)
    with pytest.raises(ValueError, match="Generator"):
        thl.negative_log_predictive(None, _t(Y), _t(m), _t(v), 10)


# families whose draws are 1-indexed labels: compare class frequencies
LABELS = ("Categorical", "Ordinal")
# the sampling test takes StudentT at df = 8 (a finite fourth moment, so
# the sample variance settles); the rest as in SIXTEEN
SAMPLED = [("StudentT", {"df": 8.0}) if n == "StudentT" else (n, kw)
           for n, kw in SIXTEEN]


@pytest.mark.parametrize("name,kw", SAMPLED, ids=[n for n, _ in SAMPLED])
def test_sampler_moments_match_conditional_moments(name, kw):
    lik = getattr(tliks, name)(**kw)
    draws = 200_000
    F = torch.full((draws, lik.dim_f), 0.4, dtype=torch.float64)
    s = lik.sample(torch.Generator().manual_seed(0), F)
    assert s.shape == (draws, lik.dim_y) and s.dtype == torch.float64
    s = s.numpy()
    if name in LABELS:
        # the class probabilities are the density of each label
        K = lik.K
        labels = torch.arange(1, K + 1, dtype=torch.float64)[:, None]
        probs = torch.exp(lik.logpdf(F[:K], labels)).numpy()
        np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-6)
        freq = (s == np.arange(1, K + 1)).mean(0)
        np.testing.assert_allclose(freq, probs, atol=5e-3)
        return
    cm, cv = (a[0].numpy() for a in lik.conditional_moments(F[:1]))
    np.testing.assert_allclose(s.mean(0), cm, rtol=0.04, atol=0.01)
    np.testing.assert_allclose(s.var(0), cv, rtol=0.06, atol=0.01)


def test_samples_fan_out_one_generator_over_the_tasks():
    _, thl = _pair()
    rng = np.random.RandomState(4)
    F = [torch.from_numpy(0.3 * rng.randn(50, lik.dim_f))
         for lik in thl.likelihoods_list]
    a = thl.samples(torch.Generator().manual_seed(9), F)
    gen = torch.Generator().manual_seed(9)
    b = [lik.sample(gen, f) for lik, f in zip(thl.likelihoods_list, F)]
    for x, y, lik in zip(a, b, thl.likelihoods_list):
        assert x.shape == (50, lik.dim_y)
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="Generator"):
        thl.samples(None, F)
