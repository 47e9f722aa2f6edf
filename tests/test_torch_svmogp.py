"""The port's ``SVMOGP`` class against the JAX package's, on the CPU, in
float64, at the same parameters.

* Every method against the JAX class: ``log_likelihood`` (rtol 1e-10),
  the latent and output moments, full covariances, the projected and
  stochastic predictions and the observation-space predictive (normwise
  1e-8, the prediction API's tolerance in ``tests/test_torch_predict.py``),
  ``fit_svi`` (histories 1e-8, as ``tests/test_torch_vem.py``), NLPD
  (the same function as the port's ``negative_log_predictive`` on the same
  generator, bitwise; JAX's draws differ, so against it within the Monte
  Carlo error, 2% at 4,000 samples).
* The constructor's validation messages, ``save``/``load`` across both
  packages and the bare-checkpoint error, ``fit_svi_on_device`` with a
  checkpoint directory and a resume, the plots under matplotlib's Agg
  backend, and the package's ``__all__``.
"""

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import hetmogp_tpu as jhet  # noqa: E402
from hetmogp_tpu import checkpoint as jckpt  # noqa: E402

import hetmogp_tpu_torch as tp  # noqa: E402
from hetmogp_tpu_torch.models import predict as tpredict  # noqa: E402
from hetmogp_tpu_torch.models.params import leaves  # noqa: E402

torch.set_num_threads(1)

Q, M, DX = 2, 8, 2
SIZES = (30, 25, 20)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = [rng.rand(n, DX) for n in SIZES]
    Y = [rng.randn(SIZES[0], 1), (rng.rand(SIZES[1], 1) > 0.5) * 1.0,
         rng.randint(1, 4, (SIZES[2], 1)) * 1.0]
    return X, Y, rng.rand(M, DX)


def _models(**cfg_kw):
    X, Y, Z = _data()
    jcfg = jhet.ModelConfig(likelihoods=(jhet.HetGaussian(), jhet.Bernoulli(),
                                         jhet.Categorical(K=3)),
                            num_latent=Q, num_inducing=M, input_dim=DX,
                            dtype="float64", jitter=1e-6, **cfg_kw)
    jm = jhet.SVMOGP(jcfg, X, Y, Z, key=jax.random.PRNGKey(1),
                     lengthscale=0.3, variance=0.8)
    tcfg = tp.ModelConfig.from_dict(jcfg.to_dict())
    tm = tp.SVMOGP(tcfg, X, Y, None, params=tp.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu"))
    return jm, tm, X, Y


def _normwise(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


@pytest.fixture(scope="module")
def models():
    return _models()


def test_log_likelihood_and_accessors(models):
    jm, tm, _, _ = models
    np.testing.assert_allclose(tm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-10)
    assert tm.num_inducing == jm.num_inducing == M
    assert tm.num_latent_funcs == jm.num_latent_funcs == Q
    assert tm.num_output_funcs == jm.num_output_funcs == 5
    for k, v in jm.Y_metadata.items():
        np.testing.assert_array_equal(tm.Y_metadata[k], v)


def test_prediction_methods_match_jax(models):
    jm, tm, X, _ = models
    Xn = np.random.RandomState(5).rand(11, DX)
    pairs = [
        (tm.predict_u(Xn), jm.predict_u(Xn)),
        (tm.predict_u(Xn, 1, full_cov=True), jm.predict_u(Xn, 1,
                                                          full_cov=True)),
        (tm.predictive_new(Xn, 3), jm.predictive_new(Xn, 3)),
        (tm.predictive_new(Xn, 2, full_cov=True),
         jm.predictive_new(Xn, 2, full_cov=True)),
        (tm.predict_f_projected(Xn, 1), jm.predict_f_projected(Xn, 1)),
        (tm.predict_f_stochastic(Xn, 0, Xanchor_list=[x[:12] for x in X]),
         jm.predict_f_stochastic(Xn, 0, Xanchor_list=[x[:12] for x in X])),
    ]
    for i, (got, want) in enumerate(pairs):
        for a, b in zip(got, want):
            assert np.shape(a) == np.shape(b), i
            assert _normwise(a, b) < 1e-8, (i, _normwise(a, b))
    for (a_m, a_v), (b_m, b_v) in zip(tm.predict_f_tasks(X),
                                      jm.predict_f_tasks(X)):
        assert _normwise(a_m, b_m) < 1e-8 and _normwise(a_v, b_v) < 1e-8
    for projected in (False, True):
        got, want = (m.predictive([Xn] * 3, projected=projected)
                     for m in (tm, jm))
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert _normwise(a, b) < 1e-8, projected


def test_samples_and_nlpd(models):
    jm, tm, X, Y = models
    Xn = np.random.RandomState(6).rand(9, DX)
    s = tm.sample_f(Xn, 2, num_samples=3,
                    generator=torch.Generator().manual_seed(4))
    want = tpredict.sample_f(tm.params, tm.config,
                             torch.Generator().manual_seed(4), Xn, 2, 3)
    np.testing.assert_array_equal(s, want.numpy())
    assert s.shape == (3, 9)
    Xt, Yt = [x[:10] for x in X], [y[:10] for y in Y]
    got = tm.negative_log_predictive(Xt, Yt, num_samples=4000,
                                     generator=torch.Generator().manual_seed(
                                         2))
    same = tpredict.negative_log_predictive(
        tm.params, tm.config, torch.Generator().manual_seed(2), Xt, Yt, 4000)
    assert got == float(same)
    ref = jm.negative_log_predictive(Xt, Yt, num_samples=4000,
                                     key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(got, ref, rtol=2e-2)
    one = tm.negative_log_predictive([Xt[1]], [Yt[1]], num_samples=50,
                                     tasks=[1])
    assert np.isfinite(one)


def test_fit_svi_matches_jax():
    jm, tm, _, _ = _models()
    kw = dict(optimizer="adam", step_rate=0.02, seed=3)
    jm.fit_svi(12, 15, train_config=jhet.TrainConfig(**kw))
    tm.fit_svi(12, 15, train_config=tp.TrainConfig(**kw))
    np.testing.assert_allclose(tm.elbo_history, jm.elbo_history, rtol=1e-8)
    for (_, a), b in zip(leaves(tm.params),
                         jax.tree_util.tree_leaves(jm.params)):
        assert _normwise(a, b) < 1e-8 or not np.any(np.asarray(b))


def test_fit_vem_and_fit_svi_on_device_with_a_resume(tmp_path):
    _, tm, X, Y = _models(adaptive_jitter=False)
    e0 = tm.log_likelihood()
    tm.fit_vem(tp.TrainConfig(batch_inner_iters=5), vem_iters=1)
    assert tm.elbo_history.shape == (2,) and tm.log_likelihood() > e0
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.01, minibatch="slice")
    kw = dict(train_config=tc, steps_per_call=5, checkpoint_every=5)
    start = tm.params
    whole = tp.SVMOGP(tm.config, X, Y, None, params=start)
    whole.fit_svi_on_device(10, 20, checkpoint_dir=tmp_path / "a", **kw)
    cut = tp.SVMOGP(tm.config, X, Y, None, params=start)
    cut.fit_svi_on_device(10, 10, checkpoint_dir=tmp_path / "b", **kw)
    resumed = tp.SVMOGP(tm.config, X, Y, None, params=start)
    resumed.fit_svi_on_device(10, 20, checkpoint_dir=tmp_path / "b",
                              resume=True, **kw)
    np.testing.assert_array_equal(
        np.concatenate([cut.elbo_history, resumed.elbo_history]),
        whole.elbo_history)
    for (_, a), (_, b) in zip(leaves(whole.params), leaves(resumed.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what,make,match", [
    ("tasks", lambda X, Y: (X[:2], Y), "one per task"),
    ("columns", lambda X, Y: ([X[0][:, :1]] + X[1:], Y), "input_dim=2"),
    ("rows", lambda X, Y: (X, [Y[0][:5]] + Y[1:]), "but Y has 5"),
    ("dim_y", lambda X, Y: (X, [np.hstack([Y[0], Y[0]])] + Y[1:]),
     "expects dim_y=1"),
])
def test_constructor_validation_matches_jax(what, make, match):
    X, Y, Z = _data()
    cfg = jhet.ModelConfig(likelihoods=(jhet.HetGaussian(), jhet.Bernoulli(),
                                        jhet.Categorical(K=3)),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype="float64")
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    Xb, Yb = make(X, Y)
    with pytest.raises(ValueError) as jerr:
        jhet.SVMOGP(cfg, Xb, Yb, Z)
    with pytest.raises(ValueError, match=match) as terr:
        tp.SVMOGP(tcfg, Xb, Yb, Z, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_save_and_load_across_packages(tmp_path):
    jm, tm, X, Y = _models()
    tm.save(tmp_path / "port")
    back = tp.SVMOGP.load(tmp_path / "port", X, Y, device="cpu")
    assert back.config == tm.config
    for (_, a), (_, b) in zip(leaves(back.params), leaves(tm.params)):
        assert torch.equal(a, b)
    assert back.log_likelihood() == tm.log_likelihood()
    jback = jhet.SVMOGP.load(tmp_path / "port", X, Y)
    np.testing.assert_allclose(jback.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-12)
    jm.save(tmp_path / "jax")
    tback = tp.SVMOGP.load(tmp_path / "jax", X, Y, device="cpu")
    np.testing.assert_allclose(tback.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-10)
    tp.save_checkpoint(tmp_path / "bare", tm.params)
    with pytest.raises(ValueError, match="bare params checkpoint"):
        tp.SVMOGP.load(tmp_path / "bare", X, Y, device="cpu")
    jckpt.save_checkpoint(tmp_path / "jbare", jm.params)
    with pytest.raises(ValueError, match="bare params checkpoint"):
        tp.SVMOGP.load(tmp_path / "jbare", X, Y, device="cpu")


def test_save_and_load_with_theta(tmp_path):
    X, Y, Z = _data()
    cfg = tp.ModelConfig(likelihoods=(tp.Gaussian(), tp.Ordinal(K=3),
                                      tp.Bernoulli()),
                         num_latent=Q, num_inducing=M, input_dim=DX,
                         dtype="float64")
    X, Y = [X[0], X[2], X[1]], [Y[0], Y[2] - 1.0, Y[1]]
    m = tp.SVMOGP(cfg, X, Y, Z, seed=2, device="cpu")
    m._ensure_lik_theta(tp.TrainConfig(learn_lik_params=True))
    assert m.params.lik_theta is not None
    m.save(tmp_path / "theta.npz")
    back = tp.SVMOGP.load(tmp_path / "theta.npz", X, Y, device="cpu")
    for (_, a), (_, b) in zip(leaves(back.params), leaves(m.params)):
        assert torch.equal(a, b)
    assert back.pred_config is back.pred_config


def test_plots_smoke():
    import matplotlib.pyplot as plt

    _, tm, X, _ = _models()
    for median in (False, True):
        assert len(tm.plot_u(num_points=10, median=median).lines) >= 2
        assert len(tm.plot_f(num_points=10, median=median).lines) >= 2
    ax = tm.plot_pred([x[:7] for x in X], task=1)
    assert len(ax.lines) >= 4
    plt.close("all")


def test_all_resolves_and_covers_the_jax_package():
    for name in tp.__all__:
        assert getattr(tp, name) is not None, name
    assert set(jhet.__all__) <= set(tp.__all__)
