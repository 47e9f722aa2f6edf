"""The port's prediction API against the JAX package's, entry by entry, on
the same numpy inputs: latent u and f (marginal and full covariance), the
projected and stochastic predictions, the observation-space predictive on
both paths, NLPD with injected draws, and correlated samples.

Small models on the CPU (Q=2, M=12, up to 40 rows), whitened and
un-whitened, in both dtypes.  Tolerances, normwise (max|a - b| / max|b|):

* float64, 1e-8: both packages factorize Kuu (jitter 1e-4, cond ~1e5) and
  solve against it; their rounding differs by about cond * eps;
* float32, 2e-2: the same algebra at eps = 6e-8 loses cond * eps ~ 1e-2 in
  the solves, and the variances' cancellation (kdiag + quad - |P|^2) a
  little more.  Both sides are equally far from float64 there: the bound
  says that the port is no worse conditioned than the reference, and a
  wrong term (a missing kappa, a transposed solve) is off by order one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models import predict as jpredict
from hetmogp_tpu.models.params import SVMOGPParams as JParams

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.ops import cuda_kernels, linalg

torch.set_num_threads(1)

Q, M, DX, N, NS = 2, 12, 2, 30, 17
LIK_NAMES = ("HetGaussian", "Bernoulli", "Poisson")
TOL = {"float64": 1e-8, "float32": 2e-2}


def _model(whiten, dtype, kappa=0.0):
    liks = tuple(getattr(jliks, n)() for n in LIK_NAMES)
    cfg = jhet.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                           input_dim=DX, dtype=dtype, jitter=1e-4,
                           adaptive_jitter=False, whiten=whiten, ard=True)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    q_sqrt = 0.5 * np.eye(M) + 0.05 * np.tril(rng.randn(Q, M, M))
    leaves = dict(Z=rng.rand(Q, M, DX), q_mu=0.3 * rng.randn(Q, M),
                  q_sqrt=q_sqrt,
                  log_lengthscale=np.log(0.3 + 0.2 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.full((Q, D), kappa))
    np_dtype = np.dtype(dtype)
    jparams = JParams(**{k: jnp.asarray(v, np_dtype)
                         for k, v in leaves.items()})
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    X_list = [rng.rand(N, DX) for _ in LIK_NAMES]
    Xs = rng.rand(NS, DX)
    return cfg, jparams, tcfg, tparams, X_list, Xs


@pytest.fixture(scope="module",
                params=[(w, d) for w in (True, False)
                        for d in ("float64", "float32")],
                ids=lambda p: f"{'whiten' if p[0] else 'unwhiten'}-{p[1]}")
def model(request):
    whiten, dtype = request.param
    return (*_model(whiten, dtype), TOL[dtype])


def _close(got, want, tol):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def test_predict_latent_u_matches_jax(model):
    cfg, jp, tcfg, tpar, _, Xs, tol = model
    for kw in (dict(), dict(latent_ind=1), dict(full_cov=True),
               dict(full_cov=True, latent_ind=0)):
        want = jpredict.predict_latent_u(jp, cfg, Xs, **kw)
        got = tp.predict_latent_u(tpar, tcfg, Xs, **kw)
        for g, w in zip(got, want):
            assert g.dtype == tcfg.torch_dtype
            _close(g, w, tol)


def test_predict_f_matches_jax(model):
    cfg, jp, tcfg, tpar, _, Xs, tol = model
    for d in (1, cfg.num_output_functions - 1):
        for full_cov in (False, True):
            want = jpredict.predict_f(jp, cfg, Xs, d, full_cov=full_cov)
            got = tp.predict_f(tpar, tcfg, Xs, d, full_cov=full_cov)
            for g, w in zip(got, want):
                _close(g, w, tol)


def test_full_cov_diagonal_is_the_marginal_variance(model):
    _, _, tcfg, tpar, _, Xs, tol = model
    mean, var = tp.predict_latent_u(tpar, tcfg, Xs)
    mean_f, cov = tp.predict_latent_u(tpar, tcfg, Xs, full_cov=True)
    _close(mean_f, mean.numpy(), tol)
    _close(torch.diagonal(cov, dim1=-2, dim2=-1).mT, var.numpy(), tol)
    # symmetric to rounding (the un-whitened A Kuf term is a product of
    # two different matrices)
    _close(cov, cov.mT.numpy(), tol * 1e-4)


@pytest.mark.parametrize("whiten", [True, False], ids=["whiten", "unwhiten"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_task_qf_full_cov_with_kappa_matches_jax(whiten, dtype):
    """Non-zero kappa: kappa scales the full prior kernel, and the diagonal
    agrees with the marginal path's kappa * kdiag."""
    cfg, jp, tcfg, tpar, X_list, _ = _model(whiten, dtype, kappa=0.3)
    X = X_list[0][:9]
    jL = jelbo.prior_cholesky(jp, cfg)
    tL = telbo.prior_cholesky(tpar, tcfg)
    Xt = torch.as_tensor(X, dtype=tcfg.torch_dtype)
    for t in (0, 1):  # two parameter functions, and one
        want = jelbo.task_qf_full_cov(jp, cfg, jL,
                                      jnp.asarray(X, cfg.np_dtype), t)
        got = telbo.task_qf_full_cov(tpar, tcfg, tL, Xt, t)
        for g, w in zip(got, want):
            _close(g, w, TOL[dtype])
        _, v_F = telbo.task_qf_moments(tpar, tcfg, tL, Xt, t,
                                       clip_variance=False)
        _close(torch.diagonal(got[1], dim1=-2, dim2=-1).mT, v_F.numpy(),
               TOL[dtype])


def test_task_qf_full_cov_builds_the_gram_once(monkeypatch):
    """The posterior covariance and the kappa term share one Kxx: on the
    card that is one kernel launch and one (Q, N, N) buffer, not two."""
    _, _, tcfg, tpar, X_list, _ = _model(True, "float64", kappa=0.3)
    Xt = torch.as_tensor(X_list[0][:9], dtype=tcfg.torch_dtype)
    tL = telbo.prior_cholesky(tpar, tcfg)
    want = telbo.task_qf_full_cov(tpar, tcfg, tL, Xt, 0)
    calls, build = [], telbo.kernels.K_self_batched

    def counted(*args, **kwargs):
        calls.append(1)
        return build(*args, **kwargs)

    monkeypatch.setattr(telbo.kernels, "K_self_batched", counted)
    got = telbo.task_qf_full_cov(tpar, tcfg, tL, Xt, 0)
    assert len(calls) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a caller's own Kxx is used as given
    Kxx = build(tcfg.kernel, Xt, tpar.lengthscale, tpar.variance)
    _, cov = telbo.latent_projections_full(tpar, tcfg, tL, Xt, Kxx=Kxx)
    assert len(calls) == 1
    _, cov_built = telbo.latent_projections_full(tpar, tcfg, tL, Xt)
    assert len(calls) == 2 and torch.equal(cov, cov_built)


def test_projected_predictions_match_jax(model):
    cfg, jp, tcfg, tpar, X_list, Xs, tol = model
    want = jpredict.predict_f_projected_task(jp, cfg, X_list, Xs, 0)
    got = tp.predict_f_projected_task(tpar, tcfg, X_list, Xs, 0)
    assert got[0].shape == got[1].shape == (2, NS)  # HetGaussian: F_t = 2
    assert bool((got[1] >= 0).all())
    for g, w in zip(got, want):
        _close(g, w, tol)
    d = cfg.num_output_functions - 1
    want = jpredict.predict_f_projected(jp, cfg, X_list, Xs, d)
    got = tp.predict_f_projected(tpar, tcfg, X_list, Xs, d)
    anchors = [X[:11] for X in X_list]
    want_s = jpredict.predict_f_stochastic(jp, cfg, anchors, Xs, d)
    got_s = tp.predict_f_stochastic(tpar, tcfg, anchors, Xs, d)
    for g, w in zip((*got, *got_s), (*want, *want_s)):
        _close(g, w, tol)


def test_predictive_matches_jax_on_both_paths(model):
    cfg, jp, tcfg, tpar, X_list, Xs, tol = model
    new = [Xs, Xs[:5], Xs[3:]]
    for kw in (dict(), dict(Xtrain_list=X_list, projected=True)):
        jm, jv = jpredict.predictive(jp, cfg, new, **kw)
        tm, tv = tp.predictive(tpar, tcfg, new, **kw)
        for t in range(cfg.num_tasks):
            _close(tm[t], jm[t], tol)
            _close(tv[t], jv[t], tol)
            assert bool((tv[t] >= 0).all())


@pytest.mark.parametrize("reference_scaling", [True, False],
                         ids=["reference", "plain"])
def test_negative_log_predictive_matches_jax(model, reference_scaling):
    """The same (N, S, J) draws on both sides: the JAX package's per-task
    ``log_predictive(eps=)`` summed, against the port's entry with ``eps=``;
    all tasks, and a subset through ``tasks=``."""
    cfg, jp, tcfg, tpar, X_list, _, tol = model
    S = 50
    rng = np.random.RandomState(3)
    Y = [rng.randn(N, 1), (rng.rand(N, 1) > 0.5).astype(float),
         rng.poisson(3.0, (N, 1)).astype(float)]
    eps = [rng.randn(N, S, lik.dim_f) for lik in cfg.likelihoods]
    moments = jpredict.predict_f_all(jp, cfg, X_list)
    want = [float(lik.log_predictive(
        None, jnp.asarray(Y[t], cfg.np_dtype), *moments[t], S,
        reference_scaling=reference_scaling, eps=eps[t]))
        for t, lik in enumerate(cfg.likelihoods)]
    got = tp.negative_log_predictive(
        tpar, tcfg, None, X_list, Y, num_samples=S,
        reference_scaling=reference_scaling, eps=eps)
    _close(got, -sum(want), tol)
    got1 = tp.negative_log_predictive(
        tpar, tcfg, None, [X_list[1]], [Y[1][:, 0]], num_samples=S,
        reference_scaling=reference_scaling, tasks=[1], eps=[eps[1]])
    _close(got1, -want[1], tol)


def test_negative_log_predictive_draws_from_the_generator():
    """Without ``eps`` the draws come from the generator: seeded runs
    repeat, and agree with the injected-draws value to Monte-Carlo error."""
    _, _, tcfg, tpar, X_list, _ = _model(True, "float64")
    rng = np.random.RandomState(4)
    Y = [rng.randn(N, 1), (rng.rand(N, 1) > 0.5).astype(float),
         rng.poisson(3.0, (N, 1)).astype(float)]

    def nlpd(seed):
        return float(tp.negative_log_predictive(
            tpar, tcfg, torch.Generator().manual_seed(seed), X_list, Y,
            num_samples=400, reference_scaling=False))

    a, b, c = nlpd(0), nlpd(0), nlpd(1)
    assert a == b and a != c
    assert np.isfinite(a) and abs(a - c) < 0.05 * abs(a)
    with pytest.raises(ValueError, match="Generator"):
        tp.negative_log_predictive(tpar, tcfg, None, X_list, Y)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sample_f_moments_match_full_cov(dtype):
    """Correlated samples have the full covariance's mean and covariance
    (Monte-Carlo, atol 0.05 as the JAX package's own test); injected draws
    give mu + eps L^T for the adaptive factor, in float32 too, where the
    base jitter 1e-8 is below the covariance's resolution."""
    _, _, tcfg, tpar, _, _ = _model(True, dtype)
    Xnew = np.stack([np.linspace(0, 1, 10), np.linspace(1, 0, 10)], axis=1)
    mu, cov = tp.predict_f(tpar, tcfg, Xnew, 0, full_cov=True)
    S = tp.sample_f(tpar, tcfg, torch.Generator().manual_seed(0), Xnew, 0,
                    num_samples=20000)
    assert S.shape == (20000, 10) and S.dtype == tcfg.torch_dtype
    assert bool(torch.isfinite(S).all())
    np.testing.assert_allclose(S.mean(0).numpy(), mu.numpy(), atol=0.05)
    np.testing.assert_allclose(np.cov(S.numpy().T), cov.numpy(), atol=0.05)
    eps = np.random.RandomState(5).randn(4, 10)
    got = tp.sample_f(tpar, tcfg, None, Xnew, 0, num_samples=4, eps=eps)
    L = linalg.jitchol(cov[None], jitter=1e-8)[0]
    want = mu[None] + torch.as_tensor(eps, dtype=mu.dtype) @ L.mT
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sample_f_factor_matches_jax_f32():
    """The float32 posterior covariance on a dense grid is singular to
    working precision: the JAX package's adaptive ``jitchol`` and the
    port's settle on the same jitter level (the same decade, read off the
    factors' diagonals) and the same factor (1e-2 normwise: the smallest
    pivots sit at the jitter level, where two float32 LAPACKs round
    differently; L L^T agrees to 1e-5)."""
    from hetmogp_tpu.ops import linalg as jlinalg

    cfg, jp, tcfg, tpar, _, _ = _model(True, "float32")
    Xnew = np.stack([np.linspace(0, 1, 40), np.linspace(0, 1, 40)], axis=1)
    _, jcov = jpredict.predict_f(jp, cfg, Xnew, 0, full_cov=True)
    cov = torch.from_numpy(np.array(jcov))
    want = np.asarray(jlinalg.jitchol(jcov[None], jitter=1e-8,
                                      adaptive=True)[0])
    got = linalg.jitchol(cov[None], jitter=1e-8)[0]
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    _close(got @ got.mT, want @ want.T, 1e-5)
    _close(got, want, 1e-2)
    levels = [np.mean(np.diag(np.float64(L) @ np.float64(L).T)
                      - np.diag(np.float64(cov.numpy())))
              for L in (got.numpy(), want)]
    assert levels[0] > 1e-7 and abs(np.log10(levels[0] / levels[1])) < 0.3


def test_predictive_computes_no_inverse(monkeypatch):
    """``predictive``, ``predict_f`` and ``predict_f_all`` are on the solve
    path: they never call the inverse that ``make_serving_predictive``
    caches."""
    _, _, tcfg, tpar, X_list, Xs = _model(True, "float64")

    def boom(K):
        raise AssertionError("an explicit inverse was computed")

    monkeypatch.setattr(linalg, "blocked_cholesky_inverse", boom)
    before = cuda_kernels.launch_counts()
    tp.predictive(tpar, tcfg, X_list)
    tp.predict_f(tpar, tcfg, Xs, 1)
    tp.predict_f_all(tpar, tcfg, X_list)
    tp.predict_latent_u(tpar, tcfg, Xs, full_cov=True)
    tp.predict_f_projected_task(tpar, tcfg, X_list, Xs, 0)
    with pytest.raises(AssertionError, match="explicit inverse"):
        tp.make_serving_predictive(tpar, tcfg, 0)
    assert cuda_kernels.launch_counts() == before


def test_solve_path_matches_the_cached_inverse_path():
    """``task_qf_moments`` with and without ``iLuu``: the same moments, to
    the factorization's rounding (1e-8 normwise in float64)."""
    for whiten in (True, False):
        _, _, tcfg, tpar, X_list, _ = _model(whiten, "float64")
        X = torch.from_numpy(X_list[0])
        Luu, iLuu = telbo.prior_cholesky_inverse(tpar, tcfg)
        for t in range(tcfg.num_tasks):
            solve = telbo.task_qf_moments(tpar, tcfg, Luu, X, t)
            cached = telbo.task_qf_moments(tpar, tcfg, Luu, X, t, iLuu=iLuu)
            for a, b in zip(solve, cached):
                _close(a, b.numpy(), 1e-8)
    with pytest.raises(ValueError, match="cache_grad"):
        telbo.latent_projections(tpar, tcfg, Luu, X, cache_grad=True)


def test_prediction_input_validation():
    _, _, tcfg, tpar, X_list, _ = _model(True, "float64")
    bad = np.random.RandomState(0).rand(5, DX + 1)
    gen = torch.Generator().manual_seed(0)
    for call in (
            lambda: tp.predict_f(tpar, tcfg, bad, 0),
            lambda: tp.predict_f(tpar, tcfg, bad, 0, full_cov=True),
            lambda: tp.predict_latent_u(tpar, tcfg, bad),
            lambda: tp.predictive(tpar, tcfg, [bad for _ in X_list]),
            lambda: tp.predict_f_projected(tpar, tcfg, X_list, bad, 0),
            lambda: tp.sample_f(tpar, tcfg, gen, bad),
            lambda: tp.negative_log_predictive(
                tpar, tcfg, gen, [bad] * 3, [np.zeros(5)] * 3)):
        with pytest.raises(ValueError, match="prediction inputs"):
            call()
    with pytest.raises(ValueError, match="requires Xtrain_list"):
        tp.predictive(tpar, tcfg, X_list, projected=True)
    with pytest.raises(ValueError, match="one entry per evaluated task"):
        tp.negative_log_predictive(tpar, tcfg, gen, X_list[:1], [np.zeros(N)])
    with pytest.raises(ValueError, match="one entry per evaluated task"):
        tp.negative_log_predictive(tpar, tcfg, gen, X_list, [np.zeros(N)] * 3,
                                   tasks=[0, 1])


@pytest.mark.parametrize("kernel", ["matern32", "matern52", "exponential",
                                    "rq"])
def test_prediction_entries_work_for_every_kernel(kernel):
    """Every ``config.kernel`` goes through the same entries (plain PyTorch
    kernels; only "rbf" has a hand-written one): held against the JAX
    package in float64."""
    cfg, jp, tcfg, tpar, X_list, Xs = _model(True, "float64")
    cfg = dataclasses.replace(cfg, kernel=kernel)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    assert tcfg.kernel == kernel
    want = jpredict.predict_f(jp, cfg, Xs, 1, full_cov=True)
    got = tp.predict_f(tpar, tcfg, Xs, 1, full_cov=True)
    for g, w in zip(got, want):
        _close(g, w, 1e-8)
    want = jpredict.predict_f_projected_task(jp, cfg, X_list, Xs, 0)
    got = tp.predict_f_projected_task(tpar, tcfg, X_list, Xs, 0)
    for g, w in zip(got, want):
        _close(g, w, 1e-8)
