"""The port's natural gradients against the JAX package's, on the CPU.

The same numpy-made inputs go through ``hetmogp_tpu.train`` and
``hetmogp_tpu_torch.train`` in float64:

* one ``natgrad_ve_step`` of each retraction from a cold and a carried
  S^{-1}, fused rows and per task, the lr/4 backoff on an indefinite A,
  and the exact retraction's rejection of a finite but divergent step;
* the exact retraction's two attempts, factored in one call on their
  stack, against the attempts formed one at a time (on the port alone,
  bitwise);
* the ports of ``tests/test_natgrad.py``'s conjugate-exactness and
  trust-ball tests, on the port alone;
* ten ``natgrad_adam`` steps of ``make_step`` against ``make_svi_step``
  (both retractions) and ``skip_nonfinite_steps`` over the natural-gradient
  update.

Tolerance 1e-8, normwise max|a - b| / max|b| (1e-10 relative for the
ELBO).  The two packages round a Cholesky factorization and the products
with its inverse differently (about cond * eps, 1e-12 here); the exact
retraction adds the reversed factorization of A and the cholesky one
three dense triangular products, which carry that rounding unchanged
into q, and ten steps compound it.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.data import full_batch as jfull_batch
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import init_params as jinit_params

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models.params import FIELDS
from hetmogp_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)

TOL = 1e-8


def _normwise(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _close(got, want, tol=TOL):
    assert _normwise(got, want) < tol, _normwise(got, want)


def _port(cfg, jparams, X_list, Y_list):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    return (tcfg, tp.params_from_jax(jparams, device="cpu"),
            tp.full_batch(X_list, Y_list, dtype=torch.float64,
                          device="cpu")[0])


def _hetero(fuse=True, q=2, m=8):
    """Three tasks (HetGaussian, Bernoulli, Poisson) of 40, 32 and 24
    rows, fixed jitter."""
    rng = np.random.RandomState(4)
    liks = (jliks.HetGaussian(), jliks.Bernoulli(), jliks.Poisson())
    cfg = jhet.ModelConfig(likelihoods=liks, num_latent=q, num_inducing=m,
                           input_dim=1, dtype="float64", jitter=1e-6,
                           adaptive_jitter=False, fuse_task_rows=fuse)
    X = [np.sort(rng.rand(n, 1), 0) for n in (40, 32, 24)]
    Y = [rng.randn(40, 1), (rng.rand(32, 1) > 0.5).astype(float),
         rng.poisson(2.0, (24, 1)).astype(float)]
    params = jinit_params(jax.random.PRNGKey(0), cfg,
                          np.linspace(0, 1, m)[:, None], lengthscale=0.3)
    # a factor away from the identity, so that every term of the step acts
    params = params.replace(q_sqrt=jnp.asarray(
        0.7 * np.eye(m) + 0.05 * np.tril(rng.randn(q, m, m))))
    data, scales = jfull_batch(X, Y, dtype=cfg.np_dtype)
    return cfg, params, data, jnp.asarray(scales, cfg.np_dtype), X, Y


def _gaussian(sigma=0.4, offset=0.0):
    """test_natgrad.py's conjugate problem: one Gaussian task, Q=1, M=6,
    the JAX defaults (adaptive jitter from 0)."""
    rng = np.random.RandomState(0)
    n, m = 50, 6
    cfg = jhet.ModelConfig(likelihoods=(jliks.Gaussian(sigma=sigma),),
                           num_latent=1, num_inducing=m, input_dim=1,
                           whiten=True, dtype="float64")
    X = [np.sort(rng.rand(n, 1), 0)]
    Y = [offset + np.sin(5 * X[0]) + 0.1 * rng.randn(n, 1)]
    params = jinit_params(jax.random.PRNGKey(0), cfg,
                          np.linspace(0, 1, m)[:, None], lengthscale=0.3,
                          q_mu_scale=1.0)
    data, scales = jfull_batch(X, Y, dtype=cfg.np_dtype)
    return cfg, params, data, jnp.asarray(scales, cfg.np_dtype), X, Y


def _jax_step(params, data, scales, cfg, lr, retraction):
    """The JAX natgrad_ve_step at a traced lr: one compile serves every lr
    of a problem."""
    return jax.jit(lambda p, lr: jtrain.natgrad_ve_step(
        p, data, scales, cfg, lr, retraction=retraction))(params, lr)


def _compare_step(jout, tout):
    (jp, je, ja, js), (tp_, te, ta, ts) = jout, tout
    np.testing.assert_allclose(te.item(), float(je), rtol=1e-10)
    _close(ta["ve"], ja["ve"])
    np.testing.assert_allclose(ta["kl"].item(), float(ja["kl"]), rtol=1e-10)
    assert ta["ng_backoff"].item() == int(ja["ng_backoff"])
    _close(tp_.q_mu, jp.q_mu)
    _close(tp_.q_sqrt, jnp.tril(jp.q_sqrt))
    if js is None:
        assert ts is None
    else:
        _close(ts, js)


@pytest.mark.parametrize("retraction", ["cholesky", "exact"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_task"])
def test_ve_step_matches_jax_cold_and_carried(retraction, fuse):
    """Three chained steps against the cached (Luu, iLuu), each from the
    carried S^{-1} of the one before (the first from a cold start), and
    one from a cold start on the solve path (no iLuu)."""
    cfg, jparams, jdata, jscales, X, Y = _hetero(fuse)
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    tscales = torch.from_numpy(np.asarray(jscales))
    jL, jiL = jelbo.prior_cholesky_inverse(jparams, cfg)
    tL, tiL = telbo.prior_cholesky_inverse(tparams, tcfg)
    jstep = jax.jit(lambda p, s: jtrain.natgrad_ve_step(
        p, jdata, jscales, cfg, 0.3, Luu=jL, iLuu=jiL, S_inv=s,
        retraction=retraction))
    js_inv = ts_inv = None
    jp, tq = jparams, tparams
    for _ in range(3):
        jout = jstep(jp, js_inv)
        tout = ttrain.natgrad_ve_step(tq, tdata, tscales, tcfg, 0.3, Luu=tL,
                                      iLuu=tiL, S_inv=ts_inv,
                                      retraction=retraction)
        _compare_step(jout, tout)
        jp, js_inv = jout[0], jout[3]
        tq, ts_inv = tout[0], tout[3]
    if retraction == "exact":  # the carried value is (Lq Lq^T)^{-1}
        Lq = torch.tril(tq.q_sqrt)
        _close(ts_inv @ (Lq @ Lq.mT), np.broadcast_to(np.eye(8), (2, 8, 8)),
               1e-8)
    jout = jax.jit(lambda p: jtrain.natgrad_ve_step(
        p, jdata, jscales, cfg, 0.3, retraction=retraction))(jparams)
    tout = ttrain.natgrad_ve_step(tparams, tdata, tscales, tcfg, 0.3,
                                  retraction=retraction)
    _compare_step(jout, tout)


def test_fused_rows_match_per_task():
    """config.fuse_task_rows changes the blocking, not the step (the JAX
    test's own bounds: rtol 1e-12 on the ELBO, 1e-9 on q)."""
    out = {}
    for fuse in (True, False):
        cfg, jparams, _, jscales, X, Y = _hetero(fuse)
        tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
        L, iL = telbo.prior_cholesky_inverse(tparams, tcfg)
        out[fuse] = ttrain.natgrad_ve_step(
            tparams, tdata, torch.from_numpy(np.asarray(jscales)), tcfg, 0.3,
            Luu=L, iLuu=iL, retraction="exact")
    (p1, e1, a1, s1), (p0, e0, a0, s0) = out[True], out[False]
    np.testing.assert_allclose(e1.item(), e0.item(), rtol=1e-12)
    np.testing.assert_allclose(a1["ve"].numpy(), a0["ve"].numpy(), rtol=1e-12)
    for a, b in ((p1.q_mu, p0.q_mu), (p1.q_sqrt, p0.q_sqrt), (s1, s0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-11)


def _indefinite_case():
    """test_natgrad.py's engineered backoff case: a broad Gaussian
    likelihood and q_sqrt = I / sqrt(2), so A ~ (2 - lr) I from the KL:
    lr = 4 fails and lr / 4 = 1 passes; lr = 4000 fails twice."""
    cfg, jparams, jdata, jscales, X, Y = _gaussian(sigma=20.0)
    jparams = jparams.replace(q_sqrt=jnp.broadcast_to(
        jnp.eye(6) / np.sqrt(2.0), jparams.q_sqrt.shape))
    return cfg, jparams, jdata, jscales, X, Y


@pytest.mark.parametrize("lr,code", [(4.0, 1), (4000.0, 2)])
def test_backoff_on_an_indefinite_A_matches_jax(lr, code):
    cfg, jparams, jdata, jscales, X, Y = _indefinite_case()
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    jout = _jax_step(jparams, jdata, jscales, cfg, lr, "exact")
    tout = ttrain.natgrad_ve_step(tparams, tdata,
                                  torch.from_numpy(np.asarray(jscales)), tcfg,
                                  lr, retraction="exact")
    assert int(jout[2]["ng_backoff"]) == code
    _compare_step(jout, tout)
    if code == 2:  # q left exactly as it was
        assert torch.equal(tout[0].q_mu, tparams.q_mu)
        assert torch.equal(tout[0].q_sqrt, torch.tril(tparams.q_sqrt))
    else:
        assert (tout[0].q_mu - tparams.q_mu).abs().max() > 1e-6
    assert torch.isfinite(tout[3]).all()


def _one_attempt(S_inv, g_S, theta1, d_eta1, lr, config):
    """One attempt of the exact retraction by itself, (Q, M, M) alone:
    (m_new, L_new, S_inv_new)."""
    theta1_new = theta1 + lr * d_eta1
    A = S_inv - 2.0 * lr * g_S
    A_rev = torch.flip(A, dims=(-2, -1))
    if config.adaptive_jitter:
        L_r = tlinalg.jitchol(A_rev)
        iL_r = tlinalg.tri_inverse(L_r)
        S_inv_n = torch.flip(L_r @ L_r.mT, dims=(-2, -1))
    else:
        j_eye = config.jitter * torch.eye(S_inv.shape[-1],
                                          dtype=S_inv.dtype)
        _, iL_r = tlinalg.blocked_cholesky_inverse(A_rev + j_eye)
        S_inv_n = A + j_eye
    L_new = torch.flip(iL_r, dims=(-2, -1)).mT
    return ((L_new @ (L_new.mT @ theta1_new[..., None]))[..., 0], L_new,
            S_inv_n)


def _accepted(out, m):
    """The step's rule for an attempt of the exact retraction."""
    m_new, L_new, _ = out
    return bool(torch.isfinite(m_new).all() and torch.isfinite(L_new).all()
                and (m_new - m).abs().max() < ttrain._NG_STEP_MAX
                and L_new.square().sum(-1).max() < ttrain._NG_SANE_VAR)


def _bitwise(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed-jitter", "adaptive-jitter"])
@pytest.mark.parametrize("lr,code", [(0.5, 0), (4.0, 1), (4000.0, 2)])
def test_stacked_attempts_equal_the_attempts_one_at_a_time(monkeypatch, lr,
                                                            code, adaptive):
    """Under "exact" the step factors both attempts' A in one call on
    their stack (``blocked_cholesky_inverse`` with a fixed jitter,
    ``jitchol`` with an adaptive one, whose jitter escalates a matrix at a
    time); q_mu, q_sqrt, S^{-1} and ng_backoff are bitwise those of the two
    attempts formed one at a time: the first accepted (lr = 0.5); the
    first rejected, A indefinite, and the second accepted (lr = 4); both
    rejected (lr = 4000)."""
    cfg, jparams, _, jscales, X, Y = _indefinite_case()
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    tcfg = dataclasses.replace(tcfg, adaptive_jitter=adaptive, jitter=1e-6)
    seen = []
    real = ttrain._exact_attempts

    def record(*args):
        seen.append(args)
        return real(*args)
    monkeypatch.setattr(ttrain, "_exact_attempts", record)
    new, _, aux, s_inv = ttrain.natgrad_ve_step(
        tparams, tdata, torch.from_numpy(np.array(jscales)), tcfg, lr,
        retraction="exact")
    [(S_inv, g_S, theta1, d_eta1, lrs, _, _)] = seen
    assert lrs == (lr, lr * 0.25)
    outs = [_one_attempt(S_inv, g_S, theta1, d_eta1, r, tcfg) for r in lrs]
    eye = torch.eye(S_inv.shape[-1], dtype=S_inv.dtype)
    for got, want in zip(real(S_inv, g_S, theta1, d_eta1, lrs, tcfg, eye),
                         outs):
        for a, b in zip(got, want):
            _bitwise(a, b)
    m, Lq = tparams.q_mu, torch.tril(tparams.q_sqrt)
    ok = [_accepted(o, m) for o in outs]
    assert (0 if ok[0] else 1 if ok[1] else 2) == code
    assert aux["ng_backoff"].item() == code
    want = outs[code] if code < 2 else (m, Lq, S_inv)
    for got, w in zip((new.q_mu, new.q_sqrt, s_inv), want):
        assert torch.equal(got, w)


def test_exact_retraction_rejects_a_finite_divergent_step():
    """Observations 1e4 prior sd away: the step at lr = 1 is finite but
    moves the whitened mean off the map; both attempts are rejected
    (``_NG_STEP_MAX``), as in the JAX package, while a small step from the
    same point is taken."""
    cfg, jparams, jdata, jscales, X, Y = _gaussian(offset=1e4)
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    tscales = torch.from_numpy(np.asarray(jscales))
    for lr, code in ((1.0, 2), (1e-6, 0)):
        jout = _jax_step(jparams, jdata, jscales, cfg, lr, "exact")
        tout = ttrain.natgrad_ve_step(tparams, tdata, tscales, tcfg, lr,
                                      retraction="exact")
        assert tout[2]["ng_backoff"].item() == int(
            jout[2]["ng_backoff"]) == code
        _compare_step(jout, tout)
    moved = float((tout[0].q_mu - tparams.q_mu).abs().max())
    assert 1e-4 < moved < ttrain._NG_STEP_MAX


def test_one_step_is_exact_for_a_conjugate_likelihood():
    """The port of test_natgrad.py's CAVI property: with a Gaussian
    likelihood and lr = 1 the exact retraction lands on the optimal q(u),
    where the ELBO's q-gradient vanishes (1e-8), and a second step is a
    fixed point."""
    cfg, jparams, _, jscales, X, Y = _gaussian()
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    scales = torch.from_numpy(np.asarray(jscales))
    p1 = ttrain.natgrad_update(tparams, tdata, scales, tcfg, 1.0,
                               retraction="exact")
    q_mu = p1.q_mu.clone().requires_grad_()
    q_sqrt = p1.q_sqrt.clone().requires_grad_()
    e, _ = telbo.elbo_fn(dataclasses.replace(p1, q_mu=q_mu, q_sqrt=q_sqrt),
                         tdata, scales, tcfg)
    g_mu, g_L = torch.autograd.grad(e, (q_mu, q_sqrt))
    assert g_mu.abs().max() < 1e-8 and torch.tril(g_L).abs().max() < 1e-8
    p2 = ttrain.natgrad_update(p1, tdata, scales, tcfg, 1.0,
                               retraction="exact")
    np.testing.assert_allclose(p2.q_mu.numpy(), p1.q_mu.numpy(), atol=1e-8)
    S1, S2 = (torch.tril(p.q_sqrt) @ torch.tril(p.q_sqrt).mT for p in (p1, p2))
    np.testing.assert_allclose(S2.numpy(), S1.numpy(), atol=1e-8)


def test_cholesky_trust_keeps_the_factor_valid_at_any_lr():
    """The port of the trust-ball test: for any lr the cholesky retraction
    keeps q_sqrt exactly lower-triangular with a positive diagonal no
    lower than (1 - trust) of the last, never forms S^{-1}, and needs no
    backoff; its result is JAX's."""
    cfg, jparams, jdata, jscales, X, Y = _indefinite_case()
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    d0 = 1.0 / np.sqrt(2.0)
    for lr in (0.5, 4.0, 4000.0):
        jout = _jax_step(jparams, jdata, jscales, cfg, lr, "cholesky")
        p, e, a, s_inv = tout = ttrain.natgrad_ve_step(
            tparams, tdata, torch.from_numpy(np.asarray(jscales)), tcfg, lr,
            retraction="cholesky", trust=0.3)
        _compare_step(jout, tout)
        assert s_inv is None and a["ng_backoff"].item() == 0
        Lq = p.q_sqrt.numpy()
        assert np.isfinite(Lq).all() and (np.triu(Lq, 1) == 0).all()
        d = np.diagonal(Lq, axis1=-2, axis2=-1)
        assert (d > 0).all() and (d >= d0 * (1 - 0.3) - 1e-12).all()


def test_natgrad_defaults_to_the_cholesky_retraction():
    """One default everywhere: ``natgrad_update``, ``natgrad_ve_step`` and
    ``TrainConfig`` all take "cholesky" (the JAX ``natgrad_update`` says
    "exact", its ``TrainConfig`` "cholesky")."""
    for fn in (ttrain.natgrad_update, ttrain.natgrad_ve_step):
        assert inspect.signature(fn).parameters[
            "retraction"].default == "cholesky"
    assert tp.TrainConfig().natgrad_retraction == "cholesky"
    cfg, jparams, _, jscales, X, Y = _hetero()
    tcfg, tparams, tdata = _port(cfg, jparams, X, Y)
    scales = torch.from_numpy(np.asarray(jscales))
    got = ttrain.natgrad_update(tparams, tdata, scales, tcfg, 0.3)
    want = ttrain.natgrad_ve_step(tparams, tdata, scales, tcfg, 0.3,
                                  retraction="cholesky")[0]
    assert torch.equal(got.q_sqrt, want.q_sqrt)
    with pytest.raises(ValueError, match="retraction"):
        ttrain.natgrad_ve_step(tparams, tdata, scales, tcfg, 0.3,
                               retraction="qr")
    with pytest.raises(ValueError, match="whiten"):
        ttrain.natgrad_update(tparams, tdata, scales,
                              dataclasses.replace(tcfg, whiten=False), 0.3)


def _sgd_problem():
    cfg, jparams, _, _, X, Y = _hetero(q=2, m=8)
    rng = np.random.RandomState(9)
    batches = [tuple(zip(*[(rng.rand(16, 1), y[rng.randint(0, len(y), 16)])
                           for y in Y])) for _ in range(10)]
    return cfg, jparams, X, Y, batches


@pytest.mark.parametrize("retraction", ["cholesky", "exact"])
def test_ten_natgrad_adam_steps_match_jax(retraction):
    """make_step against make_svi_step, natgrad_adam under VEM: natural
    gradients on q in the VE steps (the exact retraction carrying S^{-1}),
    adam on the hypers in the VM steps 4 and 9, the cache refreshed after
    each; ELBO, ng_backoff, every parameter, adam's moments and S^{-1}."""
    cfg, jparams, X, Y, batches = _sgd_problem()
    kw = dict(optimizer="natgrad_adam", step_rate=0.01, natgrad_lr=0.3,
              natgrad_retraction=retraction, minibatch="slice")
    tc = jhet.TrainConfig(**kw)
    jstep = jtrain.make_svi_step(cfg, tc)
    js = jtrain.init_train_state(jparams, cfg, jtrain.make_optimizer(tc),
                                 natgrad=retraction == "exact")
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ttc = tp.TrainConfig(**kw)
    tstep = ttrain.make_step(tcfg, ttc)
    ts = tp.init_train_state(tp.params_from_jax(jparams, device="cpu"), tcfg,
                             ttc)
    scales = np.full(3, 2.5)
    for s, (Xb, Yb) in enumerate(batches):
        js, jm = jstep(js, tuple(jelbo.task_data(x, y) for x, y in
                                 zip(Xb, Yb)), jnp.asarray(scales))
        ts, tm = tstep(ts, tp.make_dataset(Xb, Yb, tcfg, device="cpu"),
                       torch.from_numpy(scales))
        np.testing.assert_allclose(tm["elbo"].item(), float(jm["elbo"]),
                                   rtol=1e-10, err_msg=f"step {s}")
        assert tm["ng_backoff"].item() == int(jm["ng_backoff"])
        for f in FIELDS:
            w = getattr(js.params, f)
            if f == "q_sqrt":
                w = jnp.tril(w)
            if np.any(np.asarray(w)):
                _close(getattr(ts.params, f), w)
            for got, want in ((ts.opt_state.mu, js.opt_state[0].mu),
                              (ts.opt_state.nu, js.opt_state[0].nu)):
                if np.any(np.asarray(getattr(want, f))):
                    _close(getattr(got, f), getattr(want, f))
        assert ts.opt_state.count.item() == int(js.opt_state[0].count)
        if retraction == "exact":
            _close(ts.S_inv, js.S_inv)
        else:
            assert ts.S_inv is None and js.S_inv is None
        _close(ts.iLuu, js.iLuu)


def test_skip_nonfinite_steps_guards_the_natgrad_state():
    """The JAX test's case: a poisoned batch leaves params and the carried
    S^{-1} as they were; a clean step then moves both, and S^{-1} tracks
    the new factor."""
    rng = np.random.RandomState(0)
    cfg = tp.ModelConfig(likelihoods=(tp.Gaussian(), tp.Bernoulli()),
                         num_latent=2, num_inducing=6, input_dim=1,
                         dtype="float64")
    X = [rng.rand(20, 1), rng.rand(15, 1)]
    Y = [rng.randn(20, 1), (rng.rand(15, 1) > 0.5).astype(float)]
    params = tp.init_params(np.random.default_rng(0), cfg,
                            np.linspace(0, 1, 6)[:, None], lengthscale=0.3,
                            device="cpu")
    data, _ = tp.full_batch(X, Y, dtype=torch.float64, device="cpu")
    scales = torch.ones(2, dtype=torch.float64)
    bad = tuple(d._replace(X=d.X.clone()) for d in data)
    bad[0].X[0, 0] = float("nan")
    tc = tp.TrainConfig(optimizer="natgrad_adam", step_rate=0.01,
                        natgrad_lr=0.3, skip_nonfinite_steps=True,
                        natgrad_retraction="exact", minibatch="slice")
    step = ttrain.make_step(cfg, tc)
    s0 = tp.init_train_state(params, cfg, tc)
    s1, m1 = step(s0, bad, scales)
    assert m1["skipped"].item() == 1
    assert torch.equal(s1.S_inv, s0.S_inv)
    assert torch.equal(s1.params.q_mu, s0.params.q_mu)
    s2, m2 = step(s1, data, scales)
    assert m2["skipped"].item() == 0 and torch.isfinite(m2["elbo"])
    assert not torch.equal(s2.params.q_mu, s1.params.q_mu)
    Lq = torch.tril(s2.params.q_sqrt)
    assert (s2.S_inv @ (Lq @ Lq.mT) - torch.eye(6)).abs().max() < 1e-6
