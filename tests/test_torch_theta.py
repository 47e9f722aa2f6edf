"""Trainable likelihood parameters (theta) in the port, against the JAX
package on the same numpy inputs, in float64.

* ``mc_nodes``: bitwise the JAX nodes and weights.
* The theta engine (``make_var_exp_theta``, NegativeBinomial, StudentT,
  Ordinal, Weibull in grid mode) and the analytic theta paths (Gaussian,
  LogNormal, Weibull): value, dm, dv and dtheta under a cotangent that
  differs by row, against the JAX custom VJP, rtol 1e-10 (1e-8 for the
  digamma of NegativeBinomial's and StudentT's dtheta: torch's float64
  digamma is good to ~2e-13 relative, and its cancellations amplify it).
* ``default_theta``/``with_theta`` round trips, the Ordinal refusing
  thresholds that do not increase, ``with_trained_likelihoods``.
* ``elbo_fn`` with ``lik_theta`` against JAX ``elbo_fn``, value and
  gradients.
* Ten ``make_scan_trainer`` steps with ``learn_lik_params=True`` against
  JAX ``make_scan_trainer`` on JAX-drawn offsets, to 1e-8 normwise, theta
  and its adam moments included (the reasons of
  ``tests/test_torch_scan.py``).
* ``params_from_jax`` with ``lik_theta``, from a params object and from an
  npz the JAX package wrote; ``default_lik_theta`` and
  ``init_params(with_lik_theta=True)``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import checkpoint as jcheckpoint
from hetmogp_tpu import data as jdata
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models import params as jparams_mod
from hetmogp_tpu.models.params import SVMOGPParams as JParams
from hetmogp_tpu.ops import quadrature as jquad

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import likelihoods as tliks
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models import params as tparams_mod
from hetmogp_tpu_torch.models.params import leaves
from hetmogp_tpu_torch.ops import quadrature as tquad

torch.set_num_threads(1)


@pytest.mark.parametrize("S,J,seed", [(64, 2, 0), (33, 4, 0), (1, 1, 3),
                                      (128, 3, 7)])
def test_mc_nodes_are_the_jax_nodes_bitwise(S, J, seed):
    nodes, w = tquad.mc_nodes(S, J, seed)
    jnodes, jw = jquad.mc_nodes(S, J, seed)
    np.testing.assert_array_equal(nodes, jnodes)
    np.testing.assert_array_equal(w, jw)
    assert nodes.shape == (S, J) and np.isclose(w.sum(), 1.0)


# (family, kwargs, observations, dtheta through digamma)
THETA = [
    ("NegativeBinomial", {"r": 3.0, "learn_r": True},
     lambda rng, n: rng.poisson(3.0, (n, 1)).astype(float), True),
    ("StudentT", {"df": 5.0, "learn_df": True},
     lambda rng, n: rng.standard_t(4.0, (n, 1)), True),
    ("Ordinal", {"K": 4, "thresholds": (-1.0, 0.2, 1.5)},
     lambda rng, n: rng.randint(1, 5, (n, 1)).astype(float), False),
    ("Weibull", {"k": 1.3, "learn_k": True, "analytic": False},
     lambda rng, n: rng.weibull(1.5, (n, 1)) + 1e-3, False),
    ("Weibull", {"k": 1.3, "learn_k": True},
     lambda rng, n: rng.weibull(1.5, (n, 1)) + 1e-3, False),
    ("Gaussian", {"sigma": 0.6, "learn_sigma": True},
     lambda rng, n: rng.randn(n, 1), False),
    ("LogNormal", {"sigma": 0.4, "learn_sigma": True},
     lambda rng, n: np.exp(rng.randn(n, 1)), False),
]
THETA_IDS = [t[0] + ("-grid" if t[1].get("analytic") is False else "")
             for t in THETA]


@pytest.mark.parametrize("name,kw,obs,digamma", THETA, ids=THETA_IDS)
def test_theta_var_exp_and_gradients_match_jax_f64(name, kw, obs, digamma):
    jlik = getattr(jliks, name)(**kw)
    tlik = getattr(tliks, name)(**kw)
    rng = np.random.RandomState(0)
    n = 24
    Y = obs(rng, n)
    m, v = 0.7 * rng.randn(n, jlik.dim_f), 0.01 + rng.rand(n, jlik.dim_f)
    theta = jlik.default_theta() + 0.2 * rng.randn(jlik.n_theta)
    g = rng.rand(n) * (rng.rand(n) > 0.3)  # a cotangent that differs by row

    @jax.jit
    def ref(Y, m, v, theta, g):
        val, vjp = jax.vjp(lambda a, b, c: jlik.var_exp(Y, a, b, theta=c),
                           m, v, theta)
        return (val,) + vjp(g)

    want = [np.asarray(a) for a in ref(*(jnp.asarray(x)
                                         for x in (Y, m, v, theta, g)))]
    args = [torch.from_numpy(x).requires_grad_() for x in (m, v, theta)]
    val = tlik.var_exp(torch.from_numpy(Y), *args[:2], theta=args[2])
    got = [val.detach().numpy()] + [a.numpy() for a in torch.autograd.grad(
        val, args, torch.from_numpy(g))]
    for what, a, b in zip(("value", "dm", "dv", "dtheta"), got, want):
        rtol = 1e-8 if digamma and what == "dtheta" else 1e-10
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12, err_msg=what)
    # at the default theta the theta path is the static one
    static = tlik.var_exp(torch.from_numpy(Y), torch.from_numpy(m),
                          torch.from_numpy(v))
    at_default = tlik.var_exp(torch.from_numpy(Y), torch.from_numpy(m),
                              torch.from_numpy(v), theta=torch.from_numpy(
                                  tlik.default_theta()))
    np.testing.assert_allclose(at_default.numpy(), static.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_theta_engine_takes_quasi_mc_nodes():
    """make_var_exp_theta on mc_nodes against the JAX engine on the same
    nodes: an Ordinal's logpdf_t through both engines."""
    jlik, tlik = jliks.Ordinal(K=3), tliks.Ordinal(K=3)
    rng = np.random.RandomState(5)
    n = 15
    Y = rng.randint(1, 4, (n, 1)).astype(float)
    m, v = rng.randn(n, 1), 0.1 + rng.rand(n, 1)
    theta = np.array([-0.3, 0.1])
    jve = jquad.make_var_exp_theta(jlik.logpdf_t, J=1, T=20, mc_samples=16)
    tve = tquad.make_var_exp_theta(tlik.logpdf_t, J=1, T=20, mc_samples=16)

    @jax.jit
    def ref(m, v, theta):
        val, vjp = jax.vjp(lambda a, b, c: jve(jnp.asarray(Y), a, b, c),
                           m, v, theta)
        return [val, *vjp(jnp.ones(n))]

    want = ref(*(jnp.asarray(x) for x in (m, v, theta)))
    args = [torch.from_numpy(x).requires_grad_() for x in (m, v, theta)]
    got = tve(torch.from_numpy(Y), *args)
    got = [got] + list(torch.autograd.grad(got.sum(), args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,kw,obs,digamma", THETA, ids=THETA_IDS)
def test_default_theta_and_with_theta_round_trip(name, kw, obs, digamma):
    jlik = getattr(jliks, name)(**kw)
    tlik = getattr(tliks, name)(**kw)
    th = tlik.default_theta()
    np.testing.assert_array_equal(th, jlik.default_theta())
    back = tlik.with_theta(th)
    for f in dataclasses.fields(tlik):
        a, b = getattr(back, f.name), getattr(tlik, f.name)
        if isinstance(b, float):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        elif f.name != "thresholds":  # None -> the default thresholds
            assert a == b, f.name
    other = th + 0.3
    got = tlik.with_theta(torch.from_numpy(other))  # a tensor works too
    want = jlik.with_theta(jnp.asarray(other))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=1e-12)
    assert tliks.Poisson().with_theta(np.zeros(0)) == tliks.Poisson()


def test_ordinal_thresholds_must_increase():
    for thresholds in ((0.5, 0.5, 1.0), (1.0, -1.0)):
        K = len(thresholds) + 1
        with pytest.raises(ValueError, match="increasing"):
            tliks.Ordinal(K=K, thresholds=thresholds).default_theta()
        with pytest.raises(ValueError, match="increasing"):
            jliks.Ordinal(K=K, thresholds=thresholds).default_theta()
    lik = tliks.Ordinal(K=4, thresholds=(-1.0, 0.2, 1.5))
    np.testing.assert_allclose(lik.with_theta(lik.default_theta()).thresholds,
                               lik.thresholds, rtol=1e-12)
    assert tliks.Ordinal(K=5).n_theta == 4


# ---- the model: elbo_fn, the scan trainer, params --------------------------

Q, M, DX, B = 2, 16, 2, 16
SIZES = (40, 12, 40, 33, 40, 40, 40)  # task 1 is smaller than its batch
LIKS = [("Gaussian", {"learn_sigma": True}),
        ("Ordinal", {"K": 4}),
        ("NegativeBinomial", {"learn_r": True}),
        ("StudentT", {"learn_df": True}),
        ("Weibull", {"k": 1.2, "learn_k": True}),
        ("LogNormal", {"learn_sigma": True}),
        ("Poisson", {})]
TC = dict(optimizer="adam", step_rate=0.005, minibatch="slice",
          vm_batch_fraction=0.25, learn_lik_params=True)


def _observations(rng):
    n = SIZES
    return [rng.randn(n[0], 1), rng.randint(1, 5, (n[1], 1)).astype(float),
            rng.poisson(3.0, (n[2], 1)).astype(float),
            rng.standard_t(4.0, (n[3], 1)),
            rng.weibull(1.5, (n[4], 1)) + 1e-3, np.exp(rng.randn(n[5], 1)),
            rng.poisson(2.0, (n[6], 1)).astype(float)]


def _problem():
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)(**kw)
                                             for n, kw in LIKS),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype="float64", jitter=1e-4, adaptive_jitter=False,
                           ard=True)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    leaves_np = dict(
        Z=np.broadcast_to(rng.rand(M, DX), (Q, M, DX)).copy(),
        q_mu=0.3 * rng.randn(Q, M),
        q_sqrt=0.5 * np.eye(M) + 0.01 * np.tril(rng.randn(Q, M, M)),
        log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
        log_variance=np.log(0.5 + rng.rand(Q)), W=rng.randn(Q, D),
        kappa=np.zeros((Q, D)))
    theta = tuple(lik.default_theta() + 0.1 * rng.randn(
        len(lik.default_theta())) for lik in cfg.likelihoods)
    X = [rng.rand(n, DX) for n in SIZES]
    return cfg, leaves_np, theta, X, _observations(rng)


def _jparams(leaves_np, theta):
    return JParams(**{k: jnp.asarray(v) for k, v in leaves_np.items()},
                   lik_theta=tuple(jnp.asarray(t) for t in theta))


def _port(cfg, leaves_np, theta, X, Y):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(
        types.SimpleNamespace(**leaves_np, lik_theta=theta), device="cpu",
        dtype=tcfg.torch_dtype)
    return tcfg, params, tp.make_dataset(X, Y, tcfg, device="cpu")


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    if want.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def test_elbo_with_lik_theta_matches_jax_f64():
    cfg, leaves_np, theta, X, Y = _problem()
    jp = _jparams(leaves_np, theta)
    jdata_, _ = jdata.full_batch(X, Y, dtype=cfg.np_dtype)
    scales = np.array([3.0, 1.0, 2.0, 1.5, 1.0, 2.5, 1.0])

    def f(p):
        return jelbo.elbo_fn(p, jdata_, jnp.asarray(scales), cfg)[0]

    want, jgrad = jax.jit(jax.value_and_grad(f))(jp)
    tcfg, params, data = _port(cfg, leaves_np, theta, X, Y)
    tensors = [t.requires_grad_() for _, t in leaves(params)]
    p = tparams_mod.from_leaves(params, tensors)
    got, aux = telbo.elbo_fn(p, data, torch.from_numpy(scales), tcfg,
                             use_kernel=False)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    grads = torch.autograd.grad(got, tensors, allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(jleaves) == len(grads)
    for (name, t), g, w in zip(leaves(params), grads, jleaves):
        g = torch.zeros_like(t) if g is None else g
        assert _normwise(g, w) < 1e-8, (name, _normwise(g, w))
    # without lik_theta the static constants: a different ELBO
    static, _ = telbo.elbo_fn(dataclasses.replace(params, lik_theta=None),
                              data, torch.from_numpy(scales), tcfg,
                              use_kernel=False)
    assert float(static.detach()) != float(got.detach())


def _jax_offsets(key, steps, batches):
    """The offsets JAX's scan trainer draws from ``key``, as in
    ``tests/test_torch_scan.py``."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(SIZES))
        out.append([0 if b >= n else
                    int(jax.random.randint(keys[t], (), 0, n))
                    for t, (n, b) in enumerate(zip(SIZES, batches))])
    return np.array(out, dtype=np.int64)


def test_scan_trainer_learns_theta_as_jax_does_f64():
    cfg, leaves_np, theta, X, Y = _problem()
    tc = jhet.TrainConfig(**TC)
    batches = (B,) * len(SIZES)
    jrun = jtrain.make_scan_trainer(cfg, tc, SIZES, batches, vem=True,
                                    steps_per_call=10)
    js = jtrain.init_train_state(_jparams(leaves_np, theta), cfg,
                                 jtrain.make_optimizer(tc), cache_luu=True,
                                 fast_projection=True)
    jds, _ = jdata.full_batch(X, Y, dtype=cfg.np_dtype)
    key = jax.random.PRNGKey(4)
    js, jel = jrun(js, jds, key)

    tcfg, params, data = _port(cfg, leaves_np, theta, X, Y)
    run = tp.make_scan_trainer(tcfg, tp.TrainConfig(**TC), SIZES, batches,
                               steps_per_call=10)
    ts, tel = run(tp.init_train_state(params, tcfg), data,
                  offsets=_jax_offsets(key, 10, batches))
    np.testing.assert_allclose(tel.numpy(), np.asarray(jel), rtol=1e-8)
    jadam = js.opt_state[0]
    for got, want, what in ((ts.params, js.params, "param"),
                            (ts.opt_state.mu, jadam.mu, "mu"),
                            (ts.opt_state.nu, jadam.nu, "nu")):
        jleaves = jax.tree_util.tree_leaves(want)
        assert len(jleaves) == len(leaves(got))
        for (name, g), w in zip(leaves(got), jleaves):
            if not np.any(np.asarray(w)):
                assert not torch.any(g), (what, name)
                continue
            assert _normwise(g, w) < 1e-8, (what, name, _normwise(g, w))
    # theta moved (two VM steps) for every family that has one, and the
    # (0,) leaf of the Poisson stayed empty
    for t, lik in enumerate(tcfg.likelihoods):
        moved = not torch.equal(ts.params.lik_theta[t],
                                params.lik_theta[t])
        assert moved == bool(lik.n_theta), (t, lik)
    assert ts.params.lik_theta[-1].shape == (0,)


def test_theta_stays_fixed_without_learn_lik_params():
    cfg, leaves_np, theta, X, Y = _problem()
    tcfg, params, data = _port(cfg, leaves_np, theta, X, Y)
    tc = tp.TrainConfig(**{**TC, "learn_lik_params": False})
    run = tp.make_scan_trainer(tcfg, tc, SIZES, (B,) * len(SIZES),
                               steps_per_call=10)
    ts, tel = run(tp.init_train_state(params, tcfg), data,
                  torch.Generator().manual_seed(0))
    assert torch.isfinite(tel).all()
    for a, b in zip(ts.params.lik_theta, params.lik_theta):
        assert torch.equal(a, b)
    assert not torch.equal(ts.params.q_mu, params.q_mu)


def test_params_from_jax_carries_lik_theta(tmp_path):
    cfg, leaves_np, theta, _, _ = _problem()
    jp = _jparams(leaves_np, theta)
    from_obj = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    path = tmp_path / "ckpt.npz"
    jcheckpoint.save_checkpoint(path, jp, step=3)
    from_npz = tp.params_from_jax(path, device="cpu")
    without = tmp_path / "plain.npz"
    jcheckpoint.save_checkpoint(without, jp.replace(lik_theta=None))
    assert tp.params_from_jax(without, device="cpu").lik_theta is None
    for p in (from_obj, from_npz):
        assert len(p.lik_theta) == len(theta)
        for a, b in zip(p.lik_theta, theta):
            np.testing.assert_array_equal(a.numpy(), b)
        moved = p.to(dtype=torch.float32)
        assert all(t.dtype == torch.float32 for t in moved.lik_theta)


def test_default_lik_theta_and_init_params_match_jax():
    cfg, _, _, _, _ = _problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    want = jparams_mod.default_lik_theta(cfg)
    got = tparams_mod.default_lik_theta(tcfg, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Z = np.random.RandomState(0).rand(M, DX)
    p = tp.init_params(np.random.default_rng(0), tcfg, Z, device="cpu",
                       with_lik_theta=True)
    assert [t.shape for t in p.lik_theta] == [a.shape for a in got]
    assert tp.init_params(np.random.default_rng(0), tcfg, Z,
                          device="cpu").lik_theta is None


def test_with_trained_likelihoods_matches_jax():
    cfg, leaves_np, theta, _, _ = _problem()
    want = cfg.with_trained_likelihoods(_jparams(leaves_np, theta))
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(types.SimpleNamespace(**leaves_np,
                                                      lik_theta=theta),
                                device="cpu")
    got = tcfg.with_trained_likelihoods(params)
    for a, b in zip(got.likelihoods, want.likelihoods):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, (float, tuple)):
                np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                           rtol=1e-12)
            else:
                assert x == y, f.name
    assert tcfg.with_trained_likelihoods(
        dataclasses.replace(params, lik_theta=None)) is tcfg
