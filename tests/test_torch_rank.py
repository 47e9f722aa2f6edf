"""Coregionalization rank R > 1 in the port against the JAX package, on the
CPU, in float64.

At rank R the model has Q*R latent copies: Z, q_mu, q_sqrt, W and kappa
have Q*R rows, the kernel hypers Q, repeated over each group's copies.
* ``params_from_jax`` of the JAX ``init_params(rank=2)``, and the port's
  own ``init_params`` and ``random_W`` at rank 2.
* The ELBO (rtol 1e-9, as ``tests/test_torch_elbo.py``) and its gradient
  with respect to every leaf (normwise 1e-8): the tied hypers' gradient is
  the sum over their copies, which autograd takes through
  ``repeat_interleave`` as ``jax.grad`` through ``jnp.repeat``.
* Ten ``make_step`` steps against JAX ``make_svi_step`` (normwise 1e-8,
  the reasons of ``tests/test_torch_train.py``).
* The rank-2 export round trip, the counterpart of
  ``tests/test_aux.py::test_export_rank2_roundtrip`` (rtol 1e-10 against
  the eager predictive, and the JAX package's own numbers to 1e-8).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models import predict as jpredict
from hetmogp_tpu.models.params import SVMOGPParams as JParams
from hetmogp_tpu.models.params import init_params as jinit

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import export, train as ttrain
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models.params import FIELDS, random_W

torch.set_num_threads(1)

Q, R, M, DX, B = 2, 2, 12, 2, 24


def _config():
    return jhet.ModelConfig(likelihoods=(jhet.HetGaussian(), jhet.Bernoulli(),
                                         jhet.Categorical(K=3)),
                            num_latent=Q, num_inducing=M, input_dim=DX,
                            dtype="float64", jitter=1e-4,
                            adaptive_jitter=False, ard=True, rank=R)


def _leaves(cfg, rng):
    Qe, D = Q * R, cfg.num_output_functions
    return dict(Z=rng.rand(Qe, M, DX),
                q_mu=0.3 * rng.randn(Qe, M),
                q_sqrt=0.5 * np.eye(M) + 0.05 * np.tril(rng.randn(Qe, M, M)),
                log_lengthscale=np.log(0.2 + 0.2 * rng.rand(Q, DX)),
                log_variance=np.log(0.5 + rng.rand(Q)),
                W=rng.randn(Qe, D), kappa=np.zeros((Qe, D)))


def _data(rng, n=B):
    X = [rng.rand(n, DX) for _ in range(3)]
    Y = [rng.randn(n, 1), (rng.rand(n, 1) > 0.5) * 1.0,
         rng.randint(1, 4, (n, 1)) * 1.0]
    return X, Y


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _port(cfg, leaves):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(types.SimpleNamespace(**leaves, rank=R),
                                device="cpu")
    return tcfg, params


def test_params_from_jax_init_params_rank2():
    cfg = _config()
    jp = jinit(jax.random.PRNGKey(1), cfg, np.random.RandomState(0).rand(
        M, DX), lengthscale=np.array([0.3, 0.4]), variance=0.7)
    params = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    assert params.rank == R
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(params.lengthscale.numpy(),
                                  np.asarray(jp.lengthscale))
    np.testing.assert_array_equal(params.variance.numpy(),
                                  np.asarray(jp.variance))
    assert params.lengthscale.shape == (Q * R, DX)  # ARD
    # the port's own init at rank 2: the same layouts
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    D = tcfg.num_output_functions
    W3 = np.arange(Q * D * R, dtype=float).reshape(Q, D, R)
    own = tp.init_params(np.random.default_rng(0), tcfg,
                         np.random.rand(Q, M, DX), W=W3, device="cpu")
    shapes = dict(Z=(Q * R, M, DX), q_mu=(Q * R, M), q_sqrt=(Q * R, M, M),
                  log_lengthscale=(Q, DX), log_variance=(Q,),
                  W=(Q * R, D), kappa=(Q * R, D))
    for f, shape in shapes.items():
        assert tuple(getattr(own, f).shape) == shape, f
    jW = jinit(jax.random.PRNGKey(0), cfg, np.zeros((M, DX)), W=W3).W
    np.testing.assert_array_equal(own.W.numpy(), np.asarray(jW))
    torch.testing.assert_close(own.Z[0], own.Z[1], rtol=0, atol=0)
    # random_W at rank R is the rank-1 draw over sqrt(R)
    a = random_W(np.random.default_rng(4), Q * R, D, rank=R)
    b = random_W(np.random.default_rng(4), Q * R, D)
    np.testing.assert_allclose(a, b / np.sqrt(R), rtol=0, atol=1e-15)


def test_elbo_and_its_gradients_against_jax_rank2():
    cfg = _config()
    rng = np.random.RandomState(2)
    leaves = _leaves(cfg, rng)
    X, Y = _data(rng)
    scales = np.array([3.0, 5.0, 2.0])
    jdata = tuple(jelbo.task_data(x, y) for x, y in zip(X, Y))

    def jf(leaf_dict):
        p = JParams(**leaf_dict, rank=R)
        return jelbo.elbo_fn(p, jdata, jnp.asarray(scales), cfg)[0]

    jleaves = {k: jnp.asarray(v) for k, v in leaves.items()}
    want, jgrads = jax.jit(jax.value_and_grad(jf))(jleaves)
    tcfg, params = _port(cfg, leaves)
    t = {f: getattr(params, f).clone().requires_grad_() for f in FIELDS}
    got, _ = telbo.elbo_fn(tp.SVMOGPParams(**t, rank=R),
                           tp.make_dataset(X, Y, tcfg, device="cpu"),
                           torch.from_numpy(scales), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-9)
    grads = torch.autograd.grad(got, [t[f] for f in FIELDS],
                                allow_unused=True)
    for f, g in zip(FIELDS, grads):
        w = np.asarray(jgrads[f])
        if not np.any(w):
            assert g is None or not torch.any(g), f
            continue
        assert _normwise(g, w) < 1e-8, (f, _normwise(g, w))


def test_ten_steps_match_jax_make_svi_step_rank2():
    cfg = _config()
    rng = np.random.RandomState(3)
    leaves = _leaves(cfg, rng)
    tc = jhet.TrainConfig(optimizer="adam", step_rate=0.01,
                          minibatch="slice", vm_batch_fraction=0.5)
    jstep = jtrain.make_svi_step(cfg, tc)
    js = jtrain.init_train_state(
        JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}, rank=R),
        cfg, jtrain.make_optimizer(tc))
    tcfg, params = _port(cfg, leaves)
    ttc = tp.TrainConfig.from_dict(dataclasses.asdict(tc))
    ts = tp.init_train_state(params, tcfg)
    tstep = ttrain.make_step(tcfg, ttc)
    scales = np.full(3, 20.0)
    for s in range(10):
        X, Y = _data(rng)
        js, jm = jstep(js, tuple(jelbo.task_data(x, y) for x, y in zip(X, Y)),
                       jnp.asarray(scales))
        ts, tm = tstep(ts, tp.make_dataset(X, Y, tcfg, device="cpu"),
                       torch.from_numpy(scales))
        np.testing.assert_allclose(tm["elbo"].item(), float(jm["elbo"]),
                                   rtol=1e-10, err_msg=f"step {s}")
        jadam = js.opt_state[0]
        for f in FIELDS:
            for got, want, what in ((ts.params, js.params, "param"),
                                    (ts.opt_state.mu, jadam.mu, "mu"),
                                    (ts.opt_state.nu, jadam.nu, "nu")):
                g, w = getattr(got, f), getattr(want, f)
                if not np.any(np.asarray(w)):
                    assert not torch.any(g), (s, what, f)
                    continue
                assert _normwise(g, w) < 1e-8, (s, what, f, _normwise(g, w))
        assert _normwise(ts.iLuu, js.iLuu) < 1e-8, s
        assert ts.params.rank == R


def test_export_rank2_roundtrip():
    """The counterpart of the JAX package's rank-2 export test: the flat
    signature rebuilds params of the config's rank."""
    jcfg = jhet.ModelConfig(likelihoods=(jhet.Gaussian(),), num_latent=2,
                            num_inducing=4, input_dim=1, dtype="float64",
                            rank=2)
    jp = jinit(jax.random.PRNGKey(0), jcfg, np.linspace(0, 1, 4)[:, None],
               lengthscale=0.3)
    X = np.linspace(0, 1, 7)[:, None]
    tcfg = tp.ModelConfig.from_dict(jcfg.to_dict())
    params = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    assert params.q_mu.shape[0] == 4  # Q*R copies
    blob = export.export_predictive(params, tcfg, [X])
    fn = export.load_predictive(blob)
    out = fn(*export.params_args(params), torch.from_numpy(X))
    m_ref, v_ref = tp.predictive(params, tcfg, [X])
    np.testing.assert_allclose(out[0].numpy(), m_ref[0].numpy(), rtol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), v_ref[0].numpy(), rtol=1e-10)
    jm, jv = jpredict.predictive(jp, jcfg, [X])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jm[0]), rtol=1e-8)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jv[0]), rtol=1e-8)


@pytest.mark.parametrize("bad", [0, -1, 1.5, True])
def test_config_refuses_a_bad_rank(bad):
    with pytest.raises(ValueError, match="rank"):
        tp.ModelConfig(likelihoods=(tp.Gaussian(),), num_latent=1,
                       num_inducing=4, input_dim=1, rank=bad)
