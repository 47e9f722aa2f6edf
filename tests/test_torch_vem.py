"""The port's ELBO paths without a cache, its data stream and its fits
against the JAX package's, on the CPU, in float64.

* The un-whitened KL and ELBO against JAX and ``tests/oracle_numpy.py``
  on the oracle's eight-likelihood problem (the JAX package's adaptive
  jitter from 0), and ``whiten_params``/``unwhiten_params`` round trips:
  the oracle tests' tolerances (ELBO rtol 1e-9, atol 1e-6; KL atol 1e-9).
* ``elbo_fn`` without a cache: the solve path, per task, with no inverse
  formed, against JAX's ``elbo_fn`` (rtol 1e-10).
* ``MinibatchStream`` draws JAX's batches from the same seed, exactly.
* ``svi_fit`` over ``MinibatchStream(seed=...)`` in both packages: whole
  ELBO histories to 1e-8 relative (the factorization's rounding, 1e-12,
  carried through 40 steps of each optimizer).
* ``vem_algorithm``: the final ELBO within 1e-3 relative of JAX's (the two
  L-BFGS implementations take different line searches, so the iterates
  differ; both runs end near the same optimum), and each half-step raises
  the ELBO.
* A JAX ``ModelConfig`` with its defaults (adaptive jitter) loads and
  trains through ``make_step``; the callbacks and ``MetricsLogger``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import data as jdata
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import metrics as jmetrics
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import init_params as jinit_params
from tests import oracle_numpy as oracle
from tests.test_elbo_oracle import _mixed_problem

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.ops import linalg

torch.set_num_threads(1)


def _oracle_port():
    cfg, jparams, jdata_, scales, oa = _mixed_problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(jparams, device="cpu")
    tdata = tp.make_dataset(oa["X_list"], oa["Y_list"], tcfg, device="cpu")
    return cfg, jparams, jdata_, scales, oa, tcfg, tparams, tdata


def test_unwhitened_kl_and_elbo_match_jax_and_the_oracle():
    cfg, jparams, jdata_, scales, oa, tcfg, tparams, tdata = _oracle_port()
    assert not tcfg.whiten and tcfg.adaptive_jitter
    Luu = telbo.prior_cholesky(tparams, tcfg)
    kl = telbo.kl_divergence(tparams, tcfg, Luu).item()
    np.testing.assert_allclose(kl, oracle.kl_divergence(
        oa["Z"], oa["lengthscales"], oa["variances"], oa["m_u"], oa["L_u"]),
        atol=1e-9)
    got, aux = telbo.elbo_fn(tparams, tdata, torch.from_numpy(scales), tcfg)
    np.testing.assert_allclose(got.item(), oracle.elbo(**oa), rtol=1e-9,
                               atol=1e-6)
    want = jax.jit(lambda p: jelbo.elbo_fn(p, jdata_, jnp.asarray(scales),
                                           cfg)[0])(jparams)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    np.testing.assert_allclose(aux["kl"].item(), kl, rtol=1e-12)


def test_whitening_round_trips_and_keeps_the_elbo():
    cfg, jparams, _, scales, oa, tcfg, tparams, tdata = _oracle_port()
    s = torch.from_numpy(scales)
    e_u = telbo.elbo_fn(tparams, tdata, s, tcfg)[0]
    tcfg_w = dataclasses.replace(tcfg, whiten=True)
    pw = telbo.whiten_params(tparams, tcfg)
    jw = jax.jit(lambda p: jelbo.whiten_params(p, cfg))(jparams)
    np.testing.assert_allclose(pw.q_mu.numpy(), np.asarray(jw.q_mu),
                               atol=1e-9)
    np.testing.assert_allclose(pw.q_sqrt.numpy(), np.asarray(jw.q_sqrt),
                               atol=1e-9)
    e_w = telbo.elbo_fn(pw, tdata, s, tcfg_w)[0]
    np.testing.assert_allclose(e_w.item(), e_u.item(), atol=1e-8)
    back = telbo.unwhiten_params(pw, tcfg)
    np.testing.assert_allclose(back.q_mu.numpy(), tparams.q_mu.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(back.q_sqrt.numpy(),
                               np.tril(tparams.q_sqrt.numpy()), atol=1e-9)
    # batch_qf_moments: the per-task moments of the same solve path
    Luu = telbo.prior_cholesky(tparams, tcfg)
    for t, (m, v) in enumerate(telbo.batch_qf_moments(
            tparams, tcfg, oa["X_list"][:3], tasks=(0, 1, 2))):
        want = telbo.task_qf_moments(tparams, tcfg, Luu, tdata[t].X, t)
        assert torch.equal(m, want[0]) and torch.equal(v, want[1])
    f = tp.build_elbo(tcfg)
    assert f(tparams, tdata, s)[0].item() == e_u.item()


@pytest.mark.parametrize("whiten", [True, False])
def test_elbo_without_a_cache_takes_the_solve_path(monkeypatch, whiten):
    """With no cache ``elbo_fn`` factorizes and solves per task, as the JAX
    package does, and forms no inverse; with ``Luu`` alone it solves
    against it."""
    cfg, jparams, jdata_, scales, oa, tcfg, tparams, tdata = _oracle_port()
    cfg = dataclasses.replace(cfg, whiten=whiten, adaptive_jitter=False,
                              jitter=1e-8)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    want = float(jax.jit(lambda p: jelbo.elbo_fn(
        p, jdata_, jnp.asarray(scales), cfg)[0])(jparams))
    Luu = telbo.prior_cholesky(tparams, tcfg)

    def boom(K):
        raise AssertionError("an explicit inverse was computed")

    monkeypatch.setattr(linalg, "blocked_cholesky_inverse", boom)
    monkeypatch.setattr(linalg, "tri_inverse", boom)
    s = torch.from_numpy(scales)
    for kw in ({}, {"Luu": Luu}):
        got = telbo.elbo_fn(tparams, tdata, s, tcfg, **kw)[0]
        np.testing.assert_allclose(got.item(), want, rtol=1e-10)
    with pytest.raises(AssertionError, match="explicit inverse"):
        telbo.prior_cholesky_inverse(tparams, tcfg)


def _stream_problem(n=60, m=8):
    rng = np.random.RandomState(0)
    liks = (jliks.Gaussian(sigma=0.5), jliks.Bernoulli())
    cfg = jhet.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=m,
                           input_dim=1, dtype="float64", jitter=1e-6,
                           adaptive_jitter=False)
    X = [np.sort(rng.rand(n, 1), 0), np.sort(rng.rand(n - 7, 1), 0)]
    Y = [np.sin(6 * X[0]) + 0.2 * rng.randn(n, 1),
         (rng.rand(n - 7, 1) < 0.5).astype(float)]
    params = jinit_params(jax.random.PRNGKey(0), cfg,
                          np.linspace(0, 1, m)[:, None], lengthscale=0.2,
                          q_mu_scale=0.5)
    return cfg, params, X, Y


def test_minibatch_stream_draws_jax_batches():
    _, _, X, Y = _stream_problem()
    js = jdata.MinibatchStream(X, Y, [16, 64], seed=3, pad_multiple=4)
    ts = tp.MinibatchStream(X, Y, [16, 64], seed=3, pad_multiple=4,
                            dtype=torch.float64, device="cpu")
    for _ in range(9):  # past an epoch of both tasks
        (jb, jsc), (tb, tsc) = js.next(), ts.next()
        np.testing.assert_array_equal(tsc, jsc)
        for j, t in zip(jb, tb):
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    masks = [b.mask.numpy() for b in tb]
    assert tp.batch_scales(X, [b.X for b in tb], masks) == \
        jdata.batch_scales(X, [np.asarray(b.X) for b in jb], masks)


@pytest.mark.parametrize("optimizer,vem", [
    ("adam", True), ("adadelta", True), ("natgrad_adam", True),
    ("natgrad_adam", False)])
def test_svi_fit_histories_match_jax(optimizer, vem):
    cfg, jparams, X, Y = _stream_problem()
    kw = dict(optimizer=optimizer, step_rate=0.02, natgrad_lr=0.3)
    steps = 40 if vem else 15

    def stream(make, **dkw):
        return make(X, Y, 24, shuffle=True, seed=1, **dkw)

    _, jh = jtrain.svi_fit(jparams, cfg, jhet.TrainConfig(**kw),
                           stream(jdata.MinibatchStream, dtype=np.float64),
                           steps, vem=vem)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    _, th = tp.svi_fit(tp.params_from_jax(jparams, device="cpu"), tcfg,
                       tp.TrainConfig(**kw),
                       stream(tp.MinibatchStream, dtype=torch.float64,
                              device="cpu"), steps, vem=vem)
    np.testing.assert_allclose(th, jh, rtol=1e-8)
    assert th[-10:].mean() > th[:10].mean()


def test_vem_algorithm_reaches_the_jax_elbo():
    cfg, jparams, X, Y = _stream_problem(n=40, m=6)
    tc = dict(vem_iters=2, batch_inner_iters=15)
    jp, jh = jtrain.vem_algorithm(jparams, cfg, X, Y,
                                  train_config=jhet.TrainConfig(**tc))
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(jparams, device="cpu")
    tp_, th = tp.vem_algorithm(tparams, tcfg, X, Y,
                               train_config=tp.TrainConfig(**tc))
    assert th.shape == jh.shape == (4,)
    data, scales = tp.full_batch(X, Y, dtype=torch.float64, device="cpu")
    s = torch.from_numpy(scales)
    e0 = telbo.elbo_fn(tparams, data, s, tcfg)[0].item()
    e_port = telbo.elbo_fn(tp_, data, s, tcfg)[0].item()
    jd, js_ = jdata.full_batch(X, Y, dtype=np.float64)
    e_jax = float(jelbo.elbo_fn(jp, jd, jnp.asarray(js_), cfg)[0])
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-3)
    np.testing.assert_allclose(th[-1], e_port, rtol=1e-12)
    assert e0 < th[0] and np.all(np.diff(th) > -1e-6 * abs(th[-1]))
    # the VE half-steps move only q, the VM half-steps only the hypers
    ve_only, _ = tp.vem_algorithm(tparams, tcfg, X, Y, train_config=dataclasses
                                  .replace(tp.TrainConfig(**tc), vem_iters=1,
                                           learn_inducing=False))
    assert torch.equal(ve_only.Z, tparams.Z)
    assert torch.equal(ve_only.kappa, tparams.kappa)
    assert not torch.equal(ve_only.q_mu, tparams.q_mu)
    with pytest.raises(ValueError, match="MinibatchStream"):
        tp.vem_algorithm(tparams, tcfg, X, Y, stochastic=True)


def test_jax_default_config_loads_and_trains_with_adaptive_jitter():
    """A JAX ``ModelConfig(...).to_dict()`` with its defaults (adaptive
    jitter from 0) loads, and the host-loop step trains on it (jitchol's
    host loop runs eagerly on the CPU); the graphed trainer refuses it for
    a CUDA device when made."""
    cfg, jparams, X, Y = _stream_problem()
    jcfg = jhet.ModelConfig(likelihoods=cfg.likelihoods, num_latent=2,
                            num_inducing=8, input_dim=1, dtype="float64")
    tcfg = tp.ModelConfig.from_dict(jcfg.to_dict())
    assert tcfg.adaptive_jitter and tcfg.jitter == 0.0
    assert tcfg.to_dict() == jcfg.to_dict()
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.02)
    state = tp.init_train_state(tp.params_from_jax(jparams, device="cpu"),
                                tcfg, tc)
    step = ttrain.make_step(tcfg, tc)
    data = tp.make_dataset(X, Y, tcfg, device="cpu")
    scales = torch.ones(2, dtype=torch.float64)
    elbos = []
    for _ in range(10):
        state, m = step(state, data, scales)
        elbos.append(m["elbo"].item())
    jstep = jtrain.make_svi_step(jcfg, jhet.TrainConfig(optimizer="adam",
                                                        step_rate=0.02))
    js = jtrain.init_train_state(jparams, jcfg, jtrain.make_optimizer(
        jhet.TrainConfig(optimizer="adam", step_rate=0.02)))
    jd = tuple(jelbo.task_data(x, y) for x, y in zip(X, Y))
    for e in elbos:
        js, jm = jstep(js, jd, jnp.ones(2))
        np.testing.assert_allclose(e, float(jm["elbo"]), rtol=1e-8)
    assert elbos[-1] > elbos[0]
    with pytest.raises(ValueError, match="adaptive_jitter"):
        tp.make_scan_trainer(tcfg, tc, (60, 53), (16, 16), device="cuda")
    tp.make_scan_trainer(tcfg, tc, (60, 53), (16, 16), device="cpu")


def test_jax_config_of_default_precision_loads_and_trains_at_highest():
    """A JAX ``ModelConfig(ve_fwd_precision="default").to_dict()``, a
    value the JAX package runs at HIGHEST (it runs every value but "high"
    so), loads as it is, and the port runs it at "highest": its ELBO with
    the cached inverse is the JAX one in float64 and bitwise the port's at
    "highest", and ten steps train as the JAX package's do."""
    cfg, jparams, X, Y = _stream_problem()
    jcfg = dataclasses.replace(cfg, ve_fwd_precision="default")
    tcfg = tp.ModelConfig.from_dict(jcfg.to_dict())
    assert tcfg.ve_fwd_precision == "default"
    assert tcfg.projection_precision == "highest"
    assert tcfg.to_dict() == jcfg.to_dict()
    highest = dataclasses.replace(tcfg, ve_fwd_precision="highest")
    params = tp.params_from_jax(jparams, device="cpu")
    data = tp.make_dataset(X, Y, tcfg, device="cpu")
    scales = torch.ones(2, dtype=torch.float64)
    Luu, iLuu = telbo.prior_cholesky_inverse(params, tcfg)
    got = telbo.elbo_fn(params, data, scales, tcfg, Luu=Luu, iLuu=iLuu)[0]
    same = telbo.elbo_fn(params, data, scales, highest, Luu=Luu,
                         iLuu=iLuu)[0]
    assert torch.equal(got, same)
    jd = tuple(jelbo.task_data(x, y) for x, y in zip(X, Y))
    jL, jiL = jelbo.prior_cholesky_inverse(jparams, jcfg)
    want = jelbo.elbo_fn(jparams, jd, jnp.ones(2), jcfg, Luu=jL, iLuu=jiL)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.02)
    state = tp.init_train_state(params, tcfg, tc)
    step = ttrain.make_step(tcfg, tc)
    jtc = jhet.TrainConfig(optimizer="adam", step_rate=0.02)
    jstep = jtrain.make_svi_step(jcfg, jtc)
    js = jtrain.init_train_state(jparams, jcfg,
                                 jtrain.make_optimizer(jtc))
    elbos = []
    for _ in range(10):
        state, m = step(state, data, scales)
        js, jm = jstep(js, jd, jnp.ones(2))
        np.testing.assert_allclose(m["elbo"].item(), float(jm["elbo"]),
                                   rtol=1e-8)
        elbos.append(m["elbo"].item())
    assert elbos[-1] > elbos[0]


def test_callbacks_and_the_metrics_logger(capsys, tmp_path):
    cb = tp.print_callback(every=50)
    for i in range(120):
        cb(i, {"elbo": torch.tensor(-float(i))})
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3 and out[1] == "svi - iteration 50 elbo -50.000000"

    path = tmp_path / "elbo.png"
    plot = tp.plot_callback(every=5, path=str(path))
    for i in range(12):
        plot(i, {"elbo": torch.tensor(float(i) ** 0.5)})
    assert path.is_file() and path.stat().st_size > 0
    assert plot.history == pytest.approx([i ** 0.5 for i in range(12)])

    lines, jlines = [], []
    logger = tp.MetricsLogger(print_every=2, jsonl_path=str(tmp_path / "m"),
                              printer=lines.append)
    jlogger = jmetrics.MetricsLogger(print_every=2, printer=jlines.append)
    for i in range(4):
        metrics = {"elbo": torch.tensor(-1.5 * i, dtype=torch.float64),
                   "ve": torch.tensor([1.0, 2.0 + i], dtype=torch.float64)}
        logger(i, metrics)
        jlogger(i, {k: jnp.asarray(v.numpy()) for k, v in metrics.items()})
    logger.close()
    assert lines == jlines == ["svi - iteration 2: elbo=-1.5000",
                               "svi - iteration 4: elbo=-4.5000"]
    np.testing.assert_array_equal(logger.elbo, jlogger.elbo)
    recs = [json.loads(s) for s in (tmp_path / "m").read_text().splitlines()]
    assert [r["ve"] for r in recs] == [[1.0, 2.0 + i] for i in range(4)]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]

    # svi_fit hands every step's metrics to the callback
    cfg, jparams, X, Y = _stream_problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    seen = tp.MetricsLogger(print_every=0)
    _, hist = tp.svi_fit(tp.params_from_jax(jparams, device="cpu"), tcfg,
                         tp.TrainConfig(optimizer="adam", step_rate=0.02),
                         tp.MinibatchStream(X, Y, 24, dtype=torch.float64,
                                            device="cpu"), 6, callback=seen)
    np.testing.assert_array_equal(seen.elbo, hist)
