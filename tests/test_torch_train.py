"""The port's trainer against the JAX package's, on the same numpy inputs.

* Ten steps of the port's ``make_step`` against JAX ``make_svi_step`` on
  the same injected batches in float64 (the six-likelihood bench model cut
  to Q=2, M=256, 32 rows a task, adam, ``vm_batch_fraction=0.25``): steps
  4 and 9 are VM steps, each followed by the (Luu, iLuu) refresh.  After
  every step the ELBO, every parameter, the adam moments and the cache are
  compared.  Tolerances, normwise max|a - b| / max|b|: 1e-12 for the ELBO
  (rtol), 1e-8 for parameters, moments and the cache.  The two packages
  differ by the rounding of a Cholesky factorization and of products with
  its explicit inverse (entries ~1e2 at jitter 1e-4), about cond * eps ~
  1e-11; adam carries a gradient's relative error into its moments
  unchanged and into the update at most doubled, over ten steps.
* The slice sampler, ``vm_batch_fraction`` prefix, ``skip_nonfinite_steps``
  and the config's refusals; the trainer loop against the step it runs.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import SVMOGPParams as JParams

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models.params import FIELDS

torch.set_num_threads(1)

Q, M, DX, B = 2, 256, 2, 32
NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
         "Exponential")
TC = dict(optimizer="adam", step_rate=0.005, minibatch="slice",
          vm_batch_fraction=0.25)


def _observations(rng, n):
    return [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
            rng.randint(1, 4, (n, 1)).astype(float),
            rng.poisson(3.0, (n, 1)).astype(float),
            rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
            rng.exponential(1.0, (n, 1)) + 1e-3]


def _model(m=M, dtype="float64", seed=0):
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)()
                                             for n in NAMES),
                           num_latent=Q, num_inducing=m, input_dim=DX,
                           dtype=dtype, jitter=1e-4, adaptive_jitter=False,
                           ard=True)
    rng = np.random.RandomState(seed)
    D = cfg.num_output_functions
    leaves = dict(Z=np.broadcast_to(rng.rand(m, DX), (Q, m, DX)).copy(),
                  q_mu=0.1 * rng.randn(Q, m),
                  q_sqrt=0.5 * np.eye(m) + 0.01 * np.tril(rng.randn(Q, m, m)),
                  log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.zeros((Q, D)))
    return cfg, leaves, rng


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def test_ten_steps_match_jax_make_svi_step():
    cfg, leaves, rng = _model()
    tc = jhet.TrainConfig(**TC)
    jstep = jtrain.make_svi_step(cfg, tc)
    js = jtrain.init_train_state(JParams(**{k: jnp.asarray(v) for k, v
                                            in leaves.items()}), cfg,
                                 jtrain.make_optimizer(tc))
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ttc = tp.TrainConfig.from_dict(dataclasses.asdict(tc))
    ts = tp.init_train_state(tp.params_from_jax(
        types.SimpleNamespace(**leaves), device="cpu"), tcfg)
    tstep = ttrain.make_step(tcfg, ttc)
    scales = np.full(len(NAMES), 100.0)
    for s in range(10):
        X = [rng.rand(B, DX) for _ in NAMES]
        Y = _observations(rng, B)
        js, jm = jstep(js, tuple(jelbo.task_data(x, y) for x, y in zip(X, Y)),
                       jnp.asarray(scales))
        ts, tm = tstep(ts, tp.make_dataset(X, Y, tcfg, device="cpu"),
                       torch.from_numpy(scales))
        np.testing.assert_allclose(tm["elbo"].item(), float(jm["elbo"]),
                                   rtol=1e-12, err_msg=f"step {s}")
        jadam = js.opt_state[0]
        assert ts.step == int(js.step) == s + 1
        assert ts.opt_state.count.item() == int(jadam.count)
        for f in FIELDS:
            for got, want, what in ((ts.params, js.params, "param"),
                                    (ts.opt_state.mu, jadam.mu, "mu"),
                                    (ts.opt_state.nu, jadam.nu, "nu")):
                g, w = getattr(got, f), getattr(want, f)
                if not np.any(np.asarray(w)):
                    assert not torch.any(g), (s, what, f)
                    continue
                assert _normwise(g, w) < 1e-8, (s, what, f, _normwise(g, w))
        assert _normwise(ts.Luu, js.Luu) < 1e-8, s
        assert _normwise(ts.iLuu, js.iLuu) < 1e-8, s


def test_masks_match_jax():
    cfg, leaves, _ = _model(m=8)
    jp = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    for kw in ({}, {"learn_inducing": False}, {"learn_W": False}):
        tc = jhet.TrainConfig(**TC, **kw)
        ttc = tp.TrainConfig(**TC, **kw)
        for jmask, free in ((jtrain.ve_mask(jp), ttrain.ve_mask()),
                            (jtrain.vm_mask(jp, tc), ttrain.vm_mask(ttc))):
            want = {f for f in FIELDS if float(getattr(jmask, f)) == 1.0}
            assert set(free) == want, kw


def _ragged_dataset(rng, sizes):
    X = [rng.rand(n, DX) for n in sizes]
    Y = [rng.randn(n, 1) for n in sizes]
    masks = [(rng.rand(n) > 0.2).astype(float) for n in sizes]
    return X, Y, masks


def test_slice_sampler_matches_jax_wraparound():
    rng = np.random.RandomState(1)
    sizes, batches = (50, 37, 20, 64), (16, 16, 32, 8)
    X, Y, masks = _ragged_dataset(rng, sizes)
    jds = tuple(jelbo.task_data(x, y, m) for x, y, m in zip(X, Y, masks))
    tds = tuple(tp.TaskData(*(torch.from_numpy(np.asarray(a)) for a in
                              (x, y, m))) for x, y, m in zip(X, Y, masks))
    jext = jtrain.extend_for_wraparound(jds, batches, sizes)
    text = ttrain.extend_for_wraparound(tds, batches, sizes)
    for offsets in ((0, 0, 0, 0), (49, 30, 0, 60), (40, 36, 0, 57)):
        got = ttrain.slice_batch(text, offsets, sizes, batches)
        for t, (jt, tt) in enumerate(zip(jext, got)):
            bt = min(batches[t], sizes[t])
            for ja, ta in zip(jt, tt):
                want = jax.lax.dynamic_slice_in_dim(ja, offsets[t], bt, 0)
                np.testing.assert_array_equal(ta.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(3)
    draws = np.array([ttrain.draw_offsets(gen, sizes, batches)
                      for _ in range(200)])
    assert (draws[:, 2] == 0).all()  # B >= N: the whole task
    for t in (0, 1, 3):
        assert draws[:, t].min() >= 0 and draws[:, t].max() < sizes[t]
        assert len(set(draws[:, t])) > 10
    again = torch.Generator().manual_seed(3)
    assert ttrain.draw_offsets(again, sizes, batches) == tuple(draws[0])
    np.testing.assert_array_equal(
        ttrain.batch_scales(sizes, batches, torch.float64, "cpu").numpy(),
        [50 / 16, 37 / 16, 1.0, 64 / 8])


def test_vm_sub_batch_prefix_and_scales():
    """The first ceil(0.25 B) rows of each task, and the scales re-derived
    from the mask sums, as the JAX step body forms them."""
    rng = np.random.RandomState(2)
    X, Y, masks = _ragged_dataset(rng, (32, 30, 9))
    masks[1][:8] = 0.0  # a task whose prefix is all masked: sum clamps at 1
    data = tuple(tp.TaskData(*(torch.from_numpy(np.asarray(a)) for a in
                               (x, y, m))) for x, y, m in zip(X, Y, masks))
    scales = torch.tensor([3.0, 4.0, 5.0], dtype=torch.float64)
    sub, sub_scales = ttrain.vm_sub_batch(data, scales, 0.25)
    ks = [int(np.ceil(n * 0.25)) for n in (32, 30, 9)]
    assert [td.X.shape[0] for td in sub] == ks == [8, 8, 3]
    want = [s * max(m.sum(), 1.0) / max(m[:k].sum(), 1.0)
            for s, m, k in zip((3.0, 4.0, 5.0), masks, ks)]
    np.testing.assert_allclose(sub_scales.numpy(), want, rtol=1e-15)
    for td, x in zip(sub, X):
        np.testing.assert_array_equal(td.X.numpy(), x[:td.X.shape[0]])
    full, same = ttrain.vm_sub_batch(data, scales, 1.0)
    assert full is not sub and same is scales


def _small_trainer(tc_kw=None, m=16):
    cfg, leaves, rng = _model(m=m)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ttc = tp.TrainConfig(**{**TC, **(tc_kw or {})})
    state = tp.init_train_state(tp.params_from_jax(
        types.SimpleNamespace(**leaves), device="cpu"), tcfg)
    X = [rng.rand(100, DX) for _ in NAMES]
    return tcfg, ttc, state, tp.make_dataset(X, _observations(rng, 100), tcfg,
                                             device="cpu")


def test_skip_nonfinite_steps_keeps_the_state():
    tcfg, ttc, state, data = _small_trainer({"skip_nonfinite_steps": True})
    step = ttrain.make_step(tcfg, ttc)
    scales = torch.ones(len(NAMES), dtype=torch.float64)
    poisoned = list(data)
    poisoned[0] = poisoned[0]._replace(Y=torch.full_like(data[0].Y,
                                                         float("nan")))
    for s in range(5):  # VE steps and a VM step
        new, metrics = step(state, tuple(poisoned), scales)
        assert metrics["skipped"].item() == 1 and new.step == state.step + 1
        for f in FIELDS:
            assert torch.equal(getattr(new.params, f),
                               getattr(state.params, f)), (s, f)
            assert torch.equal(getattr(new.opt_state.nu, f),
                               getattr(state.opt_state.nu, f)), (s, f)
        assert new.opt_state.count.item() == state.opt_state.count.item()
        assert torch.equal(new.iLuu, state.iLuu)
        state = new
    new, metrics = step(state, data, scales)
    assert metrics["skipped"].item() == 0
    assert new.opt_state.count.item() == 1
    assert not torch.equal(new.params.q_sqrt, state.params.q_sqrt)


def test_trainer_runs_the_step_on_slices():
    """make_trainer's ELBOs are the step's on the slices at the offsets its
    generator draws, and the ELBO rises over 40 steps."""
    tcfg, ttc, state, data = _small_trainer()
    sizes, batches = (100,) * len(NAMES), (16,) * len(NAMES)
    run = tp.make_trainer(tcfg, ttc, sizes, batches, steps_per_call=10)
    new, elbos = run(state, data, torch.Generator().manual_seed(7))
    assert elbos.shape == (10,) and new.step == 10
    gen = torch.Generator().manual_seed(7)
    step = ttrain.make_step(tcfg, ttc)
    ext = ttrain.extend_for_wraparound(data, batches, sizes)
    scales = ttrain.batch_scales(sizes, batches, torch.float64, "cpu")
    s = state
    for i in range(10):
        batch = ttrain.slice_batch(ext, ttrain.draw_offsets(gen, sizes,
                                                             batches),
                                   sizes, batches)
        s, metrics = step(s, batch, scales)
        assert metrics["elbo"].item() == elbos[i].item()
    more = [elbos]
    for _ in range(3):
        new, elbos = run(new, data, gen)
        more.append(elbos)
    e = torch.cat(more)
    assert torch.isfinite(e).all()
    assert e[-5:].mean() > e[:5].mean()


def test_train_config_matches_jax_and_refuses_the_unported():
    """Field for field the JAX package's config; every optimizer, schedule,
    sampler and the solve path load (the refusals of the flagship-only
    trainer are gone, and so is the refusal of the JAX defaults), an
    unknown name raises, and natural gradients refuse the un-whitened
    model."""
    jfields = {f.name: f.default for f in dataclasses.fields(jhet.TrainConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tp.TrainConfig)}
    assert tfields == jfields
    jtc = jhet.TrainConfig(**TC, lr_schedule_kwargs=())
    ttc = tp.TrainConfig.from_dict(dataclasses.asdict(jtc))
    assert ttc.to_dict() == dataclasses.asdict(jtc)
    assert tp.TrainConfig.from_dict(ttc.to_dict()) == ttc
    for change in ({"optimizer": "adadelta"}, {"optimizer": "natgrad_adam"},
                   {"lr_schedule": "cosine"}, {"clip_grad_norm": 1.0},
                   {"minibatch": "gather"}, {"fast_projection": False}):
        jtc = jhet.TrainConfig(**{**TC, **change})
        assert (tp.TrainConfig.from_dict(dataclasses.asdict(jtc)).to_dict()
                == dataclasses.asdict(jtc))
    assert tp.TrainConfig().to_dict() == dataclasses.asdict(
        jhet.TrainConfig())  # the JAX defaults: adadelta and gather
    for change, match in ((dict(optimizer="sgd"), "optimizer"),
                          (dict(minibatch="shuffle"), "sampler"),
                          (dict(natgrad_retraction="qr"), "retraction")):
        with pytest.raises(ValueError, match=match):
            tp.TrainConfig(**{**TC, **change})
    cfg, _, _ = _model(m=8)
    unwhitened = dataclasses.replace(tp.ModelConfig.from_dict(cfg.to_dict()),
                                     whiten=False)
    ttrain.make_step(unwhitened, tp.TrainConfig(**TC))
    with pytest.raises(ValueError, match="whiten"):
        ttrain.make_step(unwhitened, tp.TrainConfig(
            **{**TC, "optimizer": "natgrad_adam"}))


def test_learn_lik_params_trains_theta():
    """``TrainConfig(learn_lik_params=True)`` trains: the host loop moves
    every theta of the likelihoods that have one (the Ordinal's
    thresholds, a Gaussian's and a StudentT's), in the VM steps only, with
    a finite ELBO, and a Poisson's (0,) leaf stays empty."""
    liks = (tp.Ordinal(K=3), tp.Gaussian(learn_sigma=True),
            tp.StudentT(learn_df=True), tp.Poisson())
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=16,
                         input_dim=DX, dtype="float64", jitter=1e-4,
                         adaptive_jitter=False)
    rng = np.random.RandomState(2)
    n = 60
    X = [rng.rand(n, DX) for _ in liks]
    Y = [rng.randint(1, 4, (n, 1)).astype(float), 2.0 * rng.randn(n, 1),
         rng.standard_t(3.0, (n, 1)), rng.poisson(2.0, (n, 1)).astype(float)]
    params = tp.init_params(np.random.default_rng(0), cfg, rng.rand(16, DX),
                            lengthscale=0.3, q_mu_scale=0.1,
                            with_lik_theta=True, device="cpu")
    tc = tp.TrainConfig(**TC, learn_lik_params=True)
    assert "lik_theta" in ttrain.vm_mask(tc)
    assert "lik_theta" not in ttrain.vm_mask(tp.TrainConfig(**TC))
    sizes, batches = (n,) * len(liks), (16,) * len(liks)
    run = tp.make_trainer(cfg, tc, sizes, batches, steps_per_call=4)
    state = tp.init_train_state(params, cfg)
    gen = torch.Generator().manual_seed(1)
    state, e_ve = run(state, tp.make_dataset(X, Y, cfg, device="cpu"), gen)
    for a, b in zip(state.params.lik_theta, params.lik_theta):
        assert torch.equal(a, b)  # four VE steps: theta frozen
    state, e = run(state, tp.make_dataset(X, Y, cfg, device="cpu"), gen)
    assert torch.isfinite(torch.cat([e_ve, e])).all()
    for lik, a, b in zip(liks, state.params.lik_theta, params.lik_theta):
        assert torch.isfinite(a).all()
        assert (not torch.equal(a, b)) == bool(lik.n_theta), lik
    assert state.params.lik_theta[-1].shape == (0,)
