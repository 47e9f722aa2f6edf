"""The port's optimizers, schedules, samplers and loops against the JAX
package's, on the CPU, in float64.

* ``climin_adadelta`` with its lookahead against ``tests/test_train.py``'s
  numpy replica of climin (1e-12 over 100 steps); each LR schedule's rate
  against optax's at steps 0..N (equal, in optax's float32 or float64);
  ``clip_by_global_norm``
  then adam against ``optax.chain`` (1e-12).
* Ten steps of ``make_step`` against ``make_svi_step`` on the same
  injected batches for adadelta (the lookahead masked to the mode's
  leaves, the VM step off the cache), adam with each schedule and
  clipping, joint mode (``vem=False``) with adam and with natural
  gradients, the un-whitened model and the solve path
  (``fast_projection=False``): ELBO 1e-10 relative, every parameter, the
  optimizer's state and the cache 1e-8 normwise (a factorization and the
  products with its inverse round differently in the two packages, about
  cond * eps ~ 1e-12 here, carried through ten steps).
* The gather sampler on given indices, against JAX's step on the same
  gathered rows; the graphed loop (eager on the CPU) against the host
  loop, bitwise, for every optimizer and sampler; ``svi_fit_on_device``
  with ``vem=False``, and its warning when natural gradients freeze q.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import init_params as jinit_params

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models.params import FIELDS

torch.set_num_threads(1)

TOL = 1e-8
SIZES = (50, 40, 12)  # task 2 is smaller than its batch
B = 16


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _problem(whiten=True, m=8):
    rng = np.random.RandomState(0)
    liks = (jliks.HetGaussian(), jliks.Bernoulli(), jliks.Poisson())
    cfg = jhet.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=m,
                           input_dim=1, dtype="float64", jitter=1e-6,
                           adaptive_jitter=False, whiten=whiten)
    X = [np.sort(rng.rand(n, 1), 0) for n in SIZES]
    Y = [rng.randn(SIZES[0], 1), (rng.rand(SIZES[1], 1) > 0.5).astype(float),
         rng.poisson(2.0, (SIZES[2], 1)).astype(float)]
    params = jinit_params(jax.random.PRNGKey(0), cfg,
                          np.linspace(0, 1, m)[:, None], lengthscale=0.25,
                          q_mu_scale=0.5)
    return cfg, params, X, Y


def test_climin_adadelta_matches_the_numpy_replica():
    step_rate, decay, momentum, offset = 0.05, 0.9, 0.9, 1e-4
    A = np.diag([1.0, 3.0, 0.5, 10.0])
    b = np.array([1.0, -2.0, 0.5, 3.0])
    w = np.array([2.0, 2.0, -1.0, 0.5])
    gms, sms, step = (np.zeros_like(w) for _ in range(3))
    want = []
    for _ in range(100):  # tests/test_train.py's literal climin loop
        step1 = momentum * step
        w = w - step1
        g = A @ w - b
        gms = decay * gms + (1 - decay) * g ** 2
        step2 = np.sqrt(sms + offset) / np.sqrt(gms + offset) * g * step_rate
        w = w - step2
        step = step1 + step2
        sms = decay * sms + (1 - decay) * step ** 2
        want.append(w.copy())
    init, update = ttrain.climin_adadelta(step_rate, decay=decay,
                                          momentum=momentum, offset=offset)
    wt = [torch.tensor([2.0, 2.0, -1.0, 0.5], dtype=torch.float64)]
    st = init(wt)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    got = []
    for _ in range(100):
        (point,) = ttrain.adadelta_lookahead_point(wt, st, momentum)
        upd, st = update([At @ point - bt], st)
        wt = [wt[0] + upd[0]]
        got.append(wt[0].numpy().copy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-12)


SCHEDULES = [
    ("cosine", (("decay_steps", 7), ("alpha", 0.1))),
    ("warmup_cosine", (("warmup_steps", 3), ("decay_steps", 9),
                       ("init_value", 0.001), ("end_value", 0.002))),
    ("exponential", (("transition_steps", 4), ("decay_rate", 0.5))),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_lr_schedules_match_optax(name, kw):
    tc = dict(optimizer="adam", step_rate=0.05, lr_schedule=name,
              lr_schedule_kwargs=kw)
    jsched = jtrain.make_lr_schedule(jhet.TrainConfig(**tc))
    tsched = ttrain.make_lr_schedule(tp.TrainConfig(**tc))
    for k in range(14):
        # adam's count: int64 here, optax's int32; both packages compute
        # the rate in the same precision, so the values are equal
        got = tsched(torch.tensor(k, dtype=torch.int64))
        want = jsched(jnp.asarray(k, jnp.int32))
        assert got.dtype == {"float32": torch.float32,
                             "float64": torch.float64}[str(want.dtype)]
        assert got.item() == float(want), (name, k)
    assert ttrain.make_lr_schedule(tp.TrainConfig(step_rate=0.3)) == 0.3
    with pytest.raises(ValueError, match="decay_step"):
        ttrain.make_lr_schedule(tp.TrainConfig(
            lr_schedule="cosine", lr_schedule_kwargs=(("decay_step", 5),)))
    with pytest.raises(ValueError, match="adadelta"):
        ttrain.make_optimizer(tp.TrainConfig(optimizer="adadelta",
                                             lr_schedule=name))


def test_clip_then_adam_matches_optax_chain():
    """Huge gradients on the free leaves: the global norm over them (the
    masked leaves count as zeros), clipped to 1e-3, then adam."""
    cfg, jparams, _, _ = _problem()
    tparams = tp.params_from_jax(jparams, device="cpu")
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.05, clip_grad_norm=1e-3)
    update = ttrain.make_optimizer(tc)
    opt = ref = ttrain.init_optimizer_state(tparams, tc)
    jopt = optax.chain(optax.clip_by_global_norm(1e-3), optax.adam(0.05))
    jst = jopt.init(jparams)
    p, jp = tparams, jparams
    for scale in (100.0, 1e-6):  # clipped, then under the norm
        grads = [scale * torch.ones_like(t) if f in ("q_mu", "W") else None
                 for f, t in zip(FIELDS, (getattr(p, f) for f in FIELDS))]
        jgrads = jax.tree_util.tree_map(jnp.zeros_like, jp).replace(
            q_mu=scale * jnp.ones_like(jp.q_mu),
            W=scale * jnp.ones_like(jp.W))
        p, opt = update(p, opt, grads)
        u, jst = jopt.update(jgrads, jst, jp)
        jp = optax.apply_updates(jp, u)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(p, f).numpy(),
                                       np.asarray(getattr(jp, f)),
                                       rtol=1e-12, atol=1e-15)
    assert opt.count.item() == 2 and ref.count.item() == 0


def _jax_opt_tensors(opt_state):
    """The leaves of JAX's optimizer state that the port keeps: adam's
    (mu, nu) and count, or Adadelta's (gms, sms, step)."""
    if isinstance(opt_state, jtrain.CliminAdadeltaState):
        return {"gms": opt_state.gms, "sms": opt_state.sms,
                "step": opt_state.step}
    for part in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(part, "nu"):
            return {"mu": part.mu, "nu": part.nu, "count": part.count}
    raise AssertionError("no adam state")


CASES = {
    "adadelta": dict(tc=dict(optimizer="adadelta", step_rate=0.05,
                             vm_batch_fraction=0.5)),
    "cosine_clip": dict(tc=dict(optimizer="adam", step_rate=0.05,
                                lr_schedule="cosine",
                                lr_schedule_kwargs=(("decay_steps", 8),),
                                clip_grad_norm=30.0)),
    "warmup_cosine_clip": dict(tc=dict(
        optimizer="adam", step_rate=0.05, lr_schedule="warmup_cosine",
        lr_schedule_kwargs=(("warmup_steps", 3), ("decay_steps", 10)),
        clip_grad_norm=30.0)),
    # optax's exponential rate is a float32 power; inside a jitted step
    # XLA rounds it one ulp away from its own eager value at some counts
    # (at 3 steps and 0.7: counts 5, 7, 10, ...), not at 2 steps and 0.25
    "exponential_clip": dict(tc=dict(
        optimizer="adam", step_rate=0.05, lr_schedule="exponential",
        lr_schedule_kwargs=(("transition_steps", 2), ("decay_rate", 0.25)),
        clip_grad_norm=30.0)),
    "joint_adam": dict(tc=dict(optimizer="adam", step_rate=0.02), vem=False),
    "joint_natgrad": dict(tc=dict(optimizer="natgrad_adam", step_rate=0.02,
                                  natgrad_lr=0.3), vem=False),
    "unwhitened": dict(tc=dict(optimizer="adam", step_rate=0.02),
                       whiten=False),
    "solve_path": dict(tc=dict(optimizer="adam", step_rate=0.02,
                               fast_projection=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ten_steps_match_jax_make_svi_step(case):
    spec = CASES[case]
    vem = spec.get("vem", True)
    cfg, jparams, X, Y = _problem(whiten=spec.get("whiten", True))
    kw = dict(minibatch="slice", **spec["tc"])
    tc = jhet.TrainConfig(**kw)
    jstep = jtrain.make_svi_step(cfg, tc, vem=vem)
    js = jtrain.init_train_state(jparams, cfg, jtrain.make_optimizer(tc),
                                 cache_luu=vem,
                                 fast_projection=tc.fast_projection)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ttc = tp.TrainConfig(**kw)
    tstep = ttrain.make_step(tcfg, ttc, vem=vem)
    ts = tp.init_train_state(tp.params_from_jax(jparams, device="cpu"), tcfg,
                             ttc, cache_luu=vem)
    rng = np.random.RandomState(5)
    scales = np.array([3.0, 2.5, 1.0])
    for s in range(10):
        rows = [rng.randint(0, n, min(B, n)) for n in SIZES]
        Xb = [x[r] for x, r in zip(X, rows)]
        Yb = [y[r] for y, r in zip(Y, rows)]
        js, jm = jstep(js, tuple(jelbo.task_data(x, y)
                                 for x, y in zip(Xb, Yb)),
                       jnp.asarray(scales))
        ts, tm = tstep(ts, tp.make_dataset(Xb, Yb, tcfg, device="cpu"),
                       torch.from_numpy(scales))
        np.testing.assert_allclose(tm["elbo"].item(), float(jm["elbo"]),
                                   rtol=1e-10, err_msg=f"{case} step {s}")
        jopt = _jax_opt_tensors(js.opt_state)
        for f in FIELDS:
            want = getattr(js.params, f)
            if f == "q_sqrt":
                want = jnp.tril(want)
            pairs = [(getattr(ts.params, f), want, "param")]
            pairs += [(getattr(getattr(ts.opt_state, k), f),
                       getattr(jopt[k], f), k)
                      for k in jopt if k != "count"]
            for got, w, what in pairs:
                if not np.any(np.asarray(w)):
                    assert not torch.any(got), (case, s, what, f)
                    continue
                assert _normwise(got, w) < TOL, (case, s, what, f,
                                                 _normwise(got, w))
        if "count" in jopt:
            assert ts.opt_state.count.item() == int(jopt["count"])
        for got, want in ((ts.Luu, js.Luu), (ts.iLuu, js.iLuu)):
            assert (got is None) == (want is None)
            if got is not None:
                assert _normwise(got, want) < TOL, (case, s)


def test_adadelta_lookahead_is_masked_under_vem():
    """The port of test_train.py's regression: past a VM step, a VE step's
    gradient point keeps the hypers where they are (the cache was built
    there) and shifts q by the momentum."""
    cfg, jparams, X, Y = _problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tc = tp.TrainConfig(optimizer="adadelta", step_rate=0.1, momentum=0.9)
    step = ttrain.make_step(tcfg, tc)
    state = tp.init_train_state(tp.params_from_jax(jparams, device="cpu"),
                                tcfg, tc)
    data = tp.make_dataset(X, Y, tcfg, device="cpu")
    scales = torch.ones(3, dtype=torch.float64)
    for _ in range(6):
        state, m = step(state, data, scales)
        assert torch.isfinite(m["elbo"])
    assert torch.any(state.opt_state.step.Z != 0)  # the VM step moved Z
    gp = ttrain.adadelta_lookahead_point(state.params, state.opt_state,
                                         tc.momentum, ttrain.ve_mask())
    for f in ("log_lengthscale", "Z", "W"):
        assert torch.equal(getattr(gp, f), getattr(state.params, f))
    assert (gp.q_mu - state.params.q_mu).abs().max() > 0


def test_gather_sampler_on_given_indices():
    """minibatch="gather": the graphed loop (eager here) on given row
    indices is JAX's step on the same gathered rows, with the scales
    N_t / B_t (task 2 has B_t > N_t: rows with replacement)."""
    cfg, jparams, X, Y = _problem()
    kw = dict(optimizer="adam", step_rate=0.02, minibatch="gather",
              vm_batch_fraction=0.5)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ttc = tp.TrainConfig(**kw)
    gen = torch.Generator().manual_seed(2)
    idx = ttrain.draw_index_stream(gen, SIZES, (B,) * 3, 7)
    assert idx.shape == (7, 3 * B)
    parts = idx.split(B, dim=1)
    for part, n in zip(parts, SIZES):
        assert part.min() >= 0 and part.max() < n
    assert len(set(parts[2].flatten().tolist())) == SIZES[2]  # repeats
    run = tp.make_scan_trainer(tcfg, ttc, SIZES, (B,) * 3, steps_per_call=4)
    dataset = tp.make_dataset(X, Y, tcfg, device="cpu")
    state0 = tp.init_train_state(tp.params_from_jax(jparams, device="cpu"),
                                 tcfg, ttc)
    ts, tel = run(state0, dataset, indices=idx)

    tc = jhet.TrainConfig(**kw)
    jstep = jtrain.make_svi_step(cfg, tc)
    js = jtrain.init_train_state(jparams, cfg, jtrain.make_optimizer(tc))
    scales = jnp.asarray([n / B for n in SIZES])
    np.testing.assert_allclose(
        ttrain.batch_scales(SIZES, (B,) * 3, torch.float64, "cpu",
                            "gather").numpy(), np.asarray(scales), rtol=0)
    for s in range(7):
        rows = [p[s].numpy() for p in parts]
        js, jm = jstep(js, tuple(jelbo.task_data(x[r], y[r]) for x, y, r in
                                 zip(X, Y, rows)), scales)
        np.testing.assert_allclose(tel[s].item(), float(jm["elbo"]),
                                   rtol=1e-10)
    for f in FIELDS:
        w = getattr(js.params, f)
        if np.any(np.asarray(w)):
            assert _normwise(getattr(ts.params, f),
                             jnp.tril(w) if f == "q_sqrt" else w) < TOL, f
    with pytest.raises(ValueError, match="indices"):
        run(ts, dataset, indices=idx[:, :B])
    bad = idx.clone()
    bad[0, 2 * B] = SIZES[2]
    with pytest.raises(ValueError, match="indices"):
        run(ts, dataset, indices=bad)
    with pytest.raises(ValueError, match="offsets"):
        run(ts, dataset, offsets=np.zeros((2, 3), np.int64))


LOOPS = {
    "adadelta": dict(optimizer="adadelta", step_rate=0.05),
    "natgrad_exact": dict(optimizer="natgrad_adam", step_rate=0.02,
                          natgrad_lr=0.3, natgrad_retraction="exact"),
    "natgrad_joint": dict(optimizer="natgrad_adam", step_rate=0.02,
                          natgrad_lr=0.3),
    "warmup_cosine_clip_gather": dict(
        optimizer="adam", step_rate=0.05, lr_schedule="warmup_cosine",
        lr_schedule_kwargs=(("warmup_steps", 3), ("decay_steps", 20)),
        clip_grad_norm=30.0, minibatch="gather"),
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_scan_trainer_is_the_host_loop_for_every_optimizer(case):
    """The graphed loop's body (eager on the CPU) against ``make_trainer``
    on one generator, bitwise, in calls of other lengths; the natural
    gradients' backoff codes are recorded per step."""
    cfg, jparams, X, Y = _problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    kw = {"minibatch": "slice", **LOOPS[case]}
    ttc = tp.TrainConfig(**kw)
    vem = case != "natgrad_joint"
    params = tp.params_from_jax(jparams, device="cpu")
    dataset = tp.make_dataset(X, Y, tcfg, device="cpu")
    state = tp.init_train_state(params, tcfg, ttc, cache_luu=vem)
    host = tp.make_trainer(tcfg, ttc, SIZES, (B,) * 3, steps_per_call=12,
                           vem=vem)
    s1, e1 = host(state, dataset, torch.Generator().manual_seed(9))
    run = tp.make_scan_trainer(tcfg, ttc, SIZES, (B,) * 3, steps_per_call=5,
                               vem=vem)
    gen = torch.Generator().manual_seed(9)
    s2, a = run(state, dataset, gen)
    s2, b = run(s2, dataset, gen)
    kinds = run.step_kinds
    s2, c = run(s2, dataset, **{run.sampler.name: run.sampler.draw(gen, 2)})
    assert torch.equal(torch.cat([a, b, c]), e1)
    assert s1.step == s2.step == 12
    for x, y in zip(ttrain._state_tensors(s1), ttrain._state_tensors(s2)):
        assert torch.equal(x, y)
    assert kinds == (["ve"] * 4 + ["vm"] if vem else ["joint"] * 5)
    if kw["optimizer"] == "natgrad_adam":
        assert run.ng_backoff.shape == (2,) and run.ng_backoff.dtype == (
            torch.int32)
        assert (s2.S_inv is not None) == (case == "natgrad_exact")
    else:
        assert run.ng_backoff is None
    assert e1[-3:].mean() > e1[:3].mean()


def test_svi_fit_on_device_joint_mode_and_the_frozen_natgrad_warning():
    cfg, jparams, X, Y = _problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(jparams, device="cpu")
    tc = tp.TrainConfig(optimizer="natgrad_adam", step_rate=0.02,
                        natgrad_lr=0.3, minibatch="gather")
    p, hist = tp.svi_fit_on_device(params, tcfg, tc, X, Y, B, 12,
                                   steps_per_call=5, vem=False,
                                   generator=torch.Generator().manual_seed(1))
    assert hist.shape == (12,) and np.isfinite(hist).all()
    assert not torch.equal(p.q_mu, params.q_mu)
    assert not torch.equal(p.log_lengthscale, params.log_lengthscale)
    # observations 1e4 away: the exact retraction rejects every step at
    # natgrad_lr and at a quarter of it, and q would freeze unannounced
    rng = np.random.RandomState(0)
    Yfar = [1e4 + rng.randn(n, 1) for n in SIZES]
    gcfg = dataclasses.replace(tcfg, likelihoods=(tp.Gaussian(sigma=0.4),) * 3)
    far = dataclasses.replace(tc, natgrad_lr=1.0, natgrad_retraction="exact",
                              minibatch="slice")
    with pytest.warns(RuntimeWarning, match="ng_backoff == 2"):
        p, _ = tp.svi_fit_on_device(params, gcfg, far, X, Yfar, B, 5,
                                    steps_per_call=5)
    assert torch.equal(p.q_mu, params.q_mu)
    with pytest.warns(RuntimeWarning, match="ng_backoff == 2"):
        tp.svi_fit(params, gcfg, far, tp.MinibatchStream(
            X, Yfar, B, dtype=torch.float64, device="cpu"), 5)
