"""The port's on-device loop (``make_scan_trainer``, ``svi_fit_on_device``)
against the JAX package's, on the CPU.

* Ten steps (two VM) of ``make_scan_trainer`` against JAX
  ``make_scan_trainer`` in float64, on the six-likelihood bench model cut to
  Q=2, M=16 and 40 rows a task (one task smaller than its batch), with the
  offsets the JAX key schedule draws passed in through ``offsets=``.  ELBOs
  and parameters agree to 1e-8 normwise: the reasons of
  ``tests/test_torch_train.py`` (a Cholesky factorization and products with
  its inverse, rounded differently by the two packages).
* Against ``make_trainer`` on the same offsets: bitwise equal, also when
  the steps are split over calls of other lengths.
* ``full_batch``, ``prepare_dataset_on_device``, ``check_dataset_fits_hbm``
  and ``svi_fit_on_device`` as the JAX tests hold theirs
  (``tests/test_data.py``, ``tests/test_train.py``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import data as jdata
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import SVMOGPParams as JParams

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models.params import FIELDS

torch.set_num_threads(1)

Q, M, DX, B = 2, 16, 2, 16
SIZES = (40, 40, 12, 40, 33, 40)  # task 2 is smaller than its batch
NAMES = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
         "Exponential")
TC = dict(optimizer="adam", step_rate=0.005, minibatch="slice",
          vm_batch_fraction=0.25)


def _observations(rng, sizes):
    return [rng.randn(sizes[0], 1),
            (rng.rand(sizes[1], 1) > 0.5).astype(float),
            rng.randint(1, 4, (sizes[2], 1)).astype(float),
            rng.poisson(3.0, (sizes[3], 1)).astype(float),
            rng.gamma(2.0, 1.0, (sizes[4], 1)) + 1e-3,
            rng.exponential(1.0, (sizes[5], 1)) + 1e-3]


def _problem(dtype="float64", precision="highest"):
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)()
                                             for n in NAMES),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype=dtype, jitter=1e-4, adaptive_jitter=False,
                           ard=True, ve_fwd_precision=precision)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    leaves = dict(Z=np.broadcast_to(rng.rand(M, DX), (Q, M, DX)).copy(),
                  q_mu=0.1 * rng.randn(Q, M),
                  q_sqrt=0.5 * np.eye(M) + 0.01 * np.tril(rng.randn(Q, M, M)),
                  log_lengthscale=np.log(0.2 + 0.1 * rng.rand(Q, DX)),
                  log_variance=np.log(0.5 + rng.rand(Q)),
                  W=rng.randn(Q, D), kappa=np.zeros((Q, D)))
    X = [rng.rand(n, DX) for n in SIZES]
    Y = _observations(rng, SIZES)
    return cfg, leaves, X, Y


def _port(cfg, leaves, X, Y):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(types.SimpleNamespace(**leaves),
                                device="cpu", dtype=tcfg.torch_dtype)
    return tcfg, params, tp.make_dataset(X, Y, tcfg, device="cpu")


def _normwise(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _jax_offsets(key, steps, batches):
    """The offsets JAX's scan trainer draws from ``key``
    (train.py:755-783): a split per step, then split(sub, T) and one
    randint per task (0 for a task taken whole)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(SIZES))
        out.append([0 if b >= n else
                    int(jax.random.randint(keys[t], (), 0, n))
                    for t, (n, b) in enumerate(zip(SIZES, batches))])
    return np.array(out, dtype=np.int64)


def test_scan_trainer_matches_jax_scan_trainer_f64():
    cfg, leaves, X, Y = _problem()
    tc = jhet.TrainConfig(**TC)
    batches = (B,) * len(SIZES)
    jrun = jtrain.make_scan_trainer(cfg, tc, SIZES, batches, vem=True,
                                    steps_per_call=10)
    js = jtrain.init_train_state(
        JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), cfg,
        jtrain.make_optimizer(tc), cache_luu=True, fast_projection=True)
    jds, _ = jdata.full_batch(X, Y, dtype=cfg.np_dtype)
    key = jax.random.PRNGKey(4)
    js, jel = jrun(js, jds, key)

    tcfg, params, data = _port(cfg, leaves, X, Y)
    run = tp.make_scan_trainer(tcfg, tp.TrainConfig(**TC), SIZES, batches,
                               steps_per_call=10)
    ts, tel = run(tp.init_train_state(params, tcfg), data,
                  offsets=_jax_offsets(key, 10, batches))
    np.testing.assert_allclose(tel.numpy(), np.asarray(jel), rtol=1e-8)
    assert ts.step == int(js.step) == 10
    assert run.replays == {"ve": 0, "vm": 0}  # CPU: eager, no graphs
    jadam = js.opt_state[0]
    for f in FIELDS:
        for got, want, what in ((ts.params, js.params, "param"),
                                (ts.opt_state.mu, jadam.mu, "mu"),
                                (ts.opt_state.nu, jadam.nu, "nu")):
            g, w = getattr(got, f), getattr(want, f)
            if not np.any(np.asarray(w)):
                assert not torch.any(g), (what, f)
                continue
            assert _normwise(g, w) < 1e-8, (what, f, _normwise(g, w))
    assert _normwise(ts.iLuu, js.iLuu) < 1e-8


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_scan_trainer_is_make_trainer_bitwise(precision):
    """The same offsets (the same generator) through make_trainer and
    through make_scan_trainer in calls of other lengths, in float32."""
    cfg, leaves, X, Y = _problem("float32", precision)
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    tcfg, params, data = _port(cfg, leaves, X, Y)
    ttc = tp.TrainConfig(**TC)
    batches = (B,) * len(SIZES)
    state = tp.init_train_state(params, tcfg)
    host = tp.make_trainer(tcfg, ttc, SIZES, batches, steps_per_call=12)
    s1, e1 = host(state, data, torch.Generator().manual_seed(9))
    run = tp.make_scan_trainer(tcfg, ttc, SIZES, batches, steps_per_call=5)
    gen = torch.Generator().manual_seed(9)
    s2, a = run(state, data, gen)
    s2, b = run(s2, data, gen)
    s2, c = run(s2, data,
                offsets=ttrain.draw_offset_stream(gen, SIZES, batches, 2))
    assert torch.equal(torch.cat([a, b, c]), e1)
    assert s1.step == s2.step == 12
    for x, y in zip(ttrain._state_tensors(s1), ttrain._state_tensors(s2)):
        assert torch.equal(x, y)
    # in place: the trainer's buffers moved, the caller's first state not
    assert all(torch.equal(x, y) for x, y in zip(
        ttrain._state_tensors(state),
        ttrain._state_tensors(tp.init_train_state(params, tcfg))))
    s3, _ = run(s2, data, offsets=np.zeros((1, len(SIZES)), np.int64))
    assert s3.params.q_mu is s2.params.q_mu and s3.step == 13


def test_scan_trainer_refuses_bad_offsets():
    cfg, leaves, X, Y = _problem()
    tcfg, params, data = _port(cfg, leaves, X, Y)
    run = tp.make_scan_trainer(tcfg, tp.TrainConfig(**TC), SIZES,
                               (B,) * len(SIZES), steps_per_call=3)
    state = tp.init_train_state(params, tcfg)
    bad = np.zeros((2, len(SIZES)), np.int64)
    for t, v in ((0, SIZES[0]), (0, -1), (2, 1)):  # task 2 is taken whole
        off = bad.copy()
        off[1, t] = v
        with pytest.raises(ValueError, match="offsets"):
            run(state, data, offsets=off)
    with pytest.raises(ValueError, match="offsets"):
        run(state, data, offsets=bad[:, :3])
    with pytest.raises(ValueError, match="generator"):
        run(state, data)
    # bound to the first dataset's shapes; another of the same shapes is
    # copied into the trainer's buffers
    _, e = run(state, data, offsets=bad)
    other = tuple(tp.TaskData(td.X.flip(0), td.Y.flip(0), td.mask)
                  for td in data)
    _, e2 = run(state, other, offsets=bad)
    step = ttrain.make_step(tcfg, tp.TrainConfig(**TC))
    ext = ttrain.extend_for_wraparound(other, (B,) * len(SIZES), SIZES)
    scales = ttrain.batch_scales(SIZES, (B,) * len(SIZES), torch.float64,
                                 "cpu")
    _, m = step(state, ttrain.slice_batch(ext, (0,) * len(SIZES), SIZES,
                                          (B,) * len(SIZES)), scales)
    assert e2[0] == m["elbo"] and e2[0] != e[0]
    with pytest.raises(ValueError, match="one shape"):
        run(state, data[:5] + (tp.TaskData(*(a[:30] for a in data[5])),),
            offsets=bad)
    with pytest.raises(ValueError, match="steps_per_call"):
        tp.make_scan_trainer(tcfg, tp.TrainConfig(**TC), SIZES,
                             (B,) * len(SIZES), steps_per_call=0)


def test_batch_sampler_is_slice_batch():
    cfg, leaves, X, Y = _problem()
    tcfg, _, data = _port(cfg, leaves, X, Y)
    batches = (B,) * len(SIZES)
    ext = ttrain.extend_for_wraparound(data, batches, SIZES)
    sample = ttrain.make_batch_sampler(SIZES, batches, device="cpu")
    for off in ((0,) * 6, (39, 30, 0, 25, 32, 1)):
        got = sample(torch.tensor(off), ext)
        want = ttrain.slice_batch(ext, off, SIZES, batches)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)


def test_full_batch_padding_matches_jax():
    rng = np.random.RandomState(0)
    X, Y = rng.rand(10, 2), rng.randn(10)
    (jt,), jscales = jdata.full_batch([X], [Y], pad_multiple=8)
    (tt,), tscales = tp.full_batch([X], [Y], pad_multiple=8, device="cpu")
    assert tt.X.shape[0] == 16 and float(tt.mask.sum()) == 10.0
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tscales, jscales)


def test_dataset_on_device_and_the_memory_check(monkeypatch):
    cfg, leaves, X, Y = _problem()
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    ds = tp.prepare_dataset_on_device(tcfg, X, Y, device="cpu")
    for td, want in zip(ds, tp.make_dataset(X, Y, tcfg, device="cpu")):
        for a, b in zip(td, want):
            assert torch.equal(a, b)
    ttrain.check_dataset_fits_hbm(ds, device="cpu")  # no envelope on a CPU
    nbytes = sum(a.numel() * a.element_size() for td in ds for a in td)
    seen = []

    def mem_get_info(device):
        seen.append(device)
        return 0, int(nbytes / ttrain.DATASET_MEMORY_FRACTION) - 1

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    with pytest.raises(ValueError, match="GiB"):
        ttrain.check_dataset_fits_hbm(ds)
    assert seen == [torch.device("cuda")]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (0, 2 * nbytes))
    ttrain.check_dataset_fits_hbm(ds)


def _fit(num_steps, **kw):
    cfg, leaves, X, Y = _problem()
    tcfg, params, _ = _port(cfg, leaves, X, Y)
    return tcfg, params, X, Y, tp.svi_fit_on_device(
        params, tcfg, tp.TrainConfig(**TC), X, Y, B, num_steps, **kw)


def test_svi_fit_on_device_zero_steps():
    _, params, _, _, (p, hist) = _fit(0)
    assert hist.shape == (0,)
    assert torch.equal(p.q_mu, params.q_mu)


def test_svi_fit_on_device_prebuilt_dataset_and_remainder():
    """dataset= reproduces the internal build exactly; 12 steps in chunks of
    5 end in a 2-step remainder of the same trainer, on the offset stream
    of one generator."""
    tcfg, params, X, Y, (p1, h1) = _fit(
        12, steps_per_call=5, generator=torch.Generator().manual_seed(3))
    ds = tp.prepare_dataset_on_device(tcfg, X, Y, device="cpu")
    p2, h2 = tp.svi_fit_on_device(
        params, tcfg, tp.TrainConfig(**TC), X, Y, B, 12, steps_per_call=5,
        dataset=ds, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(h1, h2)
    for f in FIELDS:
        assert torch.equal(getattr(p1, f), getattr(p2, f))
    host = tp.make_trainer(tcfg, tp.TrainConfig(**TC), SIZES,
                           (B,) * len(SIZES), steps_per_call=12)
    _, e = host(tp.init_train_state(params, tcfg), ds,
                torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(h1, e.numpy())
    assert h1.shape == (12,) and not torch.equal(p1.q_mu, params.q_mu)


def test_svi_fit_on_device_early_stop_and_refusals(tmp_path):
    *_, (_, hist) = _fit(50, steps_per_call=5, early_stop_tol=1e12,
                         early_stop_patience=2)
    assert hist.shape == (15,)  # 1 improving chunk + 2 stale
    *_, (_, hist2) = _fit(30, steps_per_call=5, early_stop_tol=-1e12,
                          early_stop_patience=3)
    assert hist2.shape == (30,)
    # checkpoints and meshes are ported: what is refused is a fresh run
    # into a directory that holds a run's checkpoints already, and a mesh
    # that is not a DeviceMesh
    (tmp_path / "step_5").mkdir()
    for kw, err, match in ((dict(checkpoint_dir=tmp_path), ValueError,
                            "already contains checkpoints"),
                           (dict(mesh=object()), TypeError, "DeviceMesh"),
                           (dict(early_stop_tol=1.0, early_stop_patience=0),
                            ValueError, "patience")):
        with pytest.raises(err, match=match):
            _fit(5, **kw)


def test_scan_trainer_runs_every_vm_step_when_there_is_no_ve():
    """ve_steps_per_vm=0: every step is a VM step, and the ELBO rises."""
    cfg, leaves, X, Y = _problem()
    tcfg, params, data = _port(cfg, leaves, X, Y)
    ttc = dataclasses.replace(tp.TrainConfig(**TC), ve_steps_per_vm=0,
                              step_rate=0.02)
    run = tp.make_scan_trainer(tcfg, ttc, SIZES, (B,) * len(SIZES),
                               steps_per_call=20)
    assert set(run.kinds) == {"vm"}
    _, e = run(tp.init_train_state(params, tcfg), data,
               torch.Generator().manual_seed(1))
    assert torch.isfinite(e).all() and e[-5:].mean() > e[:5].mean()
