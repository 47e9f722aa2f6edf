"""The port's npz checkpoints and the checkpointed on-device loop, against
the JAX package's, on the CPU.

* A parameter file crosses both ways bitwise: the JAX package's
  ``save_checkpoint`` loads in the port's ``load_checkpoint`` and the
  port's in the JAX package's, with and without ``lik_theta``.
* ``peek_meta``, the reserved ``rng_key``, shape mismatches.
* ``svi_fit_on_device(checkpoint_dir=)`` with the reference's semantics: a
  fresh run into a directory with ``step_`` checkpoints raises, rotation
  keeps the newest ``keep_last``, an early stop saves, a resume on a chunk
  boundary is the uninterrupted run bit for bit, and so is a resume off
  it (the port draws its minibatch stream step by step, whatever the
  chunking).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import checkpoint as jckpt
from hetmogp_tpu.models.params import init_params as jinit

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import checkpoint, train as ttrain
from hetmogp_tpu_torch.models.params import leaves

torch.set_num_threads(1)

Q, M, DX = 2, 8, 2


def _jax_model(with_theta, rank=1):
    cfg = jhet.ModelConfig(likelihoods=(jhet.Gaussian(), jhet.Ordinal(K=3),
                                        jhet.Bernoulli()),
                           num_latent=Q, num_inducing=M, input_dim=DX,
                           dtype="float64", rank=rank)
    params = jinit(jax.random.PRNGKey(3), cfg,
                   np.random.RandomState(0).rand(M, DX),
                   with_lik_theta=with_theta)
    return cfg, params


def _template(cfg, with_theta):
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    return tcfg, tp.init_params(np.random.default_rng(9), tcfg,
                                np.zeros((M, DX)), with_lik_theta=with_theta,
                                device="cpu")


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


@pytest.mark.parametrize("with_theta", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
def test_jax_checkpoint_loads_in_the_port_bitwise(tmp_path, with_theta, rank):
    cfg, jparams = _jax_model(with_theta, rank)
    jckpt.save_checkpoint(tmp_path / "j", jparams, step=7,
                          extra={"note": "jax"},
                          rng_key=jax.random.PRNGKey(5))
    _, template = _template(cfg, with_theta)
    params, opt, step, extra = checkpoint.load_checkpoint(tmp_path / "j",
                                                          template)
    assert params.rank == rank and opt is None and step == 7
    assert extra["note"] == "jax"
    # the JAX key comes back as data, not as a seed
    np.testing.assert_array_equal(extra["rng_key"],
                                  np.asarray(jax.random.PRNGKey(5)))
    got = [t.numpy() for _, t in leaves(params)]
    want = _jax_leaves(jparams)
    assert len(got) == len(want) == 7 + 3 * with_theta
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_theta", [False, True])
def test_port_checkpoint_loads_in_jax_bitwise(tmp_path, with_theta):
    cfg, jtemplate = _jax_model(with_theta)
    _, params = _template(cfg, with_theta)
    gen = torch.Generator().manual_seed(11)
    checkpoint.save_checkpoint(tmp_path / "t", params, step=3,
                               extra={"who": "port"}, generator=gen)
    jparams, _, step, extra = jckpt.load_checkpoint(tmp_path / "t",
                                                    jtemplate)
    assert step == 3 and extra == {"who": "port"}  # the generator key is ours
    for a, (_, b) in zip(_jax_leaves(jparams), leaves(params)):
        np.testing.assert_array_equal(a, b.numpy())
    # and the generator's state comes back in the port
    _, _, _, extra = checkpoint.load_checkpoint(tmp_path / "t", params)
    g2 = torch.Generator()
    g2.set_state(extra["generator_state"])
    assert torch.equal(torch.randint(100, (5,), generator=g2),
                       torch.randint(100, (5,), generator=gen))


def test_optimizer_state_round_trips_and_meta(tmp_path):
    cfg, _ = _jax_model(True)
    tcfg, params = _template(cfg, True)
    tc = tp.TrainConfig(optimizer="adam")
    opt = ttrain.init_optimizer_state(params, tc)
    opt = ttrain._map_state(lambda t: t + 1, opt)
    checkpoint.save_checkpoint(tmp_path / "c.npz", params, opt_state=opt,
                               step=12)
    meta = checkpoint.peek_meta(tmp_path / "c")  # the suffix is optional
    assert meta["step"] == 12 and meta["n_opt"] == 1 + 2 * 10
    fresh = ttrain.init_optimizer_state(params, tc)
    _, got, step, _ = checkpoint.load_checkpoint(tmp_path / "c", params,
                                                 fresh)
    assert step == 12
    for a, b in zip(ttrain._state_tensors(got), ttrain._state_tensors(opt)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_reserved_keys_and_shape_mismatch(tmp_path):
    cfg, _ = _jax_model(False)
    tcfg, params = _template(cfg, False)
    for key in ("rng_key", "generator_state"):
        with pytest.raises(ValueError, match="reserved"):
            checkpoint.save_checkpoint(tmp_path / "x", params,
                                       extra={key: 1})
    checkpoint.save_checkpoint(tmp_path / "p", params)
    bigger = tp.init_params(np.random.default_rng(0),
                            dataclasses.replace(tcfg, num_inducing=M + 1),
                            np.zeros((M + 1, DX)), device="cpu")
    with pytest.raises(ValueError, match="param 0 shape"):
        checkpoint.load_checkpoint(tmp_path / "p", bigger)
    opt = ttrain.init_optimizer_state(params)
    checkpoint.save_checkpoint(tmp_path / "o", params, opt_state=opt)
    with pytest.raises(ValueError, match="opt_state leaf 1 shape"):
        checkpoint.load_checkpoint(tmp_path / "o", params,
                                   ttrain.init_optimizer_state(bigger))


# ---- the checkpointed on-device loop ---------------------------------------

SIZES = (60, 45)
B, CHUNK = 16, 10


def _fit_problem():
    cfg = tp.ModelConfig(likelihoods=(tp.HetGaussian(), tp.Bernoulli()),
                         num_latent=Q, num_inducing=M, input_dim=DX,
                         dtype="float64", jitter=1e-4, adaptive_jitter=False)
    rng = np.random.RandomState(1)
    X = [rng.rand(n, DX) for n in SIZES]
    Y = [rng.randn(SIZES[0], 1), (rng.rand(SIZES[1], 1) > 0.5) * 1.0]
    params = tp.init_params(np.random.default_rng(2), cfg, rng.rand(M, DX),
                            lengthscale=0.3, device="cpu")
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.01, minibatch="slice",
                        vm_batch_fraction=0.5)
    return cfg, tc, X, Y, params


def _fit(ckpt, num_steps, gen_seed=4, **kw):
    cfg, tc, X, Y, params = _fit_problem()
    gen = torch.Generator().manual_seed(gen_seed)
    return ttrain.svi_fit_on_device(
        params, cfg, tc, X, Y, B, num_steps, generator=gen,
        steps_per_call=CHUNK, checkpoint_dir=ckpt, **kw)


def _names(d):
    return [p.name for _, p in ttrain._step_checkpoints(d)]


def _same(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                           leaves(b)))


def test_fresh_run_into_checkpoints_raises_and_rotation(tmp_path):
    p, hist = _fit(tmp_path, 40, checkpoint_every=10, keep_last=2)
    assert hist.shape == (40,)
    assert _names(tmp_path) == ["step_30", "step_40"]
    assert ttrain._latest_step_checkpoint(tmp_path)[0] == 40
    with pytest.raises(ValueError, match="already contains checkpoints"):
        _fit(tmp_path, 40)
    # checkpoint_every rounds up to chunks; the last step is always saved
    p2, _ = _fit(tmp_path / "b", 45, checkpoint_every=20, keep_last=0)
    assert _names(tmp_path / "b") == ["step_20", "step_40", "step_45"]
    # the checkpoint holds the final params
    got, _, step, extra = checkpoint.load_checkpoint(
        tmp_path / "b" / "step_45" / ttrain.STEP_CHECKPOINT, p2)
    assert step == 45 and "generator_state" in extra
    assert _same(got, p2)


def test_early_stop_saves_a_final_checkpoint(tmp_path):
    # an impossible tolerance: after the first chunk sets the best mean,
    # no chunk improves on it enough, so two stale chunks stop the run
    p, hist = _fit(tmp_path, 100, checkpoint_every=1000, keep_last=3,
                   early_stop_tol=1e12, early_stop_patience=2)
    assert hist.shape == (3 * CHUNK,)
    assert _names(tmp_path) == ["step_30"]


def test_resume_on_a_chunk_boundary_is_the_uninterrupted_run(tmp_path):
    whole, hist = _fit(tmp_path / "a", 40)
    _, first = _fit(tmp_path / "b", 20)
    # resumed with a generator in another state: the checkpoint's wins
    resumed, second = _fit(tmp_path / "b", 40, gen_seed=99, resume=True)
    assert _same(whole, resumed)
    np.testing.assert_array_equal(np.concatenate([first, second]), hist)
    assert _names(tmp_path / "b") == _names(tmp_path / "a")


def test_resume_off_the_boundary_continues_the_run(tmp_path):
    """A checkpoint after a remainder chunk (25 of chunks of 10): the
    continuation replays the uninterrupted run's steps, since the stream
    is drawn step by step."""
    whole, hist = _fit(tmp_path / "a", 50)
    _, first = _fit(tmp_path / "b", 25)
    assert _names(tmp_path / "b")[-1] == "step_25"
    resumed, second = _fit(tmp_path / "b", 50, resume=True)
    assert second.shape == (25,)
    np.testing.assert_array_equal(np.concatenate([first, second]), hist)
    assert _same(whole, resumed)


def test_resume_into_an_empty_directory_starts_fresh(tmp_path):
    a, ha = _fit(tmp_path / "a", 20, resume=True)
    b, hb = _fit(None, 20)
    assert _same(a, b)
    np.testing.assert_array_equal(ha, hb)
