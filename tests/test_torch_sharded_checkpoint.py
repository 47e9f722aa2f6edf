"""The port's sharded trainers and checkpoints (``make_scan_trainer(mesh=)``,
``svi_fit_on_device(mesh=)``, ``save_checkpoint_sharded`` /
``load_checkpoint_sharded``) on the CPU in float64.

As in ``tests/test_torch_sharding.py``, the ranks are gloo processes
spawned once per mesh shape (2 data ranks; 2 data x 2 latent ranks) with a
process-group timeout, running every case of the file
(``tests/_torch_sharding_ranks.py``).

* The scan trainer over the mesh against the JAX package's on the same
  mesh shape, ten steps (two VM) on the offsets or indices the JAX key
  schedule draws, given by value: slice and gather minibatches, adam and
  natural gradients (the exact retraction, whose S^{-1} is carried split
  over the latent axis).  ELBOs rtol 1e-8, params normwise 1e-8 (the
  parity tolerance of ``tests/test_torch_scan.py``); the ranks' shards of
  the dataset are the padded rows / k_data.
* ``svi_fit_on_device(mesh=)`` with checkpoints: a run cut at step 10 and
  resumed to 20 is bitwise the uninterrupted one, the ``step_<n>``
  directories hold one shard a latent rank and a meta file, and the fit
  equals the unsharded fit on the same generator (1e-8); the early stop
  stops every rank at the same chunk; ``SVMOGP.fit_svi_on_device(mesh=)``
  is the same fit.
* ``save_checkpoint_sharded`` under a mesh round-trips each rank's shard
  and the generator; without a mesh ``load_checkpoint_sharded``
  assembles the full params from the shards; the refusals of the JAX
  package's tests; an overwrite reclaims crash leftovers.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import data as jdata
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models.params import SVMOGPParams as JParams
from hetmogp_tpu.parallel import sharding as jsharding

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.parallel import spawn_local

from tests import _torch_sharding_ranks as ranks

torch.set_num_threads(1)

MESHES = {"d2": (2, 1), "d2l2": (4, 2)}
N, B, STEPS = 64, 32, 10
ADAM = dict(optimizer="adam", step_rate=0.02, vm_batch_fraction=0.5)
NATGRAD = dict(optimizer="natgrad_adam", step_rate=0.02, natgrad_lr=0.3,
               natgrad_retraction="exact", minibatch="slice")
SCANS = {"slice": dict(ADAM, minibatch="slice"),
         "gather": dict(ADAM, minibatch="gather"), "natgrad": NATGRAD}
BASE = ranks.problem(Q=4, n=N, seed=5)
FIT = dict(tc=dict(ADAM, minibatch="slice"), batch=16, steps=20, cut=10,
           per_call=5, every=10, keep=2, seed=3)


def _jax_stream(key, steps, minibatch):
    """The offsets (slice) or indices (gather) JAX's scan trainer draws
    from ``key`` (train.py:755-801): a split per step, then split(sub, T)
    and one randint per task."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 2)
        if minibatch == "gather":
            out.append(np.concatenate([np.asarray(jax.random.randint(
                keys[t], (B,), 0, N)) for t in range(2)]))
        else:
            out.append([int(jax.random.randint(keys[t], (), 0, N))
                        for t in range(2)])
    return np.asarray(out, dtype=np.int64)


def _cases(key, root):
    cases = []
    for name, tc in SCANS.items():
        cases.append((name, "scan", dict(
            ranks_inputs(BASE), tc=tc, sizes=(N, N), batches=(B, B),
            steps=STEPS, stream=_jax_stream(jax.random.PRNGKey(7), STEPS,
                                            tc["minibatch"]))))
    cases.append(("fit", "fit", dict(ranks_inputs(BASE), **FIT,
                                     dir=str(root / key / "fit"))))
    cases.append(("ckpt", "ckpt", dict(ranks_inputs(BASE),
                                       dir=str(root / key / "ckpt"))))
    return cases


def ranks_inputs(problem):
    cfg, leaves, X, Y = problem
    return dict(cfg=cfg, leaves=leaves, X=X, Y=Y)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded")


@pytest.fixture(scope="module")
def port(root):
    """{mesh key: [rank 0's outputs, rank 1's, ...]}, both meshes' ranks
    spawned at once."""
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {key: pool.submit(spawn_local, ranks.run_cases, world, "cpu",
                                 "gloo", args=(latent, _cases(key, root)),
                                 timeout=60, deadline=300, threads=1)
                for key, (world, latent) in MESHES.items()}
        return {key: run.result() for key, run in runs.items()}


def _jmesh(key):
    world, latent = MESHES[key]
    if latent == 1:
        return jsharding.data_mesh(jax.devices()[:world])
    return jsharding.model_mesh(jax.devices()[:world], latent=latent)


def _normwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", list(SCANS))
def test_sharded_scan_trainer_matches_jax(port, key, name):
    cfg_d, leaves, X, Y = BASE
    cfg = jhet.ModelConfig.from_dict(cfg_d)
    tc = jhet.TrainConfig(**SCANS[name])
    mesh = _jmesh(key)
    world, latent = MESHES[key]
    params = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    state = jtrain.init_train_state(
        params, cfg, jtrain.make_optimizer(tc), cache_luu=True,
        natgrad=name == "natgrad")
    if latent > 1:
        state = jsharding.shard_state(mesh, state)
    dataset, _ = jdata.full_batch(X, Y, dtype=cfg.np_dtype,
                                  pad_multiple=world // latent)
    run = jtrain.make_scan_trainer(cfg, tc, (N, N), (B, B), vem=True,
                                   steps_per_call=STEPS, mesh=mesh)
    state, elbos = run(state, jsharding.shard_batch(mesh, dataset),
                       jax.random.PRNGKey(7))
    for out in port[key]:
        res = out[name]
        assert res["captured"] is False  # the CPU: eager steps
        assert res["shard_rows"] == [N // (world // latent)] * 2
        np.testing.assert_allclose(res["elbos"], np.asarray(elbos),
                                   rtol=1e-8)
        for f in ranks.FIELDS:
            want = np.asarray(getattr(state.params, f))
            if not np.any(want):
                assert not np.any(res["params"][f]), f
                continue
            err = _normwise(res["params"][f], want)
            assert err < 1e-8, (f, err)
        if name == "natgrad":
            assert res["S_inv_rows"] == 4 // latent
            assert not res["ng_backoff"].any()


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_fit_resume_is_bitwise(port, key):
    world, latent = MESHES[key]
    shards = (["meta.json"] + [f"shard_{i}.npz" for i in range(latent)])
    for out in port[key]:
        (pa, ha), (pb, hb) = out["fit"]["a"], out["fit"]["b"]
        np.testing.assert_array_equal(ha, hb)
        for f in ranks.FIELDS:
            np.testing.assert_array_equal(pa[f], pb[f])
        assert out["fit"]["listing"] == {"step_10": shards,
                                         "step_20": shards}
        np.testing.assert_array_equal(out["fit"]["model"], out["fit"]["cut"])
        # one improving chunk and two stale ones, on every rank alike
        assert out["fit"]["stopped"].shape == (3 * FIT["per_call"],)
    # every rank returns the same full params
    for out in port[key][1:]:
        for f in ranks.FIELDS:
            np.testing.assert_array_equal(out["fit"]["a"][0][f],
                                          port[key][0]["fit"]["a"][0][f])
    # the unsharded fit on the same generator
    cfg_d, leaves, X, Y = BASE
    cfg, params = ranks._port(cfg_d, leaves)
    p, h = tp.svi_fit_on_device(
        params, cfg, tp.TrainConfig.from_dict(FIT["tc"]), X, Y, FIT["batch"],
        FIT["steps"], steps_per_call=FIT["per_call"],
        generator=torch.Generator().manual_seed(FIT["seed"]))
    pa, ha = port[key][0]["fit"]["a"]
    np.testing.assert_allclose(ha, h, rtol=1e-8)
    for f in ranks.FIELDS:
        want = getattr(p, f).numpy()
        if np.any(want):
            assert _normwise(pa[f], want) < 1e-8, f


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_checkpoint_under_the_mesh(port, root, key):
    world, latent = MESHES[key]
    for out in port[key]:
        res = out["ckpt"]
        assert res["same"] and res["gen_ok"]
        assert res["step"] == 7 and res["extra"] == {"note": "r9"}
        assert res["files"] == ["meta.json"] + [
            f"shard_{i}.npz" for i in range(latent)]
        assert res["leftovers"] == ["ckpt"]  # no .tmp / .old
        assert res["step3"] == 8 and res["bumped"]
    # without a mesh the shards assemble into the full params
    cfg_d, leaves, _, _ = BASE
    _, params = ranks._port(cfg_d, leaves)
    p, opt, step, extra = tp.load_checkpoint_sharded(
        root / key / "ckpt" / "ckpt", params)
    assert opt is None and step == 8 and extra == {}
    for f in ranks.FIELDS:
        want = getattr(params, f) + (f == "q_mu")
        assert torch.equal(getattr(p, f), want), f


def test_sharded_checkpoint_roundtrip_no_mesh(tmp_path):
    cfg_d, leaves, _, _ = BASE
    cfg, params = ranks._port(cfg_d, leaves)
    path = tmp_path / "plain"
    tp.save_checkpoint_sharded(path, params, step=5)
    p2, opt2, step2, extra = tp.load_checkpoint_sharded(path, params)
    assert opt2 is None and step2 == 5 and extra == {}
    for a, b in zip(ttrain._state_tensors(params), ttrain._state_tensors(p2)):
        assert torch.equal(a, b)
    tc = tp.TrainConfig(optimizer="adam")
    opt = ttrain.init_optimizer_state(params, tc)
    with pytest.raises(ValueError, match="no opt_state"):
        tp.load_checkpoint_sharded(path, params, opt)
    tp.save_checkpoint_sharded(path, params, opt_state=opt,
                               rng_key=np.arange(2, dtype=np.uint32))
    with pytest.raises(ValueError, match="opt_state_template"):
        tp.load_checkpoint_sharded(path, params)
    _, opt3, _, extra3 = tp.load_checkpoint_sharded(path, params, opt)
    np.testing.assert_array_equal(extra3["rng_key"], [0, 1])
    assert torch.equal(opt3.count, opt.count)
    with pytest.raises(ValueError, match="rng_key"):
        tp.save_checkpoint_sharded(path, params, extra={"rng_key": [1]})
    with pytest.raises(ValueError, match="config"):
        tp.save_checkpoint_sharded(path, params, mesh=object())


def test_sharded_checkpoint_overwrite_is_crash_safe(tmp_path):
    cfg_d, leaves, _, _ = BASE
    _, params = ranks._port(cfg_d, leaves)
    path = tmp_path / "fixed"
    tp.save_checkpoint_sharded(path, params, step=1)
    bumped = tp.SVMOGPParams(*(getattr(params, f) + (f == "q_mu")
                               for f in ranks.FIELDS), rank=params.rank)
    (tmp_path / "fixed.tmp").mkdir()  # crash leftovers
    (tmp_path / "fixed.old").mkdir()
    tp.save_checkpoint_sharded(path, bumped, step=2)
    assert sorted(p.name for p in Path(tmp_path).iterdir()) == ["fixed"]
    p2, _, step2, _ = tp.load_checkpoint_sharded(path, params)
    assert step2 == 2 and torch.equal(p2.q_mu, bumped.q_mu)
