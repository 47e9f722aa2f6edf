"""The port's data- and latent-axis parallelism (``hetmogp_tpu_torch.parallel``)
against the JAX package's sharded functions, on the CPU in float64.

The port's ranks are gloo processes (``parallel.spawn_local``, a
process-group timeout of 60 s, one torch thread each), spawned once per
mesh shape for the whole file: a 1-D ``("data",)`` mesh of 2 ranks and a
2-D ``("data", "latent")`` mesh of 2 x 2.  They run every case on inputs
given by value (``tests/_torch_sharding_ranks.py``) and return their
results; the JAX package's ``parallel.sharding`` functions run the same
inputs here, on the same mesh shapes of the 8 virtual CPU devices.

* The sharded ELBO and its VE sums (rtol 1e-10), with masked junk rows
  (no effect), and each rank's gradient against the unsharded gradient
  (normwise 1e-10: a collective that double-counts, such as a backward
  all-reduce of an all-reduce, is off by the group's size).
* ``make_sharded_svi_step``, five steps (the fifth a VM step on the global
  prefix of the batch): ELBOs (rtol 1e-10) and params after the first and
  the last step (normwise 1e-8, the parity tolerance of
  ``tests/test_torch_train.py``), on the 1-D and 2-D meshes, at
  coregionalization rank 2 (the kernel hypers replicated while the copies
  split), at a latent size that does not divide Q (everything
  replicated), with fused task rows against the JAX per-task step, and
  with Adadelta, joint natural gradients and a binding global-norm clip.
* ``predict.predictive_sharded`` on both meshes and
  ``SVMOGP.predictive(mesh=)`` (rtol 1e-10), with row counts the data size
  does not divide.
* The structure, from the ranks' collective counter: each rank's RBF
  input holds its share of the batch's rows, each step issues exactly the
  collectives of its kind (no (Q, M, M)-sized gather), the predictive
  moves no rows before its final all-gather, and the cache refresh
  factorizes Q / k_latent matrices.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetmogp_tpu as jhet
from hetmogp_tpu import data as jdata
from hetmogp_tpu import train as jtrain
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models import predict as jpredict
from hetmogp_tpu.models.params import SVMOGPParams as JParams
from hetmogp_tpu.parallel import sharding as jsharding

from hetmogp_tpu_torch.parallel import spawn_local

from tests import _torch_sharding_ranks as ranks

torch.set_num_threads(1)

MESHES = {"d2": (2, 1), "d2l2": (4, 2)}
TC = dict(optimizer="adam", step_rate=0.01, vm_batch_fraction=0.5)

BASE = ranks.problem(Q=4, fuse_task_rows=False)
PADDED = ranks.problem(Q=4, n=56, seed=1, fuse_task_rows=False)
FUSED = ranks.problem(Q=4, seed=2, fuse_task_rows=True)
RANK2 = ranks.problem(Q=3, R=2, seed=3)
ODD = ranks.problem(Q=3, seed=4)
# the other optimizers and modes, on the 2-D mesh: Adadelta (its VM step at
# the lookahead point, on the solve path), joint natural gradients (no
# cache), and adam with a clipping that binds and the non-finite keep
OTHERS = {"adadelta": (dict(optimizer="adadelta", step_rate=0.05), True),
          "joint_natgrad": (dict(optimizer="natgrad_adam", step_rate=0.01,
                                 natgrad_lr=0.2), False),
          "clipped": (dict(TC, clip_grad_norm=1.0,
                           skip_nonfinite_steps=True), True)}
_rng = np.random.RandomState(7)
XP = [_rng.rand(101, 1), _rng.rand(37, 1)]
STRUCT_TC = dict(TC, minibatch="slice", ve_steps_per_vm=1)
STRUCT_BATCH = (32, 32)


def _inputs(problem, **kw):
    cfg, leaves, X, Y = problem
    return dict(cfg=cfg, leaves=leaves, X=X, Y=Y, **kw)


def _cases(key):
    both = [("elbo", "elbo", _inputs(BASE)),
            ("elbo_pad", "elbo", _inputs(PADDED, pad=8)),
            ("grad", "grad", _inputs(BASE)),
            ("steps", "steps", _inputs(BASE, tc=TC, nsteps=5)),
            ("predictive", "predictive", _inputs(BASE, Xp=XP)),
            ("structure", "structure", _inputs(
                BASE, tc=STRUCT_TC, sizes=(64, 64), batches=STRUCT_BATCH,
                stream=[(5, 40), (60, 3)]))]
    if key == "d2":
        return both + [("svmogp", "svmogp_predictive", _inputs(BASE, Xp=XP))]
    return both + [("rank2", "steps", _inputs(RANK2, tc=TC, nsteps=5)),
                   ("rank2_grad", "grad", _inputs(RANK2)),
                   ("odd", "steps", _inputs(ODD, tc=TC, nsteps=5)),
                   ("fused", "steps", _inputs(FUSED, tc=TC, nsteps=5))] + [
        (name, "steps", _inputs(BASE, tc=tc, nsteps=5, vem=vem))
        for name, (tc, vem) in OTHERS.items()]


@pytest.fixture(scope="module")
def port():
    """{mesh key: [rank 0's outputs, rank 1's, ...]}, both meshes' ranks
    spawned at once."""
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {key: pool.submit(spawn_local, ranks.run_cases, world, "cpu",
                                 "gloo", args=(latent, _cases(key)),
                                 timeout=60, deadline=300, threads=1)
                for key, (world, latent) in MESHES.items()}
        return {key: run.result() for key, run in runs.items()}


def _jmesh(key):
    world, latent = MESHES[key]
    if latent == 1:
        return jsharding.data_mesh(jax.devices()[:world])
    return jsharding.model_mesh(jax.devices()[:world], latent=latent)


def _jmodel(problem):
    cfg_d, leaves, X, Y = problem
    cfg = jhet.ModelConfig.from_dict(cfg_d)
    params = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()},
                     rank=cfg.rank)
    data, scales = jdata.full_batch(X, Y, dtype=cfg.np_dtype)
    return cfg, params, data, jnp.asarray(scales, cfg.np_dtype)


def _normwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _jax_steps(problem, key, nsteps, tc=TC, sharded=True, fuse=None,
               vem=True):
    """ELBOs and params after the first and the last of ``nsteps`` JAX
    steps, sharded over the mesh of ``key`` or not."""
    cfg, params, data, scales = _jmodel(problem)
    if fuse is not None:
        cfg = jhet.ModelConfig.from_dict(dict(cfg.to_dict(),
                                              fuse_task_rows=fuse))
    tcfg = jhet.TrainConfig(**tc)
    state = jtrain.init_train_state(params, cfg, jtrain.make_optimizer(tcfg),
                                    cache_luu=vem, fast_projection=True)
    if sharded:
        mesh = _jmesh(key)
        step = jsharding.make_sharded_svi_step(cfg, tcfg, mesh, vem=vem)
        state = jsharding.shard_state(mesh, state)
        data = jsharding.shard_batch(mesh, data)
    else:
        step = jtrain.make_svi_step(cfg, tcfg, vem=vem)
    elbos, first = [], None
    for _ in range(nsteps):
        state, m = step(state, data, scales)
        elbos.append(float(m["elbo"]))
        if first is None:
            first = state.params
    return np.array(elbos), first, state.params


def _check_params(got, want, tol):
    for f in ranks.FIELDS:
        w = np.asarray(getattr(want, f))
        if not np.any(w):
            assert not np.any(got[f]), f
            continue
        assert _normwise(got[f], w) < tol, (f, _normwise(got[f], w))


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("case", ["elbo", "elbo_pad"])
def test_sharded_elbo_matches_jax(port, key, case):
    problem = BASE if case == "elbo" else PADDED
    cfg, params, data, scales = _jmodel(problem)
    mesh = _jmesh(key)
    e, aux = jsharding.make_sharded_elbo(cfg, mesh)(
        params, jsharding.shard_batch(mesh, data), scales)
    for out in port[key]:  # every rank holds the global values
        np.testing.assert_allclose(out[case]["elbo"], float(e), rtol=1e-10)
        np.testing.assert_allclose(out[case]["ve"], np.asarray(aux["ve"]),
                                   rtol=1e-10)
        np.testing.assert_allclose(out[case]["kl"], float(aux["kl"]),
                                   rtol=1e-10)


@pytest.mark.parametrize("key,case", [("d2", "grad"), ("d2l2", "grad"),
                                      ("d2l2", "rank2_grad")])
def test_each_rank_gradient_is_the_unsharded_one(port, key, case):
    problem = BASE if case == "grad" else RANK2
    cfg, params, data, scales = _jmodel(problem)
    g = jax.jit(jax.grad(
        lambda p: -jelbo.elbo_fn(p, data, scales, cfg)[0]))(params)
    for out in port[key]:
        l, k = out[case]["latent"]
        for f in ranks.FIELDS:
            want = np.asarray(getattr(g, f))
            if out[case]["sharded"][f]:
                n = want.shape[0]
                want = want[l * n // k:(l + 1) * n // k]
            got = out[case]["grads"][f]
            assert got.shape == want.shape, f
            if not np.any(want):
                assert not np.any(got), f
                continue
            assert _normwise(got, want) < 1e-10, (f, _normwise(got, want))
    if case == "rank2_grad":  # the hypers stay whole, the copies split
        assert not port[key][0][case]["sharded"]["log_lengthscale"]
        assert port[key][0][case]["sharded"]["q_sqrt"]


@pytest.mark.parametrize("key,case", [("d2", "steps"), ("d2l2", "steps"),
                                      ("d2l2", "rank2"), ("d2l2", "odd"),
                                      ("d2l2", "fused")]
                         + [("d2l2", name) for name in OTHERS])
def test_sharded_steps_match_jax(port, key, case):
    problem = {"rank2": RANK2, "odd": ODD, "fused": FUSED}.get(case, BASE)
    if case == "fused":  # the JAX package's per-task step, unsharded
        elbos, first, last = _jax_steps(problem, key, 5, sharded=False,
                                        fuse=False)
    elif case in OTHERS:
        tc, vem = OTHERS[case]
        elbos, first, last = _jax_steps(problem, key, 5, tc=tc, vem=vem)
    else:
        elbos, first, last = _jax_steps(problem, key, 5)
    for out in port[key]:
        res = out[case]
        np.testing.assert_allclose(res["elbos"], elbos, rtol=1e-10)
        _check_params(res["first"], first, 1e-8)
        _check_params(res["last"], last, 1e-8)
    res = port[key][0][case]
    Qe = problem[1]["q_mu"].shape[0]
    if case in OTHERS:
        return
    if case == "odd":  # latent 2 does not divide Q = 3: all replicated
        assert set(res["state_placement"]) == {"replicated"}
        assert res["local_q_sqrt"][0] == Qe
    elif key == "d2l2":
        assert res["local_q_sqrt"][0] == Qe // 2
        placement = dict(zip(ranks.FIELDS, res["placement"]))
        assert placement["q_sqrt"] == "latent"
        assert placement["log_variance"] == ("replicated" if case == "rank2"
                                             else "latent")
        # params, adam's moments and the caches split; adam's count not
        assert res["state_placement"].count("replicated") == (
            1 + 3 * 2 * (case == "rank2"))
    else:
        assert set(res["placement"]) == {"replicated"}


@pytest.mark.parametrize("key", list(MESHES))
def test_sharded_predictive_matches_jax(port, key):
    cfg, params, _, _ = _jmodel(BASE)
    mesh = _jmesh(key)
    if key != "d2":
        params = jax.tree_util.tree_map(
            jax.device_put, params, jsharding.param_shardings(mesh, params))
    m, v = jpredict.predictive_sharded(params, cfg, XP, mesh)
    for out in port[key]:
        for t in range(2):
            assert out["predictive"]["m"][t].shape == np.shape(m[t])
            np.testing.assert_allclose(out["predictive"]["m"][t],
                                       np.asarray(m[t]), rtol=1e-10,
                                       atol=1e-14)
            np.testing.assert_allclose(out["predictive"]["v"][t],
                                       np.asarray(v[t]), rtol=1e-10,
                                       atol=1e-14)


def test_svmogp_predictive_mesh_entry(port):
    cfg_d, leaves, X, Y = BASE
    cfg, params, _, _ = _jmodel(BASE)
    model = jhet.SVMOGP(cfg, X, Y, np.asarray(leaves["Z"][0]),
                        key=jax.random.PRNGKey(0))
    model.params = params
    m, v = model.predictive(XP, mesh=_jmesh("d2"))
    for out in port["d2"]:
        for t in range(2):
            np.testing.assert_allclose(out["svmogp"]["m"][t],
                                       np.asarray(m[t]), rtol=1e-10)
            np.testing.assert_allclose(out["svmogp"]["v"][t],
                                       np.asarray(v[t]), rtol=1e-10)
        assert "not mesh-sharded" in out["svmogp"]["refused"]


@pytest.mark.parametrize("key", list(MESHES))
def test_collective_structure(port, key):
    world, latent = MESHES[key]
    k_data = world // latent
    M, T, D = 8, 2, 3
    q_local = 4 // latent
    rows = sum(STRUCT_BATCH) // k_data  # this rank's rows of the batch
    for out in port[key]:
        res = out["structure"]
        assert res["kinds"] == ["ve", "vm"]
        # the RBF inputs: each task's rows of the VE step's batch and of
        # the VM step's global prefix (half the batch), at this rank's
        # latents
        steps = []
        for r in res["rbf_rows"]:
            if r == "step":
                steps.append([])
            else:
                steps[-1].append(tuple(r))
        assert steps == [[(rows // T, q_local)] * T,
                         [(rows // 2 // T, q_local)] * T]
        # one refresh, after the VM step, of this rank's Q / k_latent
        assert res["chol"] == ["step", "step", q_local]
        # each step's collectives, in order: the batch's assembly over the
        # data axis (X, Y and the mask of every row), the mixing over the
        # latent axis (2-D), the diagnostics over the mesh, the gradients
        # over the data axis; no gather, nothing (Q, M, M)-sized but the
        # VE step's gradient of this rank's q_sqrt
        mix = [("latent", "all_reduce")] if latent > 1 else []
        grads = {"ve": q_local * M * (M + 1), "vm": q_local * (M + 2 + D)}
        for kind, got, n in zip(("ve", "vm"), res["steps"], (rows,
                                                             rows // 2)):
            assert [c[:2] for c in got] == (
                [("data", "all_reduce")] + mix
                + [("world", "all_reduce"), ("data", "all_reduce")]), kind
            assert got[0][2] == sum(STRUCT_BATCH) * 3
            if mix:
                assert got[1][2] == 2 * (n // T) * D
            assert got[-2][2] == T + 1
            assert got[-1][2] == grads[kind]
        # the predictive: no collective but the mixing's before each
        # task's all-gather of its rows
        pred = out["predictive"]["collectives"]
        assert {c[:2] for c in pred} == {("data", "all_gather")} | (
            {("latent", "all_reduce")} if latent > 1 else set())
        assert [c[:2] for c in pred].count(("data", "all_gather")) == T
