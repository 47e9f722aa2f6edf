"""What the ranks of ``tests/test_torch_sharding.py`` and
``tests/test_torch_sharded_checkpoint.py`` run, under
``parallel.spawn_local``: this module imports numpy, torch and the port
only, so that each spawned rank loads neither JAX nor the JAX package.

``run_cases(rank, world, latent, cases)`` builds the mesh (a 1-D data mesh
at latent 1, else a (world / latent, latent) one), runs each case of
``cases`` (a list of (name, kind, inputs) with numpy inputs) and returns
{name: outputs}, numpy arrays and plain values.  A case's inputs are given
by value: the model config as the JAX ``ModelConfig.to_dict()``, the
parameter leaves, the rows, the offsets or indices, so that the test
holds the port's ranks against the JAX package on exactly those.
"""

import types

import numpy as np
import torch

FIELDS = ("Z", "q_mu", "q_sqrt", "log_lengthscale", "log_variance", "W",
          "kappa")


def problem(names=("HetGaussian", "Bernoulli"), n=64, M=8, Q=2, R=1,
            seed=0, **config):
    """(config dict, parameter leaves, X_list, Y_list) of a small model
    with inputs in [0, 1]: the leaves of the JAX ``init_params`` layout
    (Q*R copies, Q kernel groups), from a numpy seed."""
    import hetmogp_tpu_torch as tp

    liks = tuple(getattr(tp, name)() for name in names)
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                         input_dim=1, rank=R, dtype="float64", jitter=1e-6,
                         adaptive_jitter=False, **config)
    rng = np.random.RandomState(seed)
    Qe, D = Q * R, cfg.num_output_functions
    leaves = dict(
        Z=np.broadcast_to(np.linspace(0, 1, M)[:, None], (Qe, M, 1)).copy()
        + 0.01 * rng.randn(Qe, M, 1),
        q_mu=0.5 * rng.randn(Qe, M),
        q_sqrt=0.6 * np.eye(M) + 0.05 * np.tril(rng.randn(Qe, M, M)),
        log_lengthscale=np.log(0.25 + 0.1 * rng.rand(Q, 1)),
        log_variance=np.log(0.6 + 0.4 * rng.rand(Q)),
        W=rng.randn(Qe, D) / np.sqrt(R), kappa=np.zeros((Qe, D)))
    X = [rng.rand(n, 1) for _ in names]
    Y = []
    for name in names:
        if name == "Bernoulli":
            Y.append((rng.rand(n, 1) > 0.5).astype(float))
        elif name == "Poisson":
            Y.append(rng.poisson(2.0, (n, 1)).astype(float))
        else:
            Y.append(rng.randn(n, 1))
    return cfg.to_dict(), leaves, X, Y


def _port(cfg_dict, leaves):
    import hetmogp_tpu_torch as tp

    cfg = tp.ModelConfig.from_dict(cfg_dict)
    params = tp.params_from_jax(types.SimpleNamespace(**leaves),
                                device="cpu", dtype=torch.float64)
    return cfg, params


def _np(params) -> dict:
    return {f: getattr(params, f).detach().numpy() for f in FIELDS}


def _batch(cfg, X, Y):
    import hetmogp_tpu_torch as tp

    data, scales = tp.full_batch(X, Y, dtype=cfg.torch_dtype, device="cpu")
    return data, torch.as_tensor(scales, dtype=cfg.torch_dtype)


# ---- the cases ------------------------------------------------------------

def case_elbo(mesh, inp):
    from hetmogp_tpu_torch.parallel import sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    data, scales = _batch(cfg, inp["X"], inp["Y"])
    if inp.get("pad"):  # junk rows of mask 0 after each task's real rows
        import hetmogp_tpu_torch as tp

        k = inp["pad"]
        data = tuple(tp.TaskData(
            torch.cat([td.X, torch.full((k, td.X.shape[1]), 999.0,
                                        dtype=td.X.dtype)]),
            torch.cat([td.Y, torch.full((k, td.Y.shape[1]), 7.0,
                                        dtype=td.Y.dtype)]),
            torch.cat([td.mask, torch.zeros(k, dtype=td.mask.dtype)]))
            for td in data)
    elbo = sharding.make_sharded_elbo(cfg, mesh)
    with torch.no_grad():
        e, aux = elbo(sharding.shard_params(mesh, params),
                      sharding.shard_batch(mesh, data), scales)
    return {"elbo": float(e), "ve": aux["ve"].numpy(),
            "kl": float(aux["kl"])}


def case_grad(mesh, inp):
    """Each rank's gradient of -ELBO (its shard's, after the data
    all-reduce), every leaf free."""
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.parallel import sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    data, scales = _batch(cfg, inp["X"], inp["Y"])
    comm = sharding.mesh_comm(mesh, cfg)
    rows = sharding.shard_batch(mesh, data)
    _, _, grads = ttrain._gradients(
        sharding.shard_params(mesh, params), FIELDS,
        lambda p: sharding.make_sharded_elbo(cfg, mesh)(p, rows, scales),
        comm)
    return {"grads": {f: g.numpy() for f, g in zip(FIELDS, grads)},
            "sharded": {f: comm.is_sharded(f) for f in FIELDS},
            "latent": (comm.latent_rank, comm.k_latent)}


def case_steps(mesh, inp):
    """``nsteps`` steps of ``make_sharded_svi_step`` on one global batch:
    the ELBOs, the full params after the first step and after the last,
    and the placements."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.parallel import sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    tc = tp.TrainConfig.from_dict(inp["tc"])
    data, scales = _batch(cfg, inp["X"], inp["Y"])
    vem = inp.get("vem", True)
    step = sharding.make_sharded_svi_step(cfg, tc, mesh, vem=vem)
    full = tp.init_train_state(params, cfg, tc, cache_luu=vem)
    state = sharding.shard_state(mesh, full)
    elbos, first = [], None
    for _ in range(inp["nsteps"]):
        state, m = step(state, data, scales)
        elbos.append(float(m["elbo"]))
        if first is None:
            first = _np(sharding.gather_params(mesh, state.params, cfg))
    return {"elbos": np.array(elbos), "first": first,
            "last": _np(sharding.gather_params(mesh, state.params, cfg)),
            "placement": sharding.param_shardings(mesh, params),
            "state_placement": sharding.state_shardings(mesh, full),
            "local_q_sqrt": tuple(state.params.q_sqrt.shape)}


def case_scan(mesh, inp):
    """``make_scan_trainer(mesh=)`` on the given offsets or indices."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.parallel import sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    tc = tp.TrainConfig.from_dict(inp["tc"])
    ds = tp.prepare_dataset_on_device(cfg, inp["X"], inp["Y"], device="cpu",
                                      mesh=mesh)
    run = tp.make_scan_trainer(cfg, tc, inp["sizes"], inp["batches"],
                               steps_per_call=inp["steps"], mesh=mesh)
    state = tp.init_train_state(sharding.shard_params(mesh, params), cfg, tc,
                                mesh=mesh)
    stream = {("indices" if tc.minibatch == "gather" else "offsets"):
              inp["stream"]}
    state, elbos = run(state, ds, **stream)
    out = {"elbos": elbos.numpy(), "captured": run.captured,
           "params": _np(sharding.gather_params(mesh, state.params, cfg)),
           "shard_rows": [td.X.shape[0] for td in ds]}
    if state.S_inv is not None:
        out["S_inv_rows"] = state.S_inv.shape[0]
    if run.ng_backoff is not None:
        out["ng_backoff"] = run.ng_backoff.numpy()
    return out


def case_predictive(mesh, inp):
    from hetmogp_tpu_torch.models import predict
    from hetmogp_tpu_torch.parallel import collectives

    cfg, params = _port(inp["cfg"], inp["leaves"])
    with collectives.record_collectives() as log:
        m, v = predict.predictive_sharded(params, cfg, inp["Xp"], mesh)
    return {"m": [a.numpy() for a in m], "v": [a.numpy() for a in v],
            "collectives": list(log)}


def case_svmogp_predictive(mesh, inp):
    import hetmogp_tpu_torch as tp

    cfg, params = _port(inp["cfg"], inp["leaves"])
    model = tp.SVMOGP(cfg, inp["X"], inp["Y"], None, params=params)
    m, v = model.predictive(inp["Xp"], mesh=mesh)
    try:
        model.predictive(inp["Xp"], projected=True, mesh=mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"m": [a.numpy() for a in m], "v": [a.numpy() for a in v],
            "refused": refused}


def case_structure(mesh, inp):
    """The RBF inputs' rows and the refresh's factorization batch over one
    VE and one VM step of a scan trainer, and the collectives of each
    step."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.ops import kernels, linalg
    from hetmogp_tpu_torch.parallel import collectives, sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    tc = tp.TrainConfig.from_dict(inp["tc"])
    ds = tp.prepare_dataset_on_device(cfg, inp["X"], inp["Y"], device="cpu",
                                      mesh=mesh)
    run = tp.make_scan_trainer(cfg, tc, inp["sizes"], inp["batches"],
                               steps_per_call=1, mesh=mesh)
    state = tp.init_train_state(sharding.shard_params(mesh, params), cfg, tc,
                                mesh=mesh)
    rbf_rows, chol, steps = [], [], []
    k_batched, chol_inv = kernels.K_batched, linalg.blocked_cholesky_inverse

    def rec_k(kernel, X, Z, *a, **kw):
        rbf_rows.append((X.shape[0], Z.shape[0]))
        return k_batched(kernel, X, Z, *a, **kw)

    def rec_chol(K, *a, **kw):
        chol.append(K.shape[0])
        return chol_inv(K, *a, **kw)

    kinds = []
    kernels.K_batched, linalg.blocked_cholesky_inverse = rec_k, rec_chol
    try:
        for off in inp["stream"]:
            rbf_rows.append("step")
            chol.append("step")
            with collectives.record_collectives() as log:
                state, _ = run(state, ds, offsets=np.asarray([off]))
            steps.append(list(log))
            kinds += run.step_kinds
    finally:
        kernels.K_batched = k_batched
        linalg.blocked_cholesky_inverse = chol_inv
    return {"rbf_rows": rbf_rows, "chol": chol, "steps": steps,
            "kinds": kinds}


def case_fit(mesh, inp):
    """``svi_fit_on_device(mesh=)`` with checkpoints: a run of ``steps``
    steps, and one cut at ``cut`` and resumed to ``steps``; the params,
    histories and the checkpoint directories' contents; a run that stops
    early; and ``SVMOGP.fit_svi_on_device(mesh=)`` of ``cut`` steps."""
    import os

    import hetmogp_tpu_torch as tp

    cfg, params = _port(inp["cfg"], inp["leaves"])
    tc = tp.TrainConfig.from_dict(inp["tc"])
    kw = dict(steps_per_call=inp["per_call"], mesh=mesh,
              checkpoint_every=inp["every"], keep_last=inp["keep"])

    def fit(n, d, resume=False):
        return tp.svi_fit_on_device(
            params, cfg, tc, inp["X"], inp["Y"], inp["batch"], n,
            generator=torch.Generator().manual_seed(inp["seed"]),
            checkpoint_dir=d, resume=resume, **kw)

    root = inp["dir"]
    pa, ha = fit(inp["steps"], os.path.join(root, "a"))
    _, hb1 = fit(inp["cut"], os.path.join(root, "b"))
    pb, hb2 = fit(inp["steps"], os.path.join(root, "b"), resume=True)
    listing = {d: sorted(os.listdir(os.path.join(root, "a", d)))
               for d in sorted(os.listdir(os.path.join(root, "a")))}
    _, stopped = tp.svi_fit_on_device(
        params, cfg, tc, inp["X"], inp["Y"], inp["batch"], inp["steps"],
        generator=torch.Generator().manual_seed(inp["seed"]),
        steps_per_call=inp["per_call"], mesh=mesh, early_stop_tol=1e12,
        early_stop_patience=2)
    model = tp.SVMOGP(cfg, inp["X"], inp["Y"], None, params=params)
    model.fit_svi_on_device(
        inp["batch"], inp["cut"], train_config=tc,
        steps_per_call=inp["per_call"], mesh=mesh,
        generator=torch.Generator().manual_seed(inp["seed"]))
    return {"a": (_np(pa), ha), "b": (_np(pb), np.concatenate([hb1, hb2])),
            "listing": listing, "model": model.elbo_history,
            "cut": hb1, "stopped": stopped}


def case_ckpt(mesh, inp):
    """``save_checkpoint_sharded`` of this rank's part, ``load`` of it with
    the mesh (its own shard) and a save over crash leftovers."""
    import os
    from pathlib import Path

    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain
    from hetmogp_tpu_torch.parallel import sharding

    cfg, params = _port(inp["cfg"], inp["leaves"])
    tc = tp.TrainConfig(optimizer="adam")
    full = tp.init_train_state(params, cfg, tc)
    full.opt_state.mu.q_sqrt.add_(0.5)  # an optimizer state to round-trip
    full.opt_state.count.fill_(3)
    state = sharding.shard_state(mesh, full)
    path = Path(inp["dir"]) / "ckpt"
    gen = torch.Generator().manual_seed(11)
    tp.save_checkpoint_sharded(path, state.params, opt_state=state.opt_state,
                               step=7, extra={"note": "r9"}, generator=gen,
                               mesh=mesh, config=cfg)
    p2, o2, step, extra = tp.load_checkpoint_sharded(
        path, params, ttrain.init_optimizer_state(params, tc), mesh=mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        ttrain._state_tensors(p2) + ttrain._state_tensors(o2),
        ttrain._state_tensors(state.params)
        + ttrain._state_tensors(state.opt_state)))
    gen_ok = torch.equal(extra.pop("generator_state"), gen.get_state())
    # crash leftovers beside the live checkpoint are reclaimed
    if sharding.mesh_comm(mesh, cfg).rank == 0:
        (path.parent / "ckpt.tmp").mkdir()
        (path.parent / "ckpt.old").mkdir()
    sharding.mesh_comm(mesh, cfg).barrier()
    bumped = tp.SVMOGPParams(*(getattr(state.params, f) + (f == "q_mu")
                               for f in FIELDS), rank=state.params.rank)
    tp.save_checkpoint_sharded(path, bumped, step=8, mesh=mesh, config=cfg)
    p3, _, step3, _ = tp.load_checkpoint_sharded(path, params, mesh=mesh)
    return {"same": same, "gen_ok": gen_ok, "step": step, "extra": extra,
            "files": sorted(os.listdir(path)),
            "leftovers": sorted(os.listdir(path.parent)),
            "step3": step3,
            "bumped": torch.equal(p3.q_mu, bumped.q_mu)}


CASES = {"elbo": case_elbo, "grad": case_grad, "steps": case_steps,
         "scan": case_scan, "predictive": case_predictive,
         "svmogp_predictive": case_svmogp_predictive,
         "structure": case_structure, "fit": case_fit, "ckpt": case_ckpt}


def run_cases(rank, world, latent, cases):
    """Every case of ``cases`` on this rank's mesh; {name: outputs}."""
    from hetmogp_tpu_torch.parallel import sharding

    mesh = (sharding.model_mesh("cpu", latent=latent) if latent > 1
            else sharding.data_mesh("cpu"))
    return {name: CASES[kind](mesh, inp) for name, kind, inp in cases}
