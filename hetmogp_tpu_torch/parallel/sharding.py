"""Data- and model-parallel execution over a ``torch.distributed`` mesh.

Counterpart of ``hetmogp_tpu/parallel/sharding.py``.  The ELBO is a sum
over rows and over latent GPs, so it splits over two mesh axes:

* ``data``: each task's minibatch rows are split over the data ranks;
  the VE sums and the gradients are all-reduced over the data axis;
* ``latent`` (optional, a 2-D ``("data", "latent")`` mesh): the
  Q-leading leaves (Z, q_mu, q_sqrt, W, kappa, the kernel hypers where
  the axis divides Q, the optimizer's moments of all of them and the
  cached Luu, Luu^{-1} and S^{-1}) are split over the latent ranks, so the
  per-q kernels, factorizations and projections run on different ranks
  and the mixing sum_q w_qd (...) becomes a latent all-reduce.

The JAX package places global arrays and lets ``jax.jit`` insert the
collectives; here each rank holds its part and the collectives are
explicit (``parallel/collectives.py``): nothing propagates through the
hand kernels, which run on every rank at batch Q/k_latent on the rows of
that rank.  A leaf whose first dim the latent size does not divide is
replicated, as in the JAX package, and a latent size that does not divide
Q*R replicates every leaf (each latent rank then computes all of them).

The ranks are processes of one process group: ``spawn_local`` starts them
on one host (gloo on the CPU, or gloo ranks sharing one card, whose
collectives go through the host), and ``torchrun`` starts them with NCCL,
one GPU a rank.  The entry points that take ``mesh=`` (``svi_fit_on_device``,
``make_scan_trainer``, ``prepare_dataset_on_device``,
``check_dataset_fits_hbm``, ``predict.predictive_sharded``,
``save_checkpoint_sharded``/``load_checkpoint_sharded`` and the ``SVMOGP``
methods) are called by every rank of the mesh with the same arguments.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.parallel.collectives import MeshComm

# the JAX package's names for the two dims
DATA, LATENT = "data", "latent"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def data_mesh(device_type: str = "cuda"):
    """A 1-D ``("data",)`` mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(DATA,))


def model_mesh(device_type: str = "cuda", latent: int = 1):
    """A 2-D ``("data", "latent")`` mesh: world/latent x latent, rank
    d * latent + l at (d, l), as the JAX ``model_mesh`` reshapes its
    devices."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if latent < 1 or n % latent:
        raise ValueError(f"{n} ranks not divisible by latent={latent}")
    return init_device_mesh(device_type, (n // latent, latent),
                            mesh_dim_names=(DATA, LATENT))


def has_latent_axis(mesh) -> bool:
    names = tuple(mesh.mesh_dim_names or ())
    return LATENT in names and mesh.shape[names.index(LATENT)] > 1


def mesh_comm(mesh, config_or_params) -> MeshComm:
    """The ``MeshComm`` of ``mesh`` for a model, from its ModelConfig or
    from its full params (Qe rows of q_mu over Q of log_variance; a shard
    does not say how it was split)."""
    if isinstance(config_or_params, ModelConfig):
        return MeshComm(mesh, config_or_params.num_latent_eff,
                        config_or_params.num_latent)
    p = config_or_params
    return MeshComm(mesh, int(p.q_mu.shape[0]), int(p.log_variance.shape[0]))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def param_shardings(mesh, params) -> tuple:
    """``"latent"`` (split on dim 0 over the latent axis) or
    ``"replicated"`` for each leaf of ``params``, in the order of
    ``models.params.leaves``.  At coregionalization rank R > 1 the kernel
    hypers have Q rows and the copies Q*R: a leaf whose first dim the
    latent size does not divide is replicated."""
    from hetmogp_tpu_torch.models.params import leaves

    comm = mesh_comm(mesh, params)
    return tuple("latent" if comm.is_sharded(name) else "replicated"
                 for name, _ in leaves(params))


def state_shardings(mesh, state) -> tuple:
    """The placement of each tensor of a ``train.TrainState``, in the order
    of ``train._state_tensors``: the params and the params-shaped optimizer
    moments as ``param_shardings``, the cached Luu, Luu^{-1} and S^{-1}
    split where the copies are, everything else (adam's count) replicated.
    On a 1-D data mesh everything is replicated."""
    from hetmogp_tpu_torch.models.params import SVMOGPParams
    from hetmogp_tpu_torch.train import _state_tensors

    comm = mesh_comm(mesh, state.params)
    out = []
    for f in dataclasses.fields(state):
        node = getattr(state, f.name)
        if isinstance(node, torch.Tensor):  # Luu, iLuu, S_inv
            out.append("latent" if comm.split else "replicated")
        elif isinstance(node, SVMOGPParams):
            out.extend(param_shardings(mesh, node))
        elif dataclasses.is_dataclass(node):  # the optimizer's state
            for g in dataclasses.fields(node):
                sub = getattr(node, g.name)
                out.extend(param_shardings(mesh, sub)
                           if isinstance(sub, SVMOGPParams) else
                           ["replicated"])
    assert len(out) == len(_state_tensors(state))
    return tuple(out)


def shard_params(mesh, params):
    """This rank's shard of full params (copies of its rows)."""
    return _own(mesh_comm(mesh, params).shard_params(params))


def shard_state(mesh, state):
    """This rank's part of a full ``TrainState`` (copies of its rows)."""
    from hetmogp_tpu_torch.train import _map_state

    comm = mesh_comm(mesh, state.params)
    it = iter(state_shardings(mesh, state))
    return _map_state(
        lambda t: (t[comm.latent_slice(t.shape[0])] if next(it) == "latent"
                   else t).clone(), state)


def gather_params(mesh, params, config: ModelConfig):
    """Full params on every rank from every rank's shard: an all-gather of
    each split leaf over the latent axis (the inverse of
    ``shard_params``)."""
    return mesh_comm(mesh, config).gather_params(params)


def shard_batch(mesh, data) -> tuple:
    """This data rank's rows of each TaskData: rows [d N / k_d,
    (d + 1) N / k_d) of N, as the JAX package splits a row-sharded
    array."""
    names = tuple(mesh.mesh_dim_names or ())
    k = mesh.shape[names.index(DATA)]
    d = mesh.get_local_rank(DATA)
    return tuple(type(td)(*(a[(d * a.shape[0]) // k:
                               ((d + 1) * a.shape[0]) // k] for a in td))
                 for td in data)


def _own(params):
    from hetmogp_tpu_torch.models.params import from_leaves, leaves

    return from_leaves(params, [t.clone() for _, t in leaves(params)])


# ---------------------------------------------------------------------------
# the sharded functions
# ---------------------------------------------------------------------------

def make_sharded_elbo(config: ModelConfig, mesh) -> Callable:
    """``(params, data, scales) -> (elbo, aux)`` over the mesh: params
    this rank's shard (``shard_params``), data its rows
    (``shard_batch``); the ELBO and aux are the global values on every
    rank.  The gradient of the ELBO on a rank is its part: the data
    all-reduce of the gradients (as the trainers do) completes it."""
    from hetmogp_tpu_torch.models import elbo as elbo_mod

    comm = mesh_comm(mesh, config)

    def f(params, data, scales):
        return elbo_mod.elbo_fn(params, data, scales, config, comm=comm)

    return f


def make_sharded_svi_step(config: ModelConfig, train_config: TrainConfig,
                          mesh, vem: bool = True) -> Callable:
    """The SVI step over the mesh: ``step(state, data, scales)`` with the
    state this rank's part (``shard_state``, or ``init_train_state(...,
    mesh=mesh)`` of ``shard_params``) and ``data`` the step's whole batch,
    the same on every rank.  Each rank computes on its rows of the batch
    (and of the VM step's prefix of it) and its latents, and the result is
    the unsharded step's, split the same way."""
    from hetmogp_tpu_torch import train as train_mod

    return train_mod.make_step(config, train_config, vem=vem,
                               comm=mesh_comm(mesh, config))


def make_sharded_predictive_task(config: ModelConfig, mesh,
                                 task: int) -> Callable:
    """``(params, X) -> (m_pred, v_pred)`` of one task over the mesh:
    params this rank's shard, X its rows (``shard_batch``); returns the
    predictive moments of those rows.  Each rank factorizes its latents'
    Kuu and projects its rows through the cached inverse (the RBF kernel,
    the triangular projection, ``quad_diag``): no collective but, on a
    2-D mesh, the latent all-reduce of the mixing."""
    from hetmogp_tpu_torch.models import predict as predict_mod

    comm = mesh_comm(mesh, config)

    def f(params, X):
        cache = predict_mod.sharded_cache(params, config, comm)
        return predict_mod.sharded_task_predictive(params, config, comm,
                                                   cache, X, task)

    return f


# ---------------------------------------------------------------------------
# a local launcher
# ---------------------------------------------------------------------------

def _run_rank(fn, rank: int, world_size: int, workdir: str, device_type,
              backend: str, timeout: float, threads, args) -> None:
    err = os.path.join(workdir, f"error_{rank}")
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(workdir, "store"), world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"result_{rank}"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_local(fn: Callable, world_size: int, device_type: str = "cpu",
                backend: Optional[str] = None, *, args: tuple = (),
                timeout: float = 60.0, deadline: Optional[float] = None,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes of one
    process group on this host and return their results in rank order.

    The counterpart of the JAX package's ``force_virtual_cpu``, which has
    no torch equivalent: the ranks are real processes, started with the
    ``spawn`` method, meeting at a ``FileStore`` in a temporary directory.
    ``backend``: ``"gloo"`` on the CPU, and for several ranks sharing a
    card (collectives through the host); ``"nccl"`` where each rank has a
    GPU of its own (rank % device_count on ``device_type="cuda"``).
    ``timeout``: the process group's, in seconds, so that a rank stuck in a
    collective fails instead of hanging; ``deadline``: seconds for the
    whole run, after which the ranks are killed.  ``threads`` caps each
    rank's torch threads.  ``fn`` must be importable by name (a function of
    a module) and return something picklable.  Raises RuntimeError,
    with the first failed rank's traceback, if any rank fails; the other
    ranks are then stopped.
    """
    import multiprocessing as mp

    if backend is None:
        backend = ("nccl" if device_type == "cuda"
                   and world_size <= torch.cuda.device_count() else "gloo")
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="hetmogp_spawn_")
    procs = []
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_run_rank, args=(
                fn, rank, world_size, workdir, device_type, backend, timeout,
                threads, args), daemon=True)
            p.start()
            procs.append(p)
        t_end = None if deadline is None else time.monotonic() + deadline
        failed = None
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None:
                break
            if t_end is not None and time.monotonic() > t_end:
                failed = "deadline"
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.exitcode != 0),
                          None)
        if failed is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
            if failed == "deadline":
                raise RuntimeError(f"spawn_local: the ranks did not finish "
                                   f"within {deadline} s")
            msgs = []
            for r in range(world_size):
                path = os.path.join(workdir, f"error_{r}")
                if os.path.exists(path):
                    with open(path) as f:
                        msgs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"spawn_local: rank {failed} exited with code "
                f"{procs[failed].exitcode}\n" + "\n".join(msgs))
        out = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"result_{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(workdir, ignore_errors=True)
