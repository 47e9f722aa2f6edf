"""Checkpoint and resume: one ``.npz`` in the JAX package's layout.

Counterpart of ``hetmogp_tpu/checkpoint.py``'s ``save_checkpoint``,
``peek_meta`` and ``load_checkpoint``.  The file holds

* ``param_0`` ... ``param_6``: the seven fields of ``SVMOGPParams`` in
  field order, then one ``param_i`` per task's ``lik_theta`` where the
  params hold theta (the JAX package's pytree order), so a parameter
  file written by either package loads in the other;
* ``opt_0`` ...: the optimizer state's tensors (``train.AdamState`` or
  ``train.AdadeltaState``, field by field).  The port's optimizer state is
  its own, so these round-trip within the port only;
* ``_rng_key``: a JAX PRNG key, where one was passed or read;
* ``_torch_generator_state``: the state of a CPU ``torch.Generator`` (the
  port's minibatch stream), a key of the port's own that the JAX loader
  ignores;
* ``_meta``: JSON bytes of ``{"step", "n_opt", "extra"}``.

``save_checkpoint_sharded``/``load_checkpoint_sharded`` are the JAX
package's functions of those names for a state split over a mesh
(``parallel.sharding``), in a format of the port's own: the JAX package
writes Orbax directories, and Orbax imports JAX.  A sharded checkpoint is a
directory holding ``meta.json`` (step, the number of optimizer tensors,
extra, the number of shards and which tensors are split) and one
``shard_<l>.npz`` a latent rank, each with that rank's rows of the split
tensors and the replicated ones whole (``param_i``/``opt_i`` in the order
above), written by data rank 0 of each latent rank.  It is written beside
its final name (``<name>.tmp``) and swapped in, the previous one kept as
``<name>.old`` until then, so a crash leaves the old or the new whole.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.models.params import SVMOGPParams
from hetmogp_tpu_torch.train import _map_state, _state_tensors

GENERATOR_KEY = "_torch_generator_state"
_RESERVED = ("rng_key", "generator_state")


def _normalize(path) -> Path:
    """np.savez appends '.npz' to a name without that suffix; pin the
    suffix on save and load alike, so save('ckpt') + load('ckpt')
    round-trips."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path, params: SVMOGPParams, opt_state: Any = None,
                    step: int = 0, extra: Optional[dict] = None,
                    rng_key=None,
                    generator: Optional[torch.Generator] = None) -> None:
    """Save (params, opt_state, step, extra) as one .npz, with the state of
    the CPU ``generator`` (the minibatch stream) or a JAX ``rng_key`` if
    given.  ``extra`` must be JSON-serializable; its keys ``rng_key`` and
    ``generator_state`` are reserved for what the loader returns.  The
    file is written beside its final name and then renamed, so a crash
    mid-save leaves any earlier file at ``path`` whole."""
    if extra and any(k in extra for k in _RESERVED):
        raise ValueError(
            "extra['rng_key'] and extra['generator_state'] are reserved: pass "
            "the training key via rng_key= or the generator via generator= "
            "(load_checkpoint returns them under those names)")
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"param_{i}": _numpy(t)
              for i, t in enumerate(_state_tensors(params))}
    opt = _state_tensors(opt_state) if opt_state is not None else []
    arrays.update({f"opt_{i}": _numpy(t) for i, t in enumerate(opt)})
    if rng_key is not None:
        arrays["_rng_key"] = np.asarray(rng_key)
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    meta = {"step": int(step), "n_opt": len(opt), "extra": extra or {}}
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def peek_meta(path) -> dict:
    """The metadata (step, n_opt, extra) of an npz checkpoint, without its
    arrays: what a caller needs to build the templates for
    ``load_checkpoint`` (``SVMOGP.load`` reads the config from it)."""
    with np.load(_normalize(path), allow_pickle=False) as z:
        return json.loads(bytes(z["_meta"]).decode())


def load_checkpoint(path, params_template: SVMOGPParams,
                    opt_state_template: Any = None
                    ) -> Tuple[SVMOGPParams, Any, int, dict]:
    """Restore (params, opt_state, step, extra) into the structure of the
    templates, each tensor of its template leaf's dtype and device; shapes
    are checked against the saved arrays.  A checkpoint of the JAX package
    loads here (its params; its optimizer state is optax's and does not).

    ``extra["generator_state"]`` holds a saved generator's state (a uint8
    tensor for ``torch.Generator.set_state``).  ``extra["rng_key"]`` holds a
    JAX key saved by the JAX package, as an array: torch cannot replay
    JAX's PRNG from it, so it is returned as data and seeds nothing.
    """
    with np.load(_normalize(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["_meta"]).decode())

        def read(prefix, what, template):
            arrays = []
            for i, leaf in enumerate(_state_tensors(template)):
                key = f"{prefix}_{i}"
                if key not in z.files:
                    raise ValueError(f"checkpoint has no {what} {i}: the "
                                     "template has more leaves than the file")
                arr = z[key]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint {what} {i} shape {arr.shape} != "
                        f"template {tuple(leaf.shape)}")
                arrays.append(arr)
            it = iter(arrays)
            return _map_state(lambda t: torch.tensor(
                next(it), dtype=t.dtype, device=t.device), template)

        params = read("param", "param", params_template)
        opt_state = None
        if opt_state_template is not None and meta["n_opt"]:
            opt_state = read("opt", "opt_state leaf", opt_state_template)
        extra = dict(meta["extra"])
        if "_rng_key" in z.files:
            extra["rng_key"] = np.array(z["_rng_key"])
        if GENERATOR_KEY in z.files:
            extra["generator_state"] = torch.from_numpy(
                np.array(z[GENERATOR_KEY]))
        return params, opt_state, meta["step"], extra


# ---------------------------------------------------------------------------
# sharded checkpoints (a state split over a mesh)
# ---------------------------------------------------------------------------

META = "meta.json"


def _shard_name(latent: int) -> str:
    return f"shard_{latent}.npz"


def _split_flags(comm, tree) -> list:
    """Whether each tensor of a params or optimizer-state tree (in the
    order of ``_state_tensors``) is split over the latent axis."""
    from hetmogp_tpu_torch.models.params import SVMOGPParams, leaves

    if tree is None:
        return []
    if isinstance(tree, SVMOGPParams):
        return [comm is not None and comm.is_sharded(name)
                for name, _ in leaves(tree)]
    flags = []
    for f in dataclasses.fields(tree):
        sub = getattr(tree, f.name)
        flags += (_split_flags(comm, sub) if isinstance(sub, SVMOGPParams)
                  else [False] * len(_state_tensors(sub)))
    return flags


def save_checkpoint_sharded(path, params: SVMOGPParams, opt_state: Any = None,
                            step: int = 0, extra: Optional[dict] = None,
                            rng_key=None,
                            generator: Optional[torch.Generator] = None,
                            mesh=None, config=None) -> None:
    """Save (params, opt_state, step, extra) as a sharded checkpoint
    directory at ``path`` (see the module docstring).

    mesh: the ``parallel.sharding`` mesh the state is split over; every
      rank calls with its own part (``shard_state``), and data rank 0 of
      each latent rank writes that rank's shard.  None saves full params
      from one process, as one shard.
    config: the model's ModelConfig, needed with ``mesh`` (a shard does not
      say how it was split).
    ``extra``, ``rng_key`` and ``generator`` as for ``save_checkpoint``.
    Overwriting a checkpoint at ``path`` is crash-safe: the new one is
    written to ``<name>.tmp`` and swapped in, so a crash leaves the old or
    the new one whole at ``path`` (and perhaps a ``.tmp`` or ``.old``,
    which the next save clears).  Under a mesh the ranks meet at barriers
    around the writes and the swap.
    """
    if extra and any(k in extra for k in _RESERVED):
        raise ValueError(
            "extra['rng_key'] and extra['generator_state'] are reserved: pass "
            "the training key via rng_key= or the generator via generator= "
            "(load_checkpoint_sharded returns them under those names)")
    comm = None
    if mesh is not None:
        from hetmogp_tpu_torch.parallel import sharding

        if config is None:
            raise ValueError("save_checkpoint_sharded(mesh=) needs the "
                             "model's config=: a shard does not say how it "
                             "was split")
        comm = sharding.mesh_comm(mesh, config)
    path = Path(path).absolute()
    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    root = comm is None or comm.rank == 0
    latent = comm.latent_rank if comm is not None and comm.split else 0
    # one writer a shard: data rank 0 of each latent rank that holds one
    writes = comm is None or (comm.data_rank == 0
                              and (comm.split or comm.latent_rank == 0))
    opt = _state_tensors(opt_state) if opt_state is not None else []
    if root:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    if comm is not None:
        comm.barrier()
    if writes:
        arrays = {f"param_{i}": _numpy(t)
                  for i, t in enumerate(_state_tensors(params))}
        arrays.update({f"opt_{i}": _numpy(t) for i, t in enumerate(opt)})
        if latent == 0 and rng_key is not None:
            arrays["_rng_key"] = np.asarray(rng_key)
        if latent == 0 and generator is not None:
            arrays[GENERATOR_KEY] = generator.get_state().numpy()
        with open(tmp / _shard_name(latent), "wb") as f:
            np.savez(f, **arrays)
    if root:
        meta = {"step": int(step), "n_opt": len(opt), "extra": extra or {},
                "shards": comm.k_latent if comm is not None and comm.split
                else 1,
                "split_params": _split_flags(comm, params),
                "split_opt": _split_flags(comm, opt_state)}
        (tmp / META).write_text(json.dumps(meta))
    if comm is not None:
        comm.barrier()
    if root:
        # the old checkpoint survives until the new one is whole on disk
        shutil.rmtree(old, ignore_errors=True)
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old, ignore_errors=True)
    if comm is not None:
        comm.barrier()


def load_checkpoint_sharded(path, params_template: SVMOGPParams,
                            opt_state_template: Any = None, mesh=None
                            ) -> Tuple[SVMOGPParams, Any, int, dict]:
    """Restore a checkpoint written by ``save_checkpoint_sharded``.

    The templates are the full structures (``init_params``,
    ``train.init_optimizer_state``), whose dtype and device the result
    takes.  With ``mesh=`` each rank gets its part: where the checkpoint
    was split the same way it reads only its own shard; otherwise the full
    tensors are assembled and cut to its rows.  Without a mesh the full
    params are assembled from every shard.  Returns ``(params, opt_state,
    step, extra)`` as ``load_checkpoint``; shapes are checked against the
    templates.
    """
    comm = None
    if mesh is not None:
        from hetmogp_tpu_torch.parallel import sharding

        comm = sharding.mesh_comm(mesh, params_template)
    path = Path(path)
    meta = json.loads((path / META).read_text())
    if meta["n_opt"] and opt_state_template is None:
        raise ValueError(
            "checkpoint contains opt_state: pass opt_state_template")
    if not meta["n_opt"] and opt_state_template is not None:
        raise ValueError("checkpoint has no opt_state but a template was "
                         "passed")
    shards = meta["shards"]
    own = (comm is not None and comm.split and shards == comm.k_latent
           and meta["split_params"] == _split_flags(comm, params_template)
           and meta["split_opt"] == _split_flags(comm, opt_state_template))
    names = [_shard_name(comm.latent_rank)] if own else [
        _shard_name(l) for l in range(shards)]
    files = [np.load(path / n, allow_pickle=False) for n in names]
    try:
        def read(prefix, what, template, saved_flags):
            want = _split_flags(comm, template)
            if len(saved_flags) != len(want):
                raise ValueError(f"checkpoint has {len(saved_flags)} "
                                 f"{what}s, the template {len(want)}")
            arrays = []
            for i, (leaf, was, now) in enumerate(zip(
                    _state_tensors(template), saved_flags, want)):
                key = f"{prefix}_{i}"
                if own or not was:
                    arr = files[0][key]
                else:
                    arr = np.concatenate([z[key] for z in files])
                if now and not own:
                    arr = arr[comm.latent_slice(arr.shape[0])]
                shape = tuple(leaf.shape)
                if now:
                    sl = comm.latent_slice(shape[0])
                    shape = (sl.stop - sl.start,) + shape[1:]
                if arr.shape != shape:
                    raise ValueError(f"checkpoint {what} {i} shape "
                                     f"{arr.shape} != template {shape}")
                arrays.append(arr)
            it = iter(arrays)
            return _map_state(lambda t: torch.tensor(
                next(it), dtype=t.dtype, device=t.device), template)

        params = read("param", "param", params_template, meta["split_params"])
        opt_state = None
        if opt_state_template is not None:
            opt_state = read("opt", "opt_state leaf", opt_state_template,
                             meta["split_opt"])
        extra = dict(meta["extra"])
        first = files[0] if not own or comm.latent_rank == 0 else np.load(
            path / _shard_name(0), allow_pickle=False)
        if "_rng_key" in first.files:
            extra["rng_key"] = np.array(first["_rng_key"])
        if GENERATOR_KEY in first.files:
            extra["generator_state"] = torch.from_numpy(
                np.array(first[GENERATOR_KEY]))
        if first is not files[0]:
            first.close()
    finally:
        for z in files:
            z.close()
    return params, opt_state, meta["step"], extra
