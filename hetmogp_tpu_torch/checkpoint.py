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

The mesh-sharded checkpoints of the JAX package (``save_checkpoint_sharded``,
``load_checkpoint_sharded``, Orbax directories) come with the parallelism
slice.
"""

from __future__ import annotations

import json
import os
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
