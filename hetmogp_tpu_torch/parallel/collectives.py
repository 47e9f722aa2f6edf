"""The explicit collectives of the sharded ELBO, trainers and predictive.

The JAX package lets ``jax.jit`` partition its programs over a mesh and
insert the collectives itself.  Here every collective is written out, on
the process groups of a ``torch.distributed`` ``DeviceMesh`` with dims
``("data",)`` or ``("data", "latent")``; nothing propagates through the
hand kernels' custom operators (no DTensor).  ``MeshComm`` holds this
rank's place in the mesh and the collectives:

* on the latent axis, Megatron's pair of autograd functions:
  ``reduce_from_latent`` (all-reduce forward, identity backward) where the
  per-q partial sums of the mixing leave the sharded region, and
  ``copy_to_latent`` (identity forward, all-reduce of the gradient
  backward) where a latent-replicated leaf enters per-q work.
  ``torch.distributed.nn.functional.all_reduce`` would all-reduce the
  gradient again in its backward, which multiplies it by the group's size;
* on the data axis, one all-reduce of the flat gradient after the
  backward (``data_sum_``): each rank's gradient is that of its rows;
* one all-reduce over the whole mesh of the step's diagnostics
  (``reduce_metrics``): the VE sums over the data axis and the KL over the
  latent axis, with the KL's gradient kept on data rank 0 only, so that
  the data all-reduce counts it once.

Every collective adds to ``collective_counts()`` (calls and bytes, by axis
and kind, as ``cuda_kernels.launch_counts()`` counts launches) where it is
issued: in a captured CUDA graph that is once, at the capture.
``record_collectives()`` also lists them in order, for the tests that pin
the structure.  Each count is taken where the collective is issued, never
for a collective that was not.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from hetmogp_tpu_torch.models.params import (FIELDS, SVMOGPParams,
                                             from_leaves, leaves)

_COUNTS: collections.Counter = collections.Counter()
_TRACE: List[list] = []

# the Q-leading leaves of the params: the latent copies (Qe rows) and the
# kernel hypers (Q rows); lik_theta is per task and always replicated
_COPY_LEAVES = ("Z", "q_mu", "q_sqrt", "W", "kappa")
_HYPER_LEAVES = ("log_lengthscale", "log_variance")


def collective_counts() -> dict:
    """Collectives issued since the last ``zero_collective_counts``:
    ``"<axis>.<kind>"`` calls and ``"<axis>.<kind>.bytes"``, axis ``data``,
    ``latent`` or ``world``, kind ``all_reduce``, ``all_gather`` or
    ``broadcast``."""
    return dict(_COUNTS)


def zero_collective_counts() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def record_collectives():
    """Yield a list that receives ``(axis, kind, numel)`` for each
    collective issued inside the block, in order."""
    log: list = []
    _TRACE.append(log)
    try:
        yield log
    finally:
        _TRACE.remove(log)


def _count(axis: str, kind: str, t: torch.Tensor) -> None:
    key = f"{axis}.{kind}"
    _COUNTS[key] += 1
    _COUNTS[key + ".bytes"] += t.numel() * t.element_size()
    for log in _TRACE:
        log.append((axis, kind, t.numel()))


def all_reduce_(t: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over ``group``, counted under ``axis``."""
    _count(axis, "all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, axis: str, size: int) -> list:
    """The ``size`` ranks' ``t`` of ``group``, in rank order."""
    _count(axis, "all_gather", t)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return out


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


class _ReduceFromLatent(torch.autograd.Function):
    """All-reduce over the latent group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group, "latent")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToLatent(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over the latent group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, "latent"), None


class _ReduceMetrics(torch.autograd.Function):
    """[ve_sums (T,), kl] summed over the mesh, each weighted 1 on the
    ranks that count it and 0 on the others (a non-finite value stays
    non-finite).  Backward: the VE sums' gradient passes to every rank,
    the KL's times ``kl_grad_weight``."""

    @staticmethod
    def forward(ctx, ve_sums, kl, group, ve_weight, kl_weight,
                kl_grad_weight):
        ctx.kl_grad_weight = kl_grad_weight
        flat = torch.cat([ve_sums * ve_weight, (kl * kl_weight).reshape(1)])
        all_reduce_(flat, group, "world")
        return flat[:-1].clone(), flat[-1].clone()

    @staticmethod
    def backward(ctx, g_ve, g_kl):
        return g_ve, g_kl * ctx.kl_grad_weight, None, None, None, None


@dataclasses.dataclass
class MeshComm:
    """This rank's place in a ``("data",)`` or ``("data", "latent")``
    mesh, for a model of ``num_latent_eff`` latent copies of
    ``num_latent`` kernel groups, and the collectives over it.

    The latent axis splits the copies when its size divides Qe
    (``split``), and the kernel hypers as well when it divides Q
    (``split_hypers``); otherwise the Q-leading leaves are replicated and
    every latent rank computes all of them.  Data rank d holds rows
    [d N / k_d, (d + 1) N / k_d) of every N-row array it is given.
    """

    mesh: object
    num_latent_eff: int
    num_latent: int

    def __post_init__(self):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(parallel.data_mesh or parallel.model_mesh), "
                            f"got {type(self.mesh).__name__}")
        names = tuple(self.mesh.mesh_dim_names or ())
        if names not in (("data",), ("data", "latent")):
            raise ValueError(f"the mesh's dims must be ('data',) or ('data', "
                             f"'latent'), got {names}")
        if self.mesh.size() != dist.get_world_size():
            raise ValueError("the mesh must span every rank of the process "
                             "group")
        shape = dict(zip(names, self.mesh.shape))
        self.k_data = shape["data"]
        self.data_group = self.mesh.get_group("data")
        self.data_rank = self.mesh.get_local_rank("data")
        self.k_latent = shape.get("latent", 1)
        self.latent_group = (self.mesh.get_group("latent")
                             if self.k_latent > 1 else None)
        self.latent_rank = (self.mesh.get_local_rank("latent")
                            if self.k_latent > 1 else 0)
        self.split = (self.k_latent > 1
                      and self.num_latent_eff % self.k_latent == 0)
        self.split_hypers = (self.split
                             and self.num_latent % self.k_latent == 0)
        self.backend = dist.get_backend()
        self.world = dist.group.WORLD
        self.rank = dist.get_rank()

    # ---- placement ------------------------------------------------------
    def is_sharded(self, name: str) -> bool:
        """Whether the params leaf ``name`` is split over the latent axis."""
        return ((self.split and name in _COPY_LEAVES)
                or (self.split_hypers and name in _HYPER_LEAVES))

    def _part(self, n: int, k: int, i: int):
        return (i * n) // k, ((i + 1) * n) // k

    def latent_slice(self, n: int) -> slice:
        """This rank's rows of an n-row leaf split over the latent axis."""
        return slice(*self._part(n, self.k_latent, self.latent_rank))

    def shard_params(self, params: SVMOGPParams) -> SVMOGPParams:
        """This rank's shard of full params."""
        return from_leaves(params, [
            t[self.latent_slice(t.shape[0])] if self.is_sharded(name) else t
            for name, t in leaves(params)])

    def gather_params(self, params: SVMOGPParams) -> SVMOGPParams:
        """Full params from every rank's shard: an all-gather over the
        latent axis of each split leaf."""
        out = []
        for name, t in leaves(params):
            if self.is_sharded(name):
                t = torch.cat(all_gather(t, self.latent_group, "latent",
                                         self.k_latent))
            out.append(t)
        return from_leaves(params, out)

    def view(self, params: SVMOGPParams) -> SVMOGPParams:
        """The params this rank's per-q work reads: its own where the
        hypers are split with the copies (or nothing is split); where only
        the copies are, the replicated hypers repeated over all copies
        (through ``copy_to_latent``) and cut to this rank's."""
        if not self.split or self.split_hypers:
            return params
        rows = self.latent_slice(self.num_latent_eff)

        def copies(h):
            h = _CopyToLatent.apply(h, self.latent_group)
            return h.repeat_interleave(params.rank, 0)[rows]

        return dataclasses.replace(
            params, log_lengthscale=copies(params.log_lengthscale),
            log_variance=copies(params.log_variance), rank=1)

    def rows(self, n: int) -> slice:
        """This data rank's part of n rows."""
        return slice(*self._part(n, self.k_data, self.data_rank))

    def local_rows(self, data):
        """This data rank's rows of each task's batch (a tuple of
        TaskData)."""
        out = []
        for td in data:
            sl = self.rows(td.X.shape[0])
            if sl.stop <= sl.start:
                raise ValueError(
                    f"a batch of {td.X.shape[0]} rows leaves data rank "
                    f"{self.data_rank} of {self.k_data} none: every task's "
                    "batch (and the VM step's part of it) needs at least one "
                    "row per data rank")
            out.append(type(td)(*(a[sl] for a in td)))
        return tuple(out)

    # ---- collectives ----------------------------------------------------
    def latent_sum(self, tensors: Sequence[torch.Tensor]) -> list:
        """``reduce_from_latent`` of each tensor (one all-reduce for all of
        them); the tensors themselves where the copies are not split."""
        if not self.split:
            return list(tensors)
        flat = _ReduceFromLatent.apply(_flat(tensors), self.latent_group)
        return _unflat(flat, tensors)

    def latent_values(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the latent axis of ``t``, without gradient (``t``
        itself where the copies are not split)."""
        if not self.split:
            return t
        with torch.no_grad():
            return all_reduce_(t.clone(), self.latent_group, "latent")

    def data_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum the tensors over the data axis in place, as one flat
        all-reduce (issued at k_data = 1 too)."""
        if not tensors:
            return
        with torch.no_grad():
            flat = all_reduce_(_flat(tensors), self.data_group, "data")
            for t, s in zip(tensors, _unflat(flat, tensors)):
                t.copy_(s)

    def reduce_metrics(self, ve_sums: torch.Tensor, kl: torch.Tensor):
        """(the global VE sums (T,), the global KL) from this rank's: its
        rows' VE sums and its latents' KL, in one all-reduce over the mesh.
        The gradient of the global values on this rank is its own part: the
        VE sums' in full, the KL's on data rank 0 only."""
        owns_kl = self.data_rank == 0 and (self.split or self.latent_rank == 0)
        return _ReduceMetrics.apply(
            ve_sums, kl, self.world, float(self.latent_rank == 0),
            float(owns_kl), float(self.data_rank == 0))

    def sq_norm(self, grads: Sequence[Optional[torch.Tensor]]):
        """The squared global norm of the gradients (None for a masked
        leaf), in the order of ``leaves``: the split leaves' squares summed
        over the latent axis, the replicated leaves' counted once."""
        names = FIELDS + ("lik_theta",) * (len(grads) - len(FIELDS))
        present = [(n, g) for n, g in zip(names, grads) if g is not None]
        sharded = [torch.sum(torch.square(g)) for n, g in present
                   if self.is_sharded(n)]
        total = None
        if sharded:
            total = self.latent_values(sum(sharded))
        for n, g in present:
            if not self.is_sharded(n):
                s = torch.sum(torch.square(g))
                total = s if total is None else total + s
        return total

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in order (the predictive's final
        all-gather)."""
        return torch.cat(all_gather(t, self.data_group, "data", self.k_data))

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        _count("world", "broadcast", t)
        dist.broadcast(t, src=0)
        return t

    def barrier(self) -> None:
        dist.barrier()

