"""Stochastic VEM training: the flagship trainer of the JAX package.

Counterpart of the main path of ``hetmogp_tpu/train.py``: adam, the cached
fast projection, the whitened model, ``minibatch="slice"`` and the VE/VM
flip-flop of ``make_svi_step_body`` (``ve_steps_per_vm`` VE steps, then one
VM step).  Two loops drive it: ``make_scan_trainer`` (the JAX package's
production loop), which on the card replays one captured CUDA graph per
step kind, and ``make_trainer``, a host loop of eager steps.
``svi_fit_on_device`` wraps the first.  Natural gradients, Adadelta and its
lookahead, the LR schedules and the row-gather sampler are not ported
(``TrainConfig`` refuses them).

One step:

* **VE** differentiates only (q_mu, q_sqrt), against the cached
  (Luu, Luu^{-1}) of the frozen hypers, so no gradient runs through the
  projection, the kernel or the factorization.
* **VM** differentiates the hypers, Z and W (per ``learn_inducing`` and
  ``learn_W``) and the likelihoods' theta (``params.lik_theta``, per
  ``learn_lik_params``) on the ``vm_batch_fraction`` prefix of each task's
  batch,
  with the ELBO scales re-derived from the mask sums, through the
  cached-inverse adjoints; then (Luu, Luu^{-1}) is refreshed at the new
  hypers.
* Both end with adam written out with ``optax.adam``'s semantics: every
  leaf's moments tick with its masked gradient (zero for frozen leaves) and
  only the free leaves move.  ``torch.optim.Adam`` would keep moving a
  frozen leaf through its momentum after a VE/VM switch.

The step count and the VE/VM schedule live on the host (the 4:1 schedule
is static), so the loop needs no device-side branch; the ELBOs stay on the
device and nothing synchronises per step.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.data import full_batch
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import (SVMOGPParams, from_leaves,
                                             leaves)
from hetmogp_tpu_torch.ops import cuda_kernels

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def ve_mask() -> Tuple[str, ...]:
    """The leaves a VE step frees: the variational parameters."""
    return ("q_mu", "q_sqrt")


def vm_mask(train_config: TrainConfig) -> Tuple[str, ...]:
    """The leaves a VM step frees: the kernel hypers, plus Z, W and
    ``lik_theta`` per ``learn_inducing``, ``learn_W`` and
    ``learn_lik_params``; kappa stays fixed always."""
    free = ["log_lengthscale", "log_variance"]
    if train_config.learn_inducing:
        free.append("Z")
    if train_config.learn_W:
        free.append("W")
    if train_config.learn_lik_params:
        free.append("lik_theta")
    return tuple(free)


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the number of accepted updates and the
    first and second moments of every leaf."""

    count: torch.Tensor  # () int64
    mu: SVMOGPParams
    nu: SVMOGPParams


@dataclasses.dataclass
class TrainState:
    params: SVMOGPParams
    opt_state: AdamState
    step: int
    Luu: torch.Tensor  # (Q, M, M), valid for the current hypers
    iLuu: torch.Tensor  # (Q, M, M), Luu^{-1}


def init_train_state(params: SVMOGPParams, config: ModelConfig) -> TrainState:
    """Step 0: zero adam moments and the (Luu, Luu^{-1}) cache."""
    with torch.no_grad():
        Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
        zeros = from_leaves(params, [torch.zeros_like(t)
                                     for _, t in leaves(params)])
    count = torch.zeros((), dtype=torch.int64, device=params.Z.device)
    return TrainState(params, AdamState(count, zeros, zeros), 0, Luu, iLuu)


def _adam(params: SVMOGPParams, opt: AdamState,
          grads: Sequence[Optional[torch.Tensor]], lr: float):
    """One masked ``optax.adam`` step.  ``grads`` holds a gradient for each
    free leaf and None for the others, in the order of ``leaves``; every
    other leaf's moments decay as with a zero gradient, and only the free
    leaves move."""
    count = opt.count + 1
    c = count.to(params.Z.dtype)
    bc1 = 1.0 - torch.pow(ADAM_B1, c)
    bc2 = 1.0 - torch.pow(ADAM_B2, c)
    new_p, new_mu, new_nu = [], [], []
    for (_, p), (_, mu), (_, nu), g in zip(leaves(params), leaves(opt.mu),
                                           leaves(opt.nu), grads):
        if g is None:
            new_mu.append(ADAM_B1 * mu)
            new_nu.append(ADAM_B2 * nu)
            new_p.append(p)
            continue
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1.0 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu
        new_mu.append(mu)
        new_nu.append(nu)
        new_p.append(p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return (from_leaves(params, new_p),
            AdamState(count, from_leaves(params, new_mu),
                      from_leaves(params, new_nu)))


def vm_sub_batch(data: Sequence[elbo_mod.TaskData], scales: torch.Tensor,
                 fraction: float):
    """The VM step's batch: the first ceil(fraction * B_t) rows of each
    task (a prefix of a uniform random block is a smaller one), with the
    scales re-derived from the mask sums so masked rows stay excluded."""
    if fraction >= 1.0:
        return tuple(data), scales
    sub = tuple(elbo_mod.TaskData(*(a[:max(1, math.ceil(td.X.shape[0]
                                                         * fraction))]
                                    for a in td))
                for td in data)
    full = torch.stack([torch.clamp(td.mask.sum(), min=1.0) for td in data])
    part = torch.stack([torch.clamp(td.mask.sum(), min=1.0) for td in sub])
    return sub, scales * (full / part).to(scales.dtype)


def make_step(config: ModelConfig, train_config: TrainConfig, *,
              use_kernel: bool = True) -> Callable:
    """step(state, data, scales) -> (state, metrics), one VE or VM step by
    ``state.step`` (counterpart of ``make_svi_step_body`` at vem=True).

    ``use_kernel=False`` takes the plain PyTorch versions of the CUDA
    kernels.  metrics: ``elbo`` (before the update), ``kl``, ``ve`` (T,),
    and ``skipped`` (0/1) under ``skip_nonfinite_steps``; all on the
    device.
    """
    if not config.whiten:
        raise NotImplementedError(
            "the trainer's cached-inverse path needs config.whiten (the "
            "un-whitened solve path is ROADMAP.md section 1, item 7)")
    cycle = train_config.ve_steps_per_vm + 1
    lr = train_config.step_rate
    frac = train_config.vm_batch_fraction

    def step(state: TrainState, data, scales):
        params = state.params
        is_ve = state.step % cycle < train_config.ve_steps_per_vm
        free = ve_mask() if is_ve else vm_mask(train_config)
        names = [name for name, _ in leaves(params)]
        tensors = [t.detach().requires_grad_(name in free)
                   for name, t in leaves(params)]
        p = from_leaves(params, tensors)
        if is_ve:
            elbo, aux = elbo_mod.elbo_fn(p, data, scales, config,
                                         Luu=state.Luu, iLuu=state.iLuu,
                                         use_kernel=use_kernel)
        else:
            data_vm, scales_vm = vm_sub_batch(data, scales, frac)
            elbo, aux = elbo_mod.elbo_fn(p, data_vm, scales_vm, config,
                                         Luu=state.Luu, iLuu=state.iLuu,
                                         cache_grad=True,
                                         use_kernel=use_kernel)
        free_at = [i for i, name in enumerate(names) if name in free]
        grads = [None] * len(names)
        for i, gi in zip(free_at, torch.autograd.grad(
                -elbo, [tensors[i] for i in free_at], allow_unused=True)):
            # a theta leaf of a family without theta is not in the graph:
            # its gradient is zero
            grads[i] = torch.zeros_like(tensors[i]) if gi is None else gi
        with torch.no_grad():
            new_params, opt = _adam(params, state.opt_state, grads, lr)
            if is_ve:
                Luu, iLuu = state.Luu, state.iLuu
            else:  # hypers and Z moved: refresh the cache
                Luu, iLuu = elbo_mod.prior_cholesky_inverse(new_params,
                                                            config)
            metrics = {"elbo": elbo.detach(), "kl": aux["kl"].detach(),
                       "ve": aux["ve"].detach()}
            new = TrainState(new_params, opt, state.step + 1, Luu, iLuu)
            if train_config.skip_nonfinite_steps:
                new, metrics["skipped"] = _keep_if_nonfinite(
                    state, new, elbo, [grads[i] for i in free_at])
        return new, metrics

    return step


def _keep_if_nonfinite(old: TrainState, new: TrainState, elbo, grads):
    """``skip_nonfinite_steps``: where the step's ELBO or gradient global
    norm is not finite, the new state keeps the old params, adam state and
    cache (the step count still advances, so the VE/VM schedule stays
    aligned).  Selected on the device, without a synchronisation."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    ok = torch.isfinite(elbo) & torch.isfinite(gnorm)

    def sel(a, b):
        return torch.where(ok, a, b)

    def sel_params(a, b):
        return from_leaves(a, [sel(x, y) for (_, x), (_, y) in
                               zip(leaves(a), leaves(b))])

    opt = AdamState(sel(new.opt_state.count, old.opt_state.count),
                    sel_params(new.opt_state.mu, old.opt_state.mu),
                    sel_params(new.opt_state.nu, old.opt_state.nu))
    kept = TrainState(sel_params(new.params, old.params), opt, new.step,
                      sel(new.Luu, old.Luu), sel(new.iLuu, old.iLuu))
    return kept, (~ok).to(torch.int32)


# ---------------------------------------------------------------------------
# the training loop over a device-resident dataset
# ---------------------------------------------------------------------------

def extend_for_wraparound(dataset: Sequence[elbo_mod.TaskData], batch_sizes,
                          task_sizes=None):
    """Append each task's first B_t real rows, so that a circular slice at
    any offset in [0, N_t) is a plain slice.  Rows past N_t (padding) are
    dropped: offsets never reach them."""
    if task_sizes is None:
        task_sizes = tuple(td.X.shape[0] for td in dataset)
    return tuple(elbo_mod.TaskData(*(torch.cat([a[:nt], a[:min(bt, nt)]])
                                     for a in td))
                 for td, bt, nt in zip(dataset, batch_sizes, task_sizes))


def draw_offsets(generator: torch.Generator, task_sizes,
                 batch_sizes) -> Tuple[int, ...]:
    """One uniform offset in [0, N_t) per task (0 where B_t >= N_t: the
    whole task is the batch), from a CPU ``generator``: host integers, so
    slicing needs no device synchronisation."""
    return tuple(0 if bt >= nt else
                 int(torch.randint(nt, (), generator=generator))
                 for nt, bt in zip(task_sizes, batch_sizes))


def slice_batch(extended: Sequence[elbo_mod.TaskData], offsets, task_sizes,
                batch_sizes):
    """The contiguous wraparound block of each task at its offset, from a
    dataset passed through ``extend_for_wraparound``: every row has the
    inclusion probability B/N, so the N/B scale is unbiased."""
    return tuple(elbo_mod.TaskData(*(a[off:off + min(bt, nt)] for a in td))
                 for td, off, nt, bt in zip(extended, offsets, task_sizes,
                                            batch_sizes))


def batch_scales(task_sizes, batch_sizes, dtype, device) -> torch.Tensor:
    """N_t / B_t with the effective batch: a task with B_t >= N_t is taken
    whole every step, so its scale is 1."""
    return torch.tensor([n / float(min(b, n))
                         for n, b in zip(task_sizes, batch_sizes)],
                        dtype=dtype, device=device)


def make_trainer(config: ModelConfig, train_config: TrainConfig,
                 task_sizes: Tuple[int, ...], batch_sizes: Tuple[int, ...],
                 steps_per_call: int = 100):
    """A host loop of eager steps (``make_scan_trainer`` is the on-device
    loop): run(state, dataset, generator) -> (state, elbos) runs
    ``steps_per_call`` steps on minibatch slices of the device-resident
    ``dataset`` (one TaskData per task, the full arrays), with offsets from
    the CPU ``generator``.  ``elbos`` is a (steps_per_call,) device tensor;
    nothing synchronises per step.
    """
    step = make_step(config, train_config)

    def run(state: TrainState, dataset, generator: torch.Generator):
        scales = batch_scales(task_sizes, batch_sizes, config.torch_dtype,
                              state.params.Z.device)
        extended = extend_for_wraparound(dataset, batch_sizes, task_sizes)
        elbos = []
        for _ in range(steps_per_call):
            offsets = draw_offsets(generator, task_sizes, batch_sizes)
            batch = slice_batch(extended, offsets, task_sizes, batch_sizes)
            state, metrics = step(state, batch, scales)
            elbos.append(metrics["elbo"])
        return state, torch.stack(elbos)

    return run


def make_dataset(X_list, Y_list, config: ModelConfig,
                 device="cuda") -> Tuple[elbo_mod.TaskData, ...]:
    """Per-task TaskData of the config's dtype on ``device`` (the card
    unless the caller names another), mask 1."""
    return tuple(elbo_mod.task_data(X, Y, dtype=config.torch_dtype,
                                    device=device)
                 for X, Y in zip(X_list, Y_list))


# ---------------------------------------------------------------------------
# the on-device loop: one captured CUDA graph per step kind
# ---------------------------------------------------------------------------

def draw_offset_stream(generator: torch.Generator, task_sizes, batch_sizes,
                       steps: int) -> torch.Tensor:
    """(steps, T) int64 CPU tensor of slice offsets: ``draw_offsets`` for
    each step in turn, so it is the stream ``make_trainer`` draws from the
    same generator."""
    return torch.tensor([draw_offsets(generator, task_sizes, batch_sizes)
                         for _ in range(steps)],
                        dtype=torch.int64).reshape(steps, len(task_sizes))


def make_batch_sampler(task_sizes, batch_sizes, device="cuda") -> Callable:
    """sample_batch(offsets, extended) -> tuple[TaskData]: each task's block
    of min(B_t, N_t) rows from its offset, gathered from a dataset passed
    through ``extend_for_wraparound`` by offsets[t] + arange(B_t).

    offsets: (T,) int64 on ``device``.  The gather reads no host value, so
    it runs inside a captured CUDA graph; its rows are ``slice_batch``'s.
    """
    rows = tuple(torch.arange(min(b, n), device=device)
                 for n, b in zip(task_sizes, batch_sizes))

    def sample_batch(offsets: torch.Tensor, extended):
        return tuple(elbo_mod.TaskData(*(a.index_select(0, offsets[t] + r)
                                         for a in td))
                     for t, (td, r) in enumerate(zip(extended, rows)))

    return sample_batch


def _state_tensors(state: TrainState):
    """The state's tensors in a fixed order: params (theta included), adam
    count and moments, Luu, iLuu."""
    opt = state.opt_state

    def flat(p):
        return [t for _, t in leaves(p)]

    return (flat(state.params) + [opt.count] + flat(opt.mu) + flat(opt.nu)
            + [state.Luu, state.iLuu])


def _assign(dst: TrainState, src: TrainState) -> None:
    """Copy src's tensors into dst's, in place (skipping shared ones)."""
    for d, s in zip(_state_tensors(dst), _state_tensors(src)):
        if s is not d:
            d.copy_(s)


def _clone_state(state: TrainState) -> TrainState:
    params, opt = state.params, state.opt_state

    def clone(p):
        return from_leaves(p, [t.detach().clone() for _, t in leaves(p)])

    return TrainState(clone(params),
                      AdamState(opt.count.clone(), clone(opt.mu),
                                clone(opt.nu)),
                      state.step, state.Luu.detach().clone(),
                      state.iLuu.detach().clone())


class ScanTrainer:
    """``make_scan_trainer``'s runner; see there.

    After the first call on the card, ``capture_seconds`` is the warm-up and
    capture time, ``capture_launches[kind]`` the kernel launches recorded
    into each graph (``cuda_kernels.launch_counts`` keys), and
    ``replays[kind]`` the number of replays so far.
    """

    def __init__(self, config: ModelConfig, train_config: TrainConfig,
                 task_sizes, batch_sizes, steps_per_call: int):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")
        self.config, self.train_config = config, train_config
        self.task_sizes, self.batch_sizes = tuple(task_sizes), tuple(
            batch_sizes)
        self.steps_per_call = steps_per_call
        self.step_fn = make_step(config, train_config)
        nve = train_config.ve_steps_per_vm
        self.cycle = nve + 1
        # a representative step number of each kind the schedule has
        self.kinds = {"ve": 0, "vm": nve} if nve > 0 else {"vm": 0}
        self.state: Optional[TrainState] = None  # the static buffers
        self.ext = None
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.capture_launches: Dict[str, dict] = {}
        self.replays = {k: 0 for k in self.kinds}
        self.capture_seconds = None

    # ---- the step body: what a graph holds -----------------------------
    def _body(self, kind: str) -> None:
        """One step of ``kind`` on the static buffers: the offsets of row
        ``pos`` of the offset buffer, the step, the new state copied into
        the static one, the ELBO into ``elbo_buf[pos]``, then pos += 1."""
        st = self.state
        off = self.off_buf.index_select(0, self.pos)[0]
        batch = self.sample(off, self.ext)
        new, metrics = self.step_fn(
            dataclasses.replace(st, step=self.kinds[kind]), batch,
            self.scales)
        with torch.no_grad():
            _assign(st, new)
            self.elbo_buf.index_copy_(0, self.pos,
                                      metrics["elbo"].reshape(1))
            self.pos.add_(1)

    # ---- binding a call's state and dataset to the static buffers ------
    def _bind(self, state: TrainState, dataset) -> None:
        device = state.params.Z.device
        dtype = self.config.torch_dtype
        if self.state is None:
            self.state = _clone_state(state)
            self.device = device
            cap = self.steps_per_call
            self.off_buf = torch.zeros((cap, len(self.task_sizes)),
                                       dtype=torch.int64, device=device)
            self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
            self.elbo_buf = torch.zeros((cap,), dtype=dtype, device=device)
            self.scales = batch_scales(self.task_sizes, self.batch_sizes,
                                       dtype, device)
            self.sample = make_batch_sampler(self.task_sizes,
                                             self.batch_sizes, device)
        elif device != self.device:
            raise ValueError(f"this trainer runs on {self.device}; the state "
                             f"is on {device}")
        elif ([tuple(t.shape) for t in _state_tensors(state)]
              != [tuple(t.shape) for t in _state_tensors(self.state)]):
            raise ValueError("a trainer runs on states of one structure: the "
                             "graphs read its buffers (lik_theta included)")
        elif any(a is not b for a, b in zip(_state_tensors(state),
                                             _state_tensors(self.state))):
            with torch.no_grad():
                _assign(self.state, state)
        self.state.step = state.step
        if any(a.device != device or a.dtype != dtype
               for td in dataset for a in td):
            raise ValueError(f"the dataset must be {dtype} on {device}")
        ext = extend_for_wraparound(dataset, self.batch_sizes,
                                    self.task_sizes)
        if self.ext is None:
            self.ext = ext
            return
        new, old = ([a for td in e for a in td] for e in (ext, self.ext))
        if [a.shape for a in new] != [a.shape for a in old]:
            raise ValueError("a trainer runs on datasets of one shape: the "
                             "graphs read its buffers")
        for d, s in zip(old, new):  # the graphs read these buffers
            d.copy_(s)

    # ---- capture -------------------------------------------------------
    def _capture(self) -> None:
        """Warm each step kind up once on a side stream (cuBLAS, cuSOLVER
        and GH-table set-up), capture one graph per kind on that stream in
        one memory pool, and restore the state the warm-up moved."""
        t0 = time.perf_counter()
        saved = _clone_state(self.state)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for kind in self.kinds:
                self._body(kind)
        torch.cuda.current_stream(self.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for kind in self.kinds:
            before = cuda_kernels.launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    self._body(kind)
            except Exception as e:
                raise RuntimeError(f"capturing the {kind.upper()} step into "
                                   f"a CUDA graph failed: {e}") from e
            after = cuda_kernels.launch_counts()
            self.capture_launches[kind] = {k: after[k] - before[k]
                                           for k in after}
            self.graphs[kind] = graph
        with torch.no_grad():
            _assign(self.state, saved)
            self.pos.zero_()
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0

    # ---- a call --------------------------------------------------------
    def __call__(self, state: TrainState, dataset,
                 generator: Optional[torch.Generator] = None, *,
                 offsets=None):
        T = len(self.task_sizes)
        if offsets is None:
            if generator is None:
                raise ValueError("pass a CPU generator or offsets=")
            offsets = draw_offset_stream(generator, self.task_sizes,
                                         self.batch_sizes,
                                         self.steps_per_call)
        offsets = torch.as_tensor(offsets, dtype=torch.int64).cpu()
        if offsets.ndim != 2 or offsets.shape[1] != T:
            raise ValueError(f"offsets must be (steps, {T}), got "
                             f"{tuple(offsets.shape)}")
        limit = torch.tensor([n if b < n else 1 for n, b in
                              zip(self.task_sizes, self.batch_sizes)])
        if bool(((offsets < 0) | (offsets >= limit)).any()):
            raise ValueError("offsets must lie in [0, N_t), and be 0 for a "
                             "task with B_t >= N_t")
        self._bind(state, dataset)
        graphed = self.device.type == "cuda"
        if graphed and not self.graphs:
            self._capture()
        elbos = []
        cap = self.steps_per_call
        for start in range(0, offsets.shape[0], cap):
            block = offsets[start:start + cap]
            self.off_buf[:block.shape[0]].copy_(block)
            self.pos.zero_()
            for _ in range(block.shape[0]):
                kind = ("ve" if self.state.step % self.cycle
                        < self.train_config.ve_steps_per_vm else "vm")
                if graphed:
                    self.graphs[kind].replay()
                    self.replays[kind] += 1
                else:
                    self._body(kind)
                self.state.step += 1
            elbos.append(self.elbo_buf[:block.shape[0]].clone())
        if not elbos:
            elbos.append(self.elbo_buf[:0].clone())
        return dataclasses.replace(self.state), torch.cat(elbos)


def make_scan_trainer(config: ModelConfig, train_config: TrainConfig,
                      task_sizes: Tuple[int, ...],
                      batch_sizes: Tuple[int, ...],
                      steps_per_call: int = 100) -> ScanTrainer:
    """The JAX package's production loop: run(state, dataset, generator, *,
    offsets=None) -> (state, elbos) runs ``steps_per_call`` steps on slices
    of the device-resident ``dataset`` (one TaskData per task, the full
    arrays) and returns the (steps,) ELBOs on the device.

    Offsets: drawn once per call from the CPU ``generator`` as a
    (steps_per_call, T) stream (``draw_offset_stream``, the stream
    ``make_trainer`` would draw), copied to the device once, and read by
    each step from a device index; the batch is gathered by offset +
    arange(B_t) from the wraparound-extended dataset.  ``offsets=`` takes a
    given (steps, T) stream instead, of any length.

    On CUDA tensors the first call captures one CUDA graph for the VE step
    and one for the VM step (with its (Luu, iLuu) refresh), in one memory
    pool, after a warm-up of each on a side stream; every step is then one
    replay, picked on the host from the static VE/VM schedule.  A capture
    that fails raises: nothing falls back to eager steps.  The graphs do
    not depend on the number of steps, so a call of another length replays
    the same graphs; a dataset of other shapes raises.  On CPU tensors the
    same step body runs eagerly.

    The update is in place: the trainer keeps the state in its own static
    buffers (the graphs read and write them), copies a state passed in into
    them unless it is already the one it returned, and returns a state
    whose tensors are those buffers, which the next call overwrites.  The
    caller's first state is left as it was.
    """
    return ScanTrainer(config, train_config, task_sizes, batch_sizes,
                       steps_per_call)


# ---------------------------------------------------------------------------
# the dataset on the device, and the fit around the on-device loop
# ---------------------------------------------------------------------------

#: Share of the card's memory the parked dataset may take; the rest is
#: headroom for the parameters, adam moments, the (Q, B, M) projections
#: and the graphs' pool (under 2 GB at the flagship's shapes).
DATASET_MEMORY_FRACTION = 0.6


def check_dataset_fits_hbm(dataset, device="cuda") -> None:
    """Raise a ValueError if the dataset would take more than
    ``DATASET_MEMORY_FRACTION`` of ``device``'s memory (from
    ``torch.cuda.mem_get_info``).  Returns at once for a CPU device: host
    memory is not the envelope guarded here."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    _, total = torch.cuda.mem_get_info(device)
    nbytes = sum(a.numel() * a.element_size() for td in dataset for a in td)
    budget = DATASET_MEMORY_FRACTION * total
    if nbytes > budget:
        raise ValueError(
            f"the on-device dataset is {nbytes / 2**30:.2f} GiB, more than "
            f"{DATASET_MEMORY_FRACTION:.0%} of the {total / 2**30:.0f} GiB "
            f"of {device}: stream minibatches from the host with "
            "make_trainer and make_step, or raise "
            "train.DATASET_MEMORY_FRACTION if the envelope is wrong")


def prepare_dataset_on_device(config: ModelConfig, X_list, Y_list,
                              device="cuda") -> Tuple[elbo_mod.TaskData, ...]:
    """The full dataset (``data.full_batch``), checked against the card's
    memory and placed on ``device`` once, for reuse across
    ``svi_fit_on_device`` calls."""
    dataset, _ = full_batch(X_list, Y_list, dtype=config.torch_dtype,
                            device="cpu")
    check_dataset_fits_hbm(dataset, device)
    return tuple(elbo_mod.TaskData(*(a.to(device) for a in td))
                 for td in dataset)


def svi_fit_on_device(params: SVMOGPParams, config: ModelConfig,
                      train_config: TrainConfig, X_list, Y_list,
                      batch_sizes, num_steps: int, *,
                      generator: Optional[torch.Generator] = None,
                      steps_per_call: int = 100, mesh=None, dataset=None,
                      checkpoint_dir=None,
                      early_stop_tol: Optional[float] = None,
                      early_stop_patience: int = 3):
    """Train with ``make_scan_trainer`` on the params' device; returns
    (params, history), history a numpy array of the ELBOs of the steps run.

    generator: the CPU generator of the offsets (seeded from
      ``train_config.seed`` when None).
    dataset: a prebuilt dataset (``prepare_dataset_on_device``) to reuse;
      task sizes still come from X_list, so pass the X_list it was built
      from.
    early_stop_tol: stop at chunk granularity once the chunk-mean ELBO has
      failed to beat its best by more than this for
      ``early_stop_patience`` chunks in a row.
    Steps past the last whole chunk run as a shorter call of the same
    graphs.  The caller's params are not modified.  Checkpoints
    (``checkpoint_dir``) and a device mesh (``mesh``) are not ported.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir: checkpoints are not ported yet (ROADMAP.md "
            "section 1, item 13)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh: parallelism is not ported yet (ROADMAP.md section 1, "
            "item 14)")
    if isinstance(batch_sizes, int):
        batch_sizes = (batch_sizes,) * len(X_list)
    batch_sizes = tuple(batch_sizes)
    if early_stop_tol is not None and early_stop_patience < 1:
        raise ValueError("early_stop_patience must be >= 1 (patience 0 "
                         "would stop after the first chunk even while "
                         "improving)")
    if generator is None:
        generator = torch.Generator().manual_seed(train_config.seed)
    task_sizes = tuple(int(np.shape(x)[0]) for x in X_list)
    device = params.Z.device
    if dataset is None:
        dataset = prepare_dataset_on_device(config, X_list, Y_list, device)
    run = make_scan_trainer(config, train_config, task_sizes, batch_sizes,
                            steps_per_call)
    state = init_train_state(params, config)
    chunks, done = [], 0
    best_mean, stale, stopped = -np.inf, 0, False
    while done + steps_per_call <= num_steps:
        state, elbos = run(state, dataset, generator)
        chunks.append(elbos.cpu().numpy())
        done += steps_per_call
        if early_stop_tol is not None:
            m = float(chunks[-1].mean())
            if m > best_mean + early_stop_tol:
                best_mean, stale = m, 0
            else:
                stale += 1
            if stale >= early_stop_patience:
                stopped = True
                break
    if not stopped and done < num_steps:
        offsets = draw_offset_stream(generator, task_sizes, batch_sizes,
                                     num_steps - done)
        state, elbos = run(state, dataset, offsets=offsets)
        chunks.append(elbos.cpu().numpy())
    history = np.concatenate(chunks) if chunks else np.zeros((0,))
    return state.params, history
