"""Stochastic VEM training: the flagship trainer of the JAX package.

Counterpart of the main path of ``hetmogp_tpu/train.py``: adam, the cached
fast projection, the whitened model, ``minibatch="slice"`` and the VE/VM
flip-flop of ``make_svi_step_body`` (``ve_steps_per_vm`` VE steps, then one
VM step), driven by ``make_trainer`` where the JAX package runs
``make_scan_trainer``.  Natural gradients, Adadelta and its lookahead, the
LR schedules and the row-gather sampler are not ported (``TrainConfig``
refuses them).

One step:

* **VE** differentiates only (q_mu, q_sqrt), against the cached
  (Luu, Luu^{-1}) of the frozen hypers, so no gradient runs through the
  projection, the kernel or the factorization.
* **VM** differentiates the hypers, Z and W (per ``learn_inducing`` and
  ``learn_W``) on the ``vm_batch_fraction`` prefix of each task's batch,
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
from typing import Callable, Dict, Sequence, Tuple

import torch

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import FIELDS, SVMOGPParams

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def ve_mask() -> Tuple[str, ...]:
    """The leaves a VE step frees: the variational parameters."""
    return ("q_mu", "q_sqrt")


def vm_mask(train_config: TrainConfig) -> Tuple[str, ...]:
    """The leaves a VM step frees: the kernel hypers, plus Z and W per
    ``learn_inducing`` and ``learn_W``; kappa stays fixed always."""
    free = ["log_lengthscale", "log_variance"]
    if train_config.learn_inducing:
        free.append("Z")
    if train_config.learn_W:
        free.append("W")
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
        zeros = SVMOGPParams(*(torch.zeros_like(getattr(params, f))
                               for f in FIELDS))
    count = torch.zeros((), dtype=torch.int64, device=params.Z.device)
    return TrainState(params, AdamState(count, zeros, zeros), 0, Luu, iLuu)


def _adam(params: SVMOGPParams, opt: AdamState, grads: Dict[str, torch.Tensor],
          free: Sequence[str], lr: float):
    """One masked ``optax.adam`` step.  ``grads`` holds the free leaves'
    gradients; every other leaf's moments decay as with a zero gradient,
    and only the free leaves move."""
    count = opt.count + 1
    c = count.to(params.Z.dtype)
    bc1 = 1.0 - torch.pow(ADAM_B1, c)
    bc2 = 1.0 - torch.pow(ADAM_B2, c)
    new_p, new_mu, new_nu = {}, {}, {}
    for f in FIELDS:
        p, mu, nu = getattr(params, f), getattr(opt.mu, f), getattr(opt.nu, f)
        g = grads.get(f)
        if g is None:
            new_mu[f], new_nu[f], new_p[f] = ADAM_B1 * mu, ADAM_B2 * nu, p
            continue
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1.0 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu
        new_mu[f], new_nu[f] = mu, nu
        if f in free:
            p = p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        new_p[f] = p
    return (SVMOGPParams(**new_p),
            AdamState(count, SVMOGPParams(**new_mu), SVMOGPParams(**new_nu)))


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
        leaves = {f: getattr(params, f).detach().requires_grad_(f in free)
                  for f in FIELDS}
        p = SVMOGPParams(**leaves)
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
        g = torch.autograd.grad(-elbo, [leaves[f] for f in free])
        grads = dict(zip(free, g))
        with torch.no_grad():
            new_params, opt = _adam(params, state.opt_state, grads, free, lr)
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
                    state, new, elbo, g)
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
        return SVMOGPParams(*(sel(getattr(a, f), getattr(b, f))
                              for f in FIELDS))

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
    """The counterpart of ``make_scan_trainer``: run(state, dataset,
    generator) -> (state, elbos) runs ``steps_per_call`` steps on minibatch
    slices of the device-resident ``dataset`` (one TaskData per task, the
    full arrays), with offsets from the CPU ``generator``.  ``elbos`` is a
    (steps_per_call,) device tensor; nothing synchronises per step.
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
                 device=None) -> Tuple[elbo_mod.TaskData, ...]:
    """Per-task TaskData of the config's dtype on ``device``, mask 1."""
    return tuple(elbo_mod.task_data(X, Y, dtype=config.torch_dtype,
                                    device=device)
                 for X, Y in zip(X_list, Y_list))
