"""Training: stochastic SVI, batch VEM, natural gradients.

Counterpart of ``hetmogp_tpu/train.py``: the VE/VM flip-flop of
``make_svi_step_body`` (``ve_steps_per_vm`` VE steps, then one VM step) or
joint mode (``vem=False``), with each of the JAX package's optimizers:

* ``adam``, written out with ``optax.adam``'s semantics (every leaf's
  moments tick with its masked gradient, zero for frozen leaves, and only
  the free leaves move; ``torch.optim.Adam`` would keep moving a frozen
  leaf through its momentum after a VE/VM switch), with the LR schedules
  of ``make_lr_schedule`` driven by adam's count on the device and
  ``clip_grad_norm`` as ``optax.clip_by_global_norm``; on the card the
  update of every leaf is one launch of kernel 7
  (``cuda_kernels.adam_update``, ``_adam``'s arithmetic to the bit);
* ``adadelta``, climin's rule with its momentum lookahead: the gradient is
  taken at params - momentum * step, masked to the mode's free leaves;
* ``natgrad_adam``: natural gradients on the whitened q(u)
  (``natgrad_ve_step``, both retractions) and adam on the rest.

One step of the VE/VM schedule:

* **VE** differentiates only (q_mu, q_sqrt), against the cached
  (Luu, Luu^{-1}) of the frozen hypers (or Luu alone on the solve path,
  ``fast_projection=False``), so no gradient runs through the projection,
  the kernel or the factorization; under ``natgrad_adam`` the fused
  natural-gradient step takes its place.
* **VM** differentiates the hypers, Z and W (per ``learn_inducing`` and
  ``learn_W``) and the likelihoods' theta (per ``learn_lik_params``) on
  the ``vm_batch_fraction`` prefix of each task's batch, with the ELBO
  scales re-derived from the mask sums: through the cached-inverse
  adjoints when the model is whitened and the gradient point is the
  stored one, else through a new factorization on the solve path (the
  un-whitened model, the Adadelta lookahead); then the cache is refreshed
  at the new hypers.

Loops: ``make_scan_trainer`` (the JAX package's on-device loop), which on
the card replays one captured CUDA graph per step kind; ``make_trainer``,
a host loop of eager steps on the device-resident dataset; ``svi_fit``,
the host loop over a ``MinibatchStream``; ``svi_fit_on_device`` around
the first; and ``vem_algorithm``, batch VEM by masked L-BFGS.  The step
count and the VE/VM schedule live on the host (the schedule is static),
so the loops need no device-side branch; the ELBOs stay on the device and
nothing in a step synchronises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.data import full_batch
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import (SVMOGPParams, from_leaves,
                                             leaves)
from hetmogp_tpu_torch.ops import cuda_kernels, linalg

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults

# Acceptance bounds of the exact retraction's natural-gradient step, in
# whitened units (the prior q(v) is N(0, I)): the largest move of the
# whitened mean in one step, and the largest posterior variance.  The JAX
# package's values, kept so that results match; a step they reject twice
# leaves q as it was (ng_backoff 2), and the fits warn when that is all a
# call did.
_NG_STEP_MAX = 50.0
_NG_SANE_VAR = 1e2

_Q_LEAVES = ("q_mu", "q_sqrt")


# ---------------------------------------------------------------------------
# gradient masks (the fix/unfix mechanism), by leaf name
# ---------------------------------------------------------------------------

def ve_mask() -> Tuple[str, ...]:
    """The leaves a VE step frees: the variational parameters."""
    return _Q_LEAVES


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


def all_mask(train_config: TrainConfig) -> Tuple[str, ...]:
    """Joint mode (``vem=False``): every leaf but kappa, with Z, W and
    ``lik_theta`` per the same flags."""
    return _Q_LEAVES + vm_mask(train_config)


# ---------------------------------------------------------------------------
# optimizer states and the train state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the number of updates and the first and
    second moments of every leaf.  A schedule reads its rate from
    ``count``, as optax's ScaleByScheduleState, which ticks with it."""

    count: torch.Tensor  # () int64
    mu: SVMOGPParams
    nu: SVMOGPParams


@dataclasses.dataclass
class AdadeltaState:
    """climin Adadelta's accumulators for every leaf: the gradient and the
    step mean squares, and the previous total step (the momentum term)."""

    gms: SVMOGPParams
    sms: SVMOGPParams
    step: SVMOGPParams


@dataclasses.dataclass
class TrainState:
    params: SVMOGPParams
    opt_state: Union[AdamState, AdadeltaState]
    step: int
    Luu: Optional[torch.Tensor] = None  # (Q, M, M), valid for the hypers
    iLuu: Optional[torch.Tensor] = None  # (Q, M, M) Luu^{-1}; None: solves
    # natgrad_adam with the exact retraction: the carried (Q, M, M)
    # S^{-1} = (Lq Lq^T)^{-1}, which each natural-gradient step emits for
    # the next one; None recomputes it from Lq
    S_inv: Optional[torch.Tensor] = None


def _zeros_like_params(params: SVMOGPParams) -> SVMOGPParams:
    return from_leaves(params, [torch.zeros_like(t)
                                for _, t in leaves(params)])


def init_optimizer_state(params: SVMOGPParams,
                         train_config: Optional[TrainConfig] = None):
    """The optimizer's initial state: ``AdadeltaState`` for adadelta,
    ``AdamState`` for adam and natgrad_adam (and when no config is
    given)."""
    if train_config is not None and train_config.optimizer == "adadelta":
        z = _zeros_like_params(params)
        return AdadeltaState(z, z, z)
    zeros = _zeros_like_params(params)
    count = torch.zeros((), dtype=torch.int64, device=params.Z.device)
    return AdamState(count, zeros, zeros)


def s_inverse(q_sqrt: torch.Tensor) -> torch.Tensor:
    """(Lq Lq^T)^{-1} = iLq^T iLq from the factor parameter, iLq by a
    triangular solve against I."""
    iLq = linalg.tri_inverse(torch.tril(q_sqrt))
    return iLq.mT @ iLq


def init_train_state(params: SVMOGPParams, config: ModelConfig,
                     train_config: Optional[TrainConfig] = None, *,
                     cache_luu: bool = True, mesh=None) -> TrainState:
    """Step 0: the optimizer's initial state and the prior cache.

    cache_luu: keep the (Luu, Luu^{-1}) cache, or Luu alone under
      ``fast_projection=False`` (the VEM trainers); False keeps none
      (joint mode, ``vem=False``, factorizes every step).
    Without ``train_config`` the state is the flagship trainer's: adam and
    the cached inverse.  ``natgrad_adam`` with the exact retraction also
    carries S^{-1}.
    mesh: a ``parallel.sharding`` mesh, whose rank's shard the params are
      (``parallel.shard_params``): the caches are its latents'.
    """
    fast = train_config is None or train_config.fast_projection
    natgrad_exact = (train_config is not None
                     and train_config.optimizer == "natgrad_adam"
                     and train_config.natgrad_retraction == "exact")
    view = params
    if mesh is not None:
        from hetmogp_tpu_torch.parallel import sharding

        view = sharding.mesh_comm(mesh, config).view(params)
    with torch.no_grad():
        Luu = iLuu = None
        if cache_luu and fast:
            Luu, iLuu = elbo_mod.prior_cholesky_inverse(view, config)
        elif cache_luu:
            Luu = elbo_mod.prior_cholesky(view, config, blocked=True)
        S_inv = s_inverse(params.q_sqrt) if natgrad_exact else None
        opt = init_optimizer_state(params, train_config)
    return TrainState(params, opt, 0, Luu, iLuu, S_inv)


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def _cosine(init_value: float, decay_steps: int, alpha: float):
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = torch.clamp(count.to(torch.float64), max=float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * count
                                            / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32, on ``like``'s device (a fill, so a
    captured step can make it)."""
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


def _linear(init_value: float, end_value: float, transition_steps: int):
    if transition_steps <= 0:
        return lambda count: _f32(init_value, count)

    def schedule(count):
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count.to(torch.float32) / transition_steps
        return _f32(init_value - end_value, count) * frac + _f32(end_value,
                                                                 count)

    return schedule


def make_lr_schedule(train_config: TrainConfig):
    """``step_rate``, or the schedule of ``train_config.lr_schedule`` as a
    function of adam's int64 count (a tensor on the device, so a captured
    step reads the current rate): optax's ``cosine_decay_schedule``,
    ``warmup_cosine_decay_schedule`` and ``exponential_decay``, formula for
    formula, with ``step_rate`` as the peak, and in the precision optax
    computes them in: optax divides its int32 count by the step counts,
    which JAX promotes to float32, so the linear warmup, the warmup-cosine
    join and the exponential decay are float32, and the cosine float64.
    The caller casts the rate to the parameters' dtype."""
    if train_config.lr_schedule is None:
        return train_config.step_rate
    kw = dict(train_config.lr_schedule_kwargs)
    known = {"cosine": {"decay_steps", "alpha"},
             "warmup_cosine": {"warmup_steps", "decay_steps", "init_value",
                               "end_value"},
             "exponential": {"transition_steps", "decay_rate"}}
    allowed = known.get(train_config.lr_schedule, set())
    unknown = set(kw) - allowed
    if unknown:
        raise ValueError(
            f"unknown lr_schedule_kwargs {sorted(unknown)} for "
            f"{train_config.lr_schedule!r}; allowed: {sorted(allowed)}")
    peak = train_config.step_rate
    if train_config.lr_schedule == "cosine":
        return _cosine(peak, int(kw.get("decay_steps", 10_000)),
                       float(kw.get("alpha", 0.0)))
    if train_config.lr_schedule == "warmup_cosine":
        warmup = int(kw.get("warmup_steps", 100))
        end = float(kw.get("end_value", 0.0))
        ramp = _linear(float(kw.get("init_value", 0.0)), peak, warmup)
        decay = _cosine(peak, int(kw.get("decay_steps", 10_000)) - warmup,
                        0.0 if peak == 0.0 else end / peak)

        def schedule(count):
            return torch.where(count < warmup, ramp(count),
                               decay(count - warmup).to(torch.float32))

        return schedule
    if train_config.lr_schedule == "exponential":
        steps = int(kw.get("transition_steps", 1_000))
        rate = float(kw.get("decay_rate", 0.9))
        if steps <= 0 or rate == 0:
            return peak

        def schedule(count):
            p = count.to(torch.float32) / steps
            return torch.where(count <= 0, _f32(peak, count),
                               _f32(peak, count) * torch.pow(_f32(rate, count),
                                                             p))

        return schedule
    raise ValueError(f"unknown lr_schedule {train_config.lr_schedule!r}")


def clip_by_global_norm(grads: Sequence[Optional[torch.Tensor]],
                        max_norm: float, comm=None):
    """``optax.clip_by_global_norm`` over the gradients that are not None
    (a None stands for a masked leaf's zero): unchanged where their global
    norm is below ``max_norm``, else scaled to it.  Selected on the
    device.  Under ``comm`` (a mesh) the norm is the global one: the split
    leaves' squares summed over the latent axis, so every rank scales
    alike."""
    present = [g for g in grads if g is not None]
    if not present:
        return list(grads)
    g_norm = torch.sqrt(comm.sq_norm(grads) if comm is not None else
                        sum(torch.sum(torch.square(g)) for g in present))
    trigger = g_norm < max_norm
    return [None if g is None else
            torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def _adam(params: SVMOGPParams, opt: AdamState,
          grads: Sequence[Optional[torch.Tensor]], lr):
    """One masked ``optax.adam`` step at rate ``lr`` (a float or a device
    tensor).  ``grads`` holds a gradient for each free leaf and None for
    the others, in the order of ``leaves``; every other leaf's moments
    decay as with a zero gradient, and only the free leaves move."""
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


def _adam_step(params: SVMOGPParams, opt: AdamState,
               grads: Sequence[Optional[torch.Tensor]], lr,
               use_kernel: bool = True):
    """``_adam``'s step: kernel 7 (``cuda_kernels.adam_update``, one
    launch for every leaf, bitwise ``_adam``) for a model on the card,
    ``_adam`` itself for one on the CPU or under ``use_kernel=False``."""
    if not (use_kernel and params.Z.is_cuda):
        return _adam(params, opt, grads, lr)
    new_p, new_mu, new_nu, count = cuda_kernels.adam_update(
        [t for _, t in leaves(params)], grads,
        [t for _, t in leaves(opt.mu)], [t for _, t in leaves(opt.nu)],
        opt.count, lr)
    return (from_leaves(params, new_p),
            AdamState(count, from_leaves(params, new_mu),
                      from_leaves(params, new_nu)))


def _adadelta(params: SVMOGPParams, opt: AdadeltaState,
              grads: Sequence[Optional[torch.Tensor]], train_config):
    """One climin Adadelta step (``climin_adadelta``) with masked updates:
    every leaf's accumulators evolve (a frozen leaf's with a zero
    gradient: its step decays by the momentum), and only the free leaves
    move, by -(step1 + step2)."""
    rate, decay = train_config.step_rate, train_config.adadelta_decay
    momentum, offset = train_config.momentum, train_config.adadelta_offset
    new_p, gms_l, sms_l, step_l = [], [], [], []
    for (_, p), (_, gms), (_, sms), (_, st), g in zip(
            leaves(params), leaves(opt.gms), leaves(opt.sms),
            leaves(opt.step), grads):
        step1 = momentum * st
        if g is None:
            gms = decay * gms
            step = step1
        else:
            gms = decay * gms + (1.0 - decay) * torch.square(g)
            step = step1 + (torch.sqrt(sms + offset) / torch.sqrt(gms + offset)
                            * g * rate)
        sms = decay * sms + (1.0 - decay) * torch.square(step)
        new_p.append(p if g is None else p - step)
        gms_l.append(gms)
        sms_l.append(sms)
        step_l.append(step)
    return (from_leaves(params, new_p),
            AdadeltaState(from_leaves(params, gms_l),
                          from_leaves(params, sms_l),
                          from_leaves(params, step_l)))


def climin_adadelta(step_rate: float, decay: float = 0.9,
                    momentum: float = 0.9, offset: float = 1e-4):
    """climin's Adadelta update rule as (init, update) on a list of
    tensors, the JAX ``climin_adadelta`` transformation:

        step1 = momentum * step_{k-1}          # applied before the
        g     = grad(wrt - step1)              # gradient (lookahead)
        gms   = decay gms + (1 - decay) g^2
        step2 = sqrt(sms + offset) / sqrt(gms + offset) g step_rate
        step  = step1 + step2;   wrt -= step
        sms   = decay sms + (1 - decay) step^2

    ``init(tensors)`` -> state; ``update(grads, state)`` -> (updates,
    state) with updates = -(step1 + step2).  The gradient point is
    ``adadelta_lookahead_point``.  The trainers run the same rule leaf by
    leaf on the parameters."""

    def init(tensors):
        z = [torch.zeros_like(t) for t in tensors]
        return {"gms": z, "sms": list(z), "step": list(z)}

    def update(grads, state):
        step1 = [momentum * s for s in state["step"]]
        gms = [decay * a + (1.0 - decay) * torch.square(g)
               for a, g in zip(state["gms"], grads)]
        step = [s1 + torch.sqrt(s + offset) / torch.sqrt(a + offset) * g
                * step_rate for s1, s, a, g in zip(step1, state["sms"], gms,
                                                   grads)]
        sms = [decay * s + (1.0 - decay) * torch.square(st)
               for s, st in zip(state["sms"], step)]
        return [-s for s in step], {"gms": gms, "sms": sms, "step": step}

    return init, update


def adadelta_lookahead_point(params, opt_state, momentum: float,
                             free: Optional[Sequence[str]] = None):
    """climin evaluates the gradient at wrt - momentum * step_{k-1}.

    params, opt_state: ``SVMOGPParams`` and ``AdadeltaState``, or a list
    of tensors and ``climin_adadelta``'s state dict.  free: the leaf
    names the current mode updates (all when None); the other leaves stay
    where they are, so that a VE step's point keeps the hypers the cache
    was built at."""
    if isinstance(params, SVMOGPParams):
        return from_leaves(params, [
            p - momentum * s if free is None or name in free else p
            for (name, p), (_, s) in zip(leaves(params),
                                         leaves(opt_state.step))])
    return [p - momentum * s for p, s in zip(params, opt_state["step"])]


def make_optimizer(train_config: TrainConfig, comm=None,
                   use_kernel: bool = True) -> Callable:
    """update(params, opt_state, grads) -> (params, opt_state): one masked
    step of the configured first-order optimizer, ``grads`` a gradient per
    free leaf and None for the others (in the order of ``leaves``).
    Adadelta refuses a schedule and clipping, as the JAX package does.
    ``comm``: the mesh's, for the global norm of the clipping.  The adam
    step of a model on the card is kernel 7 (``_adam_step``) unless
    ``use_kernel`` is False."""
    if train_config.optimizer == "adadelta":
        if (train_config.lr_schedule is not None
                or train_config.clip_grad_norm is not None):
            raise ValueError("lr_schedule/clip_grad_norm require "
                             "optimizer='adam' or 'natgrad_adam' (adadelta "
                             "is the climin-parity rule)")

        def update(params, opt, grads):
            if not isinstance(opt, AdadeltaState):
                raise TypeError("optimizer='adadelta' needs an AdadeltaState:"
                                " build the state with init_train_state(params,"
                                " config, train_config)")
            return _adadelta(params, opt, grads, train_config)

        return update
    if train_config.optimizer not in ("adam", "natgrad_adam"):
        raise ValueError(f"unknown optimizer {train_config.optimizer!r}")
    lr = make_lr_schedule(train_config)
    clip = train_config.clip_grad_norm

    def update(params, opt, grads):
        if not isinstance(opt, AdamState):
            raise TypeError(f"optimizer={train_config.optimizer!r} needs an "
                            "AdamState: build the state with "
                            "init_train_state(params, config, train_config)")
        if clip is not None:
            grads = clip_by_global_norm(grads, clip, comm)
        rate = lr(opt.count).to(params.Z.dtype) if callable(lr) else lr
        return _adam_step(params, opt, grads, rate, use_kernel)

    return update


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def vm_sub_batch(data: Sequence[elbo_mod.TaskData], scales: torch.Tensor,
                 fraction: float):
    """The VM step's batch: the first ceil(fraction * B_t) rows of each
    task (a prefix of a uniform random block, or of iid rows, is a smaller
    one), with the scales re-derived from the mask sums so masked rows
    stay excluded.  Under a mesh the step passes the whole batch here, so
    the prefix and the mask sums are the global ones, as in the JAX
    package; each rank then takes its part of the prefix."""
    if fraction >= 1.0:
        return tuple(data), scales
    sub = tuple(elbo_mod.TaskData(*(a[:max(1, math.ceil(td.X.shape[0]
                                                         * fraction))]
                                    for a in td))
                for td in data)
    full = torch.stack([torch.clamp(td.mask.sum(), min=1.0) for td in data])
    part = torch.stack([torch.clamp(td.mask.sum(), min=1.0) for td in sub])
    return sub, scales * (full / part).to(scales.dtype)


def _gradients(params: SVMOGPParams, free: Sequence[str], loss_fn,
               comm=None):
    """(loss value, aux, grads): ``loss_fn(p)`` -> (elbo, aux) at params
    with the ``free`` leaves differentiable; grads holds the gradient of
    -elbo for each free leaf (zero for a theta leaf that is not in the
    graph) and None for the others, in the order of ``leaves``.  Under
    ``comm`` each rank's gradient is that of its rows, and one all-reduce
    of all of them over the data axis makes it the batch's."""
    names = [name for name, _ in leaves(params)]
    tensors = [t.detach().requires_grad_(name in free)
               for name, t in leaves(params)]
    with torch.enable_grad():
        elbo, aux = loss_fn(from_leaves(params, tensors))
        free_at = [i for i, name in enumerate(names) if name in free]
        grads = [None] * len(names)
        if free_at:
            for i, gi in zip(free_at, torch.autograd.grad(
                    -elbo, [tensors[i] for i in free_at], allow_unused=True)):
                grads[i] = torch.zeros_like(tensors[i]) if gi is None else gi
    if comm is not None:
        comm.data_sum_([g for g in grads if g is not None])
    return elbo.detach(), aux, grads


def make_step(config: ModelConfig, train_config: TrainConfig, *,
              vem: bool = True, use_kernel: bool = True,
              comm=None) -> Callable:
    """step(state, data, scales) -> (state, metrics): one step by
    ``state.step`` (counterpart of ``make_svi_step_body``).

    vem: the VE/VM schedule; False is joint mode (every leaf but kappa
      free each step, no cache: the state comes from
      ``init_train_state(..., cache_luu=False)``).
    use_kernel: False takes the plain PyTorch versions of the CUDA
      kernels.
    comm: a ``parallel.collectives.MeshComm``
      (``parallel.sharding.make_sharded_svi_step``): the state is this
      rank's part and ``data`` the whole batch, of which each rank takes its
      rows (and its rows of the VM step's global prefix); the gradients are
      all-reduced over the data axis, and every decision taken on the
      device (clipping, the non-finite keep, the natural-gradient backoff)
      reads global values, so that every rank takes the same one.
    metrics: ``elbo`` (before the update), ``kl``, ``ve`` (T,);
    ``ng_backoff`` (0/1/2, 0 on VM steps) under natgrad_adam; ``skipped``
    (0/1) under ``skip_nonfinite_steps``; all on the device.
    """
    update = make_optimizer(train_config, comm, use_kernel)
    use_natgrad = train_config.optimizer == "natgrad_adam"
    if use_natgrad and not config.whiten:
        raise ValueError("natural gradients require the whitened "
                         "parameterization (config.whiten)")
    nve = train_config.ve_steps_per_vm
    cycle = nve + 1
    fastp = train_config.fast_projection
    lookahead = (train_config.optimizer == "adadelta"
                 and train_config.momentum > 0.0)
    # the cached-inverse VM gradients need the whitened model, and the
    # stored hypers at the gradient point (not the lookahead's)
    vm_cached = fastp and config.whiten and not lookahead
    frac = train_config.vm_batch_fraction
    tc = train_config

    def natgrad(p, data, scales, **kw):
        return natgrad_ve_step(p, data, scales, config, tc.natgrad_lr,
                               retraction=tc.natgrad_retraction,
                               trust=tc.natgrad_trust, use_kernel=use_kernel,
                               comm=comm, **kw)

    def rows(data):
        return data if comm is None else comm.local_rows(data)

    def elbo(p, data, scales, **kw):
        return elbo_mod.elbo_fn(p, rows(data), scales, config,
                                use_kernel=use_kernel, comm=comm, **kw)

    def step(state: TrainState, data, scales):
        params = state.params
        is_ve = vem and state.step % cycle < nve
        free = ((ve_mask() if is_ve else vm_mask(tc)) if vem
                else all_mask(tc))
        if use_natgrad:  # natural gradients own q
            free = tuple(n for n in free if n not in _Q_LEAVES)
        point = (adadelta_lookahead_point(params, state.opt_state,
                                          tc.momentum, free)
                 if lookahead else params)
        use_cache = vem and state.Luu is not None
        if fastp and use_cache and state.iLuu is None:
            raise ValueError("TrainConfig.fast_projection=True but the train "
                             "state has no cached inverse: build it with "
                             "init_train_state(params, config, train_config)")
        iLuu = state.iLuu if fastp else None
        q_new = None  # (q_mu, q_sqrt, S_inv, ng_backoff) of a natgrad step
        if use_cache and is_ve and use_natgrad:
            with torch.no_grad():
                new_p, value, aux, s_inv = natgrad(
                    point, rows(data), scales, Luu=state.Luu, iLuu=iLuu,
                    S_inv=state.S_inv)
            q_new = (new_p.q_mu, new_p.q_sqrt, s_inv, aux["ng_backoff"])
            grads = [None] * len(leaves(params))
        elif use_cache and is_ve:
            value, aux, grads = _gradients(point, free, lambda p: elbo(
                p, data, scales, Luu=state.Luu, iLuu=iLuu), comm)
        elif use_cache:
            data_vm, scales_vm = vm_sub_batch(data, scales, frac)
            cache = (dict(Luu=state.Luu, iLuu=state.iLuu, cache_grad=True)
                     if vm_cached else {})
            value, aux, grads = _gradients(point, free, lambda p: elbo(
                p, data_vm, scales_vm, **cache), comm)
        else:
            value, aux, grads = _gradients(point, free, lambda p: elbo(
                p, data, scales), comm)
        with torch.no_grad():
            new_params, opt = update(params, state.opt_state, grads)
            S_inv = state.S_inv
            if use_natgrad and not use_cache and (is_ve or not vem):
                # no cache: natural gradients at the updated hypers, on
                # the solve path, from a cold S^{-1}
                new_p, _, ng_aux, _ = natgrad(new_params, rows(data), scales)
                q_new = (new_p.q_mu, new_p.q_sqrt, None,
                         ng_aux["ng_backoff"])
            if q_new is not None:
                new_params = dataclasses.replace(new_params, q_mu=q_new[0],
                                                 q_sqrt=q_new[1])
                if use_cache and S_inv is not None:
                    S_inv = q_new[2]
            Luu, iLuu_next = state.Luu, state.iLuu
            if use_cache and not is_ve:  # hypers and Z moved: refresh
                # (this rank's latents only, under a mesh)
                view = new_params if comm is None else comm.view(new_params)
                if state.iLuu is None:
                    Luu = elbo_mod.prior_cholesky(view, config, blocked=True)
                else:
                    Luu, iLuu_next = elbo_mod.prior_cholesky_inverse(
                        view, config)
            metrics = {"elbo": value, "kl": aux["kl"].detach(),
                       "ve": aux["ve"].detach()}
            if use_natgrad:
                metrics["ng_backoff"] = (
                    q_new[3] if q_new is not None else
                    torch.zeros((), dtype=torch.int32,
                                device=params.Z.device))
            new = TrainState(new_params, opt, state.step + 1, Luu, iLuu_next,
                             S_inv)
            if tc.skip_nonfinite_steps:
                new, metrics["skipped"] = _keep_if_nonfinite(
                    state, new, value, grads,
                    None if q_new is None else q_new[:2], comm)
        return new, metrics

    return step


def _map_state(fn, *states):
    """Apply ``fn`` to the tensors of one or more states of one structure
    (dataclasses, tuples, tensors; None and ints pass through from the
    first) and rebuild the first's structure."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    if isinstance(first, tuple):  # theta, or a dataset's TaskData
        parts = [_map_state(fn, *p) for p in zip(*states)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(
            parts)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _map_state(fn, *(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(first)})
    return first


def _state_tensors(state) -> list:
    """The state's tensors in a fixed order: params (theta included), the
    optimizer's state, then Luu, iLuu and S_inv where present."""
    out = []

    def keep(t):
        out.append(t)
        return t

    _map_state(keep, state)
    return out


def _keep_if_nonfinite(old: TrainState, new: TrainState, elbo, grads, q=None,
                       comm=None):
    """``skip_nonfinite_steps``: where the step's ELBO, the global norm of
    its gradients or its natural-gradient q update is not finite, the new
    state keeps the old params, optimizer state and caches (the step count
    still advances, so the VE/VM schedule stays aligned).  Selected on the
    device, without a synchronisation.  Under ``comm`` the ELBO is the
    global one, the norm the global one (``MeshComm.sq_norm``) and the q
    update's finiteness is counted over the latent axis, so that every
    rank keeps or moves alike."""
    ok = torch.isfinite(elbo)
    present = [g for g in grads if g is not None]
    if present:
        sq = (comm.sq_norm(grads) if comm is not None else
              sum(torch.sum(torch.square(g)) for g in present))
        ok = ok & torch.isfinite(torch.sqrt(sq))
    if q:
        q_ok = torch.stack([torch.isfinite(t).all() for t in q]).all()
        if comm is not None:
            q_ok = comm.latent_values((~q_ok).to(elbo.dtype)) == 0
        ok = ok & q_ok
    kept = _map_state(lambda a, b: torch.where(ok, a, b), new, old)
    return dataclasses.replace(kept, step=new.step), (~ok).to(torch.int32)


# ---------------------------------------------------------------------------
# natural gradients for the whitened q(u)
# ---------------------------------------------------------------------------

def _ve_terms(params, data, scales, config, means, gammas, kdiags,
              comm=None, use_kernel: bool = True):
    """(ve_total, ve_sums (T,)): the scaled variational expectations from
    per-task (Q, N_t) latent moments, with the natural-gradient step's
    variance floor 1e-12; under ``comm``, of this rank's rows, the mixing
    summed over the latent axis."""
    moments = elbo_mod._mix_tasks(list(zip(means, gammas, kdiags)), params,
                                  config, range(len(data)), comm=comm,
                                  var_floor=1e-12)
    ve_sums = elbo_mod.likelihood_term(params, config, data, moments, scales,
                                       use_kernel=use_kernel)
    parts = ve_sums.unbind()
    total = parts[0]
    for v in parts[1:]:
        total = total + v
    return total, ve_sums


def _select(ok, new, old):
    return tuple(torch.where(ok, a, b) for a, b in zip(new, old))


def natgrad_ve_step(params: SVMOGPParams, data, scales, config: ModelConfig,
                    lr: float, Luu=None, iLuu=None, S_inv=None,
                    retraction: str = "cholesky", trust: float = 0.3, *,
                    use_kernel: bool = True, comm=None):
    """Fused natural-gradient VE step on the whitened q(u).

    Returns (new_params, elbo, aux, S_inv_new): one forward and one
    backward give the step's metrics and the update.  aux: ``ve`` (T,),
    ``kl``, ``ng_backoff`` (0: the step at ``lr``; 1: at lr/4; 2: both
    rejected, q unchanged).

    The variance term runs in factor form, gamma = kdiag + quad_diag(P,
    Lq) - |P|^2 with P = (Luu^{-1} Kuf)^T (``latent_projection_P``: kernel
    3 or A with ``iLuu``, all tasks' rows at once under
    ``config.fuse_task_rows``; a triangular solve per task without), and
    autograd covers only the mixing and the quadrature; g_m = P^T g_mean
    and g_S = P^T diag(c) P are formed directly, and the whitened KL's
    gradients are analytic (dKL/dS = 0.5 (I - S^{-1})).

    retraction:
      "cholesky" (the default here and in ``TrainConfig``): the
        triangular-group step L_new = L (I + X), X = 2 lr Phi(L^T dS L),
        damped per latent to max|X_q| <= ``trust`` (so diag(I + X) > 0
        and L_new stays a Cholesky factor at any lr); m_new = m + L d,
        d = lr L^T dm capped at an RMS of ``trust``.  No factorization;
        ``S_inv`` passes through.
      "exact": the natural-parameter line theta <- theta + lr dtheta,
        S_new^{-1} = A = S^{-1} - 2 lr dS, L_new from one reversed
        Cholesky of A (+ the fixed jitter); A + jitter I is the exact next
        S^{-1}, returned for the caller to carry.  Exact CAVI at lr=1 for
        a conjugate likelihood.  ``S_inv=None`` recomputes S^{-1} from Lq.
    A step whose result is not finite, not a valid factor, or (exact)
    moves the whitened mean by ``_NG_STEP_MAX`` or more or gives a
    posterior variance of ``_NG_SANE_VAR`` or more, is retried at lr/4,
    then skipped.  Both attempts are computed and the result selected on
    the device, so the step reads nothing on the host (except the exact
    retraction under ``config.adaptive_jitter``, whose ``jitchol`` does).
    Under ``comm`` (a mesh: params, Luu, iLuu and S_inv this rank's
    latents, data its rows) g_m and g_S, sums over rows, are all-reduced
    over the data axis, the ELBO and aux are the global ones, and a step is
    accepted where every latent rank accepts it.
    """
    if not config.whiten:
        raise ValueError("natural gradients require the whitened "
                         "parameterization (config.whiten)")
    if retraction not in ("exact", "cholesky"):
        raise ValueError(f"unknown natgrad retraction {retraction!r}; "
                         "use 'exact' or 'cholesky'")
    params = from_leaves(params, [t.detach() for _, t in leaves(params)])
    view = params if comm is None else comm.view(params)
    with torch.no_grad():
        Lq, m = torch.tril(params.q_sqrt), params.q_mu
        eye = torch.eye(config.num_inducing, dtype=Lq.dtype, device=Lq.device)
        if Luu is None:
            Luu = elbo_mod.prior_cholesky(view, config)
        if S_inv is None and retraction == "exact":
            S_inv = s_inverse(Lq)
        fuse_rows = config.fuse_task_rows and iLuu is not None
        X_parts = ([torch.cat([td.X for td in data])] if fuse_rows
                   else [td.X for td in data])
        Ps, kds = zip(*(elbo_mod.latent_projection_P(
            view, config, Luu, X_, iLuu=iLuu, use_kernel=use_kernel)
            for X_ in X_parts))
        mean_parts = [(P @ m[..., None])[..., 0] for P in Ps]
        gamma_parts = [kd + linalg.quad_diag(P, Lq, use_kernel=use_kernel)
                       - torch.sum(torch.square(P), dim=-1)
                       for P, kd in zip(Ps, kds)]

    def task_views(parts):
        if not fuse_rows:
            return list(parts)
        out, off = [], 0
        for td in data:
            out.append(parts[0][:, off:off + td.X.shape[0]])
            off += td.X.shape[0]
        return out

    means = [t.requires_grad_() for t in mean_parts]
    gammas = [t.requires_grad_() for t in gamma_parts]
    with torch.enable_grad():
        ve_total, ve_sums = _ve_terms(params, data, scales, config,
                                      task_views(means), task_views(gammas),
                                      task_views(kds), comm, use_kernel)
        grads = torch.autograd.grad(ve_total, means + gammas)
    with torch.no_grad():
        ve_total, ve_sums = ve_total.detach(), ve_sums.detach()
        g_means, cs = grads[:len(means)], grads[len(means):]
        g_m_ve = sum((P.mT @ g[..., None])[..., 0]
                     for P, g in zip(Ps, g_means))
        g_S_ve = sum((P * c[..., None]).mT @ P for P, c in zip(Ps, cs))
        kl = torch.sum(0.5 * (torch.sum(torch.square(Lq), dim=(-2, -1))
                              + torch.sum(torch.square(m), dim=-1)
                              - config.num_inducing
                              - linalg.logdet_from_chol(Lq)))
        if comm is not None:
            # g_m and g_S sum over rows: the data axis completes them
            comm.data_sum_([g_m_ve, g_S_ve])
            ve_sums, kl = comm.reduce_metrics(ve_sums, kl)
            ve_total = ve_sums[0]
            for v in ve_sums[1:]:
                ve_total = ve_total + v
        g_m = g_m_ve - m
        g_S_ve_sym = 0.5 * (g_S_ve + g_S_ve.mT)

        if retraction == "cholesky":
            # H = L^T dS L with dS = g_S_ve + 0.5 (S^{-1} - I): the S^{-1}
            # term is 0.5 I under the congruence
            H = linalg.matmul_tril(
                linalg.tril_t_matmul(Lq, g_S_ve_sym - 0.5 * eye,
                                     use_kernel=use_kernel),
                Lq, use_kernel=use_kernel)
            H = 0.5 * (H + H.mT) + 0.5 * eye
            Lt_gm = (Lq.mT @ g_m[..., None])[..., 0]

            def attempt(lr_):
                X = 2.0 * lr_ * linalg._phi(H)
                mx = torch.amax(torch.abs(X), dim=(-2, -1), keepdim=True)
                X = X * torch.clamp(trust / torch.clamp(mx, min=1e-30),
                                    max=1.0)
                L_new = Lq + linalg.matmul_tril(Lq, X,
                                                use_kernel=use_kernel)
                d = lr_ * Lt_gm
                rms = torch.sqrt(torch.mean(torch.square(d), dim=-1,
                                            keepdim=True))
                d = d * torch.clamp(trust / torch.clamp(rms, min=1e-30),
                                    max=1.0)
                return m + (Lq @ d[..., None])[..., 0], L_new

            def ok_(out):
                diag = torch.diagonal(out[1], dim1=-2, dim2=-1)
                return (torch.isfinite(out[0]).all()
                        & torch.isfinite(out[1]).all() & (diag > 0).all())

            kept = (m, Lq)
        else:
            g_S = g_S_ve_sym + 0.5 * (S_inv - eye)
            theta1 = (S_inv @ m[..., None])[..., 0]
            d_eta1 = g_m - 2.0 * (g_S @ m[..., None])[..., 0]

            def attempt(lr_):
                theta1_new = theta1 + lr_ * d_eta1
                A = S_inv - 2.0 * lr_ * g_S  # must stay positive definite
                # L_new L_new^T = A^{-1} from one reversed (UL) Cholesky:
                # chol(J A J) = L_r gives L_new = (J L_r^{-1} J)^T
                A_rev = torch.flip(A, dims=(-2, -1))
                if config.adaptive_jitter:
                    L_r = linalg.jitchol(A_rev)
                    iL_r = linalg.tri_inverse(L_r)
                    S_inv_n = torch.flip(L_r @ L_r.mT, dims=(-2, -1))
                else:
                    j_eye = config.jitter * eye
                    _, iL_r = linalg.blocked_cholesky_inverse(A_rev + j_eye)
                    S_inv_n = A + j_eye  # exactly (L_new L_new^T)^{-1}
                L_new = torch.flip(iL_r, dims=(-2, -1)).mT
                m_new = (L_new @ (L_new.mT @ theta1_new[..., None]))[..., 0]
                return m_new, L_new, S_inv_n

            def ok_(out):
                # a finite step may still blow up where A is nearly
                # singular: bound the mean's move and the variances
                var = torch.sum(torch.square(out[1]), dim=-1)
                return (torch.isfinite(out[0]).all()
                        & torch.isfinite(out[1]).all()
                        & (torch.amax(torch.abs(out[0] - m)) < _NG_STEP_MAX)
                        & (torch.amax(var) < _NG_SANE_VAR))

            kept = (m, Lq, S_inv)

        out1, out2 = attempt(lr), attempt(lr * 0.25)
        ok1, ok2 = ok_(out1), ok_(out2)
        if comm is not None:  # accepted where every latent rank accepts
            bad = comm.latent_values((~torch.stack([ok1, ok2])).to(m.dtype))
            ok1, ok2 = bad[0] == 0, bad[1] == 0
        outs = _select(ok1, out1, _select(ok2, out2, kept))
        zero = torch.zeros((), dtype=torch.int32, device=Lq.device)
        nb = torch.where(ok1, zero, torch.where(ok2, zero + 1, zero + 2))
        S_inv_new = S_inv if retraction == "cholesky" else outs[2]
        new_params = dataclasses.replace(params, q_mu=outs[0],
                                         q_sqrt=outs[1])
        aux = {"ve": ve_sums, "kl": kl, "ng_backoff": nb}
    return new_params, ve_total - kl, aux, S_inv_new


def natgrad_update(params: SVMOGPParams, data, scales, config: ModelConfig,
                   lr: float, Luu=None, retraction: str = "cholesky",
                   trust: float = 0.3, *,
                   use_kernel: bool = True) -> SVMOGPParams:
    """One natural-gradient ascent step on the whitened q(u), on the solve
    path from a cold S^{-1}; see ``natgrad_ve_step``, whose ELBO, aux and
    S^{-1} this drops.  The retraction defaults to ``"cholesky"``, as
    ``TrainConfig.natgrad_retraction`` does."""
    return natgrad_ve_step(params, data, scales, config, lr, Luu=Luu,
                           retraction=retraction, trust=trust,
                           use_kernel=use_kernel)[0]


# ---------------------------------------------------------------------------
# minibatches from a device-resident dataset
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


def draw_indices(generator: torch.Generator, task_sizes,
                 batch_sizes) -> torch.Tensor:
    """The gather sampler's rows of one step: B_t uniform row indices in
    [0, N_t) per task, with replacement, concatenated over tasks into a
    (sum B_t,) int64 CPU tensor, from a CPU ``generator``."""
    return torch.cat([torch.randint(nt, (bt,), generator=generator)
                      for nt, bt in zip(task_sizes, batch_sizes)])


def slice_batch(extended: Sequence[elbo_mod.TaskData], offsets, task_sizes,
                batch_sizes):
    """The contiguous wraparound block of each task at its offset, from a
    dataset passed through ``extend_for_wraparound``: every row has the
    inclusion probability B/N, so the N/B scale is unbiased."""
    return tuple(elbo_mod.TaskData(*(a[off:off + min(bt, nt)] for a in td))
                 for td, off, nt, bt in zip(extended, offsets, task_sizes,
                                            batch_sizes))


def batch_scales(task_sizes, batch_sizes, dtype, device,
                 minibatch: str = "slice") -> torch.Tensor:
    """N_t / B_t with the effective batch: a slice takes a task with
    B_t >= N_t whole every step, so its scale is 1; the gather sampler
    draws B_t rows with replacement, an unbiased estimate at N_t / B_t for
    any B_t."""
    eff = (batch_sizes if minibatch == "gather" else
           [min(b, n) for n, b in zip(task_sizes, batch_sizes)])
    return torch.tensor([n / float(b) for n, b in zip(task_sizes, eff)],
                        dtype=dtype, device=device)


def draw_offset_stream(generator: torch.Generator, task_sizes, batch_sizes,
                       steps: int) -> torch.Tensor:
    """(steps, T) int64 CPU tensor of slice offsets: ``draw_offsets`` for
    each step in turn, so it is the stream ``make_trainer`` draws from the
    same generator."""
    return torch.tensor([draw_offsets(generator, task_sizes, batch_sizes)
                         for _ in range(steps)],
                        dtype=torch.int64).reshape(steps, len(task_sizes))


def draw_index_stream(generator: torch.Generator, task_sizes, batch_sizes,
                      steps: int) -> torch.Tensor:
    """(steps, sum B_t) int64 CPU tensor of gathered rows: ``draw_indices``
    for each step in turn."""
    rows = [draw_indices(generator, task_sizes, batch_sizes)
            for _ in range(steps)]
    if not rows:
        return torch.zeros((0, sum(batch_sizes)), dtype=torch.int64)
    return torch.stack(rows)


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


def make_gather_sampler(batch_sizes) -> Callable:
    """sample_batch(indices, dataset) -> tuple[TaskData]: task t's rows
    ``indices[start_t:start_t + B_t]`` of the dataset (``draw_indices``'
    layout), gathered on the device, as the JAX package's ``"gather"``
    sampler takes them."""
    starts = np.concatenate([[0], np.cumsum(batch_sizes)[:-1]]).tolist()

    def sample_batch(indices: torch.Tensor, dataset):
        return tuple(elbo_mod.TaskData(*(
            a.index_select(0, indices[s:s + b]) for a in td))
            for td, s, b in zip(dataset, starts, batch_sizes))

    return sample_batch


def make_mesh_sampler(comm, task_sizes, batch_sizes,
                      minibatch: str = "slice") -> Callable:
    """sample_batch(row, shard) -> tuple[TaskData]: the step's whole batch,
    on every rank of a mesh whose data ranks each hold a block of every
    task's rows (``prepare_dataset_on_device(mesh=)``: data rank d rows
    [d n, (d + 1) n) of the padded task, n the shard's rows).

    ``row``: a device row of the offset stream (each task's block is rows
    offset + arange(min(B_t, N_t)) mod N_t, ``slice_batch``'s) or of the
    index stream (``draw_indices``' layout).  Each rank fills the rows it
    holds into a zero batch and one all-reduce over the data axis sums
    them: every row is held by one rank and the others add zeros, so the
    batch is the unsharded one, row for row.  Reads no host value, so it
    runs inside a captured CUDA graph."""
    gather = minibatch == "gather"
    eff = (list(batch_sizes) if gather else
           [min(b, n) for n, b in zip(task_sizes, batch_sizes)])
    starts = np.concatenate([[0], np.cumsum(batch_sizes)[:-1]]).tolist()
    steps = {}

    def rows_of(row, t, device):
        if gather:
            return row[starts[t]:starts[t] + batch_sizes[t]]
        if (t, device) not in steps:
            steps[t, device] = torch.arange(eff[t], device=device)
        return torch.remainder(row[t] + steps[t, device], task_sizes[t])

    def sample_batch(row, shard):
        parts = []
        for t, td in enumerate(shard):
            n = td.X.shape[0]
            local = rows_of(row, t, td.X.device) - comm.data_rank * n
            held = (local >= 0) & (local < n)
            idx = torch.clamp(local, 0, n - 1)
            parts.append([torch.where(held.view(-1, *[1] * (a.ndim - 1)),
                                      a.index_select(0, idx), 0.0)
                          for a in td])
        comm.data_sum_([a for td in parts for a in td])
        return tuple(elbo_mod.TaskData(*td) for td in parts)

    return sample_batch


class _Sampler:
    """One minibatch sampler: what a step reads (a row of a stream on the
    host or the device), how a call's stream is drawn and checked, and how
    the batch is formed from the prepared dataset.  Under a mesh
    (``comm``) the dataset is this rank's shard and a step's batch is
    assembled over the data axis (``make_mesh_sampler``)."""

    def __init__(self, minibatch: str, task_sizes, batch_sizes, comm=None):
        self.gather = minibatch == "gather"
        self.minibatch, self.comm = minibatch, comm
        self.task_sizes, self.batch_sizes = task_sizes, batch_sizes
        self.width = sum(batch_sizes) if self.gather else len(task_sizes)
        self.name = "indices" if self.gather else "offsets"
        # the prepared dataset is the caller's own tensors: the graphs
        # read a copy, which a later call's dataset is copied into
        self.copies = self.gather or comm is not None

    def draw(self, generator, steps: int) -> torch.Tensor:
        draw = draw_index_stream if self.gather else draw_offset_stream
        return draw(generator, self.task_sizes, self.batch_sizes, steps)

    def check(self, stream) -> torch.Tensor:
        stream = torch.as_tensor(stream, dtype=torch.int64).cpu()
        if stream.ndim != 2 or stream.shape[1] != self.width:
            raise ValueError(f"{self.name} must be (steps, {self.width}), "
                             f"got {tuple(stream.shape)}")
        if self.gather:
            limit = torch.tensor(np.repeat(self.task_sizes,
                                           self.batch_sizes).tolist())
            what = "indices must lie in [0, N_t) of their task"
        else:
            limit = torch.tensor([n if b < n else 1 for n, b in
                                  zip(self.task_sizes, self.batch_sizes)])
            what = ("offsets must lie in [0, N_t), and be 0 for a task with "
                    "B_t >= N_t")
        if bool(((stream < 0) | (stream >= limit)).any()):
            raise ValueError(what)
        return stream

    def prepare(self, dataset):
        """The dataset a call samples from: the wraparound-extended one for
        slices, the dataset itself for the gather and under a mesh."""
        if self.comm is not None:
            k = self.comm.k_data
            if any(td.X.shape[0] * k < n
                   for td, n in zip(dataset, self.task_sizes)):
                raise ValueError(
                    "under a mesh the dataset is this rank's shard "
                    "(prepare_dataset_on_device(..., mesh=mesh)): k_data "
                    "times its rows must cover each task")
            return tuple(dataset)
        if self.gather:
            return tuple(dataset)
        return extend_for_wraparound(dataset, self.batch_sizes,
                                     self.task_sizes)

    def on_host(self, prepared, row):
        """A step's batch from a host row (the host loop)."""
        if self.gather:
            return make_gather_sampler(self.batch_sizes)(
                row.to(prepared[0].X.device), prepared)
        return slice_batch(prepared, row, self.task_sizes, self.batch_sizes)

    def on_device(self, device) -> Callable:
        """sample(row, prepared) from a device row (the graphed loop)."""
        if self.comm is not None:
            return make_mesh_sampler(self.comm, self.task_sizes,
                                     self.batch_sizes, self.minibatch)
        if self.gather:
            return make_gather_sampler(self.batch_sizes)
        return make_batch_sampler(self.task_sizes, self.batch_sizes, device)


def make_trainer(config: ModelConfig, train_config: TrainConfig,
                 task_sizes: Tuple[int, ...], batch_sizes: Tuple[int, ...],
                 steps_per_call: int = 100, vem: bool = True):
    """A host loop of eager steps (``make_scan_trainer`` is the on-device
    loop): run(state, dataset, generator) -> (state, elbos) runs
    ``steps_per_call`` steps on minibatches of the device-resident
    ``dataset`` (one TaskData per task, the full arrays), with slice
    offsets or gathered rows (``train_config.minibatch``) from the CPU
    ``generator``.  ``elbos`` is a (steps_per_call,) device tensor; nothing
    synchronises per step.
    """
    step = make_step(config, train_config, vem=vem)
    sampler = _Sampler(train_config.minibatch, task_sizes, batch_sizes)

    def run(state: TrainState, dataset, generator: torch.Generator):
        scales = batch_scales(task_sizes, batch_sizes, config.torch_dtype,
                              state.params.Z.device, train_config.minibatch)
        prepared = sampler.prepare(dataset)
        elbos = []
        for _ in range(steps_per_call):
            row = sampler.draw(generator, 1)[0]
            state, metrics = step(state, sampler.on_host(prepared, row),
                                  scales)
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

def _clone_state(state: TrainState) -> TrainState:
    return _map_state(lambda t: t.detach().clone(), state)


def _assign(dst: TrainState, src: TrainState) -> None:
    """Copy src's tensors into dst's, in place (skipping shared ones)."""
    for d, s in zip(_state_tensors(dst), _state_tensors(src)):
        if s is not d:
            d.copy_(s)


_ADAPTIVE_IN_GRAPH = (
    "adaptive_jitter=True: jitchol reads each factorization's info on the "
    "host, which a captured CUDA graph cannot do; train on the card with a "
    "fixed jitter (adaptive_jitter=False), or with make_trainer or svi_fit")


class ScanTrainer:
    """``make_scan_trainer``'s runner; see there.

    After the first call on the card, ``capture_seconds`` is the warm-up and
    capture time, ``capture_launches[kind]`` the kernel launches recorded
    into each graph (``cuda_kernels.launch_counts`` keys), and
    ``replays[kind]`` the number of replays so far.  After each call,
    ``ng_backoff`` holds its steps' natural-gradient backoff codes on the
    device (None unless natgrad_adam) and ``step_kinds`` their kinds;
    ``captured`` says whether the call replayed captured graphs (True) or
    ran the step body eagerly (False: the CPU, or a mesh whose collectives
    go through the host).
    """

    def __init__(self, config: ModelConfig, train_config: TrainConfig,
                 task_sizes, batch_sizes, steps_per_call: int,
                 vem: bool = True, device=None, mesh=None):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")
        self.comm = None
        if mesh is not None:
            from hetmogp_tpu_torch.parallel import sharding

            self.comm = sharding.mesh_comm(mesh, config)
            _check_mesh_batches(self.comm, task_sizes, batch_sizes,
                                train_config)
        if (config.adaptive_jitter and device is not None
                and self._graphs_on(torch.device(device))):
            raise ValueError(_ADAPTIVE_IN_GRAPH)
        self.config, self.train_config, self.vem = config, train_config, vem
        self.task_sizes, self.batch_sizes = tuple(task_sizes), tuple(
            batch_sizes)
        self.steps_per_call = steps_per_call
        self.step_fn = make_step(config, train_config, vem=vem,
                                 comm=self.comm)
        self.sampler = _Sampler(train_config.minibatch, self.task_sizes,
                                self.batch_sizes, self.comm)
        self.captured: Optional[bool] = None
        self.natgrad = train_config.optimizer == "natgrad_adam"
        nve = train_config.ve_steps_per_vm
        self.cycle = nve + 1
        # a representative step number of each kind the schedule has
        if not vem:
            self.kinds = {"joint": 0}
        else:
            self.kinds = {"ve": 0, "vm": nve} if nve > 0 else {"vm": 0}
        self.state: Optional[TrainState] = None  # the static buffers
        self.ext = None
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.capture_launches: Dict[str, dict] = {}
        self.replays = {k: 0 for k in self.kinds}
        self.capture_seconds = None
        self.ng_backoff: Optional[torch.Tensor] = None
        self.step_kinds: list = []

    def _graphs_on(self, device: torch.device) -> bool:
        """Whether steps on ``device`` replay captured graphs: on the card,
        unless the mesh's collectives go through the host (gloo), which a
        graph cannot capture."""
        return device.type == "cuda" and (
            self.comm is None or "nccl" in str(self.comm.backend))

    def kind(self, step: int) -> str:
        if not self.vem:
            return "joint"
        return ("ve" if step % self.cycle < self.train_config.ve_steps_per_vm
                else "vm")

    # ---- the step body: what a graph holds -----------------------------
    def _body(self, kind: str) -> None:
        """One step of ``kind`` on the static buffers: the sampler's row
        ``pos`` of the stream buffer, the step, the new state copied into
        the static one, the ELBO (and the backoff code) into row ``pos``
        of their buffers, then pos += 1."""
        st = self.state
        row = self.row_buf.index_select(0, self.pos)[0]
        batch = self.sample(row, self.ext)
        new, metrics = self.step_fn(
            dataclasses.replace(st, step=self.kinds[kind]), batch,
            self.scales)
        with torch.no_grad():
            _assign(st, new)
            self.elbo_buf.index_copy_(0, self.pos,
                                      metrics["elbo"].reshape(1))
            if self.natgrad:
                self.ng_buf.index_copy_(0, self.pos,
                                        metrics["ng_backoff"].reshape(1))
            self.pos.add_(1)

    # ---- binding a call's state and dataset to the static buffers ------
    def _bind(self, state: TrainState, dataset) -> None:
        device = state.params.Z.device
        dtype = self.config.torch_dtype
        if self._graphs_on(device) and self.config.adaptive_jitter:
            raise ValueError(_ADAPTIVE_IN_GRAPH)
        if self.state is None:
            self.state = _clone_state(state)
            self.device = device
            cap = self.steps_per_call
            self.row_buf = torch.zeros((cap, self.sampler.width),
                                       dtype=torch.int64, device=device)
            self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
            self.elbo_buf = torch.zeros((cap,), dtype=dtype, device=device)
            self.ng_buf = torch.zeros((cap,), dtype=torch.int32,
                                      device=device)
            self.scales = batch_scales(self.task_sizes, self.batch_sizes,
                                       dtype, device,
                                       self.train_config.minibatch)
            self.sample = self.sampler.on_device(device)
        elif device != self.device:
            raise ValueError(f"this trainer runs on {self.device}; the state "
                             f"is on {device}")
        elif ([tuple(t.shape) for t in _state_tensors(state)]
              != [tuple(t.shape) for t in _state_tensors(self.state)]):
            raise ValueError("a trainer runs on states of one structure: the "
                             "graphs read its buffers (lik_theta, the "
                             "optimizer's state and the caches included)")
        elif any(a is not b for a, b in zip(_state_tensors(state),
                                             _state_tensors(self.state))):
            with torch.no_grad():
                _assign(self.state, state)
        self.state.step = state.step
        if any(a.device != device or a.dtype != dtype
               for td in dataset for a in td):
            raise ValueError(f"the dataset must be {dtype} on {device}")
        ext = self.sampler.prepare(dataset)
        if self.ext is None:
            # the graphs read these buffers: the gather's are a copy, not
            # the caller's dataset, which a later call would overwrite
            self.ext = (_map_state(torch.clone, ext) if self.sampler.copies
                        else ext)
            return
        new, old = ([a for td in e for a in td] for e in (ext, self.ext))
        if [a.shape for a in new] != [a.shape for a in old]:
            raise ValueError("a trainer runs on datasets of one shape: the "
                             "graphs read its buffers")
        for d, s in zip(old, new):  # the graphs read these buffers
            if d is not s:
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
        # NCCL's collectives are captured on the side stream; its watchdog
        # thread keeps querying events meanwhile, which only a thread-local
        # capture allows
        mode = {}
        if self.comm is not None:
            torch.cuda.synchronize(self.device)
            mode = dict(capture_error_mode="thread_local")
        for kind in self.kinds:
            before = cuda_kernels.launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=side, **mode):
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
                 offsets=None, indices=None):
        given = indices if self.sampler.gather else offsets
        other = offsets if self.sampler.gather else indices
        if other is not None:
            raise ValueError(f"minibatch={self.train_config.minibatch!r} "
                             f"takes {self.sampler.name}=, not "
                             f"{'offsets' if self.sampler.gather else 'indices'}=")
        if given is None:
            if generator is None:
                raise ValueError(f"pass a CPU generator or "
                                 f"{self.sampler.name}=")
            given = self.sampler.draw(generator, self.steps_per_call)
        stream = self.sampler.check(given)
        self._bind(state, dataset)
        graphed = self._graphs_on(self.device)
        if graphed and not self.graphs:
            self._capture()
        self.captured = graphed
        elbos, ngs, kinds = [], [], []
        cap = self.steps_per_call
        for start in range(0, stream.shape[0], cap):
            block = stream[start:start + cap]
            self.row_buf[:block.shape[0]].copy_(block)
            self.pos.zero_()
            for _ in range(block.shape[0]):
                kind = self.kind(self.state.step)
                kinds.append(kind)
                if graphed:
                    self.graphs[kind].replay()
                    self.replays[kind] += 1
                else:
                    self._body(kind)
                self.state.step += 1
            elbos.append(self.elbo_buf[:block.shape[0]].clone())
            ngs.append(self.ng_buf[:block.shape[0]].clone())
        if not elbos:
            elbos.append(self.elbo_buf[:0].clone())
            ngs.append(self.ng_buf[:0].clone())
        self.step_kinds = kinds
        self.ng_backoff = torch.cat(ngs) if self.natgrad else None
        return dataclasses.replace(self.state), torch.cat(elbos)


def _check_mesh_batches(comm, task_sizes, batch_sizes,
                        train_config: TrainConfig) -> None:
    """Under a mesh every data rank takes rows of every task's batch and of
    the VM step's prefix of it: each must have k_data rows at least."""
    frac = train_config.vm_batch_fraction
    for n, b in zip(task_sizes, batch_sizes):
        rows = b if train_config.minibatch == "gather" else min(b, n)
        vm = max(1, math.ceil(rows * frac)) if frac < 1.0 else rows
        if min(rows, vm) < comm.k_data:
            raise ValueError(
                f"a batch of {rows} rows (the VM step's {vm}) cannot give "
                f"each of the {comm.k_data} data ranks a row")


def make_scan_trainer(config: ModelConfig, train_config: TrainConfig,
                      task_sizes: Tuple[int, ...],
                      batch_sizes: Tuple[int, ...],
                      steps_per_call: int = 100, vem: bool = True,
                      device=None, mesh=None) -> ScanTrainer:
    """The JAX package's production loop: run(state, dataset, generator, *,
    offsets=None, indices=None) -> (state, elbos) runs ``steps_per_call``
    steps on minibatches of the device-resident ``dataset`` (one TaskData
    per task, the full arrays) and returns the (steps,) ELBOs on the
    device.  Every optimizer, ``vem`` and both samplers run here.

    Minibatches: drawn once per call from the CPU ``generator`` as a
    stream with one row per step, copied to the device once, and read by
    each step from a device index.  ``minibatch="slice"``: a (steps, T)
    stream of offsets (``draw_offset_stream``, the stream ``make_trainer``
    would draw), each task's block gathered by offset + arange(B_t) from
    the wraparound-extended dataset.  ``minibatch="gather"``: a
    (steps, sum B_t) stream of row indices (``draw_index_stream``), torch
    cannot draw JAX's.  ``offsets=`` or ``indices=`` takes a given stream
    instead, of any length.

    On CUDA tensors the first call captures one CUDA graph per step kind
    (VE, and VM with its cache refresh; one joint graph under
    ``vem=False``), in one memory pool, after a warm-up of each on a side
    stream; every step is then one replay, picked on the host from the
    static schedule.  The optimizer's state, the caches and S^{-1} live in
    the static buffers; the natural-gradient backoff is selected on the
    device.  A capture that fails raises: nothing falls back to eager
    steps.  The graphs do not depend on the number of steps, so a call of
    another length replays the same graphs; a dataset of other shapes
    raises.  On CPU tensors the same step body runs eagerly.
    ``config.adaptive_jitter`` cannot run in a graph: the trainer refuses
    it when made for a CUDA ``device`` (or at its first call on one).

    mesh: a ``parallel.sharding`` mesh (``data_mesh``, ``model_mesh``),
    which every rank calls the trainer with: the state is this rank's part
    (``init_train_state(shard_params(...), ..., mesh=mesh)``) and the
    dataset its shard (``prepare_dataset_on_device(..., mesh=mesh)``).
    Every rank draws the same stream (the same generator, or the same
    ``offsets=``/``indices=``), and each step assembles the whole batch
    with one all-reduce over the data axis (``make_mesh_sampler``) before
    each rank takes its rows (``parallel.sharding.make_sharded_svi_step``).
    On the card with an NCCL mesh the collectives are captured in the
    graphs; with a gloo mesh, whose collectives go through the host, the
    same step bodies run eagerly (``captured`` is then False); a capture
    that fails raises.  The ELBOs are the global ones on every rank.

    The update is in place: the trainer keeps the state in its own static
    buffers (the graphs read and write them), copies a state passed in into
    them unless it is already the one it returned, and returns a state
    whose tensors are those buffers, which the next call overwrites.  The
    caller's first state is left as it was.
    """
    return ScanTrainer(config, train_config, task_sizes, batch_sizes,
                       steps_per_call, vem=vem, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# the dataset on the device, and the fits
# ---------------------------------------------------------------------------

#: Share of the card's memory the parked dataset may take; the rest is
#: headroom for the parameters, optimizer state, the (Q, B, M) projections
#: and the graphs' pool (under 2 GB at the flagship's shapes).
DATASET_MEMORY_FRACTION = 0.6


def check_dataset_fits_hbm(dataset, device="cuda", mesh=None) -> None:
    """Raise a ValueError if the dataset would take more than
    ``DATASET_MEMORY_FRACTION`` of ``device``'s memory (from
    ``torch.cuda.mem_get_info``).  Returns at once for a CPU device: host
    memory is not the envelope guarded here.  With a mesh the dataset is
    the whole one and each rank holds 1/k_data of it."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    _, total = torch.cuda.mem_get_info(device)
    nbytes = sum(a.numel() * a.element_size() for td in dataset for a in td)
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names)
        nbytes /= mesh.shape[names.index("data")]
    budget = DATASET_MEMORY_FRACTION * total
    if nbytes > budget:
        raise ValueError(
            f"the on-device dataset is {nbytes / 2**30:.2f} GiB a rank, "
            "more than "
            f"{DATASET_MEMORY_FRACTION:.0%} of the {total / 2**30:.0f} GiB "
            f"of {device}: stream minibatches from the host with "
            "svi_fit and a MinibatchStream, shard the rows over more ranks "
            "(a mesh with a larger 'data' axis), or raise "
            "train.DATASET_MEMORY_FRACTION if the envelope is wrong")


def prepare_dataset_on_device(config: ModelConfig, X_list, Y_list,
                              device="cuda",
                              mesh=None) -> Tuple[elbo_mod.TaskData, ...]:
    """The full dataset (``data.full_batch``), checked against the card's
    memory and placed on ``device`` once, for reuse across
    ``svi_fit_on_device`` calls.  With a mesh each task is padded (mask 0)
    to a multiple of the data size and this rank keeps its block of the
    rows (``parallel.sharding.shard_batch``); the task sizes stay the real
    counts, so the samplers never draw a padding row."""
    k = 1
    if mesh is not None:
        k = mesh.shape[tuple(mesh.mesh_dim_names).index("data")]
    dataset, _ = full_batch(X_list, Y_list, dtype=config.torch_dtype,
                            pad_multiple=k, device="cpu")
    check_dataset_fits_hbm(dataset, device, mesh=mesh)
    if mesh is not None:
        from hetmogp_tpu_torch.parallel import sharding

        dataset = sharding.shard_batch(mesh, dataset)
    return tuple(elbo_mod.TaskData(*(a.to(device, copy=mesh is not None)
                                     for a in td)) for td in dataset)


def _warn_if_frozen(ng_codes: torch.Tensor, what: str) -> bool:
    """Warn when every natural-gradient step of a call skipped its update
    (``ng_backoff`` 2: both attempts rejected, q left as it was).
    ``ng_codes``: the call's codes of its VE (or joint) steps, read on the
    host here.  Returns whether it warned."""
    if ng_codes.numel() and bool((ng_codes == 2).all()):
        warnings.warn(
            f"{what}: every natural-gradient step of the call rejected its "
            f"update at natgrad_lr and at natgrad_lr / 4 (ng_backoff == 2), "
            "so q(u) did not move: the step left the acceptance bounds "
            f"(whitened mean move < {_NG_STEP_MAX:g}, variance < "
            f"{_NG_SANE_VAR:g}) or the factor; lower natgrad_lr or use "
            "natgrad_retraction='cholesky'", RuntimeWarning, stacklevel=3)
        return True
    return False


def _step_checkpoints(ckpt_dir):
    """Every ``step_<n>`` subdirectory of ckpt_dir as a sorted
    [(n, path), ...]: the one parser that resume and rotation share, so
    both accept the same names."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted((int(p.name[5:]), p) for p in d.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and p.name[5:].isdigit())


def _latest_step_checkpoint(ckpt_dir):
    """The newest ``step_<n>`` subdirectory of ckpt_dir, (n, path), or
    None."""
    found = _step_checkpoints(ckpt_dir)
    return found[-1] if found else None


#: the npz inside each ``step_<n>`` directory
STEP_CHECKPOINT = "checkpoint.npz"


def _save_step(ckpt_dir, done: int, state: TrainState,
               generator: torch.Generator, mesh=None, config=None) -> None:
    """``{ckpt_dir}/step_{done}/checkpoint.npz``: params, optimizer state,
    step and the generator's state, written into a sibling directory and
    renamed into place, so a crash leaves no partial ``step_`` entry.
    With a mesh, ``step_{done}`` is a sharded checkpoint
    (``checkpoint.save_checkpoint_sharded``), which swaps itself in."""
    from hetmogp_tpu_torch import checkpoint

    final = Path(ckpt_dir) / f"step_{done}"
    if mesh is not None:
        checkpoint.save_checkpoint_sharded(
            final, state.params, opt_state=state.opt_state, step=state.step,
            generator=generator, mesh=mesh, config=config)
        return
    tmp = final.with_name(final.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    checkpoint.save_checkpoint(tmp / STEP_CHECKPOINT, state.params,
                               opt_state=state.opt_state, step=state.step,
                               generator=generator)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def svi_fit_on_device(params: SVMOGPParams, config: ModelConfig,
                      train_config: TrainConfig, X_list, Y_list,
                      batch_sizes, num_steps: int, *,
                      generator: Optional[torch.Generator] = None,
                      vem: bool = True, steps_per_call: int = 100,
                      mesh=None, dataset=None, checkpoint_dir=None,
                      checkpoint_every: Optional[int] = None,
                      keep_last: int = 2, resume: bool = False,
                      early_stop_tol: Optional[float] = None,
                      early_stop_patience: int = 3):
    """Train with ``make_scan_trainer`` on the params' device; returns
    (params, history), history a numpy array of the ELBOs of the steps
    this call ran.

    generator: the CPU generator of the minibatch streams (seeded from
      ``train_config.seed`` when None).
    vem: the VE/VM schedule, or joint mode.
    dataset: a prebuilt dataset (``prepare_dataset_on_device``) to reuse;
      task sizes still come from X_list, so pass the X_list it was built
      from.
    early_stop_tol: stop at chunk granularity once the chunk-mean ELBO has
      failed to beat its best by more than this for
      ``early_stop_patience`` chunks in a row.
    mesh: a ``parallel.sharding`` mesh (``data_mesh``, ``model_mesh``);
      every rank calls with the same arguments (the full params, the whole
      X_list and Y_list, the same generator).  Each rank keeps its shard of
      the dataset and of the state (``make_scan_trainer(mesh=)``), the
      chunk means the early stop compares are rank 0's on every rank, the
      checkpoints are sharded (``checkpoint.save_checkpoint_sharded``:
      ``step_{n}/`` holds one npz a latent rank and a meta file; a resume
      restores each rank's shard), and the returned params are the full
      params on every rank.
    checkpoint_dir: periodic checkpoints at chunk boundaries, every
      ``checkpoint_every`` steps (rounded up to ``steps_per_call``; one a
      chunk by default), after the remainder chunk, and on an early stop,
      each ``{checkpoint_dir}/step_{n}/checkpoint.npz``
      (``checkpoint.save_checkpoint``: params, optimizer state, step and
      the generator's state), keeping the newest ``keep_last``.  A fresh
      run (``resume=False``) into a directory that already holds ``step_``
      checkpoints raises: rotation would delete the new run's saves and
      keep the stale higher-numbered ones.  ``resume=True`` restores the
      newest and continues to ``num_steps`` steps in all: its params and
      ELBOs are those of the uninterrupted run, bit for bit, because the
      restored state is copied into the trainer's buffers and the
      generator's state restores the minibatch stream, which is drawn step
      by step whatever the chunking.  The JAX package writes Orbax
      directories here; the port writes npz files (Orbax imports JAX).
    Steps past the last whole chunk run as a shorter call of the same
    graphs.  The caller's params are not modified.  Under natgrad_adam it
    warns once when every natural-gradient step of a call skipped its
    update.
    """
    comm = None
    if mesh is not None:
        from hetmogp_tpu_torch.parallel import sharding

        comm = sharding.mesh_comm(mesh, config)
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
    done, restored = 0, None
    if checkpoint_dir is not None:
        existing = _step_checkpoints(checkpoint_dir)
        if existing and not resume:
            raise ValueError(
                f"{checkpoint_dir!s} already contains checkpoints "
                f"(step_{existing[-1][0]} newest); pass resume=True to "
                "continue that run, or use an empty directory: starting "
                "fresh here would rotate away this run's checkpoints while "
                "keeping the stale higher-numbered ones")
        if resume and existing:
            from hetmogp_tpu_torch import checkpoint

            done, path = _latest_step_checkpoint(checkpoint_dir)
            opt0 = init_optimizer_state(params, train_config)
            if mesh is not None:  # each rank reads its shard
                params, opt, step, extra = checkpoint.load_checkpoint_sharded(
                    path, params, opt0, mesh=mesh)
            else:
                params, opt, step, extra = checkpoint.load_checkpoint(
                    path / STEP_CHECKPOINT, params, opt0)
            restored = (opt, step)
            if "generator_state" in extra:
                generator.set_state(extra["generator_state"])
        elif mesh is not None:
            params = sharding.shard_params(mesh, params)
    elif mesh is not None:
        params = sharding.shard_params(mesh, params)
    if dataset is None:
        dataset = prepare_dataset_on_device(config, X_list, Y_list, device,
                                            mesh=mesh)
    run = make_scan_trainer(config, train_config, task_sizes, batch_sizes,
                            steps_per_call, vem=vem, device=device, mesh=mesh)
    state = init_train_state(params, config, train_config, cache_luu=vem,
                             mesh=mesh)
    if restored is not None:
        state = dataclasses.replace(state, opt_state=restored[0],
                                    step=restored[1])
    warned = False

    def call(state, **kw):
        nonlocal warned
        state, elbos = run(state, dataset, **kw)
        if run.ng_backoff is not None and not warned:
            ng = run.ng_backoff.cpu()[torch.tensor(
                [k != "vm" for k in run.step_kinds], dtype=torch.bool)]
            warned = _warn_if_frozen(ng, "svi_fit_on_device")
        return state, elbos.cpu().numpy()

    last_saved = -1

    def maybe_save(prev_done):
        nonlocal last_saved
        if checkpoint_dir is None or last_saved == done:
            return
        every = checkpoint_every or steps_per_call
        if done < num_steps and done // every == prev_done // every:
            return
        _save_step(checkpoint_dir, done, state, generator, mesh, config)
        last_saved = done
        if keep_last > 0 and (comm is None or comm.rank == 0):
            for _, p in _step_checkpoints(checkpoint_dir)[:-keep_last]:
                shutil.rmtree(p)
        if comm is not None:
            comm.barrier()

    chunks = []
    best_mean, stale, stopped = -np.inf, 0, False
    while done + steps_per_call <= num_steps:
        state, elbos = call(state, generator=generator)
        chunks.append(elbos)
        done += steps_per_call
        maybe_save(done - steps_per_call)
        if early_stop_tol is not None:
            m = float(chunks[-1].mean())
            if comm is not None:  # every rank decides on rank 0's mean
                m = float(comm.broadcast(torch.tensor(
                    [m], dtype=torch.float64, device=device))[0])
            if m > best_mean + early_stop_tol:
                best_mean, stale = m, 0
            else:
                stale += 1
            if stale >= early_stop_patience:
                stopped = True
                maybe_save(-1)  # a final checkpoint at this chunk
                break
    if not stopped and done < num_steps:
        state, elbos = call(state, **{run.sampler.name: run.sampler.draw(
            generator, num_steps - done)})
        chunks.append(elbos)
        prev, done = done, num_steps
        maybe_save(prev)
    history = np.concatenate(chunks) if chunks else np.zeros((0,))
    if comm is not None:
        return comm.gather_params(state.params), history
    return state.params, history


def print_callback(every: int = 50):
    """The reference's training callback: print the ELBO every ``every``
    iterations ('svi - iteration i elbo e').  Pass to
    ``svi_fit(callback=...)``."""

    def cb(i, metrics):
        if i % every == 0:
            print(f"svi - iteration {i} elbo {float(metrics['elbo']):.6f}")

    return cb


def plot_callback(every: int = 50, path: Optional[str] = None, ax=None):
    """Live ELBO plot: an ELBO-vs-iteration line redrawn every ``every``
    iterations.  With ``path`` the figure is saved there on each redraw
    (Agg backend); in an interactive backend it updates in place.  Pass to
    ``svi_fit(callback=...)``; the history is ``cb.history``, the figure
    ``cb.figure``."""
    import matplotlib
    if path is not None and matplotlib.get_backend().lower() != "agg":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 3))
    else:
        fig = ax.figure
    (line,) = ax.plot([], [], lw=1.0)
    ax.set_xlabel("iteration")
    ax.set_ylabel("ELBO")
    history = []

    def cb(i, metrics):
        history.append(float(metrics["elbo"]))
        if i % every == 0:
            line.set_data(np.arange(len(history)), np.asarray(history))
            ax.relim()
            ax.autoscale_view()
            if path is not None:
                fig.savefig(path, dpi=80)
            else:
                fig.canvas.draw_idle()
                plt.pause(0.001)

    cb.history = history
    cb.figure = fig
    return cb


def svi_fit(params: SVMOGPParams, config: ModelConfig,
            train_config: TrainConfig, stream, num_steps: int,
            vem: bool = True, callback: Optional[Callable] = None):
    """Run SVI for ``num_steps`` minibatch steps of ``stream`` (a
    ``MinibatchStream`` whose batches lie on the params' device); returns
    (params, elbo_history).  The host loop of eager steps: one step and
    one read of its ELBO per batch.  callback(i, metrics): a per-step hook
    (``print_callback``, ``plot_callback``, ``MetricsLogger``).  Under
    natgrad_adam it warns when every natural-gradient step skipped its
    update."""
    step = make_step(config, train_config, vem=vem)
    state = init_train_state(params, config, train_config, cache_luu=vem)
    nve, cycle = train_config.ve_steps_per_vm, train_config.ve_steps_per_vm + 1
    history, ng = np.empty(num_steps), []
    for i in range(num_steps):
        data, scales = stream.next()
        state, metrics = step(state, data, torch.as_tensor(
            scales, dtype=config.torch_dtype, device=params.Z.device))
        history[i] = float(metrics["elbo"])
        if "ng_backoff" in metrics and (not vem or i % cycle < nve):
            ng.append(metrics["ng_backoff"])
        if callback is not None:
            callback(i, metrics)
    if ng:
        _warn_if_frozen(torch.stack(ng).cpu(), "svi_fit")
    return state.params, history


# ---------------------------------------------------------------------------
# batch VEM with L-BFGS
# ---------------------------------------------------------------------------

def make_lbfgs_runner(loss: Callable, free: Sequence[str], max_iters: int,
                      history_size: int = 10):
    """Masked L-BFGS (paramz ``optimize(max_iters=100)``'s role):
    run(params) -> (params, loss value at the result).  Only the ``free``
    leaves are the optimizer's variables, so the others stay exactly as
    they are; ``torch.optim.LBFGS`` with a strong-Wolfe line search and
    optax.lbfgs's memory of 10, for at most ``max_iters`` iterations.  It
    runs eagerly: the line search reads values on the host."""

    def run(params: SVMOGPParams):
        names = [name for name, _ in leaves(params)]
        tensors = [t.detach().clone().requires_grad_(name in free)
                   for name, t in leaves(params)]
        variables = [t for name, t in zip(names, tensors) if name in free]
        opt = torch.optim.LBFGS(
            variables, lr=1.0, max_iter=max_iters, history_size=history_size,
            line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            value = loss(from_leaves(params, tensors))
            value.backward()
            for t in variables:  # LBFGS flattens each gradient by view
                if t.grad is not None:
                    t.grad = t.grad.contiguous()
            return value

        opt.step(closure)
        out = from_leaves(params, [t.detach() for t in tensors])
        with torch.no_grad():
            return out, loss(out)

    return run


def vem_algorithm(params: SVMOGPParams, config: ModelConfig, X_list, Y_list,
                  train_config: Optional[TrainConfig] = None,
                  stochastic: bool = False, stream=None,
                  num_steps: Optional[int] = None, verbose: bool = False):
    """Variational EM (the reference's ``vem_algorithm``); returns (params,
    elbo_history).

    Batch mode: ``vem_iters`` x [VE: L-BFGS over (q_mu, q_sqrt), then VM:
    L-BFGS over the hypers, Z and W per the flags], each of
    ``batch_inner_iters`` iterations on the whole dataset (on the params'
    device), through ``elbo_fn`` without a cache (a factorization and
    triangular solves per evaluation).  The history holds the ELBO at the
    end of each half-step (the JAX package records the value at the start
    of its last iteration).  Stochastic mode delegates to ``svi_fit`` with
    the VE/VM schedule.
    """
    train_config = train_config or TrainConfig()
    if stochastic:
        if stream is None:
            raise ValueError("stochastic mode needs a MinibatchStream")
        return svi_fit(params, config, train_config, stream,
                       num_steps or train_config.vem_iters, vem=True)
    data, scales = full_batch(X_list, Y_list, dtype=config.torch_dtype,
                              device=params.Z.device)
    scales = torch.as_tensor(scales, dtype=config.torch_dtype,
                             device=params.Z.device)

    def loss(p):
        return -elbo_mod.elbo_fn(p, data, scales, config)[0]

    ve_run = make_lbfgs_runner(loss, ve_mask(), train_config.batch_inner_iters)
    vm_run = make_lbfgs_runner(loss, vm_mask(train_config),
                               train_config.batch_inner_iters)
    history = []
    for i in range(train_config.vem_iters):
        for what, run in (("VE", ve_run), ("VM", vm_run)):
            params, value = run(params)
            history.append(-float(value))
            if verbose:
                print(f"iteration ({i + 1}) {what} step, "
                      f"ELBO={history[-1]:.6f}")
    return params, np.asarray(history)
