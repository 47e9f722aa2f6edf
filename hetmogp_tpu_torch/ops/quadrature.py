"""Gauss-Hermite variational expectations and predictive moments, and
the Monte-Carlo log-predictive density.

Counterpart of ``hetmogp_tpu/ops/quadrature.py``.  The GH nodes and
weights come from numpy's ``hermgauss`` and the quasi-MC nodes from numpy's
``RandomState`` (``mc_nodes``), so both are the JAX package's to the bit.
Random draws come from an explicit ``torch.Generator`` or are injected;
nothing reads a global seed.

``make_var_exp`` keeps the JAX engine's gradient semantics: the value is
the T-node GH sum of ``logpdf``, and its (m, v)-gradients are the
reference's Bonnet/Price forms (E[dlogp/df], 1/2 E[d2logp/df2]) on the same
nodes, not the derivative of the finite sum (which is noisier and singular
as v -> 0).  One forward sweep gives the value and the two reduced
expectations; the backward is two multiplies.  The per-node derivatives
come from autograd over the summed sweep: every node F[n, s, :] reaches
only lp[n, s], so the gradient of sum(lp) with respect to F is the
per-node gradient, and one more backward per latent dimension j of
sum(d lp / dF_j) gives the diagonal second derivative.  That is J + 1
backward passes over tensors the size of the grid, all batched, where
``torch.func``'s vmapped ``hessian`` would build the full J x J Hessian
per node only to keep its diagonal.

``make_var_exp_theta`` adds a trainable likelihood-parameter vector theta,
shared by the rows: the (m, v)-gradients as above, and dtheta =
sum_n g_n sum_s w_s d logp(F_ns, y_n; theta) / d theta.  theta reaches the
log-density as one copy per row, so the weighted backward of the sweep
gives each row's sum over its nodes at once, with no per-node Jacobian.

On the card, an engine whose log-density has a device function
(``SWEEP_FAMILIES``: Bernoulli, Categorical and the lngamma sweep of
Gamma, Beta and Dirichlet) runs its sweep as kernel 6's per-engine design
(``csrc/gh_sweep_kernel.cu``): one launch gives the value, E[d1] and
E[d2] of every row, the JAX engine's one fused ``ve_fwd``; the autograd
sweep above is its plain version, what CPU tensors and
``use_kernel=False`` take.

``task_var_exp`` is the ELBO's whole likelihood term, each task's var_exp
and its masked, scaled sum, for the tasks whose likelihood has a device
function in ``TASK_FAMILIES`` (Bernoulli, Categorical, HetGaussian,
Poisson, Gamma and Exponential with their closed forms; Beta, Binomial,
Dirichlet and the zero-inflated Poisson, whose var_exp takes several
sweeps or a constant of the family): on the card one
launch of kernel 6's task table (``csrc/ve_tasks_kernel.cu``) gives every
task's sum and the rows' gradient coefficients, and one more launch every
task's (dM, dV) (``TaskVarExp``); ``task_var_exp_plain``, the per-task
loop, is its plain version.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

DEFAULT_T = 20  # GPy Likelihood._gh_points() default
MULTI_T = 10  # multi-latent likelihoods (categorical)


@functools.lru_cache(maxsize=None)
def gh_points(T: int):
    """Hermite-Gauss nodes and weights as float64 numpy constants."""
    return np.polynomial.hermite.hermgauss(T)


@functools.lru_cache(maxsize=None)
def tensor_grid(T: int, J: int):
    """Tensor-product GH grid over J dims.

    Returns:
      nodes: (T^J, J) float64; weights: (T^J,) already normalized by
      pi^(J/2) so that sum_s w_s g(f_s) approximates E_{N(m,v)}[g].
    """
    f, w = gh_points(T)
    grids = np.meshgrid(*([f] * J), indexing="ij")
    nodes = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wgrids = np.meshgrid(*([w] * J), indexing="ij")
    weights = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1),
                      axis=-1)
    return nodes, weights / (np.pi ** (J / 2.0))


@functools.lru_cache(maxsize=None)
def mc_nodes(S: int, J: int, seed: int = 0):
    """Fixed standard-normal nodes for quasi-MC expectations, where the T^J
    tensor grid is infeasible: S antithetic draws from numpy's
    ``RandomState(seed)`` (one more draw when S is odd), scaled by
    1/sqrt(2) to the engine's F = m + sqrt(2 v) node convention, with
    uniform weights 1/S."""
    rng = np.random.RandomState(seed)
    half = rng.standard_normal((S // 2, J))
    eps = np.concatenate([half, -half], axis=0)
    if eps.shape[0] < S:
        eps = np.concatenate([eps, rng.standard_normal((1, J))], axis=0)
    return eps / np.sqrt(2.0), np.full((eps.shape[0],), 1.0 / eps.shape[0])


def _as_tensors(nodes, weights, dtype, device):
    """Node table as tensors on ``device``.  Made outside inference mode
    even when a prediction entry asks first: autograd cannot save an
    inference tensor, and the trainer's sweeps reuse the cached tables."""
    with torch.inference_mode(False):
        return (torch.as_tensor(nodes, dtype=dtype, device=device),
                torch.as_tensor(weights, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _grid_tensors(T: int, J: int, dtype: torch.dtype, device: torch.device):
    """``tensor_grid(T, J)`` as tensors on ``device``, made once: a copy
    from host memory per call would synchronise the stream every step (and
    cannot be captured in a CUDA graph)."""
    return _as_tensors(*tensor_grid(T, J), dtype, device)


@functools.lru_cache(maxsize=None)
def _mc_tensors(S: int, J: int, dtype: torch.dtype, device: torch.device):
    """``mc_nodes(S, J)`` as tensors on ``device``, made once."""
    return _as_tensors(*mc_nodes(S, J), dtype, device)


def _nodes(T: int, J: int, mc_samples: int, like: torch.Tensor):
    """The engine's nodes and weights: ``mc_samples`` quasi-MC nodes where
    it is > 0, else the T^J tensor grid."""
    if mc_samples:
        return _mc_tensors(mc_samples, J, like.dtype, like.device)
    return _grid_tensors(T, J, like.dtype, like.device)


def _expand_nodes(m, v, nodes):
    """F[n, s, :] = m[n] + sqrt(2 v[n]) * nodes[s]; (N,J),(S,J) -> (N,S,J)."""
    return m[:, None, :] + torch.sqrt(2.0 * v)[:, None, :] * nodes[None]


def make_predictive(cond_moments, J: int, T: int, mc_samples: int = 0):
    """Observation-space predictive moments by GH quadrature.

    E[y*] = E_q[mean(f)],  V[y*] = E_q[var(f)] + E_q[mean(f)^2] - E[y*]^2.

    Args:
      cond_moments: (F: (..., J)) -> (mean, var), each (..., dim_p).
      mc_samples: if > 0, that many quasi-MC nodes (``mc_nodes``) in place
        of the T^J tensor grid.
    Returns:
      predictive(m, v) with m, v (N, J) -> (mean, var), each (N, dim_p).
    """
    def predictive(m, v):
        nodes, w = _nodes(T, J, mc_samples, m)
        cm, cv = cond_moments(_expand_nodes(m, v, nodes))  # (N, S, dim_p)
        Em = cm.mT @ w
        Em2 = torch.square(cm).mT @ w
        Ev = cv.mT @ w
        return Em, Ev + Em2 - torch.square(Em)

    return predictive


def _diag_second(d1, F, j):
    """d2 lp / dF_j^2 at every node from the per-node gradient d1 (built
    with ``create_graph``); zeros where d1_j does not depend on F."""
    if not d1.requires_grad:
        return torch.zeros_like(F[..., j])
    (g,) = torch.autograd.grad(d1[..., j].sum(), F, retain_graph=True,
                               allow_unused=True)
    return torch.zeros_like(F[..., j]) if g is None else g[..., j]


# Kernel 6's device functions (``csrc/gh_sweep.cuh``), by engine: the
# family code the kernel switches on and the latent dimensions J it is
# built for.  A CUDA tensor of an engine made with one of these ``sweep``
# names goes to the kernel (``cuda_kernels.gh_sweep``); every other engine
# runs its autograd sweep on the card.  This is a route by family, not a
# fallback: a build or launch failure raises.
SWEEP_FAMILIES = {"bernoulli": (0, (1,)),
                  "categorical": (1, (1, 2, 3, 4, 5)),
                  "lngamma": (2, (1,))}


def make_var_exp(logpdf, J: int, T: int, mc_samples: int = 0,
                 sweep: Optional[str] = None):
    """Build ve(y, m, v, use_kernel=True) -> (N,), E_{N(f; m, v)}[log p(y | f)]
    per row.

    Args:
      logpdf: batched log-density, (F: (..., J), y: (..., dim_y)) -> (...),
        broadcasting y over the node axis.
      J: number of latent parameter functions (dim_f).
      T: GH nodes per dimension (tensor grid of T^J nodes).
      mc_samples: if > 0, that many quasi-MC nodes (``mc_nodes``) in place
        of the tensor grid, for large J where T^J explodes.
      sweep: the name of ``logpdf``'s device function in
        ``SWEEP_FAMILIES``, or None.  With a name, a CUDA tensor's sweep is
        kernel 6 (value, E[d1] and E[d2] in one launch) unless the call
        passes ``use_kernel=False``; CPU tensors, and an engine without
        one, take the autograd sweep.
    The gradient with respect to (m, v) is (E[dlogp], 1/2 E[d2logp]) on the
    same nodes; y gets none.  The engine function carries ``sweep``.
    """
    if sweep is not None:
        if sweep not in SWEEP_FAMILIES:
            raise ValueError(f"no device function {sweep!r}; kernel 6 has "
                             f"{sorted(SWEEP_FAMILIES)}")
        if J not in SWEEP_FAMILIES[sweep][1]:
            raise ValueError(f"kernel 6's {sweep!r} takes J in "
                             f"{SWEEP_FAMILIES[sweep][1]}, got {J}")

    class VarExp(torch.autograd.Function):

        @staticmethod
        def forward(ctx, y, m, v, use_kernel=True):
            nodes, w = _nodes(T, J, mc_samples, m)
            deriv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
            if sweep is not None and use_kernel and m.is_cuda:
                from hetmogp_tpu_torch.ops import cuda_kernels

                family = SWEEP_FAMILIES[sweep][0]
                args = (y.detach(), m.detach(), v.detach(), nodes, w)
                if not deriv:
                    return cuda_kernels.gh_sweep_value(family, *args)
                val, Ed1, Ed2 = cuda_kernels.gh_sweep(family, *args)
                ctx.save_for_backward(Ed1, Ed2)
                return val
            if not deriv:
                return logpdf(_expand_nodes(m, v, nodes), y[:, None, :]) @ w
            with torch.enable_grad():
                F = _expand_nodes(m, v, nodes).detach().requires_grad_()
                lp = logpdf(F, y[:, None, :])  # (N, S)
                (d1,) = torch.autograd.grad(lp.sum(), F, create_graph=True)
                d2 = torch.stack([_diag_second(d1, F, j) for j in range(J)],
                                 dim=-1)
            Ed1 = d1.detach().mT @ w  # (N, J)
            Ed2 = d2.mT @ w
            ctx.save_for_backward(Ed1, Ed2)
            return lp.detach() @ w

        @staticmethod
        def backward(ctx, g):
            Ed1, Ed2 = ctx.saved_tensors
            return None, Ed1 * g[:, None], 0.5 * Ed2 * g[:, None], None

    def ve(y, m, v, use_kernel: bool = True):
        return VarExp.apply(y, m, v, use_kernel)

    ve.sweep = sweep
    return ve


# Kernel 6's task table (``csrc/ve_tasks_kernel.cu``): the likelihoods
# whose whole var_exp has a device function (``gh_sweep.cuh``'s task
# families), by the name a likelihood gives as its ``task``: the family
# code the kernel switches on, the J it is built for, and the sweep it runs
# over its first latent dimensions (a name of SWEEP_FAMILIES), None for
# a closed form alone, or TERMS for a multi-term family: several sweeps,
# each an integrand over some of the latent dimensions on a grid of its own
# (the likelihood's ``task_grid()`` lists them, one a term), with the
# family's constants (``task_consts()``).  ``models/elbo.py::
# likelihood_term`` sends the tasks of a CUDA model whose likelihood names
# one of these, and has no trainable theta, to ``task_var_exp``; every
# other task keeps its own var_exp.  A route by family, not a fallback: a
# build or launch failure raises.
TERMS = "terms"
TASK_FAMILIES = {"bernoulli": (0, (1,), "bernoulli"),
                 "categorical": (1, (1, 2, 3, 4, 5), "categorical"),
                 "hetgaussian": (2, (2,), None),
                 "poisson": (3, (1,), None),
                 "gamma": (4, (2,), "lngamma"),
                 "exponential": (5, (1,), None),
                 "beta": (6, (2,), TERMS),
                 "binomial": (7, (1,), TERMS),
                 "dirichlet": (8, (2, 3), TERMS),
                 "zipoisson": (9, (2,), TERMS)}


def task_family(lik) -> Optional[str]:
    """The name of ``lik``'s device function in TASK_FAMILIES, or None."""
    name = getattr(lik, "task", None)
    if name is None:
        return None
    if name not in TASK_FAMILIES or lik.dim_f not in TASK_FAMILIES[name][1]:
        raise ValueError(f"{type(lik).__name__} names {name!r} with J = "
                         f"{lik.dim_f}; kernel 6's task table has "
                         f"{ {k: v[1] for k, v in TASK_FAMILIES.items()} }")
    return name


def _grid(T: int, J: int, mc_samples: int):
    """The float64 numpy nodes and weights of ``_nodes``."""
    return mc_nodes(mc_samples, J) if mc_samples else tensor_grid(T, J)


@functools.lru_cache(maxsize=None)
def _terms_tensors(grids, J: int, dtype: torch.dtype, device: torch.device):
    """A multi-term family's node table on ``device``, made once: its
    terms' grids (``grids``, (T, J_k, mc_samples) each) one after another,
    (S, J) nodes with each term's coordinates in its first J_k columns and
    zeros past them, and (S,) weights, each value the one a term's own
    table holds."""
    tables = [_grid(*g) for g in grids]
    nodes = np.zeros((sum(len(w) for _, w in tables), J))
    start = 0
    for f, w in tables:
        nodes[start:start + len(w), :f.shape[1]] = f
        start += len(w)
    return _as_tensors(nodes, np.concatenate([w for _, w in tables]), dtype,
                       device)


def _task_table(liks, like):
    """(family code, nodes, w) of each likelihood of the table, the node
    table on ``like``'s dtype and device (None for a closed form; a
    multi-term family's terms one after another, ``_terms_tensors``)."""
    out = []
    for lik in liks:
        code, _, sweep = TASK_FAMILIES[task_family(lik)]
        if sweep == TERMS:
            nodes, w = _terms_tensors(tuple(lik.task_grid()), lik.dim_f,
                                      like.dtype, like.device)
        elif sweep is not None:
            nodes, w = _nodes(*lik.task_grid(), like)
        else:
            nodes, w = None, None
        out.append((code, nodes, w))
    return out


def _task_extras(lik):
    """(sizes, consts) of a task: each term's node count, a multi-term
    family's (() for the others), and the family's constants as floats."""
    sizes = ()
    if TASK_FAMILIES[task_family(lik)][2] == TERMS:
        sizes = tuple(len(_grid(*g)[1]) for g in lik.task_grid())
    return sizes, tuple(float(c) for c in lik.task_consts())


def _task_launch_args(liks, Y, M, V, masks, scales):
    """The task table's launcher arguments: (tasks, scales)."""
    table = _task_table(liks, M[0])
    return ([(code, y.detach(), m.detach(), v.detach(), mask.detach(), nodes,
              w, *_task_extras(lik))
             for lik, (code, nodes, w), y, m, v, mask in zip(
                 liks, table, Y, M, V, masks)],
            [s.detach() for s in scales])


class TaskVarExp(torch.autograd.Function):
    """The likelihood term of the tasks of ``liks`` on kernel 6's task
    table, with its gradient: forward(liks, scales, Y_0, m_0, v_0, mask_0,
    Y_1, ...) -> (T,) sums, scales a tuple of () tensors (read on the
    device).  The forward launch keeps each row's coefficients (dve/dm,
    dve/dv); the backward launch writes every (dM_t, dV_t)."""

    @staticmethod
    def forward(ctx, liks, scales, *flat):
        from hetmogp_tpu_torch.ops import cuda_kernels

        Y, M, V, masks = (flat[k::4] for k in range(4))
        tasks, scales = _task_launch_args(liks, Y, M, V, masks, scales)
        sums, _, coefs = cuda_kernels.task_var_exp(tasks, scales)
        ctx.save_for_backward(*coefs, *(t[4] for t in tasks), *scales)
        return sums

    @staticmethod
    def backward(ctx, g):
        from hetmogp_tpu_torch.ops import cuda_kernels

        saved = ctx.saved_tensors
        T = len(saved) // 3
        grads = cuda_kernels.task_var_exp_backward(
            saved[:T], saved[T:2 * T], saved[2 * T:], g)
        out = [None, None]
        for dm, dv in grads:
            out += [None, dm, dv, None]
        return tuple(out)


def task_var_exp_plain(liks, Y, M, V, masks, scales,
                       use_kernel: bool = True) -> torch.Tensor:
    """The task table's plain version: (T,) sums scale_t * sum(var_exp_t *
    mask_t), each task's ``var_exp`` (its engines' own route, by
    ``use_kernel``) and its masked, scaled sum, as the JAX package's
    ``elbo_fn`` computes them."""
    return torch.stack([s * torch.sum(lik.var_exp(y, m, v,
                                                  use_kernel=use_kernel)
                                      * mask)
                        for lik, y, m, v, mask, s in zip(liks, Y, M, V,
                                                         masks, scales)])


def task_var_exp(liks, Y, M, V, masks, scales,
                 use_kernel: bool = True) -> torch.Tensor:
    """The ELBO's likelihood term of the tasks of ``liks``, every one in
    TASK_FAMILIES: (T,) sums scale_t * sum_n mask_t[n] var_exp_t[n].

    Args:
      Y, M, V, masks: one (N_t, dim_y), (N_t, J_t), (N_t, J_t), (N_t,)
        tensor a task.
      scales: one () tensor a task (the step's scales, views of them).
    A CUDA model takes kernel 6's task table (``TaskVarExp``: one forward
    launch, one backward launch for all the tasks; the value-alone launch
    where grad mode is off or no (M_t, V_t) requires grad) unless the call
    passes ``use_kernel=False``; CPU tensors take ``task_var_exp_plain``.
    The gradient with respect to each (M_t, V_t) is the plain term's:
    autograd of the closed forms, the engines' Bonnet/Price forms where
    they sweep.
    """
    for lik in liks:
        if task_family(lik) is None:
            raise ValueError(f"{type(lik).__name__} has no device function "
                             "in kernel 6's task table; its var_exp takes "
                             "its own path")
    if use_kernel and M[0].is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (*M, *V)):
            flat = [t for task in zip(Y, M, V, masks) for t in task]
            return TaskVarExp.apply(tuple(liks), tuple(scales), *flat)
        from hetmogp_tpu_torch.ops import cuda_kernels

        return cuda_kernels.task_var_exp_value(
            *_task_launch_args(liks, Y, M, V, masks, scales))[0]
    return task_var_exp_plain(liks, Y, M, V, masks, scales, use_kernel)


def make_var_exp_theta(logpdf_t, J: int, T: int, mc_samples: int = 0):
    """Build ve(y, m, v, theta) -> (N,), ``make_var_exp`` with a trainable
    likelihood-parameter vector theta (P,) shared by the rows.

    Args:
      logpdf_t: batched log-density (F: (..., J), y: (..., dim_y),
        theta: (..., P)) -> (...), broadcasting y and theta over the node
        axis.
    The (m, v)-gradients are the Bonnet/Price forms of ``make_var_exp``;
    dtheta = sum_n g_n E[d logp / d theta] on the same nodes.  theta enters
    the sweep as one (1, P) copy per row, so one backward of the weighted
    sweep gives the per-row E[d logp / d theta] (rows differ in g through
    the mask) without a per-node Jacobian.
    """
    class VarExpTheta(torch.autograd.Function):

        @staticmethod
        def forward(ctx, y, m, v, theta):
            nodes, w = _nodes(T, J, mc_samples, m)
            n, P = m.shape[0], theta.shape[-1]
            rows = theta.detach().reshape(1, 1, P).expand(n, 1, P)
            if not any(ctx.needs_input_grad[1:]):
                return logpdf_t(_expand_nodes(m, v, nodes), y[:, None, :],
                                rows) @ w
            with torch.enable_grad():
                F = _expand_nodes(m, v, nodes).detach().requires_grad_()
                th = rows.clone().requires_grad_()
                lp = logpdf_t(F, y[:, None, :], th)  # (N, S)
                # the weighted sweep: w_s dlogp per node, and per row the
                # node sum of w_s dlogp/dtheta
                d1w, dth = torch.autograd.grad(
                    lp, (F, th), grad_outputs=w.expand_as(lp),
                    create_graph=True)
                d2w = torch.stack([_diag_second(d1w, F, j) for j in range(J)],
                                  dim=-1)
            Ed1 = d1w.detach().sum(dim=1)  # (N, J)
            Ed2 = d2w.sum(dim=1)
            Edt = dth.detach()[:, 0, :]  # (N, P)
            ctx.save_for_backward(Ed1, Ed2, Edt)
            return lp.detach() @ w

        @staticmethod
        def backward(ctx, g):
            Ed1, Ed2, Edt = ctx.saved_tensors
            return (None, Ed1 * g[:, None], 0.5 * Ed2 * g[:, None],
                    Edt.mT @ g)

    return VarExpTheta.apply


def standard_normal(shape, generator, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal draws of ``like``'s dtype on its device, from
    ``generator``: drawn on the generator's own device (a CPU generator
    serves a model on the card), then moved."""
    if generator is None:
        raise ValueError("random draws need a torch.Generator (or injected "
                         "eps): the port reads no global seed")
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def mc_log_predictive(logpdf, generator, y, m_star, v_star, num_samples: int,
                      reference_scaling: bool = True, eps=None):
    """Monte-Carlo log-predictive density, summed over the rows.

    Samples F* ~ N(m*, v*) per latent dimension, computes
    log(1/S sum_s p(y | f_s)) by logsumexp, sums over points, and applies
    the reference implementation's extra 1/num_samples factor (a quirk
    the JAX package reproduces for parity; ``reference_scaling=False``
    gives the plain sum).

    Args:
      logpdf: batched log-density, (F: (..., J), y: (..., dim_y)) -> (...).
      generator: ``torch.Generator`` for the (N, S, J) draws; unused when
        ``eps`` injects them.
      y: (N, dim_y); m_star, v_star: (N, J).
    """
    n, J = m_star.shape
    if eps is None:
        eps = standard_normal((n, num_samples, J), generator, m_star)
    else:
        eps = torch.as_tensor(eps, dtype=m_star.dtype, device=m_star.device)
    F = m_star[:, None, :] + torch.sqrt(v_star)[:, None, :] * eps
    lp = logpdf(F, y[:, None, :])  # (N, S)
    total = torch.sum(torch.logsumexp(lp, dim=-1) - math.log(num_samples))
    return total / num_samples if reference_scaling else total
