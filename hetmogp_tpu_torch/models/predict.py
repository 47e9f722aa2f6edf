"""Prediction paths: latent u, latent f, observation space, NLPD.

Counterpart of ``hetmogp_tpu/models/predict.py``.  As there,
``make_serving_predictive`` and ``predictive_sharded`` (the same over a
``parallel.sharding`` mesh) factorize once and project every request
through the cached inverse (matmuls; its error grows with cond(Kuu)),
while every other entry factorizes Kuu and uses triangular solves, and
never forms an inverse.  Every entry starts with
``kernels.K_batched``: the hand-written RBF kernel on the card.

The JAX package wraps each entry in a cached ``jax.jit``; here they are
plain functions under ``torch.inference_mode()``, each the wrapper of an
undecorated body (``_predict_f`` and so on) that ``export.py`` traces
under ``torch.no_grad()``.  ``elbo_evaluator`` takes ``jitted_elbo``'s
role.  Random draws come from a ``torch.Generator`` the caller passes
(where the JAX package takes a key).  Tensors live on the parameters'
device.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from hetmogp_tpu_torch import profiling
from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import SVMOGPParams
from hetmogp_tpu_torch.ops import kernels, linalg, quadrature


def _inference(body):
    """The entry point of ``body``: the same call under
    ``torch.inference_mode()``."""
    @functools.wraps(body)
    def entry(*args, **kw):
        with torch.inference_mode():
            return body(*args, **kw)

    return entry


@functools.lru_cache(maxsize=None)
def elbo_evaluator(config: ModelConfig):
    """``(params, data, scales) -> (elbo, aux)`` of ``elbo_fn`` for one
    config, without gradient: the role of the JAX package's cached
    ``jitted_elbo`` (there is nothing to compile here, so it is a plain
    function, cached only so that one config gives one evaluator).  The
    solve path unless the caller passes a cache to ``elbo_fn`` itself."""
    def evaluate(params, data, scales):
        with torch.no_grad():
            return elbo_mod.elbo_fn(params, data, scales, config)

    return evaluate


def _as_inputs(Xnew, config: ModelConfig, device) -> torch.Tensor:
    """Prediction inputs as an (N, input_dim) tensor of the config's dtype on
    the parameters' device.  The kernels broadcast, so a wrong column count
    would give finite but wrong covariances: it raises here instead."""
    X = torch.as_tensor(Xnew, dtype=config.torch_dtype, device=device)
    if X.ndim != 2 or X.shape[-1] != config.input_dim:
        raise ValueError(
            f"prediction inputs must be (N, {config.input_dim}) for this "
            f"model (input_dim={config.input_dim}); got {tuple(X.shape)}")
    return X


def make_serving_predictive(params: SVMOGPParams, config: ModelConfig,
                            task: int, *, use_kernel: bool = True):
    """Observation-space predictive for one task of a fixed model.

    Computes (Luu, Luu^{-1}) once and returns ``X -> (m_pred, v_pred)``,
    each (N, dim_p), which projects every request through the cached
    inverse.  The inverse's error grows with cond(Kuu): keep a jitter floor
    (``ModelConfig.jitter``), and use ``predictive`` when the solve path's
    exactness matters more than latency.  ``use_kernel=False`` takes the
    plain PyTorch versions in place of the CUDA kernels (the reference they
    are checked against).  Each call is the span ``serve.request``, with
    ``predict.moments`` and ``predict.likelihood`` inside it
    (``profiling``).
    """
    with torch.inference_mode():
        Luu, iLuu = elbo_mod.prior_cholesky_inverse(params, config)
    lik = config.likelihoods[task]
    device = params.Z.device

    def serve(Xnew):
        with torch.inference_mode(), profiling.annotate("serve.request"):
            X = _as_inputs(Xnew, config, device)
            with profiling.annotate("predict.moments"):
                m_F, v_F = elbo_mod.task_qf_moments(
                    params, config, Luu, X, task, iLuu=iLuu,
                    use_kernel=use_kernel)
            with profiling.annotate("predict.likelihood"):
                return lik.predictive(m_F, v_F)

    return serve


def _predict_latent_u(params: SVMOGPParams, config: ModelConfig, Xnew,
                      latent_ind: Optional[int] = None,
                      full_cov: bool = False, *, use_kernel: bool = True):
    """Posterior moments of the latent GPs u_q at Xnew.

    Returns (mean, var), each (N, Q), or an (N,) pair if ``latent_ind`` is
    given.  With ``full_cov=True`` the second element is the full (Q, N, N)
    posterior covariance (or (N, N) for one latent); full covariances are
    not clamped (their diagonals are non-negative up to roundoff by
    construction).
    """
    X = _as_inputs(Xnew, config, params.Z.device)
    Luu = elbo_mod.prior_cholesky(params, config)
    if full_cov:
        mean_q, cov_q = elbo_mod.latent_projections_full(
            params, config, Luu, X, use_kernel=use_kernel)
        if latent_ind is not None:
            return mean_q[latent_ind], cov_q[latent_ind]
        return mean_q.mT, cov_q
    mean_q, gamma_q, _ = elbo_mod.latent_projections(
        params, config, Luu, X, use_kernel=use_kernel)
    mean, var = mean_q.mT, torch.clamp(gamma_q, min=0.0).mT
    if latent_ind is not None:
        return mean[:, latent_ind], var[:, latent_ind]
    return mean, var


predict_latent_u = _inference(_predict_latent_u)


def _predict_f(params: SVMOGPParams, config: ModelConfig, Xnew,
               output_function_ind: int = 0, full_cov: bool = False, *,
               use_kernel: bool = True):
    """Posterior moments of one output parameter function f_d at Xnew:
    (mean, var), each (N,), or (mean, cov (N, N)) with ``full_cov=True``,
    which is what correlated samples of f* need."""
    d = output_function_ind
    t, j = config.function_index[d], config.d_index[d]
    X = _as_inputs(Xnew, config, params.Z.device)
    Luu = elbo_mod.prior_cholesky(params, config)
    if full_cov:
        m_F, cov_F = elbo_mod.task_qf_full_cov(params, config, Luu, X, t,
                                               use_kernel=use_kernel)
        return m_F[:, j], cov_F[j]
    m_F, v_F = elbo_mod.task_qf_moments(params, config, Luu, X, t,
                                        use_kernel=use_kernel)
    return m_F[:, j], v_F[:, j]


predict_f = _inference(_predict_f)


def sample_f(params: SVMOGPParams, config: ModelConfig,
             generator: torch.Generator, Xnew, output_function_ind: int = 0,
             num_samples: int = 1, jitter: float = 1e-8, *, eps=None,
             use_kernel: bool = True):
    """Correlated posterior samples of f_d at Xnew: (num_samples, N), drawn
    from the full-covariance q(f_d) (the diagonal path would sample each
    point independently).  The covariance is factorized by the adaptive
    ``jitchol``: in float32 the base jitter is below the covariance's
    resolution and the escalation is what makes the factorization succeed.
    ``eps`` injects the (num_samples, N) standard-normal draws."""
    mu, cov = predict_f(params, config, Xnew, output_function_ind,
                        full_cov=True, use_kernel=use_kernel)
    with torch.inference_mode():
        L = linalg.jitchol(cov[None], jitter=jitter, adaptive=True)[0]
        if eps is None:
            eps = quadrature.standard_normal((num_samples, mu.shape[0]),
                                             generator, mu)
        else:
            eps = torch.as_tensor(eps, dtype=mu.dtype, device=mu.device)
        return mu[None, :] + eps @ L.mT


def predict_f_projected(params: SVMOGPParams, config: ModelConfig,
                        Xtrain_list: Sequence, Xnew,
                        output_function_ind: int = 0, *,
                        use_kernel: bool = True):
    """The reference implementation's ``_raw_predict_f`` for one output
    function: the task-batched projection (``predict_f_projected_task``),
    sliced."""
    d = output_function_ind
    t, j = config.function_index[d], config.d_index[d]
    mu, var = predict_f_projected_task(params, config, Xtrain_list, Xnew, t,
                                       use_kernel=use_kernel)
    return mu[j], var[j]


def predict_f_stochastic(params: SVMOGPParams, config: ModelConfig,
                         Xanchor_list: Sequence, Xnew,
                         output_function_ind: int = 0, *,
                         use_kernel: bool = True):
    """The reference implementation's ``_raw_predict_stochastic``: the same
    projection under the name minibatch-trained models use.
    ``Xanchor_list`` may be the full training inputs (then it equals
    ``predict_f_projected``) or any subset such as the current minibatch:
    the projection identity holds for any anchor set, and a B-row anchor
    cuts the O(N_t^3) re-projection to O(B^3)."""
    return predict_f_projected(params, config, Xanchor_list, Xnew,
                               output_function_ind, use_kernel=use_kernel)


def _predict_f_projected_task(params: SVMOGPParams, config: ModelConfig,
                              Xtrain_list: Sequence, Xnew, task: int, *,
                              use_kernel: bool = True):
    """The reference implementation's ``_raw_predict_f`` for every output
    function of one task at once: (mu (F_t, Ns), var (F_t, Ns)).

    It forms the q(f_d) posterior at the task's training (anchor) inputs,
    then re-projects it to Xnew through the function-space prior K_fdfd.
    This is O(N^3) in the anchor size and not the recommended path
    (``predict_f`` computes the inducing-point posterior at Xnew directly),
    but it reproduces the reference's numbers.  The d-independent work
    (prior Cholesky, Kfu, the solves, the per-latent grams, the posterior
    correction G) is shared across the task's F_t functions, whose O(N^3)
    factorizations run as one batched adaptive ``jitchol``.  Variances are
    clamped non-negative.
    """
    device = params.Z.device
    X = _as_inputs(Xtrain_list[task], config, device)
    Xs = _as_inputs(Xnew, config, device)
    Luu = elbo_mod.prior_cholesky(params, config)
    kw = dict(use_kernel=use_kernel)

    # d-independent: the q(f) ingredients at the anchor inputs
    Kfu = kernels.K_batched(config.kernel, X, params.Z,
                            params.lengthscale, params.variance, **kw)
    R = linalg.solve_tri(Luu, Kfu.mT)  # (Q, M, N)
    P = R.mT if config.whiten else linalg.solve_tri(Luu, R,
                                                    trans=True).mT
    mean_q = (P @ params.q_mu[..., None])[..., 0]
    Kq_full = kernels.K_self_batched(config.kernel, X, params.lengthscale,
                                     params.variance, **kw)  # (Q, N, N)
    Kx = kernels.K_batched(
        config.kernel, X, Xs[None].expand(config.num_latent_eff,
                                          *Xs.shape),
        params.lengthscale, params.variance, **kw)  # (Q, N, Ns)
    PL = P @ torch.tril(params.q_sqrt)
    # whitened: P S P^T - P P^T; un-whitened: A S A^T - A Kuf, A = P
    G = PL @ PL.mT - P @ (P if config.whiten else Kfu).mT

    # per output function: (Q,)-sized mixing weights, batched over F_t
    start, stop = config.task_function_slices[task]
    Wt = params.W[:, start:stop]  # (Q, F)
    B = kernels.lmc_coregionalization(Wt, params.kappa[:, start:stop])
    m_f = Wt.mT @ mean_q  # (F, N)
    Kdd = torch.einsum("qf,qnk->fnk", B, Kq_full)  # (F, N, N)
    S_f = Kdd + torch.einsum("qf,qnk->fnk", torch.square(Wt), G)
    Kx_f = torch.einsum("qf,qns->fns", B, Kx)  # (F, N, Ns)
    # stationary kernels: Kdiag = variance
    kxx_diag = (B.mT @ params.variance)[:, None]  # (F, 1)

    LK = linalg.jitchol(Kdd, jitter=config.jitter, adaptive=True)
    wv = linalg.cho_solve_batched(LK, m_f[:, :, None])[..., 0]  # (F, N)
    tmp = linalg.cho_solve_batched(LK, Kx_f)  # (F, N, Ns): K^-1 Kx
    mu = torch.einsum("fns,fn->fs", Kx_f, wv)
    var = (kxx_diag - torch.sum(tmp * Kx_f, dim=1)
           + torch.sum(tmp * (S_f @ tmp), dim=1))
    return mu, torch.clamp(var, min=0.0)


predict_f_projected_task = _inference(_predict_f_projected_task)


def _predict_f_all(params: SVMOGPParams, config: ModelConfig,
                   X_list: Sequence, *, use_kernel: bool = True) -> list:
    """q(f) moments for every task: [(m_F_t, v_F_t)], each (N_t, F_t)."""
    device = params.Z.device
    Luu = elbo_mod.prior_cholesky(params, config)
    return [elbo_mod.task_qf_moments(params, config, Luu,
                                     _as_inputs(X_t, config, device), t,
                                     use_kernel=use_kernel)
            for t, X_t in enumerate(X_list)]


predict_f_all = _inference(_predict_f_all)


def _predictive(params: SVMOGPParams, config: ModelConfig, X_list: Sequence,
                Xtrain_list: Optional[Sequence] = None,
                projected: bool = False, *, use_kernel: bool = True):
    """Observation-space predictive moments per task: the latent moments
    pushed through each likelihood's predictive moments.

    The default uses the direct inducing-point moments on the solve path.
    ``projected=True`` with ``Xtrain_list`` routes them through the O(N^3)
    training-set projection instead (``predict_f_projected_task``), the
    reference implementation's own semantics.
    Returns (m_pred, v_pred): lists of (N_t, dim_p).
    """
    if projected:
        if Xtrain_list is None:
            raise ValueError("projected=True requires Xtrain_list")
        moments = []
        for t in range(config.num_tasks):
            mu, var = _predict_f_projected_task(params, config, Xtrain_list,
                                                X_list[t], t,
                                                use_kernel=use_kernel)
            moments.append((mu.mT, var.mT))  # (N, F_t) each
    else:
        moments = _predict_f_all(params, config, X_list,
                                 use_kernel=use_kernel)
    m_pred, v_pred = [], []
    for lik, (m_F, v_F) in zip(config.likelihoods, moments):
        m, v = lik.predictive(m_F, v_F)
        m_pred.append(m)
        v_pred.append(v)
    return m_pred, v_pred


predictive = _inference(_predictive)


def sharded_cache(params: SVMOGPParams, config: ModelConfig, comm):
    """(view, Luu, Luu^{-1}) of this rank's latents under a mesh
    (``comm``, a ``parallel.collectives.MeshComm``), params its shard."""
    view = comm.view(params)
    Luu, iLuu = elbo_mod.prior_cholesky_inverse(view, config)
    return view, Luu, iLuu


def sharded_task_predictive(params: SVMOGPParams, config: ModelConfig, comm,
                            cache, X: torch.Tensor, task: int, *,
                            use_kernel: bool = True):
    """The predictive moments of one task at this rank's rows X, through
    the cached inverse of ``sharded_cache``: the RBF kernel, the
    triangular projection and ``quad_diag`` on this rank's latents, then
    the mixing summed over the latent axis."""
    view, Luu, iLuu = cache
    m_F, v_F = elbo_mod.task_qf_moments(view, config, Luu, X, task,
                                        iLuu=iLuu, use_kernel=use_kernel,
                                        comm=comm)
    return config.likelihoods[task].predictive(m_F, v_F)


def _predictive_sharded(params: SVMOGPParams, config: ModelConfig,
                        X_list: Sequence, mesh, *, use_kernel: bool = True):
    """Observation-space predictive moments over a mesh
    (``parallel.sharding``), every rank calling with the same full params
    and inputs.

    The serving path of ``make_serving_predictive``, split: each task's
    rows are padded (repeating the last) to a multiple of the data size,
    each data rank projects its block of them through the cached inverse of
    its latents (``sharded_task_predictive``), and one all-gather over the
    data axis a task returns every row to every rank, the pad dropped.  No
    collective before that gather moves rows but, on a 2-D mesh, the
    latent all-reduce of the mixing of this rank's own.  Returns (m_pred,
    v_pred): lists of (N_t, dim_p) on every rank.
    """
    from hetmogp_tpu_torch.parallel import sharding

    comm = sharding.mesh_comm(mesh, config)
    local = comm.shard_params(params)
    cache = sharded_cache(local, config, comm)
    device = params.Z.device
    m_pred, v_pred = [], []
    for t in range(config.num_tasks):
        X = _as_inputs(X_list[t], config, device)
        n = X.shape[0]
        pad = (-n) % comm.k_data
        if pad:
            X = torch.cat([X, X[-1:].expand(pad, X.shape[1])])
        m, v = sharded_task_predictive(local, config, comm, cache,
                                       X[comm.rows(X.shape[0])], t,
                                       use_kernel=use_kernel)
        mv = comm.gather_rows(torch.cat([m, v], dim=1))[:n]
        m_pred.append(mv[:, :m.shape[1]])
        v_pred.append(mv[:, m.shape[1]:])
    return m_pred, v_pred


predictive_sharded = _inference(_predictive_sharded)


def negative_log_predictive(params: SVMOGPParams, config: ModelConfig,
                            generator: torch.Generator, Xtest: Sequence,
                            Ytest: Sequence, num_samples: int = 1000,
                            reference_scaling: bool = True,
                            tasks: Optional[Sequence[int]] = None, *,
                            eps: Optional[Sequence] = None,
                            use_kernel: bool = True):
    """Test NLPD by per-task Monte-Carlo logsumexp, including the
    reference implementation's 1/num_samples scaling quirk unless
    ``reference_scaling=False``.

    tasks: optional task indices to evaluate (Xtest/Ytest aligned to this
      list), e.g. ``tasks=[1]`` scores only task 1's held-out region
      without dummy inputs for the other tasks.
    eps: optional per-evaluated-task (N, num_samples, dim_f) draws, in
      place of the generator's.
    """
    tasks = list(range(config.num_tasks)) if tasks is None else list(tasks)
    if len(Xtest) != len(tasks) or len(Ytest) != len(tasks):
        raise ValueError(
            f"Xtest/Ytest must have one entry per evaluated task "
            f"({len(tasks)}: tasks={tasks}); got {len(Xtest)}/{len(Ytest)}. "
            "Pass tasks=[...] to score a subset of tasks.")
    device = params.Z.device
    total = 0.0
    with torch.inference_mode():
        Luu = elbo_mod.prior_cholesky(params, config)
        for i, t in enumerate(tasks):
            m_F, v_F = elbo_mod.task_qf_moments(
                params, config, Luu, _as_inputs(Xtest[i], config, device), t,
                use_kernel=use_kernel)
            Y_t = torch.as_tensor(Ytest[i], dtype=config.torch_dtype,
                                  device=device)
            if Y_t.ndim == 1:
                Y_t = Y_t[:, None]
            total = total + config.likelihoods[t].log_predictive(
                generator, Y_t, m_F, v_F, num_samples,
                reference_scaling=reference_scaling,
                eps=None if eps is None else eps[i])
    return -total
