"""The evidence lower bound and the posterior moments of the latent functions.

Counterpart of ``hetmogp_tpu/models/elbo.py``:

    ELBO = sum_t scale_t * sum_i E_{q(f)}[log p(y_ti | f_ti)]
           - sum_q KL(q(u_q) || p(u_q)).

The projections have the JAX package's two paths.  With a cached inverse
(the trainer and ``make_serving_predictive``): P = Kfu @ iLuu^T, a
triangular projection kernel on CUDA float32 (at the config's
``ve_fwd_precision``); ``cache_grad=True`` is the VM step's path, where
the hyperparameter gradients flow through the cache by the cached-inverse
adjoints (``linalg.chol_cached``, ``linalg.solve_tri_cached``).  Without
one (``iLuu=None``: ``elbo_fn`` without a cache, the solve-path trainers
and the prediction entries of ``models/predict.py``): triangular solves
against Luu, per task, and no inverse is ever formed.  The
full-covariance moments (``latent_projections_full``,
``task_qf_full_cov``) are on the solve path only.  Both the whitened and
the un-whitened q(u) are supported, with ``whiten_params`` and
``unwhiten_params`` between them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from hetmogp_tpu_torch import profiling
from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.models.params import SVMOGPParams
from hetmogp_tpu_torch.ops import kernels, linalg, quadrature


class TaskData(NamedTuple):
    """One task's (mini)batch; mask weights each row's VE term (1/0)."""

    X: torch.Tensor  # (N_t, Dx)
    Y: torch.Tensor  # (N_t, dim_y)
    mask: torch.Tensor  # (N_t,)


def task_data(X, Y, mask=None, dtype=None, device="cuda") -> TaskData:
    """One task's rows as tensors on ``device`` (the card unless the caller
    names another), Y as a column, mask 1 unless given."""
    X = torch.as_tensor(X, dtype=dtype, device=device)
    Y = torch.as_tensor(Y, dtype=X.dtype, device=X.device)
    if Y.ndim == 1:
        Y = Y[:, None]
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    return TaskData(X, Y, torch.as_tensor(mask, dtype=X.dtype,
                                          device=X.device))


def _jittered_gram(params: SVMOGPParams, config: ModelConfig) -> torch.Tensor:
    Kuu = kernels.K_gram_batched(config.kernel, params.Z, params.lengthscale,
                                 params.variance)
    eye = torch.eye(Kuu.shape[-1], dtype=Kuu.dtype, device=Kuu.device)
    return Kuu + config.jitter * eye


def prior_cholesky(params: SVMOGPParams, config: ModelConfig,
                   cached=None, blocked: bool = False, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """Luu: (Q, M, M) lower Cholesky factors of Kuu_q + jitter I.

    cached: optional (Luu, iLuu) valid for the current hypers (the VM
    step): the forward reuses the factor, and the backward runs the
    Cholesky pullback as triangular products against the cached inverse,
    at the config's ``ve_fwd_precision`` (``linalg.chol_cached``;
    ``use_kernel=False`` takes their plain versions).
    ``config.chol_dtype="float64"`` on a float32 model factorizes in
    float64 (``linalg.chol_mixed``) at the fixed jitter.  blocked: the
    factorization by ``linalg.blocked_cholesky`` (kernel 9 on its
    diagonal panels; the trainer's init and its refresh without an
    inverse), taken only at fixed jitter in the working dtype, as the JAX
    package's ``blocked=True``.  Otherwise ``config.adaptive_jitter``
    escalates the jitter where the factorization fails
    (``linalg.jitchol``, which reads ``info`` on the host).
    """
    if cached is not None:
        return linalg.chol_cached(_jittered_gram(params, config), *cached,
                                  precision=config.projection_precision,
                                  use_kernel=use_kernel)
    if _float64_island(params, config):
        return linalg.chol_mixed(_jittered_gram(params, config))
    if blocked and not config.adaptive_jitter:
        return linalg.blocked_cholesky(_jittered_gram(params, config))
    if config.adaptive_jitter:
        Kuu = kernels.K_gram_batched(config.kernel, params.Z,
                                     params.lengthscale, params.variance)
        return linalg.jitchol(Kuu, jitter=config.jitter, adaptive=True)
    return linalg.cholesky(_jittered_gram(params, config))


def _float64_island(params: SVMOGPParams, config: ModelConfig) -> bool:
    return (config.chol_dtype == "float64"
            and params.Z.dtype != torch.float64)


def prior_cholesky_inverse(params: SVMOGPParams, config: ModelConfig):
    """(Luu, Luu^{-1}) of Kuu + jitter I, each (Q, M, M): the fused,
    blocked factorization and inverse (``linalg.blocked_cholesky_inverse``:
    kernel 9 on the diagonal panels) at fixed jitter in the working dtype,
    else ``prior_cholesky`` (the float64 island, or the adaptive
    ``jitchol``) and the recursive inverse.  No gradient: the VM step
    differentiates through ``chol_cached`` against this cache."""
    if not config.adaptive_jitter and not _float64_island(params, config):
        return linalg.blocked_cholesky_inverse(_jittered_gram(params, config))
    Luu = prior_cholesky(params, config)
    return Luu, linalg.tri_inverse(Luu)


def latent_projection_P(params: SVMOGPParams, config: ModelConfig,
                        Luu: torch.Tensor, X: torch.Tensor, iLuu=None, *,
                        precision: Optional[str] = None,
                        use_kernel: bool = True):
    """(P, kdiag) with P = (Luu^{-1} K_uf)^T, (Q, N, M), and the prior
    diagonal (Q, N): the whitened projection itself, for the
    natural-gradient step, which contracts P directly.  With ``iLuu`` P is
    the triangular projection at ``precision`` (by default the config's
    ``ve_fwd_precision``: kernel 3 at ``"high"``, kernel A at
    ``"highest"`` on CUDA float32), else a triangular solve against
    Luu."""
    Kfu = kernels.K_batched(config.kernel, X, params.Z, params.lengthscale,
                            params.variance, use_kernel=use_kernel)
    kdiag = kernels.Kdiag_batched(config.kernel, X, params.variance)
    if iLuu is not None:
        P = linalg.matmul_tril_t(Kfu, iLuu,
                                 precision=precision or config.projection_precision,
                                 use_kernel=use_kernel)
    else:
        P = linalg.solve_tri(Luu, Kfu.mT).mT
    return P, kdiag


def latent_projections(params: SVMOGPParams, config: ModelConfig,
                       Luu: torch.Tensor, X: torch.Tensor, iLuu=None,
                       *, cache_grad: bool = False, use_kernel: bool = True):
    """Per-latent projection terms at inputs X.

    Returns:
      mean_q:  (Q, N)  posterior mean of each latent projection
      gamma_q: (Q, N)  kdiag_q + diag(A S A^T) - diag(A Kuf), the per-latent
               variance before the mixing weights
      kdiag:   (Q, N)  prior diagonal per latent

    Whitened: P = (Luu^{-1} Kuf)^T.  Un-whitened: A = Kfu Kuu^{-1}.
    ``iLuu=None`` is the solve path: P by a triangular solve against Luu
    and A by a second, transposed one.  With ``iLuu`` (the cached inverse)
    P = Kfu @ iLuu^T and A = P @ iLuu are triangular products (A on kernel
    4, at "highest" as the JAX package forms it) and Luu is not read,
    unless ``cache_grad`` takes P through ``linalg.solve_tri_cached``, so
    that gradients reach Luu (and, by ``chol_cached``, the hypers) as well
    as Kfu.

    P feeds the kdiag - |P|^2 cancellation, so its matmul must not round
    its operands to one bf16 pass: the JAX package measured a relative
    error of 1.5e0 in P at M=1024 that way, against 2.3e-4 in full float32.
    Without ``cache_grad`` (the VE step and serving) P is formed at the
    config's ``ve_fwd_precision``: "high" is three bf16 passes, which the
    JAX package measured at 6.3e-3 relative in P and adopted for its bench
    after a 1,500-step trajectory A/B.  The VM step's solve stays at full
    float32, as the JAX package's does.
    """
    Kfu = kernels.K_batched(config.kernel, X, params.Z, params.lengthscale,
                            params.variance, use_kernel=use_kernel)  # (Q, N, M)
    kdiag = kernels.Kdiag_batched(config.kernel, X, params.variance)
    m_u, Lq = params.q_mu, torch.tril(params.q_sqrt)
    if iLuu is None:
        if cache_grad:
            raise ValueError("cache_grad=True needs the cached inverse iLuu")
        P = linalg.solve_tri(Luu, Kfu.mT).mT
    elif cache_grad:
        P = linalg.solve_tri_cached(Luu, Kfu, iLuu,
                                    precision=config.projection_precision,
                                    use_kernel=use_kernel)
    else:
        P = linalg.matmul_tril_t(Kfu, iLuu,
                                 precision=config.projection_precision,
                                 use_kernel=use_kernel)
    if config.whiten:
        mean_q = (P @ m_u[..., None])[..., 0]
        quad = linalg.quad_diag(P, Lq,
                                precision=config.projection_precision,
                                use_kernel=use_kernel)
        gamma_q = kdiag + quad - torch.sum(torch.square(P), dim=-1)
    else:
        if iLuu is None:
            A = linalg.solve_tri(Luu, P.mT, trans=True).mT
        else:
            A = linalg.matmul_tril(P, iLuu, use_kernel=use_kernel)
        mean_q = (A @ m_u[..., None])[..., 0]
        quad = linalg.quad_diag(A, Lq,
                                precision=config.projection_precision,
                                use_kernel=use_kernel)
        gamma_q = kdiag + quad - torch.sum(A * Kfu, dim=-1)
    return mean_q, gamma_q, kdiag


def task_qf_moments(params: SVMOGPParams, config: ModelConfig,
                    Luu: torch.Tensor, X: torch.Tensor, task: int, *,
                    iLuu=None, clip_variance: bool = True,
                    var_floor: float = 0.0, cache_grad: bool = False,
                    use_kernel: bool = True, comm=None):
    """Marginal moments (m_F, v_F), each (N, F_t), of q(f_d) for every
    parameter function d of one task; ``iLuu=None`` takes the solve path.
    ``comm``: a ``parallel.collectives.MeshComm``, under which params,
    Luu and iLuu are this rank's latents and the mixing sums over the
    latent axis."""
    part = latent_projections(params, config, Luu, X, iLuu,
                              cache_grad=cache_grad, use_kernel=use_kernel)
    return _mix_tasks([part], params, config, [task], comm=comm,
                      clip_variance=clip_variance, var_floor=var_floor)[0]


def _mix_tasks(parts, params, config, tasks, *, comm=None,
               clip_variance: bool = True, var_floor: float = 0.0):
    """Coregionalization mixing of per-latent projections into each task's
    (m_F, v_F): m_fd = sum_q w_qd mean_q,
    v_fd = sum_q (w_qd^2 gamma_q + kappa_qd kdiag_q), ``parts`` the tasks'
    (mean_q, gamma_q, kdiag).  Under ``comm`` the sums over q are this
    rank's latents', and one latent all-reduce (``reduce_from_latent``) of
    all of them completes every task's before the variance is clipped."""
    out = []
    for (mean_q, gamma_q, kdiag), task in zip(parts, tasks):
        start, stop = config.task_function_slices[task]
        Wt = params.W[:, start:stop]  # (Q, F_t)
        Kt = params.kappa[:, start:stop]
        out.append((mean_q.mT @ Wt,
                    gamma_q.mT @ torch.square(Wt) + kdiag.mT @ Kt))
    if comm is not None:
        flat = comm.latent_sum([t for pair in out for t in pair])
        out = list(zip(flat[0::2], flat[1::2]))
    if clip_variance:
        out = [(m_F, torch.clamp(v_F, min=var_floor)) for m_F, v_F in out]
    return out


def fused_task_moments(params: SVMOGPParams, config: ModelConfig, Luu,
                       data: Sequence[TaskData], iLuu, *,
                       cache_grad: bool = False, use_kernel: bool = True,
                       var_floor: float = 0.0, comm=None):
    """(m_F, v_F) for every task from one concatenated-rows projection: one
    Kfu build, one triangular projection and one ``quad_diag`` for all
    tasks' rows, then the per-task mixing on column slices
    (``config.fuse_task_rows``)."""
    X_all = torch.cat([td.X for td in data], dim=0)
    mean_q, gamma_q, kdiag = latent_projections(
        params, config, Luu, X_all, iLuu, cache_grad=cache_grad,
        use_kernel=use_kernel)
    parts, off = [], 0
    for td in data:
        sl = slice(off, off + td.X.shape[0])
        off = sl.stop
        parts.append((mean_q[:, sl], gamma_q[:, sl], kdiag[:, sl]))
    return _mix_tasks(parts, params, config, range(len(data)), comm=comm,
                      var_floor=var_floor)


def latent_projections_full(params: SVMOGPParams, config: ModelConfig,
                            Luu: torch.Tensor, X: torch.Tensor, *,
                            Kxx=None, use_kernel: bool = True):
    """Full-covariance analogue of ``latent_projections``, on the solve
    path.  ``Kxx``: the (Q, N, N) prior Gram at X where the caller has
    built it already (``task_qf_full_cov`` reads it again for the kappa
    term); None builds it here.

    Returns:
      mean_q: (Q, N) posterior means of the latent projections at X.
      cov_q:  (Q, N, N) full posterior covariances.

    Whitened: cov = Kxx + P S P^T - P P^T with P = (Luu^{-1} Kuf)^T.
    Un-whitened: cov = Kxx + A S A^T - A Kuf with A = Kfu Kuu^{-1}.  The
    three terms cancel as ``gamma_q`` does, so every product runs in full
    float32.
    """
    Kfu = kernels.K_batched(config.kernel, X, params.Z, params.lengthscale,
                            params.variance, use_kernel=use_kernel)
    if Kxx is None:
        Kxx = kernels.K_self_batched(config.kernel, X, params.lengthscale,
                                     params.variance, use_kernel=use_kernel)
    R = linalg.solve_tri(Luu, Kfu.mT)  # (Q, M, N)
    P = R.mT
    B = P if config.whiten else linalg.solve_tri(Luu, R, trans=True).mT
    mean_q = (B @ params.q_mu[..., None])[..., 0]
    BL = B @ torch.tril(params.q_sqrt)
    cov_q = Kxx + BL @ BL.mT
    cov_q = cov_q - (P @ P.mT if config.whiten else B @ Kfu.mT)
    return mean_q, cov_q


def task_qf_full_cov(params: SVMOGPParams, config: ModelConfig,
                     Luu: torch.Tensor, X: torch.Tensor, task: int, *,
                     use_kernel: bool = True):
    """Full-covariance q(f_d) for every parameter function d of a task.

    Returns (m_F, cov_F): (N, F_t) means and (F_t, N, N) covariances,
    cov_fd = sum_q (w_qd^2 cov_q + kappa_qd k_q(X, X)): kappa scales the
    full prior kernel of f_d with no posterior reduction, matching the
    marginal path's kappa * kdiag term.  The d-blocks are independent
    given the factorized q(u), so there is no cross-d covariance.
    """
    start, stop = config.task_function_slices[task]
    Wt = params.W[:, start:stop]  # (Q, F_t)
    Kt = params.kappa[:, start:stop]
    # one Gram build for the posterior covariance and the kappa term
    Kxx = kernels.K_self_batched(config.kernel, X, params.lengthscale,
                                 params.variance, use_kernel=use_kernel)
    mean_q, cov_q = latent_projections_full(params, config, Luu, X, Kxx=Kxx,
                                            use_kernel=use_kernel)
    m_F = mean_q.mT @ Wt
    cov_F = torch.einsum("qj,qnk->jnk", torch.square(Wt), cov_q)
    return m_F, cov_F + torch.einsum("qj,qnk->jnk", Kt, Kxx)


def kl_divergence(params: SVMOGPParams, config: ModelConfig,
                  Luu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_q KL(q(u_q) || p(u_q)).

    Whitened, p(v) = N(0, I) and Luu is not read:
      KL_q = 0.5 (||L~||_F^2 + ||m~||^2 - M - 2 sum log |diag L~|).
    Un-whitened, by triangular solves against Luu:
      tr(Kuu^{-1} S) = ||Luu^{-1} L||_F^2,  m^T Kuu^{-1} m = ||Luu^{-1} m||^2.
    """
    M = config.num_inducing
    Lq = torch.tril(params.q_sqrt)
    logdet_q = linalg.logdet_from_chol(Lq)
    if config.whiten:
        tr = torch.sum(torch.square(Lq), dim=(-2, -1))
        mah = torch.sum(torch.square(params.q_mu), dim=-1)
        return torch.sum(0.5 * (tr + mah - M - logdet_q))
    if Luu is None:
        raise ValueError("the un-whitened KL needs Luu")
    tr = torch.sum(torch.square(linalg.solve_tri(Luu, Lq)), dim=(-2, -1))
    mah = torch.sum(torch.square(linalg.solve_tri(Luu, params.q_mu[..., None])),
                    dim=(-2, -1))
    return torch.sum(0.5 * (tr + mah - M + linalg.logdet_from_chol(Luu)
                            - logdet_q))


def likelihood_term(params: SVMOGPParams, config: ModelConfig,
                    data: Sequence[TaskData], moments, scales: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """The ELBO's likelihood term: (T,) sums scales[t] * sum_n mask_t[n]
    var_exp_t[n] at each task's moments (m_F, v_F).

    The tasks whose likelihood has a device function in
    ``quadrature.TASK_FAMILIES`` and no trainable theta go to
    ``quadrature.task_var_exp`` together (on the card, one launch of
    kernel 6's task table, and one for the gradient); every other task
    calls its own ``var_exp`` (with ``params.lik_theta[t]`` where its
    family has theta) and takes its masked, scaled sum.  The program
    counters ``likelihood.table_tasks`` and ``likelihood.engine_tasks``
    (``profiling.count``) count the two kinds of task of each call.
    """
    theta = params.lik_theta
    table = [t for t, lik in enumerate(config.likelihoods)
             if quadrature.task_family(lik) is not None
             and not (theta is not None and lik.n_theta)]
    profiling.count("likelihood.table_tasks", len(table))
    profiling.count("likelihood.engine_tasks", len(data) - len(table))
    sums = {}
    if table:
        routed = quadrature.task_var_exp(
            [config.likelihoods[t] for t in table],
            [data[t].Y for t in table], [moments[t][0] for t in table],
            [moments[t][1] for t in table], [data[t].mask for t in table],
            [scales[t] for t in table], use_kernel=use_kernel)
        if len(table) == len(data):
            return routed
        sums = dict(zip(table, routed.unbind()))
    for t, (lik, td) in enumerate(zip(config.likelihoods, data)):
        if t in sums:
            continue
        if theta is not None and lik.n_theta:
            # the trainable likelihood parameters, with their gradient
            ve = lik.var_exp(td.Y, *moments[t], theta=theta[t],
                             use_kernel=use_kernel)
        else:
            ve = lik.var_exp(td.Y, *moments[t], use_kernel=use_kernel)
        sums[t] = scales[t] * torch.sum(ve * td.mask)
    return torch.stack([sums[t] for t in range(len(data))])


def elbo_fn(params: SVMOGPParams, data: Sequence[TaskData],
            scales: torch.Tensor, config: ModelConfig, Luu=None, iLuu=None,
            cache_grad: bool = False, use_kernel: bool = True, comm=None):
    """ELBO and per-task diagnostics.

    Args:
      data: one TaskData per task.
      scales: (T,) minibatch scales N_full_t / N_batch_t.
      Luu, iLuu: the cached (Luu, Luu^{-1}) for the current hypers.
        ``Luu=None`` factorizes here, differentiably (``prior_cholesky``),
        and forms no inverse; ``iLuu=None`` takes the solve path, per task
        (``config.fuse_task_rows`` applies only with ``iLuu``, as in the
        JAX package).
      cache_grad: the VM step's path: (Luu, iLuu) are value-correct caches
        and the hyperparameter gradients flow through them by the
        cached-inverse adjoints.  Needs both and the whitened model.
      use_kernel: False takes the plain PyTorch versions of the CUDA
        kernels on any device.
      comm: a ``parallel.collectives.MeshComm`` (``parallel.sharding.
        make_sharded_elbo``): params, Luu and iLuu are this rank's latents
        and data its rows.  The ELBO and aux are then the global values on
        every rank, and the ELBO's gradient on a rank is its part, which
        the data all-reduce of the gradients completes (the KL's counted on
        data rank 0 only).
    A task whose likelihood has theta (``n_theta`` > 0) takes it from
    ``params.lik_theta`` where that is not None.
    Returns:
      (elbo, aux) with aux = {'ve': (T,), 'kl': scalar}.

    Spans (``profiling``): ``elbo.projections`` (the prior factor, the KL
    and the moments), ``elbo.likelihood`` (``likelihood_term``); the
    moments' gradients end the backward's first span.  The KL is formed
    ahead of the moments: autograd runs the nodes it may run in the
    reverse order of their making, so the KL's backward waits until the
    moments' gradients have been taken on, and falls in the backward's
    second span.
    """
    if comm is not None:
        params = comm.view(params)
    if cache_grad:
        if Luu is None or iLuu is None:
            raise ValueError("cache_grad=True needs both Luu and iLuu")
        if not config.whiten:
            raise ValueError("cache_grad fast path requires config.whiten")
    with profiling.annotate("elbo.projections"):
        if cache_grad:
            Luu = prior_cholesky(params, config, cached=(Luu, iLuu),
                                 use_kernel=use_kernel)
        elif Luu is None:
            Luu = prior_cholesky(params, config)
        kl = kl_divergence(params, config, Luu)
        if config.fuse_task_rows and iLuu is not None:
            moments = fused_task_moments(params, config, Luu, data, iLuu,
                                         cache_grad=cache_grad,
                                         use_kernel=use_kernel, comm=comm)
        else:
            moments = _mix_tasks(
                [latent_projections(params, config, Luu, td.X, iLuu,
                                    cache_grad=cache_grad,
                                    use_kernel=use_kernel)
                 for td in data], params, config, range(len(data)),
                comm=comm)
    moments = profiling.split_backward(moments)
    with profiling.annotate("elbo.likelihood"):
        ve_sums = likelihood_term(params, config, data, moments, scales,
                                  use_kernel=use_kernel)
    if comm is not None:
        ve_sums, kl = comm.reduce_metrics(ve_sums, kl)
    return torch.sum(ve_sums) - kl, {"ve": ve_sums, "kl": kl}


def build_elbo(config: ModelConfig):
    """elbo(params, data, scales) -> (elbo, aux): ``elbo_fn`` with the
    static config closed over."""

    def f(params, data, scales):
        return elbo_fn(params, data, scales, config)

    return f


def batch_qf_moments(params: SVMOGPParams, config: ModelConfig, X_list,
                     tasks: Optional[Sequence[int]] = None, *,
                     use_kernel: bool = True):
    """q(f) moments (m_F, v_F) of several tasks at once, on the solve path:
    one factorization, then ``task_qf_moments`` for each task of ``tasks``
    (all by default) at its X, taken to the params' device and dtype."""
    Luu = prior_cholesky(params, config)
    tasks = range(config.num_tasks) if tasks is None else tasks
    return [task_qf_moments(params, config, Luu,
                            torch.as_tensor(X, dtype=params.Z.dtype,
                                            device=params.Z.device), t,
                            use_kernel=use_kernel)
            for t, X in zip(tasks, X_list)]


def whiten_params(params: SVMOGPParams,
                  config: ModelConfig) -> SVMOGPParams:
    """Un-whitened (m, L) to the whitened coordinates v = Luu^{-1} u; the
    ELBO is invariant under the map."""
    Luu = prior_cholesky(params, config)
    return dataclasses.replace(
        params, q_mu=linalg.solve_tri(Luu, params.q_mu[..., None])[..., 0],
        q_sqrt=linalg.solve_tri(Luu, torch.tril(params.q_sqrt)))


def unwhiten_params(params: SVMOGPParams,
                    config: ModelConfig) -> SVMOGPParams:
    """The inverse of ``whiten_params``: u = Luu v."""
    Luu = prior_cholesky(params, config)
    return dataclasses.replace(
        params, q_mu=(Luu @ params.q_mu[..., None])[..., 0],
        q_sqrt=Luu @ torch.tril(params.q_sqrt))
