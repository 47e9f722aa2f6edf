"""Dense linear algebra of the serving, prediction and training paths.

Counterpart of ``hetmogp_tpu/ops/linalg.py``, with its packing helpers
(``pack_tril``, in GPy's order) and its float64 island (``chol_mixed``).
The JAX package blocks these by hand for the
TPU's matrix unit; here the factorizations and solves are plain PyTorch
calls (cuSOLVER and cuBLAS on the card: ``solve_tri`` is ``trsm``, which
the JAX package too computes outside any Pallas kernel), and the products
against a triangular factor, which the JAX package blocks to skip the
factor's zero blocks, are hand-written kernels for CUDA float32 tensors
that skip them too (``ops/cuda_dispatch.py`` decides):

* ``matmul_tril_t``, the projection A tril(L)^T: kernel A
  (``csrc/tril_proj_kernel.cu``) in float32, kernel 3
  (``csrc/tril_proj3_kernel.cu``) in three bf16 passes at
  ``precision="high"``;
* ``matmul_tril`` and ``tril_t_matmul``, A tril(L) and tril(L)^T B:
  kernel 4 (``csrc/tril_right_kernel.cu``) in float32, kernel 5
  (``csrc/tril_right3_kernel.cu``) in three bf16 passes at ``"high"``;
* ``quad_diag``: kernel 4 with the square and the row sum fused, its L
  gradient kernel 8;
* ``t_matmul_tril_out``, tril(A^T B) with only the lower tiles formed:
  kernel 8 (``csrc/tril_out_kernel.cu``) in float32, or in three bf16
  passes at ``"high"`` (the L cotangents of ``quad_diag``, of
  ``solve_tri_cached`` and of the products above).

``tri_inverse`` is ``rec_tri_inverse``, the JAX package's recursive
blocked inverse: one batched ``trsm`` at the leaves, then its corners as
kernels 4 and A.  ``tril_matmul`` stays a masked cuBLAS product.  Float32
matmuls must run in full float32: TF32 ruins the projection P = Kfu @
iLuu^T (see ``models/elbo.py``), so nothing here may run under
``torch.set_float32_matmul_precision("high")`` (TF32, not the 3-pass
``precision="high"`` of the triangular products).

``chol_cached`` and ``solve_tri_cached`` are the trainer's cached-inverse
adjoints (``autograd.Function``s with the JAX custom VJPs' algebra): the
VM step differentiates through the Cholesky and the projection with
matmuls against the cached (Luu, Luu^{-1}) instead of a new factorization
and triangular solves.  Their triangular products run at the
``precision`` they are given (the config's ``ve_fwd_precision``): at
``"high"`` in three bf16 passes, as the JAX package's run at
``Precision.HIGH``.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from hetmogp_tpu_torch.ops import cuda_dispatch


def tril_indices(m: int):
    """Row-major lower-triangle index order: (0,0), (1,0), (1,1), (2,0), ...

    GPy's ``choleskies._flat_to_triang_pure`` order, the JAX package's, so
    that packed vectors interchange with both.
    """
    return np.tril_indices(m)


def pack_tril(L: torch.Tensor) -> torch.Tensor:
    """(..., M, M) lower-triangular -> (..., M(M+1)/2) flat packing."""
    rows, cols = tril_indices(L.shape[-1])
    return L[..., rows, cols]


def unpack_tril(flat: torch.Tensor, m: int) -> torch.Tensor:
    """(..., M(M+1)/2) -> (..., M, M) lower-triangular (zeros above)."""
    rows, cols = tril_indices(m)
    out = flat.new_zeros(flat.shape[:-1] + (m, m))
    out[..., rows, cols] = flat
    return out


def tril_param(L: torch.Tensor) -> torch.Tensor:
    """A dense square parameter projected onto its lower triangle: the
    strictly upper entries of a stored (Q, M, M) factor are inert."""
    return torch.tril(L)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., M, M) SPD K; a factorization that
    fails gives NaNs, not an exception, and no host synchronisation (the
    JAX package's fixed-jitter ``jitchol``)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


_DEVICE_SIDE_JITCHOL = contextvars.ContextVar("device_side_jitchol",
                                               default=False)


@contextlib.contextmanager
def device_side_jitchol():
    """Inside the block, ``jitchol(adaptive=True)`` picks its jitter level on
    the device: it factorizes at every level and keeps, per batch member,
    the first that succeeds, with no host read and no data-dependent
    branch (what ``torch.export`` can trace).  The same levels, so the
    same factor as the host loop, at maxtries + 1 factorizations a call."""
    token = _DEVICE_SIDE_JITCHOL.set(True)
    try:
        yield
    finally:
        _DEVICE_SIDE_JITCHOL.reset(token)


def _jitter_level_on_device(Ksg, eye, diag_mean, maxtries: int):
    """The escalation level of each batch member without a host read: the
    first of 0, mean(diag) * 1e-6 * 10^i (i < maxtries) at which
    ``cholesky_ex`` succeeds, the last where none does."""
    levels = [torch.zeros_like(diag_mean)] + [
        diag_mean * (1e-6 * 10.0 ** i) for i in range(maxtries)]
    level, found = levels[-1], torch.zeros_like(diag_mean, dtype=torch.bool)
    for lev in levels[:-1]:
        ok = torch.linalg.cholesky_ex(Ksg + lev[..., None, None] * eye)[1] == 0
        level = torch.where(found | ~ok, level, lev)
        found = found | ok
    return level


def jitchol(K: torch.Tensor, jitter: float = 0.0, adaptive: bool = True,
            maxtries: int = 5) -> torch.Tensor:
    """Batched Cholesky with escalating jitter on failure.

    GPy's ``jitchol`` policy, as the JAX package has it: try K + jitter I
    first, then give each batch member that failed mean(diag) * 1e-6 * 10^i
    more, i = 0 .. maxtries - 1, until every member factorizes.  The level
    is found without gradient, on ``cholesky_ex``'s ``info`` in a host loop
    (one synchronisation per try: this runs outside any captured graph),
    or on the device inside ``device_side_jitchol()``; then one
    differentiable Cholesky of K + (jitter + level) I is returned, NaN
    where even the last level failed.

    Args:
      K: (..., M, M) SPD matrices.
      jitter: base jitter added unconditionally.
      adaptive: False returns the single Cholesky of K + jitter I.
    """
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    K0 = K + jitter * eye if jitter else K
    if not adaptive:
        return cholesky(K0)
    if _DEVICE_SIDE_JITCHOL.get():
        with torch.no_grad():
            Ksg = K0.detach()
            diag_mean = torch.mean(torch.diagonal(Ksg, dim1=-2, dim2=-1),
                                   dim=-1)
            level = _jitter_level_on_device(Ksg, eye, diag_mean, maxtries)
        return cholesky(K0 + level[..., None, None] * eye)
    with torch.no_grad():
        Ksg = K0.detach()
        diag_mean = torch.mean(torch.diagonal(Ksg, dim1=-2, dim2=-1), dim=-1)
        level = torch.zeros_like(diag_mean)
        ok = torch.linalg.cholesky_ex(Ksg)[1] == 0
        for i in range(maxtries):
            if bool(ok.all()):
                break
            level = torch.where(ok, level, diag_mean * (1e-6 * 10.0 ** i))
            ok = ok | (torch.linalg.cholesky_ex(
                Ksg + level[..., None, None] * eye)[1] == 0)
    return cholesky(K0 + level[..., None, None] * eye)


def solve_tri(L: torch.Tensor, B: torch.Tensor, *,
              trans: bool = False) -> torch.Tensor:
    """Batched lower-triangular solve: L X = B (or L^T X = B if ``trans``).

    L: (..., M, M) lower-triangular; B: (..., M, N).
    """
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def cho_solve_batched(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given lower Cholesky factors; batched."""
    return solve_tri(L, solve_tri(L, B), trans=True)


def rec_tri_inverse(L: torch.Tensor, leaf: int = 128) -> torch.Tensor:
    """tril(L)^{-1} of (..., m, m) lower-triangular L, by recursive
    blocking: the JAX package's ``rec_tri_inverse``.

    inv([[A, 0], [B, C]]) = [[iA, 0], [-iC B iA, iC]].  The two half-size
    inverses are independent, so each level stacks A and C into the batch
    axis (a contiguous copy): one batched triangular solve against I at
    the leaves (m <= ``leaf`` or m odd), then per level the corner as two
    triangular products of the level's whole batch, flattened into their
    Q: X = B tril(iA) (``matmul_tril``: kernel 4 for CUDA float32) and
    iC X = (X^T tril(iC)^T)^T (``matmul_tril_t``: kernel A), in full
    float32 as the JAX package's ``_CHOL = HIGHEST``.  Float64 takes the
    products' plain versions.  At M = 1024: leaves of 32 blocks of 128 at
    Q = 4, then products at (16, 128, 128), (8, 256, 256) and
    (4, 512, 512).  A NaN in L (a failed factorization) gives NaNs in
    every block it reaches; no host synchronisation, so a captured graph
    takes it.
    """
    m = L.shape[-1]
    if m <= leaf or m % 2:
        eye = torch.eye(m, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye.expand_as(L),
                                             upper=False)
    h = m // 2
    inv = rec_tri_inverse(torch.stack([L[..., :h, :h], L[..., h:, h:]]),
                          leaf=leaf)
    iA, iC = inv[0], inv[1]
    kw = dict(use_kernel=L.dtype == torch.float32)
    X = matmul_tril(L[..., h:, :h].reshape(-1, h, h), iA.reshape(-1, h, h),
                    **kw)
    corner = -matmul_tril_t(X.mT, iC.reshape(-1, h, h), **kw).mT
    top = torch.cat([iA, torch.zeros_like(iA)], dim=-1)
    bottom = torch.cat([corner.reshape(iC.shape), iC], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def tri_inverse(L: torch.Tensor) -> torch.Tensor:
    """tril(L)^{-1} of (..., M, M) lower-triangular L: ``rec_tri_inverse``
    (kernels 4 and A around a batched ``trsm`` of the leaves)."""
    return rec_tri_inverse(L)


def blocked_cholesky_inverse(K: torch.Tensor):
    """(chol(K), inv(chol(K))) for (..., M, M) SPD K.

    The contract of the JAX ``blocked_cholesky_inverse``: both factors come
    back lower-triangular, and a factorization that fails surfaces as NaNs
    in both, not as an exception (and without a host synchronisation).
    """
    L = cholesky(K)
    return L, tri_inverse(L)


def matmul_tril_t(A: torch.Tensor, L: torch.Tensor, *,
                  precision: str = "highest",
                  use_kernel: bool = True) -> torch.Tensor:
    """A @ tril(L)^T: (Q, N, M), (Q, M, M) -> (Q, N, M), the projection
    P = Kfu iLuu^T.  out[..., n, k] = sum_{m <= k} A[..., n, m] L[..., k, m].

    precision: "highest" multiplies in full float32; "high" (float32 only)
      in three bf16 passes of the bit-mask split, hi*lo + lo*hi + hi*hi
      (the JAX package's ``Precision.HIGH``).  Float64 runs at full
      precision either way: the split is a float32 scheme, and the JAX
      package's float64 products ignore the precision too.
    CUDA float32 runs the matching kernel, which skips L's zero blocks;
    CPU tensors (or ``use_kernel=False``) its plain version.
    """
    return cuda_dispatch.matmul_tril_t(A, L, precision=precision,
                                       use_kernel=use_kernel)


def matmul_tril(A: torch.Tensor, L: torch.Tensor, *,
                precision: str = "highest",
                use_kernel: bool = True) -> torch.Tensor:
    """A @ tril(L): (Q, N, M), (Q, M, M) -> (Q, N, M),
    out[..., n, k] = sum_{m >= k} A[..., n, m] L[..., m, k].

    precision: as ``matmul_tril_t``'s ("high": three bf16 passes, float32
      only).  CUDA float32 runs kernel 4 ("highest") or kernel 5 ("high"),
      which skip L's zero blocks; CPU tensors (or ``use_kernel=False``)
      their plain versions.
    """
    return cuda_dispatch.matmul_tril(A, L, precision=precision,
                                     use_kernel=use_kernel)


def t_matmul_tril_out(A: torch.Tensor, B: torch.Tensor, *,
                      precision: str = "highest",
                      use_kernel: bool = True) -> torch.Tensor:
    """tril(A^T B): (Q, N, M), (Q, N, M) -> (Q, M, M), out[..., m1, m2] =
    sum_n A[..., n, m1] B[..., n, m2] for m1 >= m2 and exact zeros above
    the diagonal, with only the lower tiles formed (the JAX package's
    ``t_matmul_tril_out``).

    precision: as ``matmul_tril_t``'s ("high": three bf16 passes, float32
      only; float64 ignores it).  CUDA float32 runs kernel 8, CPU tensors
      (or ``use_kernel=False``) its plain versions.  No gradient: it is a
      backward's product (a gradient through the kernel raises).
    """
    return cuda_dispatch.t_matmul_tril_out(A, B, precision=precision,
                                           use_kernel=use_kernel)


def tril_matmul(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """tril(L) @ B."""
    return torch.tril(L) @ B


def tril_t_matmul(L: torch.Tensor, B: torch.Tensor, *,
                  precision: str = "highest",
                  use_kernel: bool = True) -> torch.Tensor:
    """tril(L)^T @ B = (B^T tril(L))^T: ``matmul_tril``'s kernels, on B^T
    (one transposed copy of each operand at the (Q, M, M) shapes where it
    runs)."""
    return matmul_tril(B.mT, L, precision=precision,
                       use_kernel=use_kernel).mT


def _phi(A: torch.Tensor) -> torch.Tensor:
    """Lower triangle with halved diagonal (Cholesky pullback helper)."""
    return torch.tril(A) - 0.5 * torch.diag_embed(
        torch.diagonal(A, dim1=-2, dim2=-1))


class _CholMixed(torch.autograd.Function):

    @staticmethod
    def forward(ctx, K):
        L = cholesky(K.double()).to(K.dtype)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        # the Cholesky pullback Kbar = 0.5 (S + S^T),
        # S = L^{-T} Phi(L^T gL) L^{-1}, by two triangular solves
        (L,) = ctx.saved_tensors
        P = _phi(L.mT @ gL)
        T1 = solve_tri(L, P, trans=True)  # L^{-T} P
        S = solve_tri(L, T1.mT, trans=True).mT  # T1 L^{-1}
        return 0.5 * (S + S.mT)


def chol_mixed(K: torch.Tensor) -> torch.Tensor:
    """Cholesky with a float64 forward and a working-dtype backward.

    For float32 K the factor is computed in float64 and cast down, which
    recovers the half of the significand a float32 factorization loses at
    cond(K) ~ 1e6; the backward is the standard Cholesky pullback with
    triangular solves in K's dtype.  A factorization that fails gives NaNs
    (``cholesky``), with no host read, so the island runs inside a captured
    graph.  Float64 K takes the plain factorization.
    """
    if K.dtype == torch.float64:
        return cholesky(K)
    return _CholMixed.apply(K)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| from A = L L^T; batched over leading dims -> (...,)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(torch.abs(d)), dim=-1)


class _CholCached(torch.autograd.Function):

    @staticmethod
    def forward(ctx, K, L, iL, precision, use_kernel):
        ctx.save_for_backward(L, iL)
        ctx.kw = dict(precision=precision, use_kernel=use_kernel)
        return L

    @staticmethod
    def backward(ctx, gL):
        L, iL = ctx.saved_tensors
        P = _phi(tril_t_matmul(L, gL, **ctx.kw))
        # L^{-T} P L^{-1}
        S = matmul_tril(tril_t_matmul(iL, P, **ctx.kw), iL, **ctx.kw)
        return 0.5 * (S + S.mT), None, None, None, None


def chol_cached(K: torch.Tensor, L: torch.Tensor, iL: torch.Tensor, *,
                precision: str = "highest",
                use_kernel: bool = True) -> torch.Tensor:
    """Cholesky of K with a precomputed factor ``L`` and inverse ``iL``.

    Forward: returns ``L`` (the caller guarantees it is chol(K) up to
    roundoff).  Backward: the Cholesky pullback Kbar = 0.5 (S + S^T),
    S = L^{-T} Phi(L^T Lbar) L^{-1}, as three triangular products against
    L and ``iL`` at ``precision`` (kernels 4 or 5 for CUDA float32; the
    JAX package runs them at ``Precision.HIGH``).  L and iL are caches and
    get no gradient.
    """
    return _CholCached.apply(K, L, iL, precision, use_kernel)


class _SolveTriCached(torch.autograd.Function):

    @staticmethod
    def forward(ctx, L, Kfu, iL, use_kernel, precision):
        P = matmul_tril_t(Kfu, iL, use_kernel=use_kernel)
        ctx.save_for_backward(P, iL)
        ctx.kw = dict(precision=precision, use_kernel=use_kernel)
        return P

    @staticmethod
    def backward(ctx, gP):
        P, iL = ctx.saved_tensors
        gKfu = matmul_tril(gP, iL, **ctx.kw)  # (L^{-T} ybar)^T
        gL = -t_matmul_tril_out(gKfu, P.detach(), **ctx.kw)
        return gL, gKfu, None, None, None


def solve_tri_cached(L: torch.Tensor, Kfu: torch.Tensor, iL: torch.Tensor, *,
                     precision: str = "highest",
                     use_kernel: bool = True) -> torch.Tensor:
    """P = (L^{-1} Kfu^T)^T = Kfu iL^T through the cached inverse ``iL``.

    The JAX ``solve_tri_cached(L, Kfu^T, iL)`` in the (Q, N, M) layout of
    Kfu, returning P rather than its transpose.  Forward: the triangular
    projection in full float32 (the kernel for CUDA float32).  Backward,
    the exact solve adjoints with y = P^T: Kfubar = Pbar iL, a triangular
    product at ``precision``, and Lbar = -tril(Kfubar^T P), the lower
    tiles alone (kernel 8) at ``precision``, as the JAX package's
    ``Precision.HIGH``; iL is a cache and gets no gradient.
    """
    return _SolveTriCached.apply(L, Kfu, iL, use_kernel, precision)


def quad_diag(A: torch.Tensor, L: torch.Tensor, *,
              precision: str = "highest",
              use_kernel: bool = True) -> torch.Tensor:
    """diag(A L L^T A^T), batched: (Q, N, M), (Q, M, M) -> (Q, N).

    Only the lower triangle of L is read.  CUDA float32 runs kernel 4 with
    the square and the row sum fused, in full float32 (the JAX package
    runs this product at its default precision); CPU tensors (or
    ``use_kernel=False``) the plain version.  Without a gradient to form,
    A tril(L) never reaches memory.  ``precision`` is the L gradient's
    (kernel 8, tril(A^T dAL): "high" is three bf16 passes, stricter than
    the JAX package's one-pass default); the forward stays float32.
    """
    return cuda_dispatch.quad_diag(A, L, precision=precision,
                                   use_kernel=use_kernel)
