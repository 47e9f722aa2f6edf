"""tril(A^T B) with only the lower tiles formed (kernel 8,
``csrc/tril_out_kernel.cu``: ``t_matmul_tril_out``, in float32 and in
three bf16 passes) and the recursive triangular inverse on kernels 4 and A
(``rec_tri_inverse``, which ``tri_inverse`` is), against the JAX package
on the same numpy inputs.

The kernels run only on the card; here the CPU tensors take their plain
versions through the same operators and ``autograd.Function``s.  The JAX
``t_matmul_tril_out`` takes its blocked path at M = 512 (256-wide column
blocks below the diagonal) and its dense one at M = 8 and the ragged 100.

Tolerances, normwise max|a - b| / max|b|:
* 1e-12 in float64 for the product, where the two packages run the same
  sums in another blocking; 1e-11 for quad_diag's gradients (one more
  product), 1e-10 for the cached Lbar and the inverse (a product of
  inverses of a factor of condition ~10);
* 1e-5 in float32 (both in full float32, summed in other orders:
  ~sqrt(N) eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetmogp_tpu.ops import linalg as jlinalg
from hetmogp_tpu_torch.ops import cuda_kernels, linalg

torch.set_num_threads(1)  # the file runs beside others under xdist

Q, N = 2, 40
SIZES = [8, 512, 100]  # dense, blocked, ragged
F64, F32 = 1e-12, 1e-5


def _normwise(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a, dtype=np.float64):
    return torch.from_numpy(np.ascontiguousarray(a).astype(dtype))


def _factor(m, q=Q, seed=0):
    """A well-conditioned lower-triangular (q, m, m) factor."""
    rng = np.random.RandomState(seed)
    return np.tril(rng.randn(q, m, m)) / np.sqrt(m) + 2.0 * np.eye(m)


class _Ops(TorchDispatchMode):
    """Counts the ``hetmogp::`` operators that run inside it."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split(".")[0]
        if name.startswith("hetmogp::"):
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# ---- t_matmul_tril_out -------------------------------------------------------

@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
def test_t_matmul_tril_out_matches_jax(dtype, tol, M):
    rng = np.random.RandomState(M)
    A, B = rng.randn(Q, N, M).astype(dtype), rng.randn(Q, N, M).astype(dtype)
    want = np.asarray(jlinalg.t_matmul_tril_out(jnp.asarray(A),
                                                jnp.asarray(B)))
    with _Ops() as ops:
        got = linalg.t_matmul_tril_out(_t(A, dtype), _t(B, dtype))
    assert ops.seen == {"hetmogp::t_matmul_tril_out": 1}
    assert got.dtype == _t(A, dtype).dtype and got.shape == (Q, M, M)
    assert _normwise(got, want) < tol
    # exact zeros above the diagonal, on both sides
    assert not torch.any(torch.triu(got, 1))
    assert not np.any(np.triu(want, 1))
    # the plain versions, without the operator
    with _Ops() as ops:
        plain = linalg.t_matmul_tril_out(_t(A, dtype), _t(B, dtype),
                                         use_kernel=False)
    assert not ops.seen and torch.equal(plain, got)


@pytest.mark.parametrize("M", SIZES)
def test_high_is_the_3pass_product_in_float32_and_exact_in_float64(M):
    rng = np.random.RandomState(M + 1)
    A, B = rng.randn(Q, N, M), rng.randn(Q, N, M)
    with _Ops() as ops:
        got = linalg.t_matmul_tril_out(_t(A, np.float32), _t(B, np.float32),
                                       precision="high")
    assert ops.seen == {"hetmogp::t_matmul_tril_out_3pass": 1}
    assert torch.equal(got, cuda_kernels.t_matmul_tril_out_3pass_plain(
        _t(A, np.float32), _t(B, np.float32)))
    assert not torch.any(torch.triu(got, 1))
    # float64 ignores the precision, as the JAX package's products do
    f64 = linalg.t_matmul_tril_out(_t(A), _t(B), precision="high")
    assert torch.equal(f64, linalg.t_matmul_tril_out(_t(A), _t(B)))
    with pytest.raises(ValueError, match="precision"):
        linalg.t_matmul_tril_out(_t(A), _t(B), precision="default")


def _np_split(x):
    """The bit-mask split in numpy: hi = x with its low 16 bits cleared,
    lo = bf16_rn(x - hi), both as float64."""
    hi = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    lo = np.asarray(jnp.asarray(x - hi).astype(jnp.bfloat16), np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


@pytest.mark.parametrize("M", SIZES)
def test_3pass_plain_matches_a_numpy_model(M):
    """lo*hi + hi*lo + hi*hi of both operands' splits, each product of
    bf16 values exact in float64: the plain version sums them in float32,
    within ~sqrt(N) eps of the model; a 3-pass product, ~2^-16 from the
    unsplit float64 one, far nearer than a 1-pass bf16 product."""
    rng = np.random.RandomState(M + 2)
    A = rng.randn(Q, N, M).astype(np.float32)
    B = rng.randn(Q, N, M).astype(np.float32)
    (ahi, alo), (bhi, blo) = _np_split(A), _np_split(B)
    T = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    model = np.tril(T(alo) @ bhi + T(ahi) @ blo + T(ahi) @ bhi)
    got = cuda_kernels.t_matmul_tril_out_3pass_plain(_t(A, np.float32),
                                                     _t(B, np.float32))
    assert _normwise(got, model) < 1e-6
    exact = np.tril(T(A.astype(np.float64)) @ B.astype(np.float64))
    A1, B1 = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float64)
              for x in (A, B))
    one = np.tril(T(A1) @ B1)  # a 1-pass bf16 product
    assert _normwise(got, exact) < _normwise(one, exact) / 16
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.t_matmul_tril_out_3pass_plain(_t(A), _t(B))


def test_gradient_through_the_operator_raises():
    """The operators record no backward: a gradient through the kernel's
    entry raises rather than being dropped."""
    A = _t(np.ones((1, 3, 4))).requires_grad_()
    out = linalg.t_matmul_tril_out(A, _t(np.ones((1, 3, 4))))
    with pytest.raises(RuntimeError, match="autograd"):
        out.sum().backward()


# ---- the L gradients: quad_diag and the cached solve ------------------------

def _quad_inputs(M, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(Q, N, M)
    L = _factor(M, seed=seed + 1)
    return A, L, rng.randn(Q, N)


def _jax_grad(fn, A, L, c):
    return jax.grad(lambda a, l: jnp.sum(jnp.asarray(c) * fn(a, l)),
                    argnums=(0, 1))(jnp.asarray(A), jnp.asarray(L))


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_quad_diag_gradients_match_jax_quad_diag_train(precision, M):
    """quad_diag's backward (gA by kernel A, gL = tril(A^T dAL) by kernel
    8) against jax.grad of the JAX ``quad_diag_train`` (whose gL is
    ``t_matmul_tril_out``) and of ``quad_diag`` (its custom JVP's dense
    product and mask), in float64 at both precisions."""
    A, L, c = _quad_inputs(M, seed=M)
    grads = {}
    for name, fn in (("train", jlinalg.quad_diag_train),
                     ("jvp", jlinalg.quad_diag)):
        grads[name] = [np.asarray(g) for g in _jax_grad(fn, A, L, c)]
    a, l = _t(A).requires_grad_(), _t(L).requires_grad_()
    with _Ops() as ops:
        gA, gL = torch.autograd.grad(
            linalg.quad_diag(a, l, precision=precision), (a, l), _t(c))
    assert ops.seen == {"hetmogp::quad_diag_product": 1,
                        "hetmogp::tril_projection": 1,
                        "hetmogp::t_matmul_tril_out": 1}
    for wA, wL in grads.values():
        assert _normwise(gA, wA) < 1e-11
        assert _normwise(gL, np.tril(wL)) < 1e-11
    assert not torch.any(torch.triu(gL, 1))


def test_quad_diag_gl_at_high_is_the_3pass_product_in_float32():
    """In float32 at "high" gL is kernel 8's three passes (its plain
    version on the CPU) of A and dAL = 2 c (A tril(L)); at "highest" the
    float32 product."""
    A, L, c = _quad_inputs(64, seed=9)
    A32, L32, c32 = (_t(x, np.float32) for x in (A, L, c))
    dAL = 2.0 * c32[..., None] * (A32 @ torch.tril(L32))
    for precision, want in (
            ("high", cuda_kernels.t_matmul_tril_out_3pass_plain(A32, dAL)),
            ("highest", cuda_kernels.t_matmul_tril_out_plain(A32, dAL))):
        l = L32.clone().requires_grad_()
        (gL,) = torch.autograd.grad(
            linalg.quad_diag(A32, l, precision=precision), l, c32)
        torch.testing.assert_close(gL, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_solve_tri_cached_lbar_matches_jax(precision, M):
    """Lbar = -tril(Bbar y^T) of the cached solve, against the JAX
    ``_solve_tri_cached_bwd`` on the same (y, iL) and cotangent, in
    float64; at "highest" and "high" it is kernel 8's operator."""
    rng = np.random.RandomState(M + 3)
    L = _factor(M, seed=M + 4)
    iL = np.tril(np.linalg.inv(L))
    Kfu = rng.randn(Q, N, M)
    ybar = rng.randn(Q, M, N)
    y = iL @ np.swapaxes(Kfu, -1, -2)
    wL, wB, _ = jlinalg._solve_tri_cached_bwd(
        (jnp.asarray(y), jnp.asarray(iL)), jnp.asarray(ybar))
    l, kfu = _t(L).requires_grad_(), _t(Kfu).requires_grad_()
    with _Ops() as ops:
        P = linalg.solve_tri_cached(l, kfu, _t(iL), precision=precision)
        gl, gk = torch.autograd.grad(P, (l, kfu), _t(ybar).mT)
    assert ops.seen["hetmogp::t_matmul_tril_out"] == 1
    assert _normwise(gl, wL) < 1e-10
    assert _normwise(gk.mT, wB) < 1e-10
    assert not torch.any(torch.triu(gl, 1))


# ---- the recursive inverse ---------------------------------------------------

@pytest.mark.parametrize("m", [100, 512])
def test_rec_tri_inverse_matches_jax(m):
    """The same recursion as the JAX ``rec_tri_inverse(L, leaf=64)``, in
    float64: leaves of a batched solve, corners as triangular products;
    its residual ||tril(L) iL - I|| and exact zeros above the diagonal."""
    L = _factor(m, q=3, seed=m)
    want = np.asarray(jlinalg.rec_tri_inverse(jnp.asarray(L), leaf=64))
    got = linalg.rec_tri_inverse(_t(L), leaf=64)
    assert _normwise(got, want) < 1e-10
    resid = np.abs(L @ got.numpy() - np.eye(m)).max()
    assert resid < 1e-10
    assert not torch.any(torch.triu(got, 1))


def test_rec_tri_inverse_in_float32_runs_its_products_on_kernels_4_and_a():
    """Float32 goes through the operators of kernels 4 (B iA) and A
    (iC X): one each a level, 512 -> 256 -> 128 -> 64 with leaf 64, the
    batch of a level flattened into their Q; within twice a triangular
    solve's error against float64.  Float64 takes the plain products;
    ``tri_inverse`` is the recursion at leaf 128."""
    L = _factor(512, q=2, seed=11)
    ref = np.linalg.inv(L)
    L32 = _t(L, np.float32)
    with _Ops() as ops:
        got = linalg.rec_tri_inverse(L32, leaf=64)
    assert ops.seen == {"hetmogp::matmul_tril": 3,
                        "hetmogp::tril_projection": 3}
    eye = torch.eye(512).expand_as(L32)
    trsm = torch.linalg.solve_triangular(L32, eye, upper=False)
    assert _normwise(got, ref) <= 2 * _normwise(trsm, ref)
    with _Ops() as ops:
        linalg.rec_tri_inverse(_t(L), leaf=64)
    assert not ops.seen
    torch.testing.assert_close(linalg.tri_inverse(L32),
                               linalg.rec_tri_inverse(L32, leaf=128),
                               rtol=0, atol=0)


def test_rec_tri_inverse_keeps_leading_dims():
    """(..., m, m) with two leading dims, as the rank path's copies: each
    matrix's inverse."""
    L = _factor(256, q=6, seed=12).reshape(2, 3, 256, 256)
    got = linalg.rec_tri_inverse(_t(L), leaf=64)
    assert got.shape == (2, 3, 256, 256)
    assert _normwise(got, np.linalg.inv(L)) < 1e-10


def test_blocked_cholesky_inverse_of_a_non_spd_k_gives_nans():
    """A factorization that fails surfaces as NaNs in both factors (every
    entry of the lower triangle), without an exception; the SPD member of
    the batch is untouched."""
    L = _factor(256, q=2, seed=13)
    K = L @ np.swapaxes(L, -1, -2)
    K[1] -= 10.0 * np.eye(256)  # indefinite
    for dtype in (np.float64, np.float32):
        Lk, iL = linalg.blocked_cholesky_inverse(_t(K, dtype))
        lower = torch.tril(torch.ones(256, 256, dtype=torch.bool))
        for f in (Lk, iL):
            assert torch.isnan(f[1][lower]).all()
            assert torch.isfinite(f[0]).all()
        assert _normwise(iL[0], np.linalg.inv(L[0])) < (
            1e-10 if dtype == np.float64 else 1e-4)
