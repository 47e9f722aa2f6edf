"""The right products with a triangular factor, A tril(L) (kernel 4,
``csrc/tril_right_kernel.cu``, in float32; kernel 5,
``csrc/tril_proj3_kernel.cu``'s ``hetmogp_tril_right3_*``, in three bf16
passes) and ``quad_diag`` (kernel 4 with its square and row sum fused),
against the JAX package on the same numpy inputs.

The kernels run only on the card; here the CPU tensors take their plain
versions through the same operators and ``autograd.Function``s.  The JAX
functions take their blocked path at M = 512 (256-wide blocks that skip
L's zero blocks) and their dense one at M = 24.

Tolerances, normwise max|a - b| / max|b|:
* 1e-12 in float64, where the two packages run the same products in
  another blocking;
* 1e-5 in float32 at ``"highest"`` (both in full float32, summed in other
  orders: ~sqrt(M) eps);
* ``HIGH_ADJOINT`` for the float32 cached adjoints at ``"high"``, against
  the JAX custom VJPs in float64 (the JAX package's ``Precision.HIGH`` is
  a no-op on the CPU, so its float32 run would be full precision too).
  Each triangular product of the 3-pass split errs by at most 2^-15 of
  sum_m |a_m l_mk| per output (lo rounded to bf16, lo*lo dropped); the
  Cholesky pullback chains three of them, and against iL (entries ~1e2 at
  jitter 1e-4) those sums reach about ten times the outputs, so
  3 x 3e-5 x 10 ~ 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetmogp_tpu.ops import kernels as jkernels
from hetmogp_tpu.ops import linalg as jlinalg
from hetmogp_tpu_torch.ops import cuda_dispatch, cuda_kernels, linalg

torch.set_num_threads(1)  # the file runs beside others under xdist

Q, N = 2, 40
SIZES = [512, 24]  # the JAX blocked path, and its dense fallback
F64, F32 = 1e-12, 1e-5
HIGH_ADJOINT = 1e-3


def _normwise(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _inputs(M, seed=0):
    """float64 A (Q, N, M), a well-conditioned lower-triangular L, L with
    junk above its diagonal (which the port may not read; the JAX
    functions take exactly triangular factors) and weights c (Q, N)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(Q, N, M)
    L = np.tril(rng.randn(Q, M, M)) / np.sqrt(M) + 2.0 * np.eye(M)
    junk = L + np.triu(rng.randn(Q, M, M), 1)
    return A, L, junk, rng.randn(Q, N)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a).astype(dtype))


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


# ---- matmul_tril and tril_t_matmul ------------------------------------------

@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("fn", ["matmul_tril", "tril_t_matmul"])
def test_right_products_match_jax(fn, dtype, tol, M):
    A, L, junk, _ = _inputs(M)
    B = np.swapaxes(A, -1, -2)
    args = (A, L) if fn == "matmul_tril" else (L, B)
    want = getattr(jlinalg, fn)(*(jnp.asarray(a.astype(dtype))
                                  for a in args))
    args = (A, junk) if fn == "matmul_tril" else (junk, B)
    got = getattr(linalg, fn)(*(_t(a, dtype) for a in args))
    assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert _normwise(got, want) < tol


@pytest.mark.parametrize("M", SIZES)
def test_matmul_tril_gradient_matches_jax(M):
    """MatmulTril's backward (kernel A's operator for dA, a dense matmul
    and a mask for dL) against jax.grad of the JAX package's blocked
    product."""
    A, L, junk, _ = _inputs(M, seed=1)
    g = np.random.RandomState(2).randn(Q, N, M)
    want = jax.grad(lambda a, l: jnp.sum(g * jlinalg.matmul_tril(a, l)),
                    argnums=(0, 1))(jnp.asarray(A), jnp.asarray(L))
    a, l = _t(A, np.float64).requires_grad_(), _t(junk, np.float64)
    l.requires_grad_()
    got = torch.autograd.grad(linalg.matmul_tril(a, l), (a, l),
                              _t(g, np.float64))
    assert _normwise(got[0], want[0]) < F64
    # the JAX gradient in L keeps only what reaches tril(L)
    assert _normwise(got[1], np.tril(np.asarray(want[1]))) < F64
    assert not torch.any(torch.triu(got[1], 1))


# ---- quad_diag -------------------------------------------------------------

def _jax_quad(A, L, c):
    value = jlinalg.quad_diag(jnp.asarray(A), jnp.asarray(L))
    grads = jax.grad(lambda a, l: jnp.sum(jnp.asarray(c)
                                          * jlinalg.quad_diag(a, l)),
                     argnums=(0, 1))(jnp.asarray(A), jnp.asarray(L))
    return value, grads


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
def test_quad_diag_value_and_gradients_match_jax(dtype, tol, M):
    A, L, junk, c = _inputs(M, seed=3)
    A, L, junk, c = (x.astype(dtype) for x in (A, L, junk, c))
    want, (wA, wL) = _jax_quad(A, L, c)
    a, l = _t(A, dtype).requires_grad_(), _t(junk, dtype).requires_grad_()
    with _Ops() as ops:
        got = linalg.quad_diag(a, l)
        gA, gL = torch.autograd.grad(got, (a, l), _t(c, dtype))
    # forward: the product epilogue that keeps A tril(L); backward: kernel
    # A's operator for gA, kernel 8's for gL
    assert ops.seen == {"hetmogp::quad_diag_product": 1,
                        "hetmogp::tril_projection": 1,
                        "hetmogp::t_matmul_tril_out": 1}
    assert _normwise(got, want) < tol
    assert _normwise(gA, wA) < tol
    assert _normwise(gL, np.tril(np.asarray(wL))) < tol
    assert not torch.any(torch.triu(gL, 1))


@pytest.mark.parametrize("M", SIZES)
def test_quad_diag_gradient_in_L_alone(M):
    """The VE step: P comes from the frozen cache, only Lq needs a
    gradient, and the A half of the backward is not formed: gL is kernel
    8's operator alone."""
    A, L, junk, c = _inputs(M, seed=4)
    want, (_, wL) = _jax_quad(A, L, c)
    l = _t(junk, np.float64).requires_grad_()
    with _Ops() as ops:
        (gL,) = torch.autograd.grad(linalg.quad_diag(_t(A, np.float64), l),
                                    (l,), _t(c, np.float64))
    assert ops.seen == {"hetmogp::quad_diag_product": 1,
                        "hetmogp::t_matmul_tril_out": 1}
    assert _normwise(gL, np.tril(np.asarray(wL))) < F64


@pytest.mark.parametrize("M", SIZES)
def test_quad_diag_under_inference_mode(M):
    """No gradient to form: the row-sum epilogue alone, no product
    stored, the JAX value."""
    A, L, junk, c = _inputs(M, seed=5)
    want, _ = _jax_quad(A, L, c)
    for dtype, tol in ((np.float64, F64), (np.float32, F32)):
        a = _t(A, dtype).requires_grad_()
        l = _t(junk, dtype).requires_grad_()
        with torch.inference_mode(), _Ops() as ops:
            got = linalg.quad_diag(a, l)
        assert ops.seen == {"hetmogp::quad_diag": 1}
        assert not got.requires_grad
        assert _normwise(got, want) < tol
        with torch.no_grad():
            assert torch.equal(linalg.quad_diag(a, l), got)


def test_quad_diag_without_kernel_is_the_plain_version():
    A, _, junk, _ = _inputs(24, seed=6)
    a, l = _t(A, np.float64), _t(junk, np.float64)
    with _Ops() as ops:
        got = linalg.quad_diag(a, l, use_kernel=False)
    assert not ops.seen
    assert torch.equal(got, cuda_kernels.quad_diag_plain(a, l))
    assert torch.equal(got, torch.ops.hetmogp.quad_diag(a, l))


# ---- the cached adjoints at "high" ------------------------------------------

def _cached_factor(M, seed=0):
    """(K, L, iL, Kfu) of an RBF Gram at jitter 1e-4, as the trainer caches
    them, and an (Q, N, M) cross-covariance."""
    rng = np.random.RandomState(seed)
    Z = rng.rand(Q, M, 2)
    ls, var = 0.2 + 0.1 * rng.rand(Q, 2), 0.5 + rng.rand(Q)
    K = np.asarray(jkernels.K_gram_batched("rbf", Z, ls, var)) \
        + 1e-4 * np.eye(M)
    L = np.linalg.cholesky(K)
    iL = np.tril(np.linalg.inv(L))
    Kfu = np.asarray(jkernels.K_batched("rbf", rng.rand(N, 2), Z, ls, var))
    return K, L, iL, Kfu


def _chol_cached_grads(K, L, iL, gL, dtype, precision):
    k = _t(K, dtype).requires_grad_()
    got = linalg.chol_cached(k, _t(L, dtype), _t(iL, dtype),
                             precision=precision)
    return torch.autograd.grad(got, k, _t(gL, dtype))[0]


def _solve_tri_cached_grads(L, iL, Kfu, yb, dtype, precision):
    l = _t(L, dtype).requires_grad_()
    kfu = _t(Kfu, dtype).requires_grad_()
    P = linalg.solve_tri_cached(l, kfu, _t(iL, dtype), precision=precision)
    gl, gk = torch.autograd.grad(P, (l, kfu), _t(yb, dtype).mT)
    return gl, gk.mT


@pytest.mark.parametrize("M", SIZES)
def test_cached_adjoints_at_high_match_jax(M):
    K, L, iL, Kfu = _cached_factor(M)
    rng = np.random.RandomState(7)
    gL, yb = np.tril(rng.randn(Q, M, M)), rng.randn(Q, M, N)
    _, vjp = jax.vjp(lambda k: jlinalg.chol_cached(
        k, jnp.asarray(L), jnp.asarray(iL)), jnp.asarray(K))
    (wK,) = vjp(jnp.asarray(gL))
    _, vjp = jax.vjp(lambda l, b: jlinalg.solve_tri_cached(
        l, b, jnp.asarray(iL)), jnp.asarray(L),
        jnp.asarray(np.swapaxes(Kfu, -1, -2)))
    wL, wB = vjp(jnp.asarray(yb))
    errs = {}
    for dtype in (np.float64, np.float32):
        for prec in ("highest", "high"):
            gK = _chol_cached_grads(K, L, iL, gL, dtype, prec)
            gl, gb = _solve_tri_cached_grads(L, iL, Kfu, yb, dtype, prec)
            errs[dtype, prec] = [_normwise(gK, wK), _normwise(gl, wL),
                                 _normwise(gb, wB)]
    # float64 takes the full-precision route at either precision
    assert max(errs[np.float64, "high"] + errs[np.float64, "highest"]) < 1e-9
    assert max(errs[np.float32, "high"]) < HIGH_ADJOINT, errs
    # the 3-pass route was taken where its error shows (Kbar, Bbar); Lbar
    # = -tril(Bbar^T P), kernel 8's at "high" too, carries the float32
    # error of its operands at this conditioning either way
    for i in (0, 2):
        assert errs[np.float32, "high"][i] > 4 * errs[np.float32,
                                                      "highest"][i], errs


def test_high_adjoint_products_go_through_the_3pass_operator():
    K, L, iL, Kfu = _cached_factor(24, seed=1)
    rng = np.random.RandomState(8)
    gL, yb = np.tril(rng.randn(Q, 24, 24)), rng.randn(Q, 24, N)
    seen = {}
    for prec in ("high", "highest"):
        with _Ops() as ops:
            _chol_cached_grads(K, L, iL, gL, np.float32, prec)
            _solve_tri_cached_grads(L, iL, Kfu, yb, np.float32, prec)
        seen[prec] = ops.seen
    # three products in the Cholesky pullback, one in the solve's Kfubar,
    # and the solve's Lbar (kernel 8) at the same precision
    assert seen["high"] == {"hetmogp::matmul_tril_3pass": 4,
                            "hetmogp::tril_projection": 1,
                            "hetmogp::t_matmul_tril_out_3pass": 1}
    assert seen["highest"] == {"hetmogp::matmul_tril": 4,
                               "hetmogp::tril_projection": 1,
                               "hetmogp::t_matmul_tril_out": 1}


# ---- kernel 5's plain version -------------------------------------------------

def _np_split(x):
    """The bit-mask split in numpy: hi = x with its low 16 bits cleared,
    lo = bf16_rn(x - hi), both as float64."""
    hi = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    lo = np.asarray(jnp.asarray(x - hi).astype(jnp.bfloat16), np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


@pytest.mark.parametrize("M", SIZES)
def test_3pass_plain_matches_a_numpy_model(M):
    """hi*lo + lo*hi + hi*hi over tril(L), each product of bf16 values
    exact in float64: the plain version sums them in float32, within
    ~sqrt(M) eps of the model; and it ignores L's upper triangle."""
    A, _, junk, _ = _inputs(M, seed=9)
    A32, junk32 = A.astype(np.float32), junk.astype(np.float32)
    (ahi, alo), (lhi, llo) = _np_split(A32), _np_split(np.tril(junk32))
    model = ahi @ llo + alo @ lhi + ahi @ lhi
    got = cuda_kernels.matmul_tril_3pass_plain(torch.from_numpy(A32),
                                               torch.from_numpy(junk32))
    assert _normwise(got, model) < 1e-6
    # and it is a 3-pass product: ~2^-16 from the unsplit float64 one, far
    # nearer than a 1-pass bf16 product
    exact = A32.astype(np.float64) @ np.tril(junk32).astype(np.float64)
    one = (np.asarray(jnp.asarray(A32).astype(jnp.bfloat16), np.float64)
           @ np.asarray(jnp.asarray(np.tril(junk32)).astype(jnp.bfloat16),
                        np.float64))
    assert _normwise(got, exact) < _normwise(one, exact) / 16
    assert torch.equal(linalg.matmul_tril(torch.from_numpy(A32),
                                          torch.from_numpy(junk32),
                                          precision="high"), got)


# ---- dispatch, routes and launchers -------------------------------------------

def test_high_float64_is_the_full_precision_product():
    A, _, junk, _ = _inputs(24, seed=10)
    a, l = _t(A, np.float64), _t(junk, np.float64)
    high = linalg.matmul_tril(a, l, precision="high")
    assert torch.equal(high, linalg.matmul_tril(a, l))
    assert torch.equal(high, cuda_kernels.matmul_tril_plain(a, l))
    with pytest.raises(ValueError, match="precision"):
        linalg.matmul_tril(a, l, precision="default")


@pytest.mark.parametrize("fn", [cuda_dispatch.matmul_tril,
                                cuda_dispatch.quad_diag])
def test_cuda_float64_raises_in_dispatch(fn):
    """A CUDA tensor that is not float32 raises rather than falling back
    to the plain version."""
    import types

    fake = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        fn(fake, fake)


def _recorders(monkeypatch, names):
    """Swap the launchers ``names`` for recording plain versions."""
    calls = []
    plain = {"product": cuda_kernels.matmul_tril_plain,
             "both": cuda_kernels.quad_diag_product_plain,
             "rowsum": cuda_kernels.quad_diag_plain}
    for name in names:
        def launcher(A, L, epilogue="product", name=name):
            calls.append((name, epilogue, A.shape[-1]))
            if "3" in name:
                return cuda_kernels.matmul_tril_3pass_plain(A, L)
            return plain[epilogue](A, L)
        launcher.__name__ = name
        monkeypatch.setattr(cuda_kernels, name, launcher)
    return calls


@pytest.mark.parametrize("M,Mp", [(64, 64), (77, 80)])
def test_routers_reach_the_launcher_of_the_route(monkeypatch, M, Mp):
    """Kernels 4's and 5's routers reach their TMA launchers at every M,
    a ragged one padded to M' = 4 ceil(M / 4), each epilogue's results
    cropped back to M."""
    names = ("tril_right_tma", "tril_right3_tma")
    calls = _recorders(monkeypatch, names)
    A, L = (_t(x, np.float32) for x in _inputs(M, seed=11)[:2])
    got = [cuda_kernels.tril_right(A, L, epilogue)
           for epilogue in ("product", "both", "rowsum")]
    got.append(cuda_kernels.tril_right3(A, L))
    assert calls == [("tril_right_tma", e, Mp)
                     for e in ("product", "both", "rowsum")] + [
        ("tril_right3_tma", "product", Mp)]
    assert got[0].shape == got[1][0].shape == got[3].shape == A.shape
    assert got[1][1].shape == got[2].shape == A.shape[:-1]


@pytest.mark.parametrize("dtype,err", [(np.float32, ValueError),
                                       (np.float64, TypeError)])
def test_launchers_refuse_cpu_and_non_f32(dtype, err):
    A, L = (_t(x, dtype) for x in _inputs(8, seed=12)[:2])
    before = cuda_kernels.launch_counts()
    for launcher in (cuda_kernels.tril_right, cuda_kernels.tril_right_tma,
                     cuda_kernels.tril_right3, cuda_kernels.tril_right3_tma):
        with pytest.raises(err):
            launcher(A, L)
        with pytest.raises(NotImplementedError, match="no backward"):
            launcher(A, L.clone().requires_grad_())
    with pytest.raises(ValueError, match="epilogue"):
        cuda_kernels.tril_right_tma(A, L, "square")
    assert cuda_kernels.launch_counts() == before
