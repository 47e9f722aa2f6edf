"""The port's linear algebra against the JAX package's, on the same numpy
inputs: the triangular projection (the plain version of the CUDA kernel
``csrc/tril_proj_kernel.cu``, and ``linalg.matmul_tril_t``), the Pallas
projection kernel it replaces, and the cached-inverse adjoints of the VM
step.

Tolerances are normwise, max|a - b| / max|b|:
* 1e-12 in float64 where the two packages run the same products in another
  blocking (the JAX package splits M=512 into 256-wide blocks);
* 2e-5 in float32 against the Pallas kernel, which multiplies in three
  bf16 passes (Precision.HIGH, relative error ~1e-5 per product sum);
* 1e-9 for the adjoints, which multiply by the explicit inverse of a
  Cholesky factor whose entries reach ~1e2 (jitter 1e-4): the two
  packages' rounding differs by about cond * eps there.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hetmogp_tpu.ops import kernels as jkernels
from hetmogp_tpu.ops import linalg as jlinalg
from hetmogp_tpu_torch.ops import cuda_kernels, linalg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _normwise(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _tri_inputs(Q, N, M, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    A = rng.randn(Q, N, M)
    L = np.tril(rng.randn(Q, M, M)) / np.sqrt(M) + 2.0 * np.eye(M)
    return A.astype(dtype), L.astype(dtype)


def _cached_factor(Q, M, seed=0):
    """(K, L, iL) of an RBF Gram at jitter 1e-4, as the trainer caches
    them, plus a (Q, N, M) cross-covariance."""
    rng = np.random.RandomState(seed)
    Z = rng.rand(Q, M, 2)
    ls, var = 0.2 + 0.1 * rng.rand(Q, 2), 0.5 + rng.rand(Q)
    K = np.asarray(jkernels.K_gram_batched("rbf", Z, ls, var)) \
        + 1e-4 * np.eye(M)
    L = np.linalg.cholesky(K)
    iL = np.linalg.inv(L)
    iL = np.tril(iL)
    Kfu = np.array(jkernels.K_batched("rbf", rng.rand(64, 2), Z, ls, var,
                                       use_pallas=False))
    return K, L, iL, Kfu


@pytest.mark.parametrize("M", [512, 300], ids=["blocked", "dense"])
def test_matmul_tril_t_matches_jax_f64(M):
    A, L = _tri_inputs(2, 70, M)
    want = jlinalg.matmul_tril_t(jnp.asarray(A), jnp.asarray(L))
    got = linalg.matmul_tril_t(torch.from_numpy(A), torch.from_numpy(L))
    assert _normwise(got, want) < 1e-12
    plain = cuda_kernels.tril_projection_plain(torch.from_numpy(A),
                                               torch.from_numpy(L))
    assert torch.equal(plain, got)


def test_plain_projection_ignores_the_upper_triangle():
    """The kernel's contract: L's strictly upper entries count as zero."""
    A, L = _tri_inputs(3, 40, 77, seed=1)
    junk = L + np.triu(np.random.RandomState(2).randn(3, 77, 77), 1)
    a, lo, hi = map(torch.from_numpy, (A, L, junk))
    torch.testing.assert_close(cuda_kernels.tril_projection_plain(a, hi),
                               a @ lo.mT, rtol=1e-13, atol=0)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_proj", ROOT / "tools" / "probe_pallas_proj.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_projection_matches_pallas_proj_kernel_f32():
    """The Pallas kernel the CUDA kernel replaces, run in interpret mode
    with the probe's own BlockSpecs (bn=512, bk=256)."""
    probe = _probe()
    Q, N, M, bn, bk = 2, 512, 512, 512, 256
    A, L = _tri_inputs(Q, N, M, dtype=np.float32)
    out = pl.pallas_call(
        probe._proj_kernel,
        grid=(Q, N // bn, M // bk, M // bk),
        in_specs=[pl.BlockSpec((1, bn, bk), lambda q, i, j, mt: (q, i, mt)),
                  pl.BlockSpec((1, bk, bk), lambda q, i, j, mt: (q, j, mt))],
        out_specs=pl.BlockSpec((1, bn, bk), lambda q, i, j, mt: (q, i, j)),
        out_shape=jax.ShapeDtypeStruct((Q, N, M), jnp.float32),
        interpret=True,
    )(jnp.asarray(A), jnp.asarray(L))
    got = cuda_kernels.tril_projection_plain(torch.from_numpy(A),
                                             torch.from_numpy(L))
    ref64 = A.astype(np.float64) @ np.swapaxes(L.astype(np.float64), -1, -2)
    assert _normwise(got, out) < 2e-5
    assert _normwise(got, ref64) < 1e-6  # full float32 products
    assert _normwise(out, ref64) < 2e-5  # three bf16 passes


@pytest.mark.parametrize("M", [256, 512])
def test_chol_cached_matches_jax_vjp(M):
    K, L, iL, _ = _cached_factor(2, M)
    gL = np.tril(np.random.RandomState(3).randn(*L.shape))
    want, vjp = jax.vjp(lambda k: jlinalg.chol_cached(k, jnp.asarray(L),
                                                      jnp.asarray(iL)),
                        jnp.asarray(K))
    (want_K,) = vjp(jnp.asarray(gL))
    k = torch.from_numpy(K).requires_grad_()
    got = linalg.chol_cached(k, torch.from_numpy(L), torch.from_numpy(iL))
    (got_K,) = torch.autograd.grad(got, k, torch.from_numpy(gL))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert _normwise(got_K, want_K) < 1e-9


@pytest.mark.parametrize("M", [256, 512])
def test_solve_tri_cached_matches_jax_vjp(M):
    """The port takes Kfu (Q, N, M) and returns P; the JAX function takes
    Kfu^T and returns P^T."""
    _, L, iL, Kfu = _cached_factor(2, M)
    yb = np.random.RandomState(4).randn(2, M, Kfu.shape[1])
    B = np.swapaxes(Kfu, -1, -2)
    want, vjp = jax.vjp(lambda l, b: jlinalg.solve_tri_cached(
        l, b, jnp.asarray(iL)), jnp.asarray(L), jnp.asarray(B))
    want_L, want_B = vjp(jnp.asarray(yb))
    l = torch.from_numpy(L).requires_grad_()
    kfu = torch.from_numpy(Kfu).requires_grad_()
    got = linalg.solve_tri_cached(l, kfu, torch.from_numpy(iL))
    got_L, got_K = torch.autograd.grad(got, (l, kfu),
                                       torch.from_numpy(yb).mT)
    assert _normwise(got.mT, want) < 1e-12
    assert _normwise(got_L, want_L) < 1e-9
    assert _normwise(got_K.mT, want_B) < 1e-9


def test_solve_tri_cached_gradient_is_the_solve_gradient():
    """Against autograd through a real triangular solve, in float64: the
    cached-inverse adjoints are the exact solve adjoints."""
    _, L, iL, Kfu = _cached_factor(2, 128, seed=5)
    g = torch.from_numpy(np.random.RandomState(6).randn(*Kfu.shape))
    l = torch.from_numpy(L).requires_grad_()
    kfu = torch.from_numpy(Kfu).requires_grad_()
    ref = torch.linalg.solve_triangular(l, kfu.mT, upper=False).mT
    want = torch.autograd.grad(ref, (l, kfu), g)
    got = torch.autograd.grad(
        linalg.solve_tri_cached(l, kfu, torch.from_numpy(iL)), (l, kfu), g)
    assert _normwise(got[0], torch.tril(want[0])) < 1e-9
    assert _normwise(got[1], want[1]) < 1e-9


def test_logdet_and_cholesky_match_jax():
    K, L, _, _ = _cached_factor(2, 64)
    np.testing.assert_allclose(
        linalg.logdet_from_chol(torch.from_numpy(L)).numpy(),
        np.asarray(jlinalg.logdet_from_chol(jnp.asarray(L))), rtol=1e-13)
    np.testing.assert_allclose(linalg.cholesky(torch.from_numpy(K)).numpy(),
                               np.asarray(jlinalg.jitchol(
                                   jnp.asarray(K), adaptive=False)),
                               rtol=0, atol=1e-12)
    bad = linalg.cholesky(-torch.from_numpy(K))
    assert torch.isnan(bad).all()


@pytest.mark.parametrize("fn", ["matmul_tril", "tril_matmul",
                                "tril_t_matmul"])
def test_triangular_helpers_match_jax(fn):
    A, L = _tri_inputs(2, 512, 512, seed=7)
    want = getattr(jlinalg, fn)(*(jnp.asarray(a) for a in (
        (A, L) if fn == "matmul_tril" else (L, np.swapaxes(A, -1, -2)))))
    got = getattr(linalg, fn)(*(torch.from_numpy(a) for a in (
        (A, L) if fn == "matmul_tril" else (L, np.swapaxes(A, -1, -2)))))
    assert _normwise(got, want) < 1e-12


def test_phi_matches_jax():
    A = np.random.RandomState(8).randn(3, 9, 9)
    np.testing.assert_array_equal(linalg._phi(torch.from_numpy(A)).numpy(),
                                  np.asarray(jlinalg._phi(jnp.asarray(A))))


# ---- triangular solves and the adaptive Cholesky ----------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_solve_tri_and_cho_solve_match_jax(dtype, tol):
    """``solve_tri`` (both transposes) and ``cho_solve_batched`` on a
    well-conditioned factor: the same substitution in another blocking."""
    _, L = _tri_inputs(3, 1, 24, dtype=dtype)
    B = np.random.RandomState(1).randn(3, 24, 7).astype(dtype)
    tL, tB = torch.from_numpy(L), torch.from_numpy(B)
    for trans in (False, True):
        want = jlinalg.solve_tri(jnp.asarray(L), jnp.asarray(B), trans=trans)
        got = linalg.solve_tri(tL, tB, trans=trans)
        assert got.numpy().dtype == dtype
        assert _normwise(got, want) <= tol
    want = jlinalg.cho_solve_batched(jnp.asarray(L), jnp.asarray(B))
    assert _normwise(linalg.cho_solve_batched(tL, tB), want) <= tol
    K = tL @ tL.mT
    assert _normwise(K @ linalg.cho_solve_batched(tL, tB), B) <= 10 * tol


def _jitchol_batch(dtype):
    """Four (8, 8) members: well-conditioned, exactly singular (rank 3),
    near-singular in the working precision, and indefinite beyond what the
    five levels can repair."""
    rng = np.random.RandomState(0)
    A = rng.randn(8, 8)
    good = A @ A.T + 8.0 * np.eye(8)
    V = rng.randn(8, 3)
    singular = V @ V.T
    eps = np.finfo(dtype).eps
    near = singular + 1e-3 * eps * np.eye(8)
    hopeless = singular - 10.0 * np.eye(8)
    return np.stack([good, singular, near, hopeless]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_jitchol_finds_the_jax_level_and_factor(dtype):
    """GPy's policy on both sides: the member that factorizes keeps level
    0, the singular ones get the same level (read off the factor:
    mean diag(L L^T - K) over mean diag(K), the same decade and within
    1%), the hopeless one is NaN on both; the factors agree to 1e-3
    normwise (the repaired pivots sit at the level, where two LAPACKs
    round differently) and reproduce K + level I to 100 eps."""
    K = _jitchol_batch(dtype)
    want = np.asarray(jlinalg.jitchol(jnp.asarray(K), jitter=0.0))
    got = linalg.jitchol(torch.from_numpy(K)).numpy()
    assert got.dtype == dtype
    assert np.isnan(got[3]).all() and np.isnan(np.diag(want[3])).all()
    eps = np.finfo(dtype).eps
    for i in range(3):
        assert np.isfinite(got[i]).all(), i
        assert _normwise(got[i], want[i]) <= 1e-3, i
        levels = [np.mean(np.diag(np.float64(L[i]) @ np.float64(L[i]).T
                                  - np.float64(K[i])))
                  / np.mean(np.diag(K[i])) for L in (got, want)]
        if i == 0:
            assert abs(levels[0]) <= 100 * eps
            np.testing.assert_allclose(got[0], np.linalg.cholesky(K[0]),
                                       rtol=1e3 * eps, atol=1e3 * eps)
        else:
            assert levels[0] >= 0.99e-6, (i, levels)
            assert levels[0] == pytest.approx(levels[1], rel=1e-2), i


def test_jitchol_fixed_jitter_and_gradient():
    """``adaptive=False`` is one Cholesky of K + jitter I (NaN on failure,
    no exception); the adaptive factor is differentiable through the final
    factorization, with the level held constant, as in the JAX package."""
    K = _jitchol_batch(np.float64)
    fixed = linalg.jitchol(torch.from_numpy(K), jitter=1e-3, adaptive=False)
    want = jlinalg.jitchol(jnp.asarray(K), jitter=1e-3, adaptive=False)
    assert _normwise(fixed[:3], np.asarray(want)[:3]) <= 1e-9
    assert bool(torch.isnan(fixed[3]).all())

    Kt = torch.from_numpy(K[:3]).requires_grad_()
    (g,) = torch.autograd.grad(linalg.jitchol(Kt).sum(), Kt)
    gj = jax.grad(lambda k: jnp.sum(jlinalg.jitchol(k)))(jnp.asarray(K[:3]))
    assert bool(torch.isfinite(g[0]).all())
    assert _normwise(g[0], np.asarray(gj)[0]) <= 1e-9


# ---- packing, the float64 island, the device-side jitchol -------------------

@pytest.mark.parametrize("m", [1, 5, 16])
def test_pack_tril_round_trip_in_the_jax_order(m):
    """GPy's row-major order: (0,0), (1,0), (1,1), (2,0), ...: a vector
    packed by either package unpacks to the same factor in the other."""
    rng = np.random.RandomState(m)
    L = np.tril(rng.randn(3, m, m))
    rows, cols = linalg.tril_indices(m)
    jrows, jcols = jlinalg.tril_indices(m)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    flat = linalg.pack_tril(torch.from_numpy(L))
    assert flat.shape == (3, m * (m + 1) // 2)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jlinalg.pack_tril(L)))
    back = linalg.unpack_tril(flat, m)
    np.testing.assert_array_equal(back.numpy(), L)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlinalg.unpack_tril(flat.numpy(), m)))
    dense = torch.from_numpy(rng.randn(m, m))
    torch.testing.assert_close(linalg.tril_param(dense), torch.tril(dense),
                               rtol=0, atol=0)


def _spd(Q, M, seed=0, jitter=1e-4):
    """Q RBF grams of M points on [0, 1] with lengthscale 0.2 plus jitter:
    cond ~ 1e5, where a float32 factorization loses about half its
    digits."""
    rng = np.random.RandomState(seed)
    Z = rng.rand(Q, M, 1)
    K = np.exp(-0.5 * (Z - np.swapaxes(Z, 1, 2)) ** 2 / 0.04)
    return K + jitter * np.eye(M)


def test_chol_mixed_forward_and_gradient_match_jax():
    """Float32 in, a float64 factorization cast down: the same factor as
    JAX's ``chol_mixed`` with x64 on (both round the same float64 factor
    once), far closer to float64 than a float32 factorization; the
    working-dtype pullback agrees with JAX's to 1e-4 normwise (float32
    triangular solves against a factor of cond ~1e5)."""
    K64 = _spd(2, 24)
    K32 = K64.astype(np.float32)
    want = np.asarray(jlinalg.chol_mixed(jnp.asarray(K32)))
    got = linalg.chol_mixed(torch.from_numpy(K32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.linalg.cholesky(K32.astype(np.float64))
    f32 = torch.linalg.cholesky(torch.from_numpy(K32)).numpy()
    assert _normwise(got, exact) <= _normwise(f32, exact)
    g = np.random.RandomState(1).randn(*K32.shape).astype(np.float32)
    Kt = torch.from_numpy(K32).requires_grad_()
    (gt,) = torch.autograd.grad(linalg.chol_mixed(Kt), Kt, torch.from_numpy(g))
    _, vjp = jax.vjp(jlinalg.chol_mixed, jnp.asarray(K32))
    (gj,) = vjp(jnp.asarray(g))
    assert gt.dtype == torch.float32
    assert _normwise(gt, np.asarray(gj)) <= 1e-4
    # in float64 the island is the plain factorization, gradient included
    K = torch.from_numpy(K64).requires_grad_()
    (g64,) = torch.autograd.grad(linalg.chol_mixed(K), K, torch.from_numpy(
        g.astype(np.float64)))
    _, vjp = jax.vjp(jlinalg.chol_mixed, jnp.asarray(K64))
    assert _normwise(g64, np.asarray(vjp(jnp.asarray(g, jnp.float64))[0])) \
        <= 1e-8


def test_float64_island_elbo_in_float32_matches_jax():
    """``chol_dtype="float64"`` on a float32 model: the ELBO and its hyper
    gradients against the JAX package's float32 island (x64 on), and the
    cache of ``prior_cholesky_inverse`` comes from the island's factor.
    The value to 1e-4 relative: each package's float32 ELBO of these
    inputs lies 2.6e-5 (port) and 4.1e-5 (JAX) from the float64 ELBO
    (measured; the quadrature and the sums round in float32 around one
    shared float64 factor); the gradients to 1e-3 normwise."""
    import dataclasses

    import hetmogp_tpu as jhet
    from hetmogp_tpu.models import elbo as jelbo
    from hetmogp_tpu.models.params import init_params as jinit

    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch.models import elbo as telbo
    from hetmogp_tpu_torch.models.params import FIELDS

    cfg = jhet.ModelConfig(likelihoods=(jhet.HetGaussian(), jhet.Bernoulli()),
                           num_latent=2, num_inducing=24, input_dim=1,
                           dtype="float32", jitter=1e-4, adaptive_jitter=False,
                           chol_dtype="float64")
    rng = np.random.RandomState(4)
    jp = jinit(jax.random.PRNGKey(2), cfg, rng.rand(24, 1), lengthscale=0.2)
    X = [rng.rand(30, 1) for _ in range(2)]
    Y = [rng.randn(30, 1), (rng.rand(30, 1) > 0.5) * 1.0]
    scales = np.array([2.0, 3.0], np.float32)
    jdata = tuple(jelbo.task_data(x.astype(np.float32), y.astype(np.float32))
                  for x, y in zip(X, Y))

    def jf(p):
        return jelbo.elbo_fn(p, jdata, jnp.asarray(scales), cfg)[0]

    want, jg = jax.value_and_grad(jf)(jp)
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    params = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    t = {f: getattr(params, f).clone().requires_grad_() for f in FIELDS}
    got, _ = telbo.elbo_fn(tp.SVMOGPParams(**t),
                           tp.make_dataset(X, Y, tcfg, device="cpu"),
                           torch.from_numpy(scales), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    names = ("log_lengthscale", "log_variance", "Z", "q_mu")
    grads = torch.autograd.grad(got, [t[f] for f in names])
    for f, g in zip(names, grads):
        assert _normwise(g, np.asarray(getattr(jg, f))) <= 1e-3, f
    Luu, iLuu = telbo.prior_cholesky_inverse(params, tcfg)
    island = linalg.chol_mixed(telbo._jittered_gram(params, tcfg))
    torch.testing.assert_close(Luu, island, rtol=0, atol=0)
    torch.testing.assert_close(iLuu, linalg.tri_inverse(island), rtol=0,
                               atol=0)
    same = dataclasses.replace(tcfg, chol_dtype="same")
    assert not torch.equal(telbo.prior_cholesky(params, same), Luu)


def test_device_side_jitchol_is_the_host_loop():
    """Inside ``device_side_jitchol`` every level is factorized and the
    first that succeeds is selected on the device: the same factor as the
    host loop, bit for bit, the hopeless member NaN on both."""
    K = torch.from_numpy(_jitchol_batch(np.float64))
    host = linalg.jitchol(K, jitter=1e-9)
    with linalg.device_side_jitchol():
        device = linalg.jitchol(K, jitter=1e-9)
    torch.testing.assert_close(device, host, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(device[3]).all())
