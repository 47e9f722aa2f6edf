"""The 3-pass bf16 triangular projection (``ve_fwd_precision="high"``): the
plain version of the CUDA kernel ``csrc/tril_proj3_kernel.cu`` against the
Pallas kernel it replaces, and its routes through ``linalg.matmul_tril_t``.

Tolerances, normwise max|a - b| / max|b|:
* 2e-6 in float32 against the Pallas kernel run in interpret mode: both
  multiply the same bf16 values exactly and sum in float32, in other
  orders (~sqrt(M) eps);
* against float64 of the unsplit operands, the 3-pass product must sit at
  most 1/16 of a 1-pass bf16 product's error (it is ~2^-14 per product
  against ~2^-8): the bound that catches a lost lo term.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hetmogp_tpu_torch.ops import cuda_dispatch, cuda_kernels, linalg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _normwise(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _tri_inputs(Q, N, M, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    A = rng.randn(Q, N, M)
    L = np.tril(rng.randn(Q, M, M)) / np.sqrt(M) + 2.0 * np.eye(M)
    return A.astype(dtype), L.astype(dtype)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_proj", ROOT / "tools" / "probe_pallas_proj.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_split(X):
    """The probe's own bit-mask split (``pallas_proj2``), in numpy."""
    bits = X.view(np.uint32)
    hi = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    lo = np.asarray(jnp.asarray(X - hi).astype(jnp.bfloat16))
    return np.asarray(jnp.asarray(hi).astype(jnp.bfloat16)), lo


def test_plain_3pass_matches_pallas_presplit_kernel():
    """``_proj_kernel_presplit`` in interpret mode with the probe's split
    and BlockSpecs (bn=512, bk=256)."""
    probe = _probe()
    Q, N, M, bn, bk = 2, 512, 512, 512, 256
    A, L = _tri_inputs(Q, N, M)
    (ahi, alo), (lhi, llo) = _probe_split(A), _probe_split(L)
    a_spec = pl.BlockSpec((1, bn, bk), lambda q, i, j, mt: (q, i, mt))
    l_spec = pl.BlockSpec((1, bk, bk), lambda q, i, j, mt: (q, j, mt))
    out = pl.pallas_call(
        probe._proj_kernel_presplit,
        grid=(Q, N // bn, M // bk, M // bk),
        in_specs=[a_spec, a_spec, l_spec, l_spec],
        out_specs=pl.BlockSpec((1, bn, bk), lambda q, i, j, mt: (q, i, j)),
        out_shape=jax.ShapeDtypeStruct((Q, N, M), jnp.float32),
        interpret=True,
    )(*(jnp.asarray(a) for a in (ahi, alo, lhi, llo)))
    got = cuda_kernels.tril_projection_3pass_plain(torch.from_numpy(A),
                                                   torch.from_numpy(L))
    assert _normwise(got, out) < 2e-6
    # the two split the same way: the halves agree bit for bit
    hi, lo = cuda_kernels.split_bf16(torch.from_numpy(A))
    np.testing.assert_array_equal(hi.numpy(), ahi.astype(np.float32))
    np.testing.assert_array_equal(lo.numpy(), alo.astype(np.float32))
    ref64 = A.astype(np.float64) @ np.swapaxes(L.astype(np.float64), -1, -2)
    one = np.asarray(jnp.asarray(A).astype(jnp.bfloat16), np.float32) @ \
        np.swapaxes(np.asarray(jnp.asarray(L).astype(jnp.bfloat16),
                               np.float32), -1, -2)
    e3, e1 = _normwise(got, ref64), _normwise(one, ref64)
    assert e3 < e1 / 16, (e3, e1)
    assert e3 > _normwise(linalg.matmul_tril_t(torch.from_numpy(A),
                                               torch.from_numpy(L)), ref64)


def test_split_is_exact_and_bf16():
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        np.float32) * np.logspace(-20, 20, 4096).astype(np.float32))
    hi, lo = cuda_kernels.split_bf16(x)
    for half in (hi, lo):
        assert torch.equal(half, half.to(torch.bfloat16).float())
    assert torch.equal(hi.view(torch.int32) & 0xFFFF, torch.zeros_like(
        hi.view(torch.int32)))
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel < 2.0 ** -15


def test_plain_3pass_ignores_the_upper_triangle():
    A, L = _tri_inputs(3, 40, 77, seed=1)
    junk = L + np.triu(np.random.RandomState(2).randn(3, 77, 77), 1).astype(
        np.float32)
    a, lo, hi = map(torch.from_numpy, (A, L, junk))
    assert torch.equal(cuda_kernels.tril_projection_3pass_plain(a, hi),
                       cuda_kernels.tril_projection_3pass_plain(a, lo))


def test_high_f64_is_highest_bit_for_bit():
    """Float64 takes the full-precision route at "high"."""
    A, L = (torch.from_numpy(a) for a in _tri_inputs(2, 70, 300,
                                                     dtype=np.float64))
    high = linalg.matmul_tril_t(A, L, precision="high")
    assert torch.equal(high, linalg.matmul_tril_t(A, L, precision="highest"))
    assert torch.equal(high, cuda_kernels.tril_projection_plain(A, L))


def test_high_f32_routes_to_the_plain_3pass_on_the_cpu():
    A, L = (torch.from_numpy(a) for a in _tri_inputs(2, 50, 64, seed=3))
    before = cuda_kernels.launch_counts()
    for use_kernel in (True, False):
        got = linalg.matmul_tril_t(A, L, precision="high",
                                   use_kernel=use_kernel)
        assert torch.equal(got,
                           cuda_kernels.tril_projection_3pass_plain(A, L))
    assert not torch.equal(got, linalg.matmul_tril_t(A, L))
    assert cuda_kernels.launch_counts() == before
    with pytest.raises(ValueError, match="precision"):
        linalg.matmul_tril_t(A, L, precision="default")


def test_3pass_gradient_is_the_projection_gradient():
    """TrilProjection3Pass's backward is TrilProjection's, dL at the
    forward's precision: dA the gradient of the full float32 product, dL
    = tril(g^T A) in kernel 8's three passes (its plain version on the
    CPU)."""
    A, L = (torch.from_numpy(a) for a in _tri_inputs(2, 30, 40, seed=4))
    g = torch.from_numpy(np.random.RandomState(5).randn(2, 30, 40).astype(
        np.float32))
    a3, l3 = A.clone().requires_grad_(), L.clone().requires_grad_()
    got = torch.autograd.grad(
        linalg.matmul_tril_t(a3, l3, precision="high"), (a3, l3), g)
    a1 = A.clone().requires_grad_()
    (want,) = torch.autograd.grad(a1 @ torch.tril(L).mT, a1, g)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        got[1], cuda_kernels.t_matmul_tril_out_3pass_plain(g, A),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,err", [(np.float32, ValueError),
                                       (np.float64, TypeError)])
def test_3pass_launcher_refuses_cpu_and_non_f32(dtype, err):
    A, L = (torch.from_numpy(a) for a in _tri_inputs(1, 8, 8, dtype=dtype))
    before = cuda_kernels.launch_counts()
    for launcher in (cuda_kernels.tril_projection_3pass,
                     cuda_kernels.tril_projection_3pass_tma):
        with pytest.raises(err):
            launcher(A, L)
        with pytest.raises(NotImplementedError, match="no backward"):
            launcher(A, L.clone().requires_grad_())
    assert cuda_kernels.launch_counts() == before
    if dtype == np.float64:
        with pytest.raises(TypeError, match="float32"):
            cuda_kernels.tril_projection_3pass_plain(A, L.detach())


def test_high_on_cuda_f64_raises_in_dispatch():
    """A CUDA float64 tensor at "high" takes the full-precision route,
    whose kernel is float32-only: it raises rather than falling back."""
    import types

    fake = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        cuda_dispatch.use_tril_kernel(fake)
