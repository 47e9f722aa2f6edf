"""The port's RBF cross-covariance against the JAX package, and the
no-fallback contract of its CUDA kernel.

The plain PyTorch version (what CPU tensors take, and what the kernel is
checked against on the card by chip_smoke.py) is held against the JAX XLA
path and the Pallas kernel in interpret mode, on the same numpy inputs.
The CUDA kernel itself runs only on the card; here the tests show that
CPU tensors never reach it and that its wrapper and build refuse what
they cannot do.
"""

import numpy as np
import pytest
import torch

from hetmogp_tpu.ops import kernels as jkernels
from hetmogp_tpu.ops import pallas_kernels
from hetmogp_tpu_torch.ops import _build, cuda_dispatch, cuda_kernels, kernels

torch.set_num_threads(1)

CASES = {  # mirrors tests/test_pallas_kernels.py
    "ard": dict(N=70, M=50, Q=2, Dx=2, iso=False),
    "iso": dict(N=70, M=50, Q=2, Dx=2, iso=True),
    "ragged": dict(N=13, M=7, Q=3, Dx=1, iso=False),
    "wide": dict(N=20, M=9, Q=2, Dx=6, iso=False),  # matmul distance form
}


def _inputs(N, M, Q, Dx, iso, dtype, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, Dx)
    Z = rng.rand(Q, M, Dx)
    ls = 0.3 + 0.3 * rng.rand(Q, 1 if iso else Dx)
    var = 0.5 + rng.rand(Q)
    return [a.astype(dtype) for a in (X, Z, ls, var)]


def _port(arrays, **kw):
    return kernels.K_batched("rbf", *map(torch.from_numpy, arrays),
                             **kw).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rbf_matches_jax_f32(case):
    arrays = _inputs(**CASES[case], dtype=np.float32)
    got = _port(arrays)
    xla = jkernels.K_batched("rbf", *arrays, use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(xla), atol=2e-6, rtol=0)
    if CASES[case]["Dx"] <= 4:  # the Pallas kernel's own test range
        pallas = pallas_kernels.rbf_K_batched_interpret(*arrays)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-6, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rbf_matches_jax_f64(case):
    arrays = _inputs(**CASES[case], dtype=np.float64)
    got = _port(arrays)
    xla = jkernels.K_batched("rbf", *arrays, use_pallas=False)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-12, rtol=0)


def test_gram_and_kdiag_match_jax():
    X, Z, ls, var = _inputs(**CASES["ard"], dtype=np.float64)
    got = kernels.K_gram_batched("rbf", *map(torch.from_numpy, (Z, ls, var)))
    want = jkernels.K_gram_batched("rbf", Z, ls, var)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    kd = kernels.Kdiag_batched("rbf", torch.from_numpy(X),
                               torch.from_numpy(var))
    np.testing.assert_array_equal(
        kd.numpy(), np.asarray(jkernels.Kdiag_batched("rbf", X, var)))


def test_cpu_tensors_take_the_plain_version():
    arrays = [torch.from_numpy(a) for a in
              _inputs(**CASES["ard"], dtype=np.float32)]
    before = cuda_kernels.rbf_K_batched.launches
    got = kernels.K_batched("rbf", *arrays)
    assert not cuda_dispatch.use_rbf_kernel(arrays[0])
    assert cuda_kernels.rbf_K_batched.launches == before == 0
    torch.testing.assert_close(
        got, cuda_kernels.rbf_K_batched_plain(*arrays), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_wrapper_refuses_cpu_tensors(dtype):
    arrays = [torch.from_numpy(a) for a in
              _inputs(**CASES["ard"], dtype=dtype)]
    with pytest.raises((ValueError, TypeError)):
        cuda_kernels.rbf_K_batched(*arrays)
    assert cuda_kernels.rbf_K_batched.launches == 0


def test_cuda_wrapper_refuses_grad():
    X, Z, ls, var = [torch.from_numpy(a) for a in
                     _inputs(**CASES["ard"], dtype=np.float32)]
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_kernels.rbf_K_batched(X.requires_grad_(), Z, ls, var)


def test_unported_kernel_raises():
    X, Z, ls, var = [torch.from_numpy(a) for a in
                     _inputs(**CASES["ard"], dtype=np.float64)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.K_batched("matern32", X, Z, ls, var)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "hetmogp_tpu_torch")
    assert path == _build.library_path()
    assert (_build.CSRC / "rbf_kernel.cu").is_file()
