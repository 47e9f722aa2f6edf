"""The port's RBF cross-covariance against the JAX package, and the
no-fallback contract of its CUDA kernels.

The plain PyTorch version (what CPU tensors take, and what the kernel is
checked against on the card by chip_smoke.py) is held against the JAX XLA
path and the Pallas kernel in interpret mode, on the same numpy inputs;
the RBF backward against the JAX package's ``_rbf_bwd`` and against
autograd.  The CUDA kernels themselves run only on the card; here the
tests show that CPU tensors never reach them, that their wrappers and
build refuse what they cannot do, and (with the launchers swapped for
their plain versions) that the autograd.Functions around them give the
plain versions' gradients.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetmogp_tpu.ops import kernels as jkernels
from hetmogp_tpu.ops import pallas_kernels
from hetmogp_tpu_torch import config
from hetmogp_tpu_torch.ops import (_build, cuda_dispatch, cuda_kernels,
                                   kernels, linalg)

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


def _port(arrays, kind="rbf", **kw):
    return kernels.K_batched(kind, *map(torch.from_numpy, arrays),
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
    before = cuda_kernels.launch_counts()
    got = kernels.K_batched("rbf", *arrays)
    assert not cuda_dispatch.use_rbf_kernel(arrays[0])
    assert cuda_kernels.launch_counts() == before
    torch.testing.assert_close(
        got, cuda_kernels.rbf_K_batched_plain(*arrays), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_wrapper_refuses_cpu_tensors(dtype):
    arrays = [torch.from_numpy(a) for a in
              _inputs(**CASES["ard"], dtype=dtype)]
    before = cuda_kernels.launch_counts()
    for launcher in (cuda_kernels.rbf_K_batched,
                     cuda_kernels.rbf_K_batched_vec,
                     cuda_kernels.rbf_K_batched_scalar):
        with pytest.raises(TypeError if dtype == np.float64 else ValueError):
            launcher(*arrays)
    assert cuda_kernels.launch_counts() == before


def test_cuda_wrapper_refuses_grad():
    X, Z, ls, var = [torch.from_numpy(a) for a in
                     _inputs(**CASES["ard"], dtype=np.float32)]
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_kernels.rbf_K_batched(X.requires_grad_(), Z, ls, var)


def test_unported_kernel_raises():
    """Every kernel family of the JAX package is ported; an unknown name
    raises ``ValueError``, as the JAX ``kern_fn`` does."""
    X, Z, ls, var = [torch.from_numpy(a) for a in
                     _inputs(**CASES["ard"], dtype=np.float64)]
    assert kernels.KERNEL_NAMES == tuple(sorted(jkernels._KERNELS))
    assert config.KERNEL_NAMES == kernels.KERNEL_NAMES
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels.K_batched("periodic", X, Z, ls, var)
    with pytest.raises(ValueError, match="unknown kernel"):
        jkernels.K_batched("periodic", X, Z, ls, var)


STATIONARY = ("matern32", "matern52", "exponential", "rq")


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12),
                                        (np.float32, 2e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", STATIONARY)
def test_stationary_kernels_match_jax(kind, dtype, atol):
    """The four other families, plain PyTorch with explicit batch
    dimensions, against the JAX package's vmapped ones: cross-covariance
    and Gram, direct and matmul distance forms (atol as the RBF's).  No
    Gram in the matmul form: its diagonal r2 is the rounding noise of
    |a|^2 + |a|^2 - 2 a.a, of which the root keeps half the digits, so the
    two packages' diagonals differ by sqrt(eps)."""
    for case in ("ard", "iso", "wide"):
        X, Z, ls, var = _inputs(**CASES[case], dtype=dtype)
        got = _port((X, Z, ls, var), kind=kind)
        assert got.dtype == dtype
        want = jkernels.K_batched(kind, X, Z, ls, var)
        np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)
        if case == "wide":
            continue
        gram = kernels.K_gram_batched(kind, *map(torch.from_numpy,
                                                 (Z, ls, var)))
        np.testing.assert_allclose(
            gram.numpy(), np.asarray(jkernels.K_gram_batched(kind, Z, ls,
                                                             var)),
            atol=atol, rtol=0)


@pytest.mark.parametrize("kind", ("rbf",) + STATIONARY)
def test_kernel_gradients_finite_at_coincident_points(kind):
    """X contains Z's points, so r = 0 on some entries: the 1e-36 under
    the root keeps every gradient finite, as in the JAX package."""
    X, Z, ls, var = [torch.from_numpy(a) for a in
                     _inputs(**CASES["ragged"], dtype=np.float32)]
    X = torch.cat([X, Z[0, :3]])
    t = [a.clone().requires_grad_() for a in (X, Z, ls, var)]
    K = kernels.K_batched(kind, *t)
    assert float(K.detach()[0, -1, 2]) == pytest.approx(float(var[0]))
    for g in torch.autograd.grad(K.sum(), t):
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("kind", ("rbf", "matern52"))
def test_K_self_is_the_gram_of_broadcast_inputs(kind):
    """``K_self_batched`` against the JAX ``K_gram_batched`` on a broadcast
    X (what the JAX prediction paths call), symmetric to the bit."""
    X, _, ls, var = _inputs(**CASES["ard"], dtype=np.float64)
    got = kernels.K_self_batched(kind, *map(torch.from_numpy, (X, ls, var)))
    want = jkernels.K_gram_batched(kind, np.broadcast_to(X, (2, *X.shape)),
                                   ls, var)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    assert torch.equal(got, got.mT)
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1),
                       torch.from_numpy(var)[:, None].expand(2, X.shape[0]))


def test_lmc_coregionalization_matches_jax():
    rng = np.random.RandomState(0)
    W, kappa = rng.randn(3, 5), rng.rand(3, 5)
    for dtype in (np.float64, np.float32):
        got = kernels.lmc_coregionalization(
            torch.from_numpy(W.astype(dtype)),
            torch.from_numpy(kappa.astype(dtype)))
        want = jkernels.lmc_coregionalization(W.astype(dtype),
                                              kappa.astype(dtype))
        assert got.numpy().dtype == dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("M,Dx,route", [
    (1024, 2, "vec"),     # the main path: trainer and serving
    (4096, 2, "vec"),     # the projected path's Kx at Ns = 4096
    (1000, 3, "vec"),     # M % 4 == 0, not a multiple of the tile
    (4, 1, "vec"),
    (4095, 2, "scalar"),  # an odd Ns on the projected path
    (7, 1, "scalar"),     # the ragged case
    (1024, 6, "scalar"),  # Dx beyond the registers of the vec kernel
    (1022, 2, "scalar"),  # M % 4 == 2: rows are not whole float4s
])
def test_rbf_route_picks_by_shape(M, Dx, route):
    assert cuda_kernels.rbf_route(M, Dx) == route


@pytest.mark.parametrize("M,route", [(8, "vec"), (7, "scalar")])
def test_rbf_router_reaches_the_launcher_of_the_route(monkeypatch, M, route):
    """``rbf_K_batched``, the CUDA implementation of the operator that
    ``RBFCrossCovariance`` calls, with the launchers swapped for recording
    plain versions (called directly: the dispatcher sends a CPU tensor to
    the operator's CPU implementation)."""
    calls = []
    for name in ("rbf_K_batched_vec", "rbf_K_batched_scalar"):
        def launcher(*args, name=name):
            calls.append(name)
            return cuda_kernels.rbf_K_batched_plain(*args)
        monkeypatch.setattr(cuda_kernels, name, launcher)
    arrays = [torch.from_numpy(a) for a in
              _inputs(N=5, M=M, Q=2, Dx=2, iso=False, dtype=np.float32)]
    got = cuda_kernels.rbf_K_batched(*arrays)
    assert calls == [f"rbf_K_batched_{route}"]
    assert torch.equal(got, cuda_kernels.rbf_K_batched_plain(*arrays))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_is_keyed_by_the_sources(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "hetmogp_tpu_torch")
    assert path == _build.library_path()
    for name in ("rbf_kernel.cu", "tril_proj_kernel.cu",
                 "tril_proj3_kernel.cu", "tril_tma.cuh"):
        assert (_build.CSRC / name).is_file()
        # an edit to any source, or to the header two of them include,
        # gives another library
        src = tmp_path / name
        for f in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
            (tmp_path / f.name).write_bytes(f.read_bytes())
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        assert _build.library_path() == path
        src.write_bytes(src.read_bytes() + b"\n")
        assert _build.library_path() != path
        monkeypatch.undo()


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source (-c, without -shared), then one link of the
    objects; the objects are removed and nvcc's output kept in the log.
    A stand-in nvcc writes its -o file and logs its arguments."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n"
                    f'echo "$@" >> {calls}\n'
                    'while [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then echo x > "$2"; fi; shift\n'
                    "done\necho 'ptxas info : Used 1 registers'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = _build.build()
    assert path.is_file() and path.parent == tmp_path / "build"
    lines = calls.read_text().splitlines()
    sources = sorted(_build.CSRC.glob("*.cu"))
    compiles, link = lines[:-1], lines[-1]
    assert len(compiles) == len(sources) >= 3
    for src in sources:
        (line,) = [c for c in compiles if c.endswith(str(src))]
        assert " -c " in line and "-shared" not in line and "sm_90a" in line
    assert "-shared" in link and link.count(".o") == len(sources)
    assert sorted(p.name for p in path.parent.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    assert path.with_suffix(".log").read_text().count("ptxas") == len(
        sources) + 1


# ---- the triangular projection's wrapper -----------------------------------

def _tri(dtype=np.float32, Q=2, N=9, M=7):
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(Q, N, M).astype(dtype)),
            torch.from_numpy(np.tril(rng.randn(Q, M, M)).astype(dtype)))


def test_cpu_tensors_take_the_plain_projection():
    A, L = _tri()
    before = cuda_kernels.launch_counts()
    got = linalg.matmul_tril_t(A, L)
    assert not cuda_dispatch.use_tril_kernel(A)
    assert cuda_kernels.launch_counts() == before
    torch.testing.assert_close(got, cuda_kernels.tril_projection_plain(A, L),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,err", [(np.float32, ValueError),
                                       (np.float64, TypeError)])
def test_projection_wrapper_refuses_cpu_and_non_f32(dtype, err):
    before = cuda_kernels.launch_counts()
    for launcher in (cuda_kernels.tril_projection,
                     cuda_kernels.tril_projection_tma):
        with pytest.raises(err):
            launcher(*_tri(dtype))
    assert cuda_kernels.launch_counts() == before


def test_projection_wrapper_refuses_grad():
    A, L = _tri()
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_kernels.tril_projection(A, L.requires_grad_())


@pytest.mark.parametrize("what", ["rbf", "tril"])
def test_dispatch_raises_on_cuda_non_f32(what):
    """A CUDA tensor of another dtype raises instead of taking the plain
    version (the policy, on a stand-in for a CUDA float64 tensor)."""
    fake = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    use = {"rbf": cuda_dispatch.use_rbf_kernel,
           "tril": cuda_dispatch.use_tril_kernel}[what]
    with pytest.raises(TypeError, match="float32 only"):
        use(fake)
    assert not use(fake, use_kernel=False)


# ---- gradients --------------------------------------------------------------

@pytest.mark.parametrize("iso", [False, True], ids=["ard", "iso"])
def test_rbf_backward_matches_jax_and_autograd_f64(iso):
    """rtol 1e-12 against JAX's ``_rbf_bwd``: the same algebra in float64,
    reduced in another order.  rtol 1e-10 against autograd through the
    plain RBF: another algebra (the difference form's chain rule), whose
    rounding differs by a few ulps per term over 40 x 30 terms."""
    X, Z, ls, var = _inputs(N=40, M=30, Q=3, Dx=2, iso=iso, dtype=np.float64)
    g = np.random.RandomState(1).randn(3, 40, 30)
    t = [torch.from_numpy(a).requires_grad_() for a in (X, Z, ls, var)]
    K = cuda_kernels.rbf_K_batched_plain(*t)
    want_autograd = torch.autograd.grad(K, t, torch.from_numpy(g))
    got = cuda_kernels.rbf_K_batched_bwd(*(a.detach() for a in t),
                                         K.detach(), torch.from_numpy(g))
    K_j = jkernels.K_batched("rbf", X, Z, ls, var, use_pallas=False)
    want_jax = pallas_kernels._rbf_bwd(
        tuple(jnp.asarray(a) for a in (X, Z, ls, var)) + (K_j,),
        jnp.asarray(g))
    for name, a, b, c in zip(("dX", "dZ", "dls", "dvar"), got, want_autograd,
                             want_jax):
        assert a.shape == b.shape == c.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_rbf_function_gives_the_plain_gradient(monkeypatch):
    """RBFCrossCovariance on CPU tensors, its launcher swapped for the plain
    version (a CPU tensor takes its operator's plain implementation
    anyway): its gradient is autograd's through the plain RBF (rtol 1e-10,
    as above), and a CPU tensor's backward pass is not counted: the count
    is the card's."""
    monkeypatch.setattr(cuda_kernels, "rbf_K_batched",
                        cuda_kernels.rbf_K_batched_plain)
    monkeypatch.setattr(cuda_kernels.RBFCrossCovariance, "backwards", 0)
    arrays = _inputs(**CASES["ard"], dtype=np.float64)
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    g = torch.from_numpy(np.random.RandomState(2).randn(2, 70, 50))
    got = torch.autograd.grad(cuda_kernels.RBFCrossCovariance.apply(*t), t, g)
    want = torch.autograd.grad(cuda_kernels.rbf_K_batched_plain(*t), t, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    assert cuda_kernels.RBFCrossCovariance.backwards == 0


def test_projection_function_gives_the_plain_gradient(monkeypatch):
    """TrilProjection's backward (g tril(L), tril(g^T A)) against autograd
    through the plain version: the same products in float64 (rtol 1e-12)."""
    monkeypatch.setattr(cuda_kernels, "tril_projection",
                        cuda_kernels.tril_projection_plain)
    A, L = (t.double().requires_grad_() for t in _tri())
    g = torch.from_numpy(np.random.RandomState(3).randn(*A.shape))
    got = torch.autograd.grad(cuda_kernels.TrilProjection.apply(A, L),
                              (A, L), g)
    want = torch.autograd.grad(cuda_kernels.tril_projection_plain(A, L),
                               (A, L), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)
