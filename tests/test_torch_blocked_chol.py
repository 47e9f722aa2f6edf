"""The blocked factorization (``linalg.blocked_cholesky_inverse``,
``linalg.blocked_cholesky``) and kernel 9 (``csrc/chol_panel_kernel.cu``,
the Cholesky factor and inverse of one diagonal panel), against the JAX
package's ``blocked_cholesky_inverse`` and ``blocked_cholesky`` on the same
numpy inputs.

Kernel 9 runs only on the card; here CPU tensors take its plain version
(``cuda_kernels.chol_panel_plain``).  Its own source is also built with a
host compiler against ``tests/host_cuda/cuda_runtime.h`` (a thread a CUDA
thread, barriers for ``__syncthreads`` and ``__syncwarp``, one buffer for
the dynamic shared memory) and driven through the port's launcher on
tensors that say they are on the card: alone, and on every panel of the
blocked factorization.  Those cases skip, with the reason, where no g++
is found.

Tolerances, normwise (max |a - b| / max |b|):
* 1e-10 in float64 against the JAX package (the factor, the inverse, the
  factor's gradient), where the two run the same panels and products in
  other orders, with one refinement step of the rows below each panel and
  float64 updates on the port's side, on matrices of condition ~1e2 to
  1e3;
* 2e-5 in float32 against the JAX package in float32 (both factor in
  float32 with other sums; the condition is ~1e2, so each is ~1e-6 from
  float64);
* kernel 9's host build: 1e-12 from the plain version in float64; in
  float32 at most 4x the plain float32 version's error against float64
  plus 1e-6 (the bound ``chip_smoke.py`` holds the kernel to on the card).
"""

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hetmogp_tpu as jhet
from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.models import elbo as jelbo
from hetmogp_tpu.models.params import SVMOGPParams as JParams
from hetmogp_tpu.ops import linalg as jlinalg

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.ops import _build, cuda_kernels, linalg

torch.set_num_threads(1)  # the file runs beside others under xdist

F64, F32 = 1e-10, 2e-5
# (Q, M, nb): two panels of 32 and 128; a ragged M (the JAX package falls
# back to its stock factor, the port takes a last panel of 4); M <= nb,
# one panel
CASES = [(3, 96, 32), (2, 256, 128), (2, 100, 32), (2, 60, None),
         (2, 128, None)]


def _ids(case):
    q, m, nb = case
    return f"Q{q}-M{m}-nb{nb}"


def _normwise(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _spd(q, m, seed=0):
    """A (q, m, m) SPD matrix, X X^T / m + I, of condition ~1e2."""
    rng = np.random.RandomState(seed)
    X = rng.randn(q, m, m + 4)
    return X @ X.transpose(0, 2, 1) / m + np.eye(m)


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


# ---- the blocked pair against the JAX package ----------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_blocked_pair_matches_jax_in_float64(case):
    q, m, nb = case
    K = _spd(q, m, seed=m)
    want_L, want_iL = jlinalg.blocked_cholesky_inverse(jnp.asarray(K), nb=nb)
    want_chol = jlinalg.blocked_cholesky(jnp.asarray(K), nb=nb)
    L, iL = linalg.blocked_cholesky_inverse(torch.from_numpy(K), nb)
    chol = linalg.blocked_cholesky(torch.from_numpy(K), nb)
    assert _normwise(L, want_L) < F64
    assert _normwise(iL, want_iL) < F64
    assert _normwise(chol, want_chol) < F64
    assert torch.equal(chol, L)  # the same panels, with or without strips
    for t in (L, iL):
        assert not torch.triu(t, 1).any()


@pytest.mark.parametrize("case", [(2, 256, 128), (2, 100, 32)], ids=_ids)
def test_blocked_pair_matches_jax_in_float32(case):
    q, m, nb = case
    K = _spd(q, m, seed=m).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_L, want_iL = jlinalg.blocked_cholesky_inverse(jnp.asarray(K),
                                                           nb=nb)
    L, iL = linalg.blocked_cholesky_inverse(torch.from_numpy(K), nb)
    assert L.dtype == iL.dtype == torch.float32
    assert _normwise(L, want_L) < F32
    assert _normwise(iL, want_iL) < F32


def test_blocked_pair_takes_a_batch_of_any_rank():
    K = _spd(6, 96, seed=1).reshape(2, 3, 96, 96)
    L, iL = linalg.blocked_cholesky_inverse(torch.from_numpy(K), 32)
    want_L, want_iL = jlinalg.blocked_cholesky_inverse(jnp.asarray(K), nb=32)
    assert L.shape == iL.shape == (2, 3, 96, 96)
    assert _normwise(L, want_L) < F64 and _normwise(iL, want_iL) < F64


@pytest.mark.parametrize("m,nb", [(96, 32), (100, 32), (60, None)])
def test_blocked_cholesky_gradient_matches_jax(m, nb):
    """The factor's gradient (chol_cached against the pair) against
    jax.grad of the JAX blocked factor, through a symmetric K = B B^T / m
    + I: the two K-gradients differ only in their antisymmetric part,
    which no symmetric K sees."""
    rng = np.random.RandomState(m)
    B0, W = rng.randn(2, m, m + 4), rng.randn(2, m, m)

    def jloss(B):
        K = B @ jnp.swapaxes(B, -1, -2) / m + jnp.eye(m)
        return jnp.sum(jnp.asarray(W) * jlinalg.blocked_cholesky(K, nb=nb))

    want = jax.grad(jloss)(jnp.asarray(B0))
    B = torch.from_numpy(B0).requires_grad_()
    K = B @ B.mT / m + torch.eye(m, dtype=torch.float64)
    (torch.from_numpy(W) * linalg.blocked_cholesky(K, nb)).sum().backward()
    assert _normwise(B.grad, want) < F64


def test_failed_factorization_gives_the_jax_nans_and_raises_nothing():
    """A non-SPD K: NaN from the failing panel on, in both outputs, where
    the JAX package has them; the other matrices and the panels before it
    finite."""
    K = _spd(2, 96, seed=3)
    K[1, 50, 50] = -1.0  # pivot 50: the second panel of 32
    want_L, want_iL = (np.asarray(t) for t in jlinalg.blocked_cholesky_inverse(
        jnp.asarray(K), nb=32))
    L, iL = linalg.blocked_cholesky_inverse(torch.from_numpy(K), 32)
    chol = linalg.blocked_cholesky(torch.from_numpy(K), 32)
    for got, want in ((L, want_L), (iL, want_iL), (chol, want_L)):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert _nan_below(L[1, 32:64, 32:64])  # the failing panel
    assert np.isnan(L[1, 64:, 32:64].numpy()).all()  # and the rows below
    assert not L[1].triu(1).any()
    assert np.isfinite(L[1, :, :32].numpy()).all()
    assert np.isfinite(iL[1, :32, :32].numpy()).all()
    assert np.isnan(iL[1, 32:, :64].numpy()).all()
    assert np.isfinite(L[0].numpy()).all() and np.isfinite(iL[0].numpy()).all()


def test_blocked_pair_records_no_gradient():
    K = torch.from_numpy(_spd(2, 64)).requires_grad_()
    with pytest.raises(RuntimeError, match="records no gradient"):
        linalg.blocked_cholesky_inverse(K)
    with torch.no_grad():
        L, iL = linalg.blocked_cholesky_inverse(K)
    assert not (L.requires_grad or iL.requires_grad)


@pytest.mark.parametrize("nb", [0, 129])
def test_panel_width_out_of_range_raises(nb):
    with pytest.raises(ValueError, match="panel width"):
        linalg.blocked_cholesky_inverse(torch.from_numpy(_spd(1, 64)), nb)


def test_cpu_pair_launches_nothing_and_reaches_the_product_operators():
    """On the CPU: kernel 9's plain version, no launch; the rows below the
    first panel (and their refinement) through kernel A's operator, the
    second panel's strip through kernel 4's."""
    K = torch.from_numpy(_spd(2, 256).astype(np.float32))
    before = cuda_kernels.launch_counts()
    with _Ops() as ops:
        linalg.blocked_cholesky_inverse(K)
    assert ops.seen == {"hetmogp::tril_projection": 2,
                        "hetmogp::matmul_tril": 1}
    assert cuda_kernels.launch_counts() == before


# ---- prior_cholesky(blocked=True) and prior_cholesky_inverse -------------------

@pytest.fixture(scope="module")
def model():
    """The bench's six likelihoods at Q=2, M=256, float64: the JAX package
    takes its blocked path (two panels of 128)."""
    q, m, dx = 2, 256, 2
    names = ("HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
             "Exponential")
    cfg = jhet.ModelConfig(likelihoods=tuple(getattr(jliks, n)()
                                             for n in names),
                           num_latent=q, num_inducing=m, input_dim=dx,
                           dtype="float64", jitter=1e-4,
                           adaptive_jitter=False, ard=True)
    rng = np.random.RandomState(0)
    D = cfg.num_output_functions
    leaves = dict(Z=np.broadcast_to(rng.rand(m, dx), (q, m, dx)).copy(),
                  q_mu=0.3 * rng.randn(q, m),
                  q_sqrt=0.5 * np.eye(m) + 0.01 * np.tril(rng.randn(q, m, m)),
                  log_lengthscale=np.log(0.3 + 0.1 * rng.rand(q, dx)),
                  log_variance=np.log(0.5 + rng.rand(q)),
                  W=rng.randn(q, D), kappa=np.zeros((q, D)))
    jp = JParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tcfg = tp.ModelConfig.from_dict(cfg.to_dict())
    tparams = tp.params_from_jax(types.SimpleNamespace(**leaves),
                                 device="cpu")
    return cfg, jp, tcfg, tparams


def test_prior_cholesky_blocked_matches_jax(model):
    """The JAX signature's ``blocked`` keyword (the port refused it before
    the blocked factorization came), and the fused pair."""
    cfg, jp, tcfg, tparams = model
    want = jelbo.prior_cholesky(jp, cfg, blocked=True)
    got = telbo.prior_cholesky(tparams, tcfg, blocked=True)
    assert _normwise(got, want) < F64
    want_L, want_iL = jelbo.prior_cholesky_inverse(jp, cfg)
    L, iL = telbo.prior_cholesky_inverse(tparams, tcfg)
    assert _normwise(L, want_L) < F64 and _normwise(iL, want_iL) < F64
    assert torch.equal(L, got)


def test_prior_cholesky_blocked_follows_the_jax_branches(model, monkeypatch):
    """blocked=True takes the blocked factor at fixed jitter in the working
    dtype only: the float64 island and the adaptive jitter keep theirs."""
    _, _, tcfg, tparams = model
    calls = []
    monkeypatch.setattr(linalg, "blocked_cholesky",
                        lambda K, **kw: calls.append(K.shape) or
                        torch.linalg.cholesky(K))
    telbo.prior_cholesky(tparams, tcfg, blocked=True)
    telbo.prior_cholesky(tparams, tcfg)
    telbo.prior_cholesky(tparams, dataclasses.replace(
        tcfg, adaptive_jitter=True), blocked=True)
    telbo.prior_cholesky(tparams.to(dtype=torch.float32), dataclasses.replace(
        tcfg, dtype="float32", chol_dtype="float64"), blocked=True)
    assert calls == [(2, 256, 256)]


# ---- the callers that reach the blocked path -----------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Wrap the two blocked functions: each call's name, and whether its K
    would have needed a gradient."""
    calls = []
    for name in ("blocked_cholesky_inverse", "blocked_cholesky"):
        real = getattr(linalg, name)

        def record(K, *a, _name=name, _real=real, **kw):
            calls.append((_name, torch.is_grad_enabled() and K.requires_grad))
            return _real(K, *a, **kw)
        monkeypatch.setattr(linalg, name, record)
    return calls


def _small(m=24):
    liks = (tp.HetGaussian(), tp.Bernoulli())
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=m,
                         input_dim=1, dtype="float64", jitter=1e-6,
                         adaptive_jitter=False)
    rng = np.random.default_rng(1)
    params = tp.init_params(rng, cfg, np.linspace(0, 1, m)[:, None],
                            lengthscale=0.3, device="cpu")
    X = [np.sort(rng.random((30, 1)), 0) for _ in range(2)]
    Y = [rng.standard_normal((30, 1)), (rng.random((30, 1)) > 0.5) * 1.0]
    data, scales = tp.full_batch(X, Y, dtype=torch.float64, device="cpu")
    return cfg, params, data, torch.as_tensor(scales)


@pytest.mark.parametrize("fast", [True, False], ids=["inverse", "factor"])
def test_init_and_refresh_take_the_blocked_path(recorded, fast):
    """The trainer's init (JAX train.py:229) and the VM step's refresh
    (JAX train.py:564-575): the fused pair where the state keeps the
    inverse, the blocked factor where it keeps Luu alone; neither needs a
    gradient."""
    cfg, params, data, scales = _small()
    tc = tp.TrainConfig(ve_steps_per_vm=1, fast_projection=fast)
    state = tp.init_train_state(params, cfg, tc)
    name = "blocked_cholesky_inverse" if fast else "blocked_cholesky"
    assert recorded == [(name, False)]
    step = ttrain.make_step(cfg, tc)
    state, _ = step(state, data, scales)  # VE: no refresh
    assert len(recorded) == 1
    state, _ = step(state, data, scales)  # VM: the refresh
    assert recorded == [(name, False)] * 2
    assert (state.iLuu is not None) == fast


def test_natgrad_exact_attempt_takes_the_blocked_pair(recorded):
    """natural gradients' "exact" retraction (JAX train.py:1499): both
    attempts (lr and lr/4) factor A through the blocked pair, without a
    gradient."""
    cfg, params, data, scales = _small()
    ttrain.natgrad_ve_step(params, data, scales, cfg, 0.1,
                           retraction="exact")
    assert recorded == [("blocked_cholesky_inverse", False)] * 2


# ---- kernel 9: its plain version, its launcher ---------------------------------

def _nan_below(L):
    """A failed panel's L: NaN on and below the diagonal, zero above."""
    rows, cols = torch.tril_indices(*L.shape)
    return bool(torch.isnan(L[rows, cols]).all()
                and not torch.triu(L, 1).any())


def test_chol_panel_plain_is_torch_cholesky_and_solve():
    A = torch.from_numpy(_spd(3, 100))
    L, iL = cuda_kernels.chol_panel_plain(A)
    want = torch.linalg.cholesky(A)
    eye = torch.eye(100, dtype=torch.float64)
    assert torch.equal(L, want)
    assert torch.equal(iL, torch.linalg.solve_triangular(
        want, eye.expand_as(want), upper=False))
    bad = A.clone()
    bad[1, 7, 7] = -1.0
    L, iL = cuda_kernels.chol_panel_plain(bad)
    assert _nan_below(L[1]) and torch.isnan(iL[1]).all()
    assert torch.equal(L[[0, 2]], want[[0, 2]])


@pytest.mark.parametrize("bad,err", [
    ("cpu", ValueError), ("half", TypeError), ("wide", ValueError),
    ("grad", NotImplementedError)])
def test_chol_panel_launcher_refuses(bad, err):
    """The raw launcher takes float32 or float64 CUDA tensors of n <= 128
    that record no gradient; a CPU tensor is refused, not sent to the
    plain version.  Nothing is launched."""
    A = torch.from_numpy(_spd(2, 16).astype(np.float32))
    A = {"cpu": lambda: A, "half": A.half,
         "wide": lambda: torch.zeros(2, 129, 129),
         "grad": A.requires_grad_}[bad]()
    if bad != "cpu":
        A = A.as_subclass(_OnCard)
    before = cuda_kernels.launch_counts()
    with pytest.raises(err):
        cuda_kernels.chol_panel(A)
    assert cuda_kernels.launch_counts() == before


# ---- kernel 9's own source, on the host --------------------------------------

HOST_STUB = Path(__file__).resolve().parent / "host_cuda"
KERNEL_SOURCE = _build.CSRC / "chol_panel_kernel.cu"
LAUNCH = re.compile(r"(\w+<T>)<<<(\w+), (\w+), (\w+), stream>>>\((.*?)\);",
                    re.S)
SMEM = "extern __shared__ __align__(16) unsigned char chol_panel_smem[];"


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the routes and the
    launcher read (``is_cuda``), without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture(scope="module")
def host_kernel():
    """csrc/chol_panel_kernel.cu built for the host (``build/``, named by a
    hash of the rewritten source and the header), its entries bound as
    ``ops/cuda_kernels.py`` binds the card's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of "
                    "csrc/chol_panel_kernel.cu needs a C++20 compiler")
    text, launches = LAUNCH.subn(r"host_launch(\2, \3, \4, [&] { \1(\5); });",
                                 KERNEL_SOURCE.read_text())
    assert launches == 1 and SMEM in text, "the kernel's launch changed form"
    text = text.replace(SMEM,
                        "unsigned char* chol_panel_smem = host_dynamic_smem;")
    h = hashlib.sha256(text.encode())
    h.update((HOST_STUB / "cuda_runtime.h").read_bytes())
    out = _build.BUILD_DIR / f"libchol_panel_host-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cpp = out.with_suffix(f".{os.getpid()}.cpp")
        cpp.write_text(text)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-pthread", f"-I{HOST_STUB}", "-o", str(tmp),
                            str(cpp)], check=True, capture_output=True,
                           timeout=300)
        finally:
            cpp.unlink(missing_ok=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    args = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"hetmogp_chol_panel_{dt}")
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(monkeypatch, host_kernel):
    """Kernel 9's launcher on the host build: its library, and no CUDA
    device or stream to enter."""
    monkeypatch.setattr(cuda_kernels, "_library", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=None))


@pytest.mark.parametrize("n", [1, 9, 31, 32, 33, 64, 65, 96, 97, 100,
                               127, 128])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_source_on_host_matches_plain(on_host, n, dtype):
    """Through the port's launcher: the panel read through its strides (a
    view of a larger matrix), L and iL written into views of larger
    buffers, exact zeros above the diagonal, two launches bitwise equal,
    one launch counted each."""
    big = torch.from_numpy(_spd(3, n + 5, seed=n)).to(dtype)
    A = big[:, 2:n + 2, 2:n + 2]  # SPD, rows n + 5 apart
    ref = cuda_kernels.chol_panel_plain(A.double())
    plain = cuda_kernels.chol_panel_plain(A)
    bufs = [torch.full((3, n + 3, n + 7), 7.0, dtype=dtype) for _ in range(2)]
    views = [b[:, 1:n + 1, 3:n + 3].as_subclass(_OnCard) for b in bufs]
    before = cuda_kernels.chol_panel.launches
    got = cuda_kernels.chol_panel(A.as_subclass(_OnCard), views[0], views[1])
    again = cuda_kernels.chol_panel(A.as_subclass(_OnCard))
    assert cuda_kernels.chol_panel.launches == before + 2
    assert got[0] is views[0] and got[1] is views[1]
    for g, a in zip(got, again):
        assert torch.equal(g.as_subclass(torch.Tensor),
                           a.as_subclass(torch.Tensor))
        assert not torch.triu(g.as_subclass(torch.Tensor), 1).any()
    for b in bufs:  # nothing outside the views
        assert (b[:, 0] == 7).all() and (b[:, :, :3] == 7).all()
    for g, p, r in zip(got, plain, ref):
        g = g.as_subclass(torch.Tensor)
        if dtype == torch.float64:
            assert _normwise(g, p.numpy()) < 1e-12
        else:
            assert (_normwise(g, r.numpy())
                    <= 4 * _normwise(p, r.numpy()) + 1e-6)


@pytest.mark.parametrize("n,pivot", [(70, 40), (128, 0), (128, 40),
                                     (128, 127)])
def test_kernel_source_on_host_gives_nan_for_a_failed_panel(on_host, n,
                                                             pivot):
    """A pivot that fails in the first, a middle or the last sub-panel:
    that matrix's L NaN on and below the diagonal and zero above, all of
    its iL NaN, the other matrices finite."""
    A = torch.from_numpy(_spd(3, n, seed=5))
    A[1, pivot, pivot] = -1.0
    L, iL = (t.as_subclass(torch.Tensor)
             for t in cuda_kernels.chol_panel(A.as_subclass(_OnCard)))
    assert _nan_below(L[1]) and torch.isnan(iL[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(iL[[0, 2]]).all()


@pytest.mark.parametrize("case", [(2, 256, 128), (2, 100, 32)], ids=_ids)
def test_blocked_pair_on_the_host_kernel_matches_jax(on_host, case):
    """The whole blocked pair in float64 with kernel 9's source on every
    diagonal panel (the products' plain versions: kernels A and 4 take
    float32 only), against the JAX package."""
    q, m, nb = case
    K = _spd(q, m, seed=m + 1)
    want_L, want_iL = jlinalg.blocked_cholesky_inverse(jnp.asarray(K), nb=nb)
    before = cuda_kernels.chol_panel.launches
    L, iL = (t.as_subclass(torch.Tensor) for t in
             linalg.blocked_cholesky_inverse(
                 torch.from_numpy(K).as_subclass(_OnCard), nb))
    assert cuda_kernels.chol_panel.launches == before + -(-m // nb)
    assert _normwise(L, want_L) < F64 and _normwise(iL, want_iL) < F64
