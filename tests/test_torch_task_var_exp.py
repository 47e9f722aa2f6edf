"""Kernel 6's task table on the CPU: its arithmetic, its plain version and
its route.

The task table (``csrc/ve_tasks_kernel.cu``) runs only on the card.  Its
arithmetic, the closed forms of HetGaussian, Poisson, Gamma and
Exponential on a first-order jet, the sweeps of Bernoulli, Categorical and
Gamma's lngamma, the multi-term families (Beta, Binomial, Dirichlet and
the zero-inflated Poisson: several sweeps a row, a family's constants), a
row's lanes and their fixed tree (``gh::task_row`` of
``csrc/gh_sweep.cuh``), is plain C++ that ``csrc/gh_sweep_host.cpp``
builds with g++; this file holds it, through ctypes, to the port's plain
closed forms and engines (autograd over ``var_exp``) and to the JAX
package's on the same numpy inputs.  It skips, with the reason, where no
g++ is found.

Tolerances, normwise (max |a - b| / max |b| per output and task):
* float64: 1e-12 for the value and the coefficients (c_m, c_v) against the
  port's plain version and the JAX package's; Gamma's c_v holds torch's
  float64 trigamma in the port's plain engine (``polygamma(1, x)``, good
  to ~5e-10 relative), so it is held to 1e-8 there and to 1e-12 against
  JAX's;
* float32 against the float64 plain version: at most 4x the float32 plain
  version's own error plus 1e-6, and non-finite exactly where the float32
  plain version is (the bound ``chip_smoke.py`` holds the kernel to);
* the plain term (``quadrature.task_var_exp_plain``) against the JAX
  package's likelihood term (``hetmogp_tpu/models/elbo.py:442-454``), its
  value and gradients with respect to every task's (m_F, v_F): 1e-12 in
  float64 (Gamma's dV 1e-8, the trigamma above).

Then the routes, on the CPU: which likelihoods name a family of
``TASK_FAMILIES``, which tasks ``likelihood_term`` sends to the table and
which keep their own ``var_exp`` (with the program counters of the call),
CPU tensors and ``use_kernel=False``
taking the plain term, a tensor on the card reaching the forward launcher
(or the value-alone one under ``no_grad``) and the backward launcher, and
the Function's gradients, from the launchers' coefficients, equal to the
plain term's.

Last, the kernel's own source: ``csrc/ve_tasks_kernel.cu`` built with a
host compiler against ``tests/host_cuda/cuda_runtime.h`` (a thread a CUDA
thread, a barrier for ``__syncthreads``) and driven through the port's
launchers, held bitwise to the host row routine, to the fixed order of its
sums (block trees, then the last block's strided sums and tree), to the
backward's products, and to itself (two launches, the value alone), on
five tables: the flagship's six tasks, a ragged one with an empty task,
twenty tasks over two launches with K = 6 on quasi-MC nodes and other
lane counts, and two with the multi-term families; the instantiation each
table's launch takes; and the shapes a recorded launch gives
``hmbench``'s roofline formulas.  It skips where no g++ is found.
"""

import contextlib
import ctypes
import hashlib
import math
import os
import pathlib
import re
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetmogp_tpu import likelihoods as jliks
import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import likelihoods as tliks
from hetmogp_tpu_torch import profiling
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.ops import _build, cuda_kernels, quadrature

torch.set_num_threads(1)

HOST_SOURCES = (_build.CSRC / "gh_sweep_host.cpp",
                _build.CSRC / "gh_sweep.cuh")


@pytest.fixture(autouse=True)
def _launch_counts_down_after():
    """The launch counts are global to the process, and this file's cases
    drive the launchers on the host build of
    kernel 6 and on stand-ins for a card tensor: each case leaves them at 0, so that a
    later file in the same process starts from 0 too."""
    yield
    cuda_kernels.zero_launch_counts()


@pytest.fixture(scope="module")
def host():
    """``csrc/gh_sweep_host.cpp`` built with g++ into ``build/`` (the name
    carries a hash of the sources) and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of kernel 6's task table "
                    "(csrc/gh_sweep_host.cpp) needs a C++17 compiler")
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libgh_sweep_host-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                        str(tmp), str(HOST_SOURCES[0])], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for name in ("gh_task_rows_f32", "gh_task_rows_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] * 3 + [ptr] * 3 + [i64] * 3 + [ptr] * 2
                       + [ctypes.c_int] + [ptr] * 2 + [ctypes.c_int] * 2
                       + [ptr])
        fn.restype = ctypes.c_int
    return lib


# the flagship's six likelihoods, both sides, and observations of each
# support; the extreme rows' y at and past the closed forms' clips
FAMILIES = {
    "HetGaussian": (tliks.HetGaussian(), jliks.HetGaussian(),
                    lambda r, n: r.randn(n, 1), (1e5, -1e5, 0.0, 3.0)),
    "Bernoulli": (tliks.Bernoulli(), jliks.Bernoulli(),
                  lambda r, n: (r.rand(n, 1) > 0.5) * 1.0, (0, 1, 1, 0)),
    "Categorical": (tliks.Categorical(K=3), jliks.Categorical(K=3),
                    lambda r, n: r.randint(1, 4, (n, 1)) * 1.0,
                    (1, 3, 2, 1)),
    "Poisson": (tliks.Poisson(), jliks.Poisson(),
                lambda r, n: r.poisson(3.0, (n, 1)) * 1.0, (0, 1e4, 0, 7)),
    "Gamma": (tliks.Gamma(), jliks.Gamma(),
              lambda r, n: r.gamma(2.0, 1.0, (n, 1)) + 1e-3,
              (1e-9, 1e9, 1e-3, 5.0)),
    "Exponential": (tliks.Exponential(), jliks.Exponential(),
                    lambda r, n: r.exponential(1.0, (n, 1)) + 1e-3,
                    (1e-9, 1e9, 1e-3, 5.0)),
}
# the flagship's likelihoods by the task table's family code
BY_CODE = {quadrature.TASK_FAMILIES[quadrature.task_family(f[0])][0]: f[0]
           for f in FAMILIES.values()}
# the multi-term families (several sweeps, a family's constants), as the
# ten-family model has them and at the other K and n the table takes; the
# extreme rows' y inside the support
TERM_FAMILIES = {
    "Beta": (tliks.Beta(), jliks.Beta(),
             lambda r, n: 0.02 + 0.96 * r.rand(n, 1), (0.01, 0.99, 0.5, 0.2)),
    "Binomial-n1": (tliks.Binomial(n=1), jliks.Binomial(n=1),
                    lambda r, n: r.randint(0, 2, (n, 1)) * 1.0, (0, 1, 1, 0)),
    "Binomial-n10": (tliks.Binomial(n=10), jliks.Binomial(n=10),
                     lambda r, n: r.randint(0, 11, (n, 1)) * 1.0,
                     (0, 10, 3, 7)),
    "Dirichlet-K2": (tliks.Dirichlet(K=2), jliks.Dirichlet(K=2),
                     lambda r, n: r.dirichlet([2.0, 3.0], n), ()),
    "Dirichlet-K3": (tliks.Dirichlet(K=3), jliks.Dirichlet(K=3),
                     lambda r, n: r.dirichlet([2.0, 3.0, 1.5], n), ()),
    "ZIP-y0": (tliks.ZeroInflatedPoisson(), jliks.ZeroInflatedPoisson(),
               lambda r, n: np.zeros((n, 1)), ()),
    "ZIP": (tliks.ZeroInflatedPoisson(), jliks.ZeroInflatedPoisson(),
            lambda r, n: r.poisson(3.0, (n, 1)) + 1.0, (1, 1e4, 2, 7)),
}
ROW_CASES = {**FAMILIES, **TERM_FAMILIES}
# torch's float64 trigamma (polygamma(1, x), ~5e-10) in the plain engine's
# lngamma sweeps: c_v held to 1e-8 against it (1e-12 against JAX's)
TRIGAMMA = ("Gamma", "Beta", "Dirichlet-K2", "Dirichlet-K3")
# m = -+200 with v = 50, m = -+20 with v = 5, and v = 0
EXTREME_MV = ((-200.0, 50.0), (200.0, 50.0), (-20.0, 5.0), (20.0, 5.0),
              (0.3, 0.0), (-1.5, 0.0))


def _inputs(name, n=24, seed=0):
    """(Y, m, v) float64: n random rows, then the extreme ones."""
    lik, _, draw, ys = ROW_CASES[name]
    rng = np.random.RandomState(seed)
    J = lik.dim_f
    ext = len(EXTREME_MV)
    m = np.concatenate([1.5 * rng.randn(n, J),
                        np.repeat([[a] for a, _ in EXTREME_MV], J, 1)])
    v = np.concatenate([0.01 + 2.0 * rng.rand(n, J),
                        np.repeat([[b] for _, b in EXTREME_MV], J, 1)])
    Y = draw(rng, n + ext)
    Y[n:n + len(ys), 0] = ys
    return Y, m, v


def host_rows(lib, lik, Y, m, v, dtype, lanes=None):
    """(value, c_m, c_v) of every row by the host build of the task
    table's row routine, on the likelihood's node table (a multi-term
    family's terms one after another, with their node counts) and with its
    constants."""
    code, nodes, w = quadrature._task_table(
        [lik], torch.zeros(1, dtype=torch.float64))[0]
    sizes, consts = quadrature._task_extras(lik)
    nodes = np.zeros((1, 1)) if nodes is None else nodes.numpy()
    w = np.zeros(1) if w is None else w.numpy()
    J = m.shape[1]
    arr = [np.ascontiguousarray(a, dtype) for a in (m, v, Y, nodes, w)]
    sizes = np.array(list(sizes) + [0], np.int32)
    consts = np.array((list(consts) + [0.0, 0.0])[:2], np.float64)
    N, S = m.shape[0], nodes.shape[0]
    L = cuda_kernels.task_lanes(S) if lanes is None else lanes
    out = np.zeros((N, 1 + 2 * J), dtype)
    fn = lib.gh_task_rows_f64 if dtype == np.float64 else lib.gh_task_rows_f32
    rc = fn(code, J, L, *(a.ctypes.data for a in arr[:3]), J, J,
            arr[2].shape[1], arr[3].ctypes.data, arr[4].ctypes.data, S,
            sizes.ctypes.data, consts.ctypes.data, N, 1, out.ctypes.data)
    assert rc == 0
    return out[:, 0], out[:, 1:1 + J], out[:, 1 + J:]


def _plain(lik, Y, m, v, dtype):
    """(value, c_m, c_v) of the port's plain var_exp on the CPU."""
    M = torch.tensor(m, dtype=dtype, requires_grad=True)
    V = torch.tensor(v, dtype=dtype, requires_grad=True)
    val = lik.var_exp(torch.tensor(Y, dtype=dtype), M, V)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    return [a.detach().double().numpy() for a in (val, dm, dv)]


def _jax(jlik, Y, m, v):
    @jax.jit
    def ref(Y, m, v):
        val, vjp = jax.vjp(lambda a, b: jlik.var_exp(Y, a, b), m, v)
        return (val, *vjp(jnp.ones_like(val)))

    return [np.asarray(a) for a in ref(*(jnp.asarray(x) for x in (Y, m, v)))]


def normwise(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("name", list(ROW_CASES))
def test_row_routine_matches_plain_and_jax_f64(host, name):
    lik, jlik = ROW_CASES[name][:2]
    Y, m, v = _inputs(name)
    got = host_rows(host, lik, Y, m, v, np.float64)
    plain = _plain(lik, Y, m, v, torch.float64)
    ref = _jax(jlik, Y, m, v)
    for what, a, b, c in zip(("value", "c_m", "c_v"), got, plain, ref):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        tol = 1e-8 if (name in TRIGAMMA and what == "c_v") else 1e-12
        assert normwise(a[fin], b[fin]) < tol, (name, what,
                                                normwise(a[fin], b[fin]))
        assert normwise(a[fin], c[fin]) < 1e-12, (name, what,
                                                  normwise(a[fin], c[fin]))


@pytest.mark.parametrize("name", list(ROW_CASES))
def test_row_routine_f32_within_the_plain_bound(host, name):
    lik = ROW_CASES[name][0]
    Y, m, v = _inputs(name, seed=1)
    Y32, m32, v32 = (a.astype(np.float32) for a in (Y, m, v))
    want = _plain(lik, *(a.astype(np.float64) for a in (Y32, m32, v32)),
                  torch.float64)
    plain32 = _plain(lik, Y32, m32, v32, torch.float32)
    got = host_rows(host, lik, Y32, m32, v32, np.float32)
    for what, a, p, b in zip(("value", "c_m", "c_v"), got, plain32, want):
        a = a.astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(p))
        fin = np.isfinite(p) & np.isfinite(b)
        bound = 4.0 * normwise(p[fin], b[fin]) + 1e-6
        assert normwise(a[fin], b[fin]) <= bound, (name, what, bound)


@pytest.mark.parametrize("name", ["Bernoulli", "Categorical", "Gamma",
                                  *TERM_FAMILIES])
def test_row_routine_takes_any_lane_count(host, name):
    """The lanes of a row change only the order of its node sums."""
    lik = ROW_CASES[name][0]
    Y, m, v = _inputs(name, n=12, seed=2)
    base = host_rows(host, lik, Y, m, v, np.float64)
    for lanes in (1, 3, 7, 32, 100, 256):
        got = host_rows(host, lik, Y, m, v, np.float64, lanes=lanes)
        for a, b in zip(got, base):
            assert normwise(a, b) < 1e-13, (name, lanes)


# ---- the plain term against the JAX package's ---------------------------

def _term_inputs(dtype=np.float64, rows=(9, 7, 8, 6, 10, 5), seed=3):
    rng = np.random.RandomState(seed)
    Y, M, V, masks = [], [], [], []
    for (lik, _, draw, _), n in zip(FAMILIES.values(), rows):
        Y.append(draw(rng, n).astype(dtype))
        M.append((1.5 * rng.randn(n, lik.dim_f)).astype(dtype))
        V.append((0.01 + 2.0 * rng.rand(n, lik.dim_f)).astype(dtype))
        masks.append(((rng.rand(n) > 0.3) * 1.0).astype(dtype))
    scales = (1.0 + 10.0 * rng.rand(len(rows))).astype(dtype)
    return Y, M, V, masks, scales


def _jax_term(Y, M, V, masks, scales):
    """``hetmogp_tpu/models/elbo.py:442-454``'s likelihood term at given
    moments: its sums and their total's gradient in every (m_F, v_F)."""
    jl = [f[1] for f in FAMILIES.values()]

    def term(M, V):
        return jnp.stack([scales[t] * jnp.sum(lik.var_exp(Y[t], M[t], V[t])
                                              * masks[t])
                          for t, lik in enumerate(jl)])

    sums, vjp = jax.vjp(term, [jnp.asarray(m) for m in M],
                        [jnp.asarray(v) for v in V])
    dM, dV = vjp(jnp.ones_like(sums))
    return np.asarray(sums), [np.asarray(a) for a in dM], \
        [np.asarray(a) for a in dV]


def test_plain_term_matches_the_jax_likelihood_term_f64():
    Y, M, V, masks, scales = _term_inputs()
    liks = [f[0] for f in FAMILIES.values()]
    Ms = [torch.tensor(m, requires_grad=True) for m in M]
    Vs = [torch.tensor(v, requires_grad=True) for v in V]
    sums = quadrature.task_var_exp_plain(
        liks, [torch.tensor(y) for y in Y], Ms, Vs,
        [torch.tensor(k) for k in masks], list(torch.tensor(scales)))
    grads = torch.autograd.grad(sums.sum(), Ms + Vs)
    want, dM, dV = _jax_term(Y, M, V, masks, scales)
    assert normwise(sums.detach().numpy(), want) < 1e-12
    for t, name in enumerate(FAMILIES):
        assert normwise(grads[t].numpy(), dM[t]) < 1e-12, name
        tol = 1e-8 if name == "Gamma" else 1e-12
        assert normwise(grads[6 + t].numpy(), dV[t]) < tol, name


# ---- the routes ------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the routes read
    (``is_cuda``), without a card."""

    @property
    def is_cuda(self):
        return True


def _card(a):
    return torch.as_tensor(a).as_subclass(_OnCard)


def _fake_launchers(monkeypatch, host=None):
    """Swap the task table's launchers for the host build's rows (or
    zeros without ``host``) and the backward's formula, recording each
    call: what the Function and the routes reach, without a card."""
    calls = []

    def rows(tasks, scales, deriv):
        values, coefs, sums = [], [], []
        for (code, y, m, v, mask, *_), s in zip(tasks, scales):
            N, J = m.shape
            if host is None:
                val, c = torch.zeros(N, dtype=m.dtype), torch.zeros(
                    N, 2 * J, dtype=m.dtype)
            else:
                val, cm, cv = host_rows(host, BY_CODE[code], y.numpy(),
                                        m.numpy(), v.numpy(), np.float64)
                val = torch.tensor(val)
                c = torch.tensor(np.concatenate([cm, cv], axis=1))
            values.append(val)
            coefs.append(c)
            sums.append(s * torch.sum(torch.as_tensor(mask) * val))
        return torch.stack(sums), values, coefs if deriv else None

    def forward(tasks, scales, lanes=None):
        calls.append(("task_var_exp", tuple(t[0] for t in tasks)))
        return rows(tasks, scales, True)

    def value(tasks, scales, lanes=None):
        calls.append(("task_var_exp_value", tuple(t[0] for t in tasks)))
        return rows(tasks, scales, False)[:2]

    def backward(coefs, masks, scales, g):
        calls.append(("task_var_exp_backward", len(coefs)))
        out = []
        for i, (c, mask, s) in enumerate(zip(coefs, masks, scales)):
            J = c.shape[1] // 2
            gm = (g[i] * s) * torch.as_tensor(mask)
            out.append((c[:, :J] * gm[:, None], c[:, J:] * gm[:, None]))
        return out

    def sweep(family, y, m, v, nodes, w):
        calls.append(("gh_sweep", family))
        return (torch.zeros(m.shape[0], dtype=m.dtype),
                torch.zeros(m.shape, dtype=m.dtype),
                torch.zeros(m.shape, dtype=m.dtype))

    def sweep_value(family, y, m, v, nodes, w):
        calls.append(("gh_sweep_value", family))
        return torch.zeros(m.shape[0], dtype=m.dtype)

    monkeypatch.setattr(cuda_kernels, "task_var_exp", forward)
    monkeypatch.setattr(cuda_kernels, "task_var_exp_value", value)
    monkeypatch.setattr(cuda_kernels, "task_var_exp_backward", backward)
    monkeypatch.setattr(cuda_kernels, "gh_sweep", sweep)
    monkeypatch.setattr(cuda_kernels, "gh_sweep_value", sweep_value)
    return calls


def test_task_families_and_the_likelihoods_that_name_them():
    assert {k: v[0] for k, v in quadrature.TASK_FAMILIES.items()} == {
        "bernoulli": 0, "categorical": 1, "hetgaussian": 2, "poisson": 3,
        "gamma": 4, "exponential": 5, "beta": 6, "binomial": 7,
        "dirichlet": 8, "zipoisson": 9}
    named = {type(lik).__name__: quadrature.task_family(lik) for lik in (
        tliks.HetGaussian(), tliks.Bernoulli(), tliks.Categorical(K=3),
        tliks.Poisson(), tliks.Gamma(), tliks.Exponential(), tliks.Beta(),
        tliks.Binomial(n=10), tliks.Dirichlet(K=3),
        tliks.ZeroInflatedPoisson())}
    assert named == {"HetGaussian": "hetgaussian", "Bernoulli": "bernoulli",
                     "Categorical": "categorical", "Poisson": "poisson",
                     "Gamma": "gamma", "Exponential": "exponential",
                     "Beta": "beta", "Binomial": "binomial",
                     "Dirichlet": "dirichlet",
                     "ZeroInflatedPoisson": "zipoisson"}
    assert quadrature.task_family(tliks.Dirichlet(K=2)) == "dirichlet"
    # their own path: no closed form, no device function, a Categorical
    # past the sweep's J, a Dirichlet on quasi-MC nodes or past K = 3
    for lik in (tliks.HetGaussian(analytic=False),
                tliks.Poisson(analytic=False), tliks.Gamma(analytic=False),
                tliks.Exponential(analytic=False), tliks.Gaussian(),
                tliks.Beta(analytic=False), tliks.Dirichlet(analytic=False),
                tliks.Dirichlet(K=3, mc_samples=16), tliks.Dirichlet(K=4),
                tliks.LogNormal(), tliks.Ordinal(K=4), tliks.StudentT(),
                tliks.Weibull(), tliks.NegativeBinomial(),
                tliks.Categorical(K=7, mc_samples=16)):
        assert quadrature.task_family(lik) is None, type(lik).__name__
    assert quadrature.task_family(tliks.Categorical(K=6, mc_samples=16)) \
        == "categorical"
    # Gamma's closed form sweeps E[ln Gamma(a)] on the 1-D T=20 grid
    assert tliks.Gamma().task_grid() == (20, 1, 0)
    assert tliks.Categorical(K=3).task_grid() == (10, 2, 0)
    # the multi-term families: a grid a term, Beta's mix of T=20 and T=10
    assert tliks.Beta().task_grid() == [(20, 1, 0), (20, 1, 0), (10, 2, 0)]
    assert tliks.Dirichlet(K=3).task_grid() == [(20, 1, 0)] * 3 + [(5, 3, 0)]
    assert tliks.Dirichlet(K=2).task_grid() == [(20, 1, 0)] * 2 + [(10, 2, 0)]
    assert tliks.Binomial(n=10).task_grid() == [(20, 1, 0)]
    assert tliks.ZeroInflatedPoisson().task_grid() == [(10, 2, 0)]
    assert tliks.Binomial(n=10).task_consts() == (10.0, math.lgamma(11.0))
    assert quadrature._task_extras(tliks.Dirichlet(K=3)) == (
        (20, 20, 20, 125), ())


# observations of each family's support, six rows
_DRAW = {
    "HetGaussian": lambda r, lik: r.randn(6, 1),
    "Gaussian": lambda r, lik: r.randn(6, 1),
    "StudentT": lambda r, lik: r.randn(6, 1),
    "Bernoulli": lambda r, lik: (r.rand(6, 1) > 0.5) * 1.0,
    "Beta": lambda r, lik: 0.05 + 0.9 * r.rand(6, 1),
    "Gamma": lambda r, lik: r.gamma(2.0, 1.0, (6, 1)),
    "LogNormal": lambda r, lik: r.gamma(2.0, 1.0, (6, 1)),
    "Weibull": lambda r, lik: r.gamma(2.0, 1.0, (6, 1)),
    "Poisson": lambda r, lik: r.poisson(2.0, (6, 1)) * 1.0,
    "NegativeBinomial": lambda r, lik: r.poisson(2.0, (6, 1)) * 1.0,
    "ZeroInflatedPoisson": lambda r, lik: r.poisson(1.0, (6, 1)) * 1.0,
    "Binomial": lambda r, lik: r.randint(0, lik.n + 1, (6, 1)) * 1.0,
    "Categorical": lambda r, lik: r.randint(1, lik.K + 1, (6, 1)) * 1.0,
    "Ordinal": lambda r, lik: r.randint(0, lik.K, (6, 1)) * 1.0,
    "Dirichlet": lambda r, lik: r.dirichlet([2.0] * lik.K, 6),
}


def _model(liks):
    """A float64 CPU model of ``liks`` with theta, six rows a task, and
    moments that require grad."""
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=5,
                         input_dim=1, dtype="float64", jitter=1e-6,
                         adaptive_jitter=False)
    rng = np.random.RandomState(4)
    params = tp.init_params(rng, cfg, np.linspace(0, 1, 5)[:, None],
                            lengthscale=0.3, q_mu_scale=0.5,
                            with_lik_theta=True, device="cpu")
    Y = [_DRAW[type(lik).__name__](rng, lik) for lik in liks]
    data = tp.make_dataset([rng.rand(6, 1) for _ in liks], Y, cfg,
                           device="cpu")
    moments = [(torch.tensor(rng.randn(6, lik.dim_f), requires_grad=True),
                torch.tensor(0.1 + rng.rand(6, lik.dim_f),
                             requires_grad=True)) for lik in liks]
    return cfg, params, data, moments


def _mixed_model():
    return _model((tliks.HetGaussian(), tliks.Gaussian(sigma=0.5),
                   tliks.Bernoulli(), tliks.Beta(), tliks.Gamma(analytic=False),
                   tliks.Poisson(), tliks.Categorical(K=3)))


LNGAMMA = quadrature.SWEEP_FAMILIES["lngamma"][0]
# (likelihoods, the table's family codes, the engines' tasks, the
# per-engine sweeps of the forward)
ROUTES = {
    # HetGaussian, Bernoulli, Beta, Poisson and Categorical in one launch
    # each way; Gaussian (no device function) and Gamma (analytic=False)
    # keep their own var_exp
    "mixed": ((tliks.HetGaussian(), tliks.Gaussian(sigma=0.5),
               tliks.Bernoulli(), tliks.Beta(), tliks.Gamma(analytic=False),
               tliks.Poisson(), tliks.Categorical(K=3)),
              (2, 0, 6, 3, 1), ["Gamma", "Gaussian"], []),
    # the ten-family model: exactly Beta, Binomial, Dirichlet and the ZIP
    # on the table; the six families with trainable theta on their engines
    "fam10": ((tliks.Gaussian(learn_sigma=True), tliks.Beta(),
               tliks.Binomial(n=10), tliks.Dirichlet(K=3),
               tliks.LogNormal(learn_sigma=True), tliks.Ordinal(K=4),
               tliks.NegativeBinomial(learn_r=True),
               tliks.StudentT(learn_df=True),
               tliks.Weibull(k=1.0, learn_k=True),
               tliks.ZeroInflatedPoisson()),
              (6, 7, 8, 9), ["Gaussian", "LogNormal", "NegativeBinomial",
                             "Ordinal", "StudentT", "Weibull"], []),
    # off the table: a Dirichlet on quasi-MC nodes (its K lngamma sweeps
    # on kernel 6's per-engine launcher), a grid Dirichlet, a Dirichlet
    # past K = 3 (its lngamma sweep too) and a grid Beta
    "engines": ((tliks.Dirichlet(K=3, mc_samples=16),
                 tliks.Dirichlet(K=3, analytic=False), tliks.Dirichlet(K=4),
                 tliks.Beta(analytic=False)),
                (), ["Beta", "Dirichlet", "Dirichlet", "Dirichlet"],
                [LNGAMMA, LNGAMMA]),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_likelihood_term_routes_by_family(monkeypatch, route):
    liks, table, engines, sweeps = ROUTES[route]
    cfg, params, data, moments = _model(liks)
    calls = _fake_launchers(monkeypatch)
    own = []
    for cls in {type(lik) for lik in cfg.likelihoods}:
        orig = cls.var_exp

        def spy(self, *args, orig=orig, **kw):
            own.append(type(self).__name__)
            return orig(self, *args, **kw)

        monkeypatch.setattr(cls, "var_exp", spy)
    card_data = [tp.TaskData(*(_card(a) for a in td)) for td in data]
    card_moments = [(_card(m.detach()).requires_grad_(),
                     _card(v.detach()).requires_grad_())
                    for m, v in moments]
    scales = _card(torch.ones(len(data), dtype=torch.float64))
    with profiling.spans(), profiling.annotate("elbo.likelihood"):
        sums = telbo.likelihood_term(params, cfg, card_data, card_moments,
                                     scales)
    torch.autograd.grad(sums.sum(), [m for m, _ in card_moments])
    launched = [("task_var_exp", table)] if table else []
    grads = [("task_var_exp_backward", len(table))] if table else []
    assert calls == (launched + [("gh_sweep", s) for s in sweeps] + grads)
    assert sorted(own) == engines
    assert sums.shape == (len(data),)
    # the program counters of the call, in its span
    assert profiling.span_report()["spans"]["elbo.likelihood"]["counts"] == {
        "likelihood.table_tasks": len(table),
        "likelihood.engine_tasks": len(engines)}
    # without a gradient: the value alone
    calls.clear()
    with torch.no_grad():
        telbo.likelihood_term(params, cfg, card_data, card_moments, scales)
    assert calls == ([("task_var_exp_value", table)] if table else []) + [
        ("gh_sweep_value", s) for s in sweeps]


def test_cpu_tensors_and_use_kernel_false_take_the_plain_term(monkeypatch):
    cfg, params, data, moments = _mixed_model()
    calls = _fake_launchers(monkeypatch)
    cuda_kernels.zero_launch_counts()
    scales = torch.ones(len(data), dtype=torch.float64)
    for use_kernel in (True, False):
        got = telbo.likelihood_term(params, cfg, data, moments, scales,
                                    use_kernel=use_kernel)
        want = []
        for t, (lik, td) in enumerate(zip(cfg.likelihoods, data)):
            ve = (lik.var_exp(td.Y, *moments[t], theta=params.lik_theta[t])
                  if lik.n_theta else lik.var_exp(td.Y, *moments[t]))
            want.append(scales[t] * torch.sum(ve * td.mask))
        assert torch.equal(got, torch.stack(want))
    # a tensor on the card under use_kernel=False: the plain term too
    liks = [cfg.likelihoods[t] for t in (0, 2, 5, 6)]
    quadrature.task_var_exp(
        liks, [_card(data[t].Y) for t in (0, 2, 5, 6)],
        [_card(moments[t][0].detach()) for t in (0, 2, 5, 6)],
        [_card(moments[t][1].detach()) for t in (0, 2, 5, 6)],
        [_card(data[t].mask) for t in (0, 2, 5, 6)], list(scales[:4]),
        use_kernel=False)
    assert calls == []
    assert not any(cuda_kernels.launch_counts().values())
    with pytest.raises(ValueError, match="task table"):
        quadrature.task_var_exp([tliks.Gaussian()], *([None],) * 4,
                                [scales[0]])


def test_function_gradients_from_the_coefficients_are_the_plain_terms(
        host, monkeypatch):
    """TaskVarExp's forward and backward, on launchers that compute the
    kernel's rows on the host and its backward formula, against autograd
    of the plain term (float64)."""
    _fake_launchers(monkeypatch, host)
    Y, M, V, masks, scales = _term_inputs(seed=5)
    liks = [f[0] for f in FAMILIES.values()]
    Ms = [torch.tensor(m, requires_grad=True) for m in M]
    Vs = [torch.tensor(v, requires_grad=True) for v in V]
    g = torch.tensor(np.random.RandomState(6).rand(6) + 0.5)
    want = quadrature.task_var_exp_plain(
        liks, [torch.tensor(y) for y in Y], Ms, Vs,
        [torch.tensor(k) for k in masks], list(torch.tensor(scales)))
    dwant = torch.autograd.grad(want, Ms + Vs, g)
    Mc = [_card(m.detach().clone()).requires_grad_() for m in Ms]
    Vc = [_card(v.detach().clone()).requires_grad_() for v in Vs]
    got = quadrature.task_var_exp(
        liks, [_card(y) for y in Y], Mc, Vc, [_card(k) for k in masks],
        list(_card(scales)))
    dgot = torch.autograd.grad(got, Mc + Vc, _card(g))
    assert normwise(got.detach().numpy(), want.detach().numpy()) < 1e-12
    for i, (a, b) in enumerate(zip(dgot, dwant)):
        tol = 1e-8 if i == 6 + 4 else 1e-12  # Gamma's dV: torch's trigamma
        assert a.shape == b.shape
        assert normwise(a.detach().numpy(), b.numpy()) < tol, i


# ---- the kernel's own source, run on the host ---------------------------------
#
# csrc/ve_tasks_kernel.cu compiled with g++ against tests/host_cuda/
# cuda_runtime.h (one std::thread a CUDA thread, a barrier for
# __syncthreads), its launches rewritten as host_launch calls, and driven
# through the port's own launchers: the rows' values and coefficients
# bitwise the host row routine's, each task's sum bitwise the fixed
# reduction (the block trees, then the last block's strided sums and
# tree), the backward bitwise (g scale) mask c, two launches and the value
# alone bitwise equal.

HOST_STUB = pathlib.Path(__file__).resolve().parent / "host_cuda"
KERNEL_SOURCE = _build.CSRC / "ve_tasks_kernel.cu"
LAUNCH = re.compile(r"(\w+<[^<>]*>)<<<(.*?), (\w+), 0, stream>>>\((\w+)\);")
THREADS = cuda_kernels.TASK_THREADS


@pytest.fixture(scope="module")
def host_kernel():
    """The kernel library built for the host (``build/``, named by a hash
    of the rewritten source and the headers), its entries bound as
    ``ops/cuda_kernels.py`` binds the card's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of csrc/ve_tasks_kernel.cu "
                    "needs a C++20 compiler")
    text, launches = LAUNCH.subn(
        r'{ host_launch(\2, \3, [&] { \1(\4); }); host_launched = "\1"; }',
        KERNEL_SOURCE.read_text())
    assert launches == 6, "the kernel's launches changed form"
    # the last launch's kernel with its template arguments, as written
    text = ('static const char* host_launched = "";\n' + text
            + '\nextern "C" const char* hetmogp_host_launched() '
              '{ return host_launched; }\n')
    h = hashlib.sha256(text.encode())
    for src in (HOST_STUB / "cuda_runtime.h", _build.CSRC / "gh_sweep.cuh"):
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libve_tasks_host-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cpp = out.with_suffix(f".{os.getpid()}.cpp")
        cpp.write_text(text)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-pthread", f"-I{HOST_STUB}", f"-I{_build.CSRC}",
                            "-o", str(tmp), str(cpp)], check=True,
                           capture_output=True, timeout=300)
        finally:
            cpp.unlink(missing_ok=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"hetmogp_ve_tasks_{dt}")
        fn.argtypes = [ptr, ptr, i32, i32, ptr, i64, ptr]
        fn.restype = i32
        fn = getattr(lib, f"hetmogp_ve_tasks_grad_{dt}")
        fn.argtypes = [ptr, ptr, i32, ptr]
        fn.restype = i32
    lib.hetmogp_ve_tasks_max.restype = i32
    lib.hetmogp_ve_tasks_blocks.argtypes = [ptr, ptr, i32, i32]
    lib.hetmogp_ve_tasks_blocks.restype = i64
    lib.hetmogp_host_launched.restype = ctypes.c_char_p
    return lib


@pytest.fixture
def on_host(monkeypatch, host_kernel):
    """The launchers of ``ops/cuda_kernels.py`` on the host build: its
    library, and no CUDA device or stream to enter."""
    monkeypatch.setattr(cuda_kernels, "_library", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=None))


def _draw(lik, rng, n):
    name = quadrature.task_family(lik)
    if name == "dirichlet":
        return rng.dirichlet([2.0] * lik.K, n)
    if lik.ismulti():
        return rng.randint(1, lik.K + 1, (n, 1)) * 1.0
    return {"hetgaussian": lambda: rng.randn(n, 1),
            "bernoulli": lambda: (rng.rand(n, 1) > 0.5) * 1.0,
            "poisson": lambda: rng.poisson(3.0, (n, 1)) * 1.0,
            "zipoisson": lambda: rng.poisson(1.0, (n, 1)) * 1.0,
            "binomial": lambda: rng.randint(0, lik.n + 1, (n, 1)) * 1.0,
            "beta": lambda: 0.02 + 0.96 * rng.rand(n, 1)}.get(
                name, lambda: rng.gamma(2.0, 1.0, (n, 1)) + 1e-3)()


def _tree(vals):
    """gh::tree_top's fixed tree over ``vals`` (numpy scalars)."""
    x, L = list(vals), len(vals)
    off = 1
    while 2 * off < L:
        off *= 2
    off = off if L > 1 else 0
    while off > 0:
        for lane in range(off):
            if lane + off < L:
                x[lane] = x[lane] + x[lane + off]
        off //= 2
    return x[0]


def _fixed_sum(val, mask, scale, lanes, dtype):
    """scale * sum(mask * val) in the kernel's order: a tree over each
    block's rows, then each of THREADS threads adds the partials i, i +
    THREADS, ... and a tree adds the threads'."""
    rows = THREADS // lanes
    contrib = [dtype(m) * dtype(v) for m, v in zip(mask, val)]
    partials = [_tree(contrib[b:b + rows])
                for b in range(0, len(contrib), rows)]
    strided = []
    for i in range(min(len(partials), THREADS)):
        s = dtype(0)
        for p in partials[i::THREADS]:
            s = s + p
        strided.append(s)
    return dtype(scale) * _tree(strided)


HOST_TABLES = {
    "flagship": ([f[0] for f in FAMILIES.values()],
                 (40, 37, 30, 300, 45, 600), None),
    "ragged": ([f[0] for f in FAMILIES.values()], (3, 1, 0, 1, 5, 2), None),
    # 20 tasks: two launches; K = 6 on quasi-MC nodes (the widest
    # accumulators), K = 4, and lanes other than one node a lane
    "wide": ([tliks.Categorical(K=6, mc_samples=33), tliks.Categorical(K=4),
              tliks.Gamma(), tliks.Bernoulli()] * 5,
             (7, 5, 9, 30, 0, 3, 11, 2, 4, 4, 4, 4, 1, 1, 1, 1, 6, 7, 8, 9),
             [33, 13, 20, 5] * 5),
    # the ten-family model's four multi-term families beside the flagship's
    # (the launch's instantiation compiles both in)
    "terms": ([tliks.Beta(), tliks.Binomial(n=10), tliks.Dirichlet(K=3),
               tliks.ZeroInflatedPoisson(), tliks.Bernoulli(),
               tliks.Categorical(K=3), tliks.Gamma(), tliks.HetGaussian()],
              (13, 37, 9, 21, 20, 9, 5, 3), None),
    # K = 2, n = 1, an empty task, K = 6 on quasi-MC nodes (the widest
    # Categorical in the same instantiation), lanes other than one node a
    # lane
    "terms-lanes": ([tliks.Dirichlet(K=2), tliks.Binomial(n=1),
                     tliks.ZeroInflatedPoisson(), tliks.Beta(),
                     tliks.Categorical(K=6, mc_samples=33)],
                    (7, 0, 11, 5, 3), [7, 3, 64, 256, 33]),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("table", list(HOST_TABLES))
def test_kernel_source_on_the_host_is_the_fixed_order_term(
        host, on_host, table, dtype):
    liks, rows, lanes = HOST_TABLES[table]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rng = np.random.RandomState(7)
    Y, M, V, masks = [], [], [], []
    for lik, n in zip(liks, rows):
        Y.append(_draw(lik, rng, n).astype(dtype))
        M.append((1.5 * rng.randn(n, lik.dim_f)).astype(dtype))
        V.append((0.01 + 2.0 * rng.rand(n, lik.dim_f)).astype(dtype))
        masks.append(((rng.rand(n) > 0.3) * 1.0).astype(dtype))
    scales = (1.0 + 10.0 * rng.rand(len(rows))).astype(dtype)
    g = (0.5 + rng.rand(len(rows))).astype(dtype)
    tasks = [(code, _card(y), _card(m), _card(v), _card(k),
              None if n_ is None else _card(n_),
              None if w_ is None else _card(w_), *quadrature._task_extras(lik))
             for lik, (code, n_, w_), y, m, v, k in zip(
                 liks, quadrature._task_table(liks, torch.zeros(1, dtype=tdt)),
                 Y, M, V, masks)]
    sc = list(_card(scales))
    cuda_kernels.zero_launch_counts()
    sums, values, coefs = cuda_kernels.task_var_exp(tasks, sc, lanes=lanes)
    again = cuda_kernels.task_var_exp(tasks, sc, lanes=lanes)
    alone = cuda_kernels.task_var_exp_value(tasks, sc, lanes=lanes)
    grads = cuda_kernels.task_var_exp_backward(
        [_card(c) for c in coefs], [t[4] for t in tasks], sc, _card(g))
    chunks = -(-sum(1 for n in rows if n) // 16)
    assert cuda_kernels.launch_counts()["task_var_exp"] == 2 * chunks
    assert cuda_kernels.launch_counts()["task_var_exp_backward"] == chunks
    assert torch.equal(sums, again[0]) and torch.equal(sums, alone[0])
    for t, (lik, n) in enumerate(zip(liks, rows)):
        J = lik.dim_f
        assert torch.equal(values[t], again[1][t])
        assert torch.equal(values[t], alone[1][t])
        assert torch.equal(coefs[t], again[2][t])
        L = (lanes[t] if lanes is not None
             else cuda_kernels.task_lanes(tasks[t][5].shape[0])
             if tasks[t][5] is not None else 1)
        if n:
            want = host_rows(host, lik, Y[t], M[t], V[t], dtype, lanes=L)
            np.testing.assert_array_equal(values[t].numpy(), want[0])
            np.testing.assert_array_equal(coefs[t][:, :J].numpy(), want[1])
            np.testing.assert_array_equal(coefs[t][:, J:].numpy(), want[2])
        fixed = (_fixed_sum(values[t].numpy(), masks[t], scales[t],
                            L if tasks[t][5] is not None else 1, dtype)
                 if n else dtype(0))
        assert sums[t].item() == fixed, (table, t)
        gm = (g[t] * scales[t]) * masks[t]
        dm, dv = grads[t]
        np.testing.assert_array_equal(
            dm.numpy(), coefs[t][:, :J].numpy() * gm[:, None])
        np.testing.assert_array_equal(
            dv.numpy(), coefs[t][:, J:].numpy() * gm[:, None])


# ---- the instantiation a table takes, and what a launch records ----------------

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _table_liks(config):
    """The likelihoods of an ``hmbench`` configuration that its trainer
    sends to the task table (a family of the table, no trainable theta)."""
    import json

    entries = json.loads((ROOT / "hmbench" / "configs" / f"{config}.json")
                         .read_text())["likelihoods"]
    liks = [getattr(tliks, e["family"])(**e.get("args", {})) for e in entries]
    return [lik for lik in liks
            if quadrature.task_family(lik) is not None and not lik.n_theta]


def _card_table(liks, rows, seed=8, grad=False):
    """(Y, M, V, masks, scales) of ``liks`` in float32 on stand-ins for the
    card; M and V require grad with ``grad``."""
    rng = np.random.RandomState(seed)
    Y, M, V, masks = [], [], [], []
    for lik, n in zip(liks, rows):
        Y.append(_card(_draw(lik, rng, n).astype(np.float32)))
        M.append(_card((1.5 * rng.randn(n, lik.dim_f)).astype(np.float32)))
        V.append(_card((0.01 + 2.0 * rng.rand(n, lik.dim_f))
                       .astype(np.float32)))
        masks.append(_card(((rng.rand(n) > 0.3) * 1.0).astype(np.float32)))
    if grad:
        M = [m.requires_grad_() for m in M]
        V = [v.requires_grad_() for v in V]
    scales = list(_card((1.0 + rng.rand(len(rows))).astype(np.float32)))
    return Y, M, V, masks, scales


def test_each_table_takes_its_instantiation(host_kernel, on_host):
    """The instantiation <T, DERIV, A, TERMS> of ``ve_tasks_kernel`` that
    a launch of the host build takes, by the families its table holds:
    ``lmc6_m1024``'s six take the ones they took before the multi-term
    families came (A = 5 with the derivatives, its K = 3 Categorical's; 1
    for the value alone; no terms), a K = 6 Categorical A = 11, and
    ``fam10_m1024``'s four multi-term families the ones that compile them
    in (16, 4)."""
    lmc6, fam10 = _table_liks("lmc6_m1024"), _table_liks("fam10_m1024")
    assert [type(lik).__name__ for lik in lmc6] == [
        "HetGaussian", "Bernoulli", "Categorical", "Poisson", "Gamma",
        "Exponential"]
    assert [type(lik).__name__ for lik in fam10] == [
        "Beta", "Binomial", "Dirichlet", "ZeroInflatedPoisson"]
    wide = [tliks.Categorical(K=6, mc_samples=33), tliks.Gamma()]
    for liks, deriv, want in ((lmc6, True, "true, 5, false"),
                              (lmc6, False, "false, 1, false"),
                              (wide, True, "true, 11, false"),
                              (fam10, True, "true, 16, true"),
                              (fam10, False, "false, 4, true"),
                              (lmc6 + fam10[:1], True, "true, 16, true")):
        Y, M, V, masks, scales = _card_table(liks, [5] * len(liks))
        tasks, sc = quadrature._task_launch_args(liks, Y, M, V, masks,
                                                 scales)
        # the node tables too on stand-ins for the card
        tasks = [(*t[:5], *(None if a is None else _card(a) for a in t[5:7]),
                  *t[7:]) for t in tasks]
        (cuda_kernels.task_var_exp if deriv
         else cuda_kernels.task_var_exp_value)(tasks, sc)
        assert (host_kernel.hetmogp_host_launched().decode()
                == f"ve_tasks_kernel<T, {want}>"), (
            [type(lik).__name__ for lik in liks], deriv)


def test_recorded_table_launches_give_the_roofline_formulas_their_shapes(
        on_host, monkeypatch):
    """A ``fam10_m1024`` table's launches, recorded as ``hmbench`` records
    the program's (``hmbench/port.py::record_launches``: the arguments as
    shapes), still give ``hmbench/roofline/launchers.py``'s
    ``task_var_exp`` and ``task_var_exp_backward`` formulas (N, dim_y, J)
    of each task: y and m at positions 1 and 2 of a task, the
    coefficients (N, 2J)."""
    from hmbench import port
    from hmbench.roofline import kernels as rk
    from hmbench.roofline import launchers as rl

    liks = _table_liks("fam10_m1024")
    rows = (9, 7, 5, 6)
    # the launches as quadrature.TaskVarExp makes them: its arguments, the
    # node tables on stand-ins for the card
    tasks, sc = quadrature._task_launch_args(liks, *_card_table(liks, rows))
    tasks = [(*t[:5], _card(t[5]), _card(t[6]), *t[7:]) for t in tasks]
    with port.record_launches() as log:
        _, _, coefs = cuda_kernels.task_var_exp(tasks, sc)
        cuda_kernels.task_var_exp_backward(
            [_card(c) for c in coefs], [t[4] for t in tasks], sc,
            _card(torch.ones(len(rows))))
    assert [(r["launcher"], r["launches"]) for r in log] == [
        ("task_var_exp", 1), ("task_var_exp_backward", 1)]
    seen = []
    monkeypatch.setattr(rk, "task_forward", lambda rows, deriv=True: (
        seen.append(("forward", rows, deriv)) or (0.0, "ve_tasks_kernel")))
    monkeypatch.setattr(rk, "task_backward", lambda rows: (
        seen.append(("backward", rows)) or (0.0, "ve_tasks_grad_kernel")))
    assert [e[1:] for e in rl.table(log)] == [("ve_tasks_kernel", 1),
                                             ("ve_tasks_grad_kernel", 1)]
    want = [(n, lik.dim_y, lik.dim_f) for lik, n in zip(liks, rows)]
    assert seen == [("forward", want, True),
                    ("backward", [(n, None, J) for n, _, J in want])]
