"""Kernel 6's arithmetic on the CPU, and the routes of kernels 6 and 7.

Kernel 6 (``csrc/gh_sweep_kernel.cu``) runs only on the card.  Its
arithmetic, the jets, digamma and trigamma and the families' log densities
of ``csrc/gh_sweep.cuh``, is plain C++ behind a ``__host__ __device__``
macro that is empty under a host compiler.  So this file compiles
``csrc/gh_sweep_host.cpp`` with g++ into ``build/`` and runs the per-row
sweep routine the kernel calls (each row's 32 lane sums added by the
kernel's shuffle tree) through ctypes, on the same numpy inputs as the
port's plain engine (autograd over ``logpdf``, ``ops/quadrature.py``) and
the JAX package's ``make_var_exp``.  It skips, with the reason, where no
g++ is found.

Tolerances, normwise (max |a - b| / max |b| per output):
* float64: 1e-12 against both; Gamma's lngamma sweep's Ed2 holds torch's
  float64 trigamma (``polygamma(1, x)``, good to ~5e-10 relative), so it is
  held to 1e-8 against the port's plain engine and to 1e-12 against JAX's;
* float32 against the float64 plain engine: at most 4x the float32 plain
  engine's own error plus 1e-6, and non-finite exactly where the float32
  plain engine is (the bound ``chip_smoke.py`` holds the kernel to);
* digamma and trigamma against scipy over the clip range [1e-9, 1e9].

Then the routes, on the CPU: CPU tensors and ``use_kernel=False`` take the
plain engine and launch nothing, a tensor on the card of a family in
``SWEEP_FAMILIES`` reaches the kernel's launcher, ``elbo_fn`` passes its
``use_kernel`` to ``var_exp``, and kernel 7's host wrapper builds its leaf
table in ``params.leaves`` order with the step's masks.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from hetmogp_tpu import likelihoods as jliks
from hetmogp_tpu.likelihoods import gamma as jgamma
import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import likelihoods as tliks
from hetmogp_tpu_torch import train as ttrain
from hetmogp_tpu_torch.likelihoods import base as tbase
from hetmogp_tpu_torch.likelihoods import gamma as tgamma
from hetmogp_tpu_torch.models import elbo as telbo
from hetmogp_tpu_torch.models.params import leaves
from hetmogp_tpu_torch.ops import _build, cuda_kernels, quadrature

torch.set_num_threads(1)

HOST_SOURCES = (_build.CSRC / "gh_sweep_host.cpp", _build.CSRC / "gh_sweep.cuh")


@pytest.fixture(autouse=True)
def _launch_counts_down_after():
    """The launch counts are global to the process, and this file's cases
    drive the launchers on stand-ins for a
    card tensor: each case leaves them at 0, so that a
    later file in the same process starts from 0 too."""
    yield
    cuda_kernels.zero_launch_counts()


@pytest.fixture(scope="module")
def host_sweep():
    """``csrc/gh_sweep_host.cpp`` built with g++ into ``build/`` (the name
    carries a hash of the sources) and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of kernel 6's sweep "
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
    for name in ("gh_sweep_rows_f32", "gh_sweep_rows_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] * 2 + [ptr] * 3 + [i64] * 3 + [ptr] * 2
                       + [ctypes.c_int] * 3 + [ptr])
        fn.restype = ctypes.c_int
    for nm, ct in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        for f in ("digamma", "trigamma"):
            fn = getattr(lib, f"gh_{f}_{nm}")
            fn.argtypes, fn.restype = [ct], ct
    return lib


def host_rows(lib, engine, Y, m, v, dtype):
    """(value, Ed1, Ed2) of every row by the host build of the kernel's
    per-row routine, on ``engine``'s node table."""
    J = m.shape[1]
    family = quadrature.SWEEP_FAMILIES[engine.sweep][0]
    nodes, w = engine.table
    arr = [np.ascontiguousarray(a, dtype) for a in (m, v, Y, nodes, w)]
    N = m.shape[0]
    out = np.zeros((N, 1 + 2 * J), dtype)
    fn = lib.gh_sweep_rows_f64 if dtype == np.float64 else lib.gh_sweep_rows_f32
    rc = fn(family, J, *(a.ctypes.data for a in arr[:3]), J, J,
            arr[2].shape[1], arr[3].ctypes.data, arr[4].ctypes.data,
            nodes.shape[0], N, 1, out.ctypes.data)
    assert rc == 0
    return out[:, 0], out[:, 1:1 + J], out[:, 1 + J:]


class Engine:
    """One of kernel 6's engines on both sides: the port's likelihood (or
    engine function) and the JAX package's, the node table and a y."""

    def __init__(self, name, tlik, jlik, J, T, mc=0, port=None, jax_fn=None):
        self.name, self.tlik, self.jlik, self.J = name, tlik, jlik, J
        self.port = port or tbase._var_exp_engine(tlik)
        self.jax_fn = jax_fn or jlik.var_exp
        self.sweep = self.port.sweep
        self.table = (quadrature.mc_nodes(mc, J) if mc
                      else quadrature.tensor_grid(T, J))


ENGINES = {
    "Bernoulli": lambda: Engine("Bernoulli", tliks.Bernoulli(),
                                jliks.Bernoulli(), 1, 20),
    "Categorical": lambda: Engine("Categorical", tliks.Categorical(K=3),
                                  jliks.Categorical(K=3), 2, 10),
    "Categorical-K4-mc": lambda: Engine(
        "Categorical", tliks.Categorical(K=4, mc_samples=33),
        jliks.Categorical(K=4, mc_samples=33), 3, 10, mc=33),
    "lngamma": lambda: Engine("lngamma", None, None, 1, 20,
                              port=tgamma._lngamma_engine(20),
                              jax_fn=jgamma._lngamma_engine(20)),
}

# moments: random rows, then the extreme ones of test_torch_families.py's
# EXTREME_MV (m = -+200 with v = 50, m = -+20 with v = 5) and v = 0
EXTREME_MV = ((-200.0, 50.0), (200.0, 50.0), (-20.0, 5.0), (20.0, 5.0),
              (0.3, 0.0), (-1.5, 0.0))


def _inputs(name, J, n=24, seed=0):
    rng = np.random.RandomState(seed)
    m = np.concatenate([1.5 * rng.randn(n, J),
                        np.repeat([[a] for a, _ in EXTREME_MV], J, 1)])
    v = np.concatenate([0.01 + 2.0 * rng.rand(n, J),
                        np.repeat([[b] for _, b in EXTREME_MV], J, 1)])
    rows = m.shape[0]
    if name == "Bernoulli":
        Y = (rng.rand(rows, 1) > 0.5).astype(float)
    elif name == "Categorical":
        Y = rng.randint(1, J + 2, (rows, 1)).astype(float)
    else:
        Y = rng.rand(rows, 1)
    return Y, m, v


def _plain(engine, Y, m, v, dtype):
    """(value, Ed1, Ed2) of the port's plain engine on the CPU."""
    M = torch.tensor(m, dtype=dtype, requires_grad=True)
    V = torch.tensor(v, dtype=dtype, requires_grad=True)
    val = engine.port(torch.tensor(Y, dtype=dtype), M, V)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    return [a.detach().double().numpy() for a in (val, dm, 2.0 * dv)]


def _jax(engine, Y, m, v):
    @jax.jit
    def ref(Y, m, v):
        val, vjp = jax.vjp(lambda a, b: engine.jax_fn(Y, a, b), m, v)
        dm, dv = vjp(jnp.ones_like(val))
        return val, dm, 2.0 * dv

    return [np.asarray(a) for a in ref(*(jnp.asarray(x) for x in (Y, m, v)))]


def normwise(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("name", list(ENGINES))
def test_sweep_routine_matches_plain_engine_and_jax_f64(host_sweep, name):
    engine = ENGINES[name]()
    Y, m, v = _inputs(engine.name, engine.J)
    got = host_rows(host_sweep, engine, Y, m, v, np.float64)
    plain = _plain(engine, Y, m, v, torch.float64)
    ref = _jax(engine, Y, m, v)
    for what, a, b, c in zip(("value", "Ed1", "Ed2"), got, plain, ref):
        assert np.isfinite(a).all() and np.isfinite(b).all(), (name, what)
        tol = 1e-8 if (engine.sweep == "lngamma" and what == "Ed2") \
            else 1e-12  # torch's float64 trigamma
        assert normwise(a, b) < tol, (name, what, normwise(a, b))
        assert normwise(a, c) < 1e-12, (name, what, normwise(a, c))


@pytest.mark.parametrize("name", list(ENGINES))
def test_sweep_routine_f32_within_the_plain_engines_bound(host_sweep, name):
    engine = ENGINES[name]()
    Y, m, v = _inputs(engine.name, engine.J, seed=1)
    m32, v32 = m.astype(np.float32), v.astype(np.float32)
    want = _plain(engine, Y, m32.astype(np.float64),
                  v32.astype(np.float64), torch.float64)
    plain32 = _plain(engine, Y, m32, v32, torch.float32)
    got = host_rows(host_sweep, engine, Y, m32, v32, np.float32)
    for what, a, p, b in zip(("value", "Ed1", "Ed2"), got, plain32, want):
        a = a.astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(p))
        fin = np.isfinite(p)
        bound = 4.0 * normwise(p[fin], b[fin]) + 1e-6
        assert normwise(a[fin], b[fin]) <= bound, (name, what, bound)


def test_digamma_and_trigamma_against_scipy(host_sweep):
    x = np.geomspace(1e-9, 1e9, 4001)
    for nm, dtype, tol in (("f64", np.float64, 1e-14),
                           ("f32", np.float32, 2e-6)):
        xs = x.astype(dtype).astype(np.float64)
        dg = np.array([getattr(host_sweep, f"gh_digamma_{nm}")(a)
                       for a in xs])
        tg = np.array([getattr(host_sweep, f"gh_trigamma_{nm}")(a)
                       for a in xs])
        want_dg, want_tg = scipy.special.digamma(xs), \
            scipy.special.polygamma(1, xs)
        # digamma crosses 0 near 1.4616: its error is held against the
        # size of the terms that cancel there
        assert np.all(np.abs(dg - want_dg)
                      <= tol * np.maximum(1.0, np.abs(want_dg))), nm
        assert np.all(np.abs(tg - want_tg) <= tol * want_tg), nm


# ---- the routes -------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the engine's route
    reads (``is_cuda``), without a card."""

    @property
    def is_cuda(self):
        return True


def _recording_launchers(monkeypatch):
    """Swap kernel 6's launchers for the plain engine's results, recording
    which one each call reached."""
    calls = []

    def sweep(family, y, m, v, nodes, w):
        calls.append(("gh_sweep", family))
        return (torch.zeros(m.shape[0], dtype=m.dtype),
                torch.zeros(m.shape, dtype=m.dtype),
                torch.zeros(m.shape, dtype=m.dtype))

    def value(family, y, m, v, nodes, w):
        calls.append(("gh_sweep_value", family))
        return torch.zeros(m.shape[0], dtype=m.dtype)

    monkeypatch.setattr(cuda_kernels, "gh_sweep", sweep)
    monkeypatch.setattr(cuda_kernels, "gh_sweep_value", value)
    return calls


def _cuda_like(*arrays):
    return [torch.tensor(a).as_subclass(_OnCard) for a in arrays]


@pytest.mark.parametrize("name", list(ENGINES))
def test_cpu_tensors_and_use_kernel_false_take_the_plain_engine(
        monkeypatch, name):
    engine = ENGINES[name]()
    Y, m, v = _inputs(engine.name, engine.J, n=4)
    cuda_kernels.zero_launch_counts()
    calls = _recording_launchers(monkeypatch)
    want = _plain(engine, Y, m, v, torch.float64)
    for use_kernel in (True, False):
        M = torch.tensor(m, requires_grad=True)
        V = torch.tensor(v, requires_grad=True)
        val = engine.port(torch.tensor(Y), M, V, use_kernel)
        dm, dv = torch.autograd.grad(val.sum(), (M, V))
        for a, b in zip((val.detach(), dm, 2.0 * dv), want):
            np.testing.assert_array_equal(a.numpy(), b)
    # a tensor on the card under use_kernel=False: the plain engine too
    Yc, Mc, Vc = _cuda_like(Y, m, v)
    engine.port(Yc, Mc.requires_grad_(), Vc.requires_grad_(), False)
    assert calls == []
    assert not any(cuda_kernels.launch_counts().values())


@pytest.mark.parametrize("name", list(ENGINES))
def test_a_tensor_on_the_card_reaches_kernel_6(monkeypatch, name):
    engine = ENGINES[name]()
    Y, m, v = _inputs(engine.name, engine.J, n=4)
    calls = _recording_launchers(monkeypatch)
    family = quadrature.SWEEP_FAMILIES[engine.sweep][0]
    Yc, Mc, Vc = _cuda_like(Y, m, v)
    Mc.requires_grad_()
    Vc.requires_grad_()
    val = engine.port(Yc, Mc, Vc)
    torch.autograd.grad(val.sum(), (Mc, Vc))
    engine.port(Yc, Mc.detach(), Vc.detach())  # no input needs a gradient
    assert calls == [("gh_sweep", family), ("gh_sweep_value", family)]


def test_sweep_families_name_bernoulli_categorical_and_lngamma(monkeypatch):
    assert set(quadrature.SWEEP_FAMILIES) == {"bernoulli", "categorical",
                                              "lngamma"}
    swept = {type(lik).__name__ for lik in (
        tliks.Gaussian(), tliks.HetGaussian(), tliks.Bernoulli(),
        tliks.Binomial(), tliks.Categorical(K=3),
        tliks.Categorical(K=6, mc_samples=16), tliks.Beta(analytic=False),
        tliks.Gamma(analytic=False), tliks.Exponential(analytic=False),
        tliks.LogNormal(), tliks.NegativeBinomial(),
        tliks.Poisson(analytic=False), tliks.StudentT(analytic=False),
        tliks.Ordinal(K=4), tliks.Dirichlet(analytic=False),
        tliks.Weibull(analytic=False), tliks.ZeroInflatedPoisson())
        if tbase._var_exp_engine(lik).sweep is not None}
    assert swept == {"Bernoulli", "Categorical"}
    assert tliks.Categorical(K=7, mc_samples=16).sweep is None
    assert tgamma._lngamma_engine(20).sweep == "lngamma"
    # a tensor on the card of a family without a device function runs the
    # plain engine there: a route by family
    calls = _recording_launchers(monkeypatch)
    Yc, Mc, Vc = _cuda_like(np.full((3, 1), 2.0), np.zeros((3, 1)),
                            np.ones((3, 1)))
    tliks.Poisson(analytic=False).var_exp(Yc, Mc.requires_grad_(), Vc)
    assert calls == []


def _small_model(dtype=torch.float64, with_lik_theta=False):
    liks = (tliks.Bernoulli(), tliks.Gamma(), tliks.Gaussian(sigma=0.5))
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=6,
                         input_dim=1, dtype="float64", jitter=1e-6,
                         adaptive_jitter=False)
    rng = np.random.RandomState(0)
    params = tp.init_params(rng, cfg, np.linspace(0, 1, 6)[:, None],
                            lengthscale=0.3, q_mu_scale=0.5,
                            with_lik_theta=with_lik_theta, device="cpu")
    X = [rng.rand(20, 1) for _ in liks]
    Y = [(rng.rand(20, 1) > 0.5).astype(float), rng.gamma(2.0, 1.0, (20, 1)),
         rng.randn(20, 1)]
    return cfg, params, tp.make_dataset(X, Y, cfg, device="cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_elbo_fn_passes_use_kernel_to_var_exp(monkeypatch, use_kernel):
    cfg, params, data = _small_model()
    seen = []
    for cls in (tliks.Bernoulli, tliks.Gamma, tliks.Gaussian):
        orig = cls.var_exp

        def spy(self, *args, orig=orig, **kw):
            seen.append((type(self).__name__, kw.get("use_kernel")))
            return orig(self, *args, **kw)

        monkeypatch.setattr(cls, "var_exp", spy)
    scales = torch.ones(3, dtype=torch.float64)
    telbo.elbo_fn(params, data, scales, cfg, use_kernel=use_kernel)
    assert seen == [(n, use_kernel) for n in ("Bernoulli", "Gamma",
                                               "Gaussian")]


@pytest.mark.parametrize("mode", ["ve", "vm", "all", "vm-theta"])
def test_adam_leaf_table_follows_leaves_and_the_mask(mode):
    cfg, params, _ = _small_model(with_lik_theta=mode.endswith("theta"))
    tc = tp.TrainConfig(optimizer="adam", learn_lik_params=True,
                        learn_inducing=True)
    free = {"ve": ttrain.ve_mask(), "vm": ttrain.vm_mask(tc),
            "all": ttrain.all_mask(tc),
            "vm-theta": ttrain.vm_mask(tc)}[mode]
    named = leaves(params)
    grads = [torch.ones_like(t) if name in free else None
             for name, t in named]
    table = cuda_kernels.adam_leaf_table([t for _, t in named], grads)
    want = [(i, t.numel(), name in free) for i, (name, t) in enumerate(named)
            if t.numel()]
    assert table == want
    assert [named[i][0] for i, _, _ in table][:7] == list(
        tp.models.params.FIELDS)
    if mode == "vm-theta":
        # one theta leaf a task, the empty ones (families without theta)
        # left out of the table
        assert [named[i][0] for i, _, _ in table[7:]] == ["lik_theta"]


def test_adam_step_on_the_cpu_is_the_plain_adam():
    cfg, params, _ = _small_model()
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.01)
    opt = ttrain.init_optimizer_state(params, tc)
    rng = np.random.RandomState(3)
    grads = [torch.from_numpy(rng.randn(*t.shape)) if name in ttrain.vm_mask(tc)
             else None for name, t in leaves(params)]
    cuda_kernels.zero_launch_counts()
    a = ttrain._adam_step(params, opt, grads, 0.01)
    b = ttrain._adam(params, opt, grads, 0.01)
    for (_, x), (_, y) in zip(leaves(a[0]), leaves(b[0])):
        assert torch.equal(x, y)
    assert torch.equal(a[1].count, b[1].count)
    assert not any(cuda_kernels.launch_counts().values())
