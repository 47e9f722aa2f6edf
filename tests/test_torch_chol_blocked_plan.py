"""Kernel 10's schedule on the CPU, a plain executor of it, and the
kernel's own source on the host.

Kernel 10 (``csrc/chol_blocked_kernel.cu``: the blocked Cholesky factor
and inverse of a float32 stack in one persistent launch) runs only on the
card.  Its tile tasks, their ticket order, what each waits for and which
counter it adds to (``csrc/chol_blocked_plan.cuh``) are plain C++ behind a
``__host__ __device__`` macro that is empty under a host compiler.  So this
file compiles ``csrc/chol_blocked_plan_host.cpp`` with g++ into ``build/``
and walks every ticket of a launch in order, for B in {1, 4, 8} and M in
{256, 777, 1024, 4096}, asserting that

* every wait is on a counter that earlier tickets bring to its target (a
  block waits only on tickets that blocks already running hold: no
  deadlock);
* every task's own tile has exactly the writes before it that its last
  wait names (a tile's updates chained in panel order, its inverse's
  terms in ascending k: no two tasks write one tile unordered), but for
  the row parts of one TRSM or UPD, which write other rows of it;
* every tile of L and of iL is written final exactly once, and every
  counter ends at its tile's final count;
* the tasks are as many as ``cuda_kernels.chol_blocked_tasks`` (what
  ``factor.tile_tasks`` counts) says.

A plain executor runs each task's algebra on float64 tiles (the buffers
start as NaN, so a read before a write shows), in ticket order and in a
random order that honours only the waits, at M = 256 and 777 (padded to
896 with an identity block, as ``linalg._tiled`` pads), and must match
``blocked_cholesky_inverse``'s plain version to 1e-12 normwise.

Kernel 10's source is also built with a host compiler against
``tests/host_cuda/cuda_runtime.h`` (a thread a CUDA thread, one block at a
time: the block that runs first takes every ticket in order) and driven
through ``linalg.blocked_cholesky_inverse`` on tensors that say they are on
the card: within 4x the plain float32 version's error against float64
plus 1e-6 (kernel 9's host bound), exact zeros above the diagonal, two
launches bitwise equal, a stack's part bitwise the part alone, a failed
pivot's NaN from its panel on, and the tasks counted in the open span.
Everything here skips, with the reason, where no g++ is found.
"""

import contextlib
import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hetmogp_tpu_torch import profiling
from hetmogp_tpu_torch.ops import _build, cuda_kernels, linalg

torch.set_num_threads(1)  # the file runs beside others under xdist

CSRC = _build.CSRC
HOST_STUB = Path(__file__).resolve().parent / "host_cuda"
STATS = ("tasks", "POTRF", "TRSM", "UPD", "ACC", "INV", "wait_faults",
         "chain_faults", "output_faults", "final_faults")
KINDS = ("POTRF", "TRSM", "UPD", "ACC", "INV")
TILE = 128  # csrc/chol_blocked_plan.cuh: TILE


def _host_library(name: str, text: str, std: str, extra=()):
    """``text`` compiled with g++ into ``build/`` (named by a hash of the
    text and the flags) and loaded; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip(f"no g++ on PATH: the host build of {name} needs a "
                    "C++ compiler")
    flags = [f"-std={std}", "-shared", "-fPIC", *extra]
    h = hashlib.sha256(text.encode())
    h.update(" ".join(flags).encode())
    h.update((HOST_STUB / "cuda_runtime.h").read_bytes())
    h.update((CSRC / "chol_blocked_plan.cuh").read_bytes())
    out = _build.BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cpp = out.with_suffix(f".{os.getpid()}.cpp")
        cpp.write_text(text)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *flags, f"-I{CSRC}", "-o", str(tmp),
                            str(cpp)], check=True, capture_output=True,
                           timeout=300)
        finally:
            cpp.unlink(missing_ok=True)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def plan():
    """``csrc/chol_blocked_plan_host.cpp`` built and loaded: ``walk(batch,
    nt)`` (faults, stats) and ``tasks(batch, nt)`` (the tickets' tasks,
    their counters and waits, as an int array)."""
    lib = _host_library("chol_blocked_plan",
                        (CSRC / "chol_blocked_plan_host.cpp").read_text(),
                        "c++17", ["-O2"])
    lib.chol_blocked_plan_walk.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.chol_blocked_plan_walk.restype = ctypes.c_longlong
    lib.chol_blocked_plan_tasks.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.chol_blocked_plan_tasks.restype = ctypes.c_longlong
    assert lib.chol_blocked_plan_stats() == len(STATS)
    width = lib.chol_blocked_plan_task_ints()

    def walk(batch, nt):
        stats = (ctypes.c_longlong * len(STATS))()
        faults = lib.chol_blocked_plan_walk(batch, nt, stats)
        return faults, dict(zip(STATS, stats))

    def tasks(batch, nt):
        n = cuda_kernels.chol_blocked_tasks(batch, nt)
        out = np.zeros((n, width), dtype=np.int32)
        assert lib.chol_blocked_plan_tasks(batch, nt, out.ctypes.data) == n
        return out, lib.chol_blocked_plan_flags(batch, nt)

    return types.SimpleNamespace(walk=walk, tasks=tasks)


@pytest.mark.parametrize("m", [256, 777, 1024, 4096])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_every_wait_is_on_an_earlier_ticket_and_every_tile_written_once(
        plan, batch, m):
    nt = -(-m // TILE)
    faults, st = plan.walk(batch, nt)
    assert faults == 0, st
    assert st["wait_faults"] == st["chain_faults"] == 0
    assert st["output_faults"] == st["final_faults"] == 0
    assert st["tasks"] == cuda_kernels.chol_blocked_tasks(batch, nt)
    # TRSM and UPD in row parts: CHOL_PARTS each next to a panel (the
    # tile rows p + 1 and p + 2), CHOL_BULK for the rest
    parts, bulk = cuda_kernels.CHOL_PARTS, cuda_kernels.CHOL_BULK
    pairs, near_t, near_u = nt * (nt - 1) // 2, 2 * nt - 3, 3 * nt - 5
    assert [st[k] for k in KINDS] == [
        batch * nt, batch * (parts * near_t + bulk * (pairs - near_t)),
        batch * (parts * near_u + bulk * (math.comb(nt + 1, 3) - near_u)),
        batch * math.comb(nt, 3), batch * pairs]


# ---- a plain executor of the plan ----------------------------------------------

def _spd(q, m, seed=0):
    """A (q, m, m) SPD matrix, X X^T / m + I, of condition ~1e2."""
    rng = np.random.RandomState(seed)
    X = rng.randn(q, m, m + 4)
    return X @ X.transpose(0, 2, 1) / m + np.eye(m)


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _execute(K, table, n_flags, rng=None):
    """Kernel 10's tasks on float64 tiles of the (B, M, M) ``K`` (M a
    multiple of 128): in ticket order, or, given ``rng``, in a random order
    that honours only each task's waits.  Returns (L, iL)."""
    batch, m = K.shape[0], K.shape[-1]
    nt = m // TILE
    nan = torch.full((batch, m, m), float("nan"), dtype=torch.float64)
    L, iL = nan.clone(), nan.clone()
    C = {}
    flags = np.zeros(n_flags, dtype=np.int64)

    def t(A, b, i, k, rows=slice(None)):
        return A[b, i * TILE:(i + 1) * TILE, k * TILE:(k + 1) * TILE][rows]

    def ready(row):
        return all(flags[row[7 + 2 * d]] >= row[8 + 2 * d]
                   for d in range(row[6]))

    def run(row):
        kind, b, i, k, j = (int(v) for v in row[:5])
        part, parts, units = (int(v) for v in row[-3:])
        size = TILE // parts
        rows = slice(part * size, (part + 1) * size)
        name = KINDS[kind]
        if name == "POTRF":
            A = t(K, b, 0, 0) if k == 0 else t(L, b, k, k)
            A = torch.tril(A) + torch.tril(A, -1).mT
            Lkk = torch.linalg.cholesky(A)
            t(L, b, k, k)[:] = Lkk
            t(iL, b, k, k)[:] = torch.linalg.solve_triangular(
                Lkk, torch.eye(TILE, dtype=K.dtype), upper=False)
        elif name == "TRSM":  # its rows alone
            acc = (t(K, b, i, 0, rows) if k == 0
                   else t(L, b, i, k, rows)).clone()
            Lkk, iLkk = t(L, b, k, k), t(iL, b, k, k)
            t(iL, b, i, k, rows)[:] = acc @ iLkk.mT  # below, in iL's tile
            below = t(iL, b, i, k, rows)
            R = acc - below @ Lkk.mT
            t(L, b, i, k, rows)[:] = below + R @ iLkk.mT
            t(L, b, k, i, rows)[:] = 0.0
            t(iL, b, k, i, rows)[:] = 0.0
        elif name == "UPD":  # its rows alone
            src = t(K, b, i, k, rows) if j == 0 else C[b, i, k][rows]
            out = src - t(L, b, i, j, rows) @ t(L, b, k, j).mT
            if j == k - 1:
                t(L, b, i, k, rows)[:] = out
            else:
                C.setdefault((b, i, k), torch.full(
                    (TILE, TILE), float("nan"), dtype=K.dtype))[rows] = out
        elif name == "ACC":  # tile (i, j), term k
            X = 0.0 if k == j else t(iL, b, i, j)
            t(iL, b, i, j)[:] = X + t(L, b, i, k) @ t(iL, b, k, j)
        else:  # INV (i, j)
            X = 0.0 if j == i - 1 else t(iL, b, i, j)
            X = X + t(L, b, i, i - 1) @ t(iL, b, i - 1, j)
            t(iL, b, i, j)[:] = -t(iL, b, i, i) @ X
        flags[row[5]] += units

    if rng is None:
        for row in table:
            assert ready(row), row
            run(row)
    else:
        pending = list(range(len(table)))
        while pending:
            ok = [p for p in pending if ready(table[p])]
            assert ok, "no task can run: a wait that nothing satisfies"
            p = ok[rng.integers(len(ok))]
            run(table[p])
            pending.remove(p)
    return L, iL


def _padded(K, m):
    """``linalg._tiled``'s padding: an identity block to 128 ceil(M / 128)."""
    mp = -(-m // TILE) * TILE
    Kp = torch.zeros((K.shape[0], mp, mp), dtype=K.dtype)
    Kp[:, :m, :m] = K
    Kp.diagonal(dim1=-2, dim2=-1)[:, m:] = 1.0
    return Kp


@pytest.mark.parametrize("order", ["ticket", "random"])
@pytest.mark.parametrize("batch,m", [(2, 256), (1, 777)])
def test_the_plan_executed_plainly_is_the_blocked_pair(plan, batch, m,
                                                       order):
    K = torch.from_numpy(_spd(batch, m, seed=m))
    Kp = _padded(K, m)
    table, n_flags = plan.tasks(batch, Kp.shape[-1] // TILE)
    rng = np.random.default_rng(m) if order == "random" else None
    L, iL = _execute(Kp, table, n_flags, rng)
    L, iL = L[:, :m, :m], iL[:, :m, :m]
    want_L, want_iL = linalg.blocked_cholesky_inverse(K)
    assert _normwise(L, want_L) < 1e-12
    assert _normwise(iL, want_iL) < 1e-12
    assert not torch.triu(L, 1).any() and not torch.triu(iL, 1).any()


# ---- kernel 10's own source, on the host ---------------------------------------

KERNEL_SOURCE = CSRC / "chol_blocked_kernel.cu"
LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), ([\w()]+), stream>>>\((.*?)\);",
                    re.S)
SMEMS = {"chol_panel_smem": "extern __shared__ __align__(16) unsigned char "
                            "chol_panel_smem[];",
         "chol_blocked_smem": "extern __shared__ __align__(16) unsigned "
                              "char chol_blocked_smem[];"}


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the routes and the
    launcher read (``is_cuda``), without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture(scope="module")
def host_kernel():
    """csrc/chol_blocked_kernel.cu built for the host, kernel 9's source
    inlined where it includes it, its launch and dynamic shared memory
    rewritten for tests/host_cuda/cuda_runtime.h, its entries bound as
    ``ops/cuda_kernels.py`` binds the card's."""
    text = KERNEL_SOURCE.read_text().replace(
        '#include "chol_panel_kernel.cu"',
        (CSRC / "chol_panel_kernel.cu").read_text())
    text, launches = LAUNCH.subn(r"host_launch(\2, \3, \4, [&] { \1(\5); });",
                                 text)
    assert launches == 1, "the kernel's launch changed form"
    for name, decl in SMEMS.items():
        assert decl in text, "the dynamic shared memory changed form"
        text = text.replace(decl,
                            f"unsigned char* {name} = host_dynamic_smem;")
    lib = _host_library("chol_blocked_host", text, "c++20",
                        ["-O1", "-pthread", f"-I{HOST_STUB}"])
    lib.hetmogp_chol_blocked_f32.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.hetmogp_chol_blocked_f32.restype = ctypes.c_int
    lib.hetmogp_chol_blocked_flags.argtypes = [ctypes.c_int] * 2
    lib.hetmogp_chol_blocked_flags.restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(monkeypatch, host_kernel):
    """Kernel 10's launcher on the host build: its library, and no CUDA
    device or stream to enter."""
    monkeypatch.setattr(cuda_kernels, "_library", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=None))


def _pair(K):
    L, iL = linalg.blocked_cholesky_inverse(K.as_subclass(_OnCard))
    return L.as_subclass(torch.Tensor), iL.as_subclass(torch.Tensor)


@pytest.mark.parametrize("batch,m", [(2, 256), (1, 300)])
def test_kernel_10_source_on_host_matches_plain(on_host, batch, m):
    """Through ``blocked_cholesky_inverse``: one launch a call (a ragged M
    padded), the tasks counted in the open span, the errors of the plain
    float32 version, exact zeros above the diagonal, two launches bitwise
    equal, and each matrix of the stack bitwise the matrix alone."""
    K64 = torch.from_numpy(_spd(batch, m, seed=m))
    K = K64.float()
    nt = -(-m // TILE)
    before = cuda_kernels.chol_blocked.launches
    with profiling.spans(), profiling.annotate("refresh"):
        got = _pair(K)
    rep = profiling.span_report()
    assert rep["spans"]["refresh"]["counts"] == {
        "factor.tile_tasks": cuda_kernels.chol_blocked_tasks(batch, nt)}
    again = _pair(K)
    alone = _pair(K[-1:])
    assert cuda_kernels.chol_blocked.launches == before + 3
    ref = torch.linalg.cholesky(K64)
    ref = (ref, torch.linalg.solve_triangular(
        ref, torch.eye(m, dtype=K64.dtype).expand_as(ref), upper=False))
    plain = cuda_kernels.chol_blocked_plain(K)
    for g, a, one, p, r in zip(got, again, alone, plain, ref):
        assert g.shape == K.shape and torch.equal(g, a)
        assert torch.equal(g[-1:], one)
        assert not torch.triu(g, 1).any()
        assert _normwise(g, r) <= 4 * _normwise(p, r) + 1e-6


def test_kernel_10_source_on_host_gives_nan_from_the_failed_panel(on_host):
    """A pivot that fails in the second panel of one matrix: its L NaN on
    and below the diagonal from column 128 on, its iL NaN from row 128 on,
    the rest and the other matrix finite, zeros above the diagonal."""
    K = torch.from_numpy(_spd(2, 256, seed=3)).float()
    K[1, 200, 200] = -1.0
    L, iL = _pair(K)
    assert torch.isfinite(L[0]).all() and torch.isfinite(iL[0]).all()
    rows, cols = torch.tril_indices(256, 256)
    right = cols >= TILE
    assert torch.isnan(L[1][rows[right], cols[right]]).all()
    assert torch.isfinite(L[1][rows[~right], cols[~right]]).all()
    assert torch.isnan(iL[1][TILE:]).all()
    assert torch.isfinite(iL[1][:TILE]).all()
    assert not torch.triu(L[1], 1).any()
    assert not torch.triu(iL[1][:TILE], 1).any()
