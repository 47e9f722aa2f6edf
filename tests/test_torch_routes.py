"""The triangular products' one design per precision on the card: the
TMA-fed kernels (``csrc/tril_proj_kernel.cu``, ``tril_proj3_kernel.cu``,
``tril_right_kernel.cu``, ``tril_right3_kernel.cu`` and
``tril_out_kernel.cu``, sharing ``csrc/tril_tma.cuh``), which every shape
reaches through ``_tma_operands``: a ragged M padded with zeros, an
unaligned base copied.

The kernels run only on the card.  Here: the operands ``_tma_operands``
hands on, each router against the plain version at a ragged M, the launch
counters of every launcher, the autograd.Functions going through the
routers (with the launchers swapped for recording plain versions), the plain
version of kernel 3's L pre-pass against the JAX package's bit-mask split
(``tools/probe_pallas_proj.py:pallas_proj2``), kernel 5's router, and what
kernel 5's TMA-fed launcher hands its entry (no pre-pass scratch: it
splits L in shared memory), through a stand-in library; the row-strided
views kernels A's and 4's TMA-fed launchers take in place, and the
strides they hand their entries; kernel 8's (tril(A^T B)) routers,
launchers and what they hand their entries; and
the ``hetmogp::`` operators a VE and a VM step reach on the CPU, what each
launches on the card.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetmogp_tpu_torch.ops import cuda_kernels, linalg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _launch_counts_down_after():
    """The launch counts are global to the process, and this file's cases
    drive the launchers on stand-ins for a
    card tensor: each case leaves them at 0, so that a
    later file in the same process starts from 0 too."""
    yield
    cuda_kernels.zero_launch_counts()


def _inputs(Q, N, M, offset=0, seed=0):
    """float32 (A, L); ``offset`` floats into a buffer shifts A's base off
    16-byte alignment while keeping it contiguous."""
    rng = np.random.RandomState(seed)
    buf = torch.empty(offset + Q * N * M)  # 64-byte aligned
    A = buf[offset:].view(Q, N, M)
    A.copy_(torch.from_numpy(rng.randn(Q, N, M).astype(np.float32)))
    assert (A.data_ptr() % 16 == 0) == (offset % 4 == 0)
    L = torch.from_numpy((np.tril(rng.randn(Q, M, M)) / np.sqrt(M)
                          + 2.0 * np.eye(M)).astype(np.float32))
    return A, L


@pytest.mark.parametrize("M,aligned,square", [
    (1024, True, True),     # the main path: trainer, VM step and serving
    (1000, True, True),     # M % 4 == 0, not a multiple of the tile
    (4, True, True),
    (777, True, True),      # chip_smoke's ragged case
    (1022, True, True),     # rows not a multiple of 16 bytes
    (7, True, True),
    (1024, False, True),    # an unaligned base
    (1024, True, False),    # kernel 8's: the VE and VM steps' gL
    (772, True, False),     # M % 4 == 0, not a multiple of the tile
    (777, True, False),     # chip_smoke's ragged VM step
    (1022, True, False),    # rows not a multiple of 16 bytes
    (1024, False, False),   # an unaligned base
])
def test_tma_operands_pad_or_copy_by_shape(M, aligned, square):
    """``_tma_operands`` hands (A, L), or kernel 8's (A, B), on as they are
    where M % 4 == 0 and both are contiguous on 16-byte boundaries; else
    as copies, padded with zeros to M' = 4 ceil(M / 4) (A's and B's
    columns, L's rows and columns) where M % 4 != 0.  What it hands on is
    what a TMA entry takes, and holds the operands' values."""
    A, L = _inputs(1, 3, M, offset=0 if aligned else 1)
    X = L if square else _inputs(1, 3, M, seed=1)[0]
    a, x = cuda_kernels._tma_operands(A, X, square)
    Mp = -(-M // 4) * 4
    assert a.shape == (1, 3, Mp)
    assert x.shape == ((1, Mp, Mp) if square else (1, 3, Mp))
    copied = not aligned or M % 4 != 0
    assert (a.data_ptr() != A.data_ptr()) == copied
    assert (x.data_ptr() != X.data_ptr()) == (M % 4 != 0)
    for t, v in ((a, A), (x, X)):
        assert cuda_kernels._tma_ready(t, views=False)
        assert torch.equal(t[..., :v.shape[-2], :M], v)
        assert not t[..., M:].any() and not t[..., v.shape[-2]:, :].any()


def _recorders(monkeypatch, names, plain):
    """Swap the launchers ``names`` for the plain version, recording which
    one each call reached and the operands it was handed."""
    calls = []
    for name in names:
        def launcher(A, L, name=name):
            calls.append((name, A, L))
            return plain(A, L)
        launcher.__name__ = name
        monkeypatch.setattr(cuda_kernels, name, launcher)
    return calls


# how the TMA launcher gets each case's operands
ROUTE_CASES = [((2, 40, 64, 0), "as-is"), ((2, 40, 77, 0), "padded"),
               ((2, 40, 64, 1), "copied")]


def _handed(calls, name, A, X, how, square=True):
    """The one call in ``calls`` reached ``name`` with (A, X) as they are,
    as 16-byte-aligned copies, or padded with zeros to M' = 80."""
    (reached, a, x), = calls
    assert reached == name
    M = A.shape[-1]
    Mp = 80 if how == "padded" else M
    assert a.shape == (*A.shape[:-1], Mp)
    assert x.shape == ((*X.shape[:-2], Mp, Mp) if square
                       else (*X.shape[:-1], Mp))
    assert (a.data_ptr() == A.data_ptr()) == (how == "as-is")
    for t, v in ((a, A), (x, X)):
        assert cuda_kernels._tma_ready(t, views=False)
        assert torch.equal(t[..., :v.shape[-2], :M], v)
        assert not t[..., M:].any() and not t[..., v.shape[-2]:, :].any()


@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=["aligned", "ragged-M", "unaligned-base"])
def test_projection_router_reaches_the_launcher_of_the_route(
        monkeypatch, case, route):
    """Kernel A's router hands its TMA launcher the operands of
    ``_tma_operands`` and crops the result to M."""
    A, L = _inputs(*case)
    calls = _recorders(monkeypatch, ("tril_projection_tma",),
                       cuda_kernels.tril_projection_plain)
    got = cuda_kernels.tril_projection(A, L)
    _handed(calls, "tril_projection_tma", A, L, route)
    assert got.shape == A.shape and got.is_contiguous()
    assert torch.equal(got, cuda_kernels.tril_projection_plain(A, L))


@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=["aligned", "ragged-M", "unaligned-base"])
def test_3pass_function_goes_through_the_router(monkeypatch, case, route):
    """TrilProjection3Pass with the kernel asked for: the CUDA
    implementation of its operator is the router (called directly: the
    dispatcher sends a CPU tensor to the plain version), which hands the
    TMA launcher the operands of ``_tma_operands``; its dA the full
    float32 product's and its dL kernel 8's three-pass plain version's
    (rtol 1e-6, as test_torch_proj3.py), and the dispatch of a CPU tensor
    takes the plain version without reaching the router."""
    A, L = _inputs(*case)
    calls = _recorders(monkeypatch, ("tril_projection_3pass_tma",),
                       cuda_kernels.tril_projection_3pass_plain)
    # detach() keeps the storage, and so A's alignment
    routed = cuda_kernels.tril_projection_3pass(A.detach(),
                                                L.detach())
    _handed(calls, "tril_projection_3pass_tma", A, L, route)
    a, l = A.detach().requires_grad_(), L.detach().requires_grad_()
    out = cuda_kernels.TrilProjection3Pass.apply(a, l, True)
    assert torch.equal(out.detach(), routed)
    assert torch.equal(out.detach(),
                       cuda_kernels.tril_projection_3pass_plain(A, L))
    g = torch.from_numpy(np.random.RandomState(5).randn(*A.shape).astype(
        np.float32))
    got = torch.autograd.grad(out, (a, l), g)
    a1 = A.clone().requires_grad_()
    (want,) = torch.autograd.grad(a1 @ torch.tril(L).mT, a1, g)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        got[1], cuda_kernels.t_matmul_tril_out_3pass_plain(g, A),
        rtol=1e-6, atol=1e-6)
    linalg.matmul_tril_t(A, L, precision="high")
    assert len(calls) == 1


def test_projection_function_goes_through_the_router(monkeypatch):
    A, L = _inputs(2, 30, 64)
    calls = _recorders(monkeypatch, ("tril_projection_tma",),
                       cuda_kernels.tril_projection_plain)
    cuda_kernels.tril_projection(A, L)  # the operator's CUDA implementation
    assert [c[0] for c in calls] == ["tril_projection_tma"]
    a = A.double().requires_grad_()
    out = cuda_kernels.TrilProjection.apply(a, L.double())
    assert len(calls) == 1  # a CPU tensor: the plain version
    g = torch.ones_like(out)
    (da,) = torch.autograd.grad(out, (a,), g)
    torch.testing.assert_close(da, g @ torch.tril(L.double()), rtol=1e-12,
                               atol=1e-12)


def _stand_in(name):
    """A stand-in for the TMA launcher ``name``: the plain version on the
    operands it is handed, which must be what TMA takes (M % 4 == 0)."""
    plain = {"tril_projection_tma": cuda_kernels.tril_projection_plain,
             "tril_projection_3pass_tma":
                 cuda_kernels.tril_projection_3pass_plain,
             "tril_right3_tma": cuda_kernels.matmul_tril_3pass_plain,
             "tril_out_tma": cuda_kernels.t_matmul_tril_out_plain,
             "tril_out3_tma": cuda_kernels.t_matmul_tril_out_3pass_plain}
    right = {"product": cuda_kernels.matmul_tril_plain,
             "both": cuda_kernels.quad_diag_product_plain,
             "rowsum": cuda_kernels.quad_diag_plain}

    def launcher(A, X, epilogue="product"):
        assert A.shape[-1] % 4 == 0
        if name == "tril_right_tma":
            return right[epilogue](A, X)
        return plain[name](A, X)
    launcher.__name__ = name
    return launcher


@pytest.mark.parametrize("M", [7, 777])
@pytest.mark.parametrize("router", ["tril_projection",
                                    "tril_projection_3pass", "tril_right",
                                    "tril_right3", "tril_out", "tril_out3"])
def test_router_at_a_ragged_M_matches_the_plain_version(monkeypatch, router,
                                                        M):
    """Each router, its TMA launcher swapped for the plain version on the
    operands it hands on (padded to M' = 4 ceil(M / 4)), matches the plain
    version on the unpadded operands: the padding's zeros add nothing, and
    the crop returns (Q, N, M) or (Q, M, M), contiguous; kernel 4's router
    in each of its epilogues."""
    monkeypatch.setattr(cuda_kernels, f"{router}_tma",
                        _stand_in(f"{router}_tma"))
    A, L = _inputs(2, 40, M)
    plain = {"tril_projection": cuda_kernels.tril_projection_plain,
             "tril_projection_3pass":
                 cuda_kernels.tril_projection_3pass_plain,
             "tril_right3": cuda_kernels.matmul_tril_3pass_plain,
             "tril_out": cuda_kernels.t_matmul_tril_out_plain,
             "tril_out3": cuda_kernels.t_matmul_tril_out_3pass_plain}
    fn = getattr(cuda_kernels, router)
    if router == "tril_right":
        got = [fn(A, L), *fn(A, L, "both"), fn(A, L, "rowsum")]
        want = [cuda_kernels.matmul_tril_plain(A, L),
                *cuda_kernels.quad_diag_product_plain(A, L),
                cuda_kernels.quad_diag_plain(A, L)]
    else:
        X = _inputs(2, 40, M, seed=1)[0] if router.startswith(
            "tril_out") else L
        got, want = [fn(A, X)], [plain[router](A, X)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


LAUNCHERS = ("rbf_K_batched_vec", "rbf_K_batched_scalar",
             "tril_projection_tma", "tril_projection_3pass_tma",
             "tril_right_tma", "tril_right3_tma", "tril_out_tma",
             "tril_out3_tma", "gh_sweep", "gh_sweep_value", "task_var_exp",
             "task_var_exp_value", "task_var_exp_backward", "adam_update",
             "chol_panel", "chol_blocked")


# the vector kernel is what ``rbf_K_batched`` reaches on the main path, and
# keeps the id this case had before the RBF kernel got a second route
@pytest.mark.parametrize("name", [
    pytest.param(n, id="rbf_K_batched" if n == "rbf_K_batched_vec" else n)
    for n in LAUNCHERS])
def test_every_route_has_a_launch_counter(monkeypatch, name):
    launcher = getattr(cuda_kernels, name)
    monkeypatch.setattr(launcher, "launches", 7)
    counts = cuda_kernels.launch_counts()
    assert set(counts) == {*LAUNCHERS, "rbf_backward"}
    assert counts[name] == 7
    cuda_kernels.zero_launch_counts()
    assert launcher.launches == 0
    assert not any(cuda_kernels.launch_counts().values())


def _jax_split(X):
    """The JAX package's split of float32 X, as ``pallas_proj2.split``
    (``tools/probe_pallas_proj.py:135-140``) writes it: (hi, lo) as bf16
    bit patterns (uint16)."""
    bits = jax.lax.bitcast_convert_type(jnp.asarray(X), jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                      jnp.float32)
    lo = (jnp.asarray(X) - hi).astype(jnp.bfloat16)
    return tuple(np.asarray(h).view(np.uint16)
                 for h in (hi.astype(jnp.bfloat16), lo))


@pytest.mark.parametrize("M", [64, 77])
def test_split_prepass_plain_matches_the_jax_split(M):
    """Kernel 3's pre-pass, plain: the same hi and lo bits as the JAX
    package's split of tril(L), exact zeros above the diagonal and in the
    pad columns (rows padded to a multiple of 8 bf16)."""
    rng = np.random.RandomState(3)
    L = (rng.randn(2, M, M) * np.logspace(-6, 6, M)).astype(np.float32)
    hi, lo = cuda_kernels.tril_split_bf16_plain(torch.from_numpy(L))
    Mp = cuda_kernels.bf16_row(M)
    assert Mp % 8 == 0 and M <= Mp < M + 8
    assert hi.shape == lo.shape == (2, M, Mp)
    assert hi.dtype == lo.dtype == torch.bfloat16
    want_hi, want_lo = _jax_split(np.tril(L))
    for got, want in ((hi, want_hi), (lo, want_lo)):
        bits = got.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits[..., :M], want)
        assert not bits[..., M:].any()
        assert not np.triu(bits[..., :M].astype(np.int64), 1).any()


@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=["aligned", "ragged-M", "unaligned-base"])
def test_3pass_right_router_reaches_the_launcher_of_the_route(
        monkeypatch, case, route):
    """Kernel 5's router (``tril_right3``, the CUDA implementation of
    ``hetmogp::matmul_tril_3pass``) hands the TMA-fed launcher the
    operands of ``_tma_operands`` and crops the result to M."""
    A, L = _inputs(*case)
    calls = _recorders(monkeypatch, ("tril_right3_tma",),
                       cuda_kernels.matmul_tril_3pass_plain)
    got = cuda_kernels.tril_right3(A.detach(), L.detach())
    _handed(calls, "tril_right3_tma", A, L, route)
    assert got.shape == A.shape and got.is_contiguous()
    assert torch.equal(got, cuda_kernels.matmul_tril_3pass_plain(A, L))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: what the launchers' input
    checks read (``is_cuda``), without a card."""

    @property
    def is_cuda(self):
        return True


class _Library:
    """Stands for the kernel library: records each entry called with its
    arguments; ``hetmogp_tril_right3_partials`` answers ``partials``."""

    def __init__(self, partials):
        self.partials, self.calls = partials, []

    def hetmogp_tril_right3_partials(self, Q, N, M):
        return self.partials

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


@pytest.mark.parametrize("partials", [0, 3 * 128 * 128],
                         ids=["no-split", "split"])
def test_kernel5_launch_takes_no_split_scratch(monkeypatch, partials):
    """Kernel 5's TMA-fed launcher runs one entry, with A, L, out and the
    partial-sum scratch its schedule asks for (none where it splits no
    tile): no bf16 scratch for a split pre-pass, whose entry it no longer
    has; the launch counts once."""
    lib = _Library(partials)
    monkeypatch.setattr(cuda_kernels, "_library", lambda: lib)

    def no_scratch(A):
        raise AssertionError("kernel 5 took kernel 3's bf16 scratch")
    monkeypatch.setattr(cuda_kernels, "_bf16_scratch", no_scratch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    A, L = (t.as_subclass(_OnCard) for t in _inputs(3, 40, 64))
    cuda_kernels.zero_launch_counts()
    out = cuda_kernels.tril_right3_tma(A, L)
    assert out.shape == A.shape
    assert [entry for entry, _ in lib.calls] == ["hetmogp_tril_right3_f32"]
    args = lib.calls[0][1]
    assert args[:3] == (A.data_ptr(), L.data_ptr(), out.data_ptr())
    assert (args[3] is None) == (partials == 0)
    assert args[4:] == (3, 40, 64, 0)
    assert cuda_kernels.launch_counts()["tril_right3_tma"] == 1
    cuda_kernels.zero_launch_counts()


# ---- kernels A and 4 read row-strided views where TMA can address them ------

def _views(width, seed=0):
    """float32 (A, L) of (2, 40, 64) and (2, 64, 64) as views of arrays
    ``width`` columns wide, starting at column 4 (16 bytes in): TMA can
    address them in place when ``width`` % 4 == 0."""
    rng = np.random.RandomState(seed)
    bigA = torch.from_numpy(rng.randn(2, 41, width).astype(np.float32))
    bigL = torch.from_numpy((rng.randn(2, 65, width) / 8).astype(np.float32))
    return bigA[:, 1:, 4:68], bigL[:, 1:, 4:68]


@pytest.mark.parametrize("t,want", [
    (torch.zeros(2, 40, 64), (64, 40 * 64)),           # contiguous
    (torch.zeros(2, 41, 100)[:, 1:, 4:68], (100, 41 * 100)),  # a view
    (torch.zeros(1, 40, 100)[:, :, 4:68], (100, 40 * 100)),   # batch 1
    (torch.zeros(2, 40, 99)[:, :, 4:68], None),         # rows 396 B apart
    (torch.zeros(2, 40, 100)[:, :, 1:65], None),        # base 4 B in
    (torch.zeros(2, 40, 64).mT, None),                  # columns strided
    (torch.zeros(1, 40, 64).expand(2, 40, 64), None),   # planes overlap
])
def test_tma_strides_of_what_tma_can_address(t, want):
    assert cuda_kernels._tma_strides(t) == want


@pytest.mark.parametrize("width,in_place", [(100, True), (99, False)],
                         ids=["aligned-rows", "unaligned-rows"])
@pytest.mark.parametrize("router,tma,plain", [
    ("tril_projection", "tril_projection_tma",
     cuda_kernels.tril_projection_plain),
    ("tril_right", "tril_right_tma", cuda_kernels.matmul_tril_plain)],
    ids=["kernel-A", "kernel-4"])
def test_strided_routers_hand_views_to_the_tma_launcher(
        monkeypatch, width, in_place, router, tma, plain):
    """Kernels A's and 4's routers hand row-strided views to the TMA-fed
    launcher as they are where TMA can address them, and contiguous
    copies where it cannot (rows not a multiple of 16 bytes apart)."""
    A, L = _views(width)
    seen = []

    def launcher(a, l, *extra):
        seen.append((a, l))
        return plain(a, l)
    launcher.__name__ = tma
    monkeypatch.setattr(cuda_kernels, tma, launcher)
    got = getattr(cuda_kernels, router)(A, L)
    (a, l), = seen
    for t, v in ((a, A), (l, L)):
        assert (t.data_ptr() == v.data_ptr()
                and t.stride() == v.stride()) == in_place
        assert torch.equal(t, v)
    assert torch.equal(got, plain(A, L))


@pytest.mark.parametrize("width,in_place", [(100, True), (99, False)],
                         ids=["aligned-rows", "unaligned-rows"])
def test_tma_launchers_hand_their_strided_entries_the_views(
        monkeypatch, width, in_place):
    """Kernels A's and 4's routers run their TMA-fed launchers' strided
    entries with each operand's pointer followed by its row and plane
    strides: the view's own where TMA can address it, else a contiguous
    copy's, which the launcher alone refuses to make.  Each launch counts
    once."""
    lib = _Library(0)
    monkeypatch.setattr(cuda_kernels, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    A, L = (t.as_subclass(_OnCard) for t in _views(width))
    cuda_kernels.zero_launch_counts()
    for router, entry in (("tril_projection",
                           "hetmogp_tril_proj_strided_f32"),
                          ("tril_right", "hetmogp_tril_right_strided_f32")):
        name, lib.calls = f"{router}_tma", []
        if not in_place:
            with pytest.raises(ValueError, match="router pads or copies"):
                getattr(cuda_kernels, name)(A, L)
        out = getattr(cuda_kernels, router)(A, L)
        assert out.shape == A.shape and out.is_contiguous()
        (called, args), = lib.calls
        assert called == entry
        if in_place:
            assert args[:6] == (A.data_ptr(), width, 41 * width,
                                L.data_ptr(), width, 65 * width)
        else:
            assert A.data_ptr() not in args and L.data_ptr() not in args
            assert args[1:3] == (64, 40 * 64) and args[4:6] == (64, 64 * 64)
        assert args[6] == out.data_ptr()
        assert args[-4:] == (2, 40, 64, 0)
        assert cuda_kernels.launch_counts()[name] == 1
    cuda_kernels.zero_launch_counts()


# ---- kernel 8: tril(A^T B) ----------------------------------------------------

@pytest.mark.parametrize("three", [False, True], ids=["f32", "3pass"])
@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=["aligned", "ragged-M", "unaligned-base"])
def test_tril_out_router_reaches_the_launcher_of_the_route(
        monkeypatch, case, route, three):
    """Kernel 8's routers (``tril_out`` and ``tril_out3``, the CUDA
    implementations of ``hetmogp::t_matmul_tril_out`` and its 3-pass
    twin) hand the TMA-fed launcher the operands of ``_tma_operands``
    (A's and B's columns padded at a ragged M) and crop the result to
    (M, M)."""
    A, _ = _inputs(*case)
    B, _ = _inputs(*case[:3], seed=1)
    name = "tril_out3" if three else "tril_out"
    plain = (cuda_kernels.t_matmul_tril_out_3pass_plain if three
             else cuda_kernels.t_matmul_tril_out_plain)
    calls = _recorders(monkeypatch, (f"{name}_tma",), plain)
    got = getattr(cuda_kernels, name)(A.detach(), B)
    _handed(calls, f"{name}_tma", A, B, route, square=False)
    M = A.shape[-1]
    assert got.shape == (2, M, M) and got.is_contiguous()
    assert torch.equal(got, plain(A, B))


class _OutLibrary(_Library):
    """``_Library`` with kernel 8's scratch query: answers ``partials``
    and records which design asked."""

    def __init__(self, partials):
        super().__init__(partials)
        self.asked = []

    def hetmogp_tril_out_partials(self, Q, N, M, three):
        self.asked.append(three)
        return self.partials


@pytest.mark.parametrize("partials", [0, 12 * 10 * 128 * 128],
                         ids=["no-split", "split"])
def test_kernel8_launchers_hand_their_entries_what_they_take(monkeypatch,
                                                             partials):
    """Kernel 8's launchers run one entry each, with A, B, out and the
    partial-sum scratch their schedule asks for (none where it splits no
    tile), each asking for its own design's.  Each launch counts once; the
    output is (Q, M, M)."""
    lib = _OutLibrary(partials)
    monkeypatch.setattr(cuda_kernels, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    A = _inputs(3, 40, 64)[0].as_subclass(_OnCard)
    B = _inputs(3, 40, 64, seed=1)[0].as_subclass(_OnCard)
    cuda_kernels.zero_launch_counts()
    for name, entry, three in (
            ("tril_out_tma", "hetmogp_tril_out_f32", 0),
            ("tril_out3_tma", "hetmogp_tril_out3_f32", 1)):
        lib.calls, lib.asked = [], []
        out = getattr(cuda_kernels, name)(A, B)
        assert out.shape == (3, 64, 64)
        assert [e for e, _ in lib.calls] == [entry]
        args = lib.calls[0][1]
        assert args[:3] == (A.data_ptr(), B.data_ptr(), out.data_ptr())
        assert lib.asked == [three]
        assert (args[3] is None) == (partials == 0)
        assert args[4:] == (3, 40, 64, 0)
        assert cuda_kernels.launch_counts()[name] == 1
    cuda_kernels.zero_launch_counts()


def test_kernel8_launchers_refuse_what_they_cannot_take():
    """Off the card, in another dtype or with a gradient to record, and
    on the card at a ragged M or an unaligned base, which their routers
    pad or copy."""
    A, _ = _inputs(1, 8, 8)
    ragged = _inputs(1, 8, 7)[0].as_subclass(_OnCard)
    unaligned = _inputs(1, 8, 8, offset=1)[0].as_subclass(_OnCard)
    before = cuda_kernels.launch_counts()
    for name in ("tril_out_tma", "tril_out3_tma"):
        launcher = getattr(cuda_kernels, name)
        for a in (ragged, unaligned):
            with pytest.raises(ValueError, match="router pads or copies"):
                launcher(a, a)
        with pytest.raises(ValueError, match="CUDA"):
            launcher(A, A)
        with pytest.raises(TypeError, match="float32"):
            launcher(A.double(), A.double())
        with pytest.raises(NotImplementedError, match="no backward"):
            launcher(A, A.clone().requires_grad_())
    assert cuda_kernels.launch_counts() == before


class _OpCounts(TorchDispatchMode):
    """Counts the ``hetmogp::`` operators that run inside it."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split(".")[0]
        if name.startswith("hetmogp::"):
            name = name[len("hetmogp::"):]
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_operator_counts_of_a_ve_and_a_vm_step(precision):
    """The flagship's steps on the CPU at M = 256 (two panels of the
    blocked factorization), every ``hetmogp::`` operator counted: what a
    launch each is on the card.  A VE step: the RBF, the projection at
    ``precision``, quad_diag's forward and its gL (kernel 8 at
    ``precision``).  The VM step: the RBF, the solve's float32 projection
    and quad_diag's gA (kernel A; q(u) is frozen, so no gL), the four
    adjoint products at ``precision``, the solve's Lbar (kernel 8), and
    the refresh of (Luu, iLuu), in float32 as the state's first
    factorization has: kernel A twice on the rows below the first panel
    (the product and its refinement), kernel 4 on the second panel's
    strip of the inverse (kernel 9 factors each panel: a launcher, not an
    operator)."""
    import hetmogp_tpu_torch as tp
    from hetmogp_tpu_torch import train as ttrain

    liks = (tp.HetGaussian(), tp.Bernoulli(), tp.Categorical(K=3),
            tp.Poisson(), tp.Gamma(), tp.Exponential())
    n, b, m = 48, 16, 256
    rng = np.random.RandomState(0)
    X = [rng.rand(n, 2).astype(np.float32) for _ in liks]
    Y = [rng.randn(n, 1), (rng.rand(n, 1) > 0.5).astype(float),
         rng.randint(1, 4, (n, 1)).astype(float),
         rng.poisson(3.0, (n, 1)).astype(float),
         rng.gamma(2.0, 1.0, (n, 1)) + 1e-3,
         rng.exponential(1.0, (n, 1)) + 1e-3]
    cfg = tp.ModelConfig(likelihoods=liks, num_latent=2, num_inducing=m,
                         input_dim=2, dtype="float32", jitter=1e-4,
                         adaptive_jitter=False, fuse_task_rows=True,
                         ve_fwd_precision=precision)
    tc = tp.TrainConfig(optimizer="adam", step_rate=0.005,
                        minibatch="slice", vm_batch_fraction=0.25)
    params = tp.init_params(rng, cfg, rng.rand(m, 2).astype(np.float32),
                            lengthscale=0.2, variance=0.5, q_mu_scale=0.1,
                            device="cpu")
    sizes, batches = (n,) * 6, (b,) * 6
    ext = ttrain.extend_for_wraparound(
        tp.prepare_dataset_on_device(cfg, X, Y, device="cpu"), batches,
        sizes)
    step = ttrain.make_step(cfg, tc)
    scales = ttrain.batch_scales(sizes, batches, torch.float32, "cpu")
    refresh = {"matmul_tril": 1, "tril_projection": 2}
    with _OpCounts() as ops:
        state = tp.init_train_state(params, cfg)
    assert ops.seen == refresh
    p3 = "_3pass" if precision == "high" else ""
    ve = {"rbf_K_batched": 1, f"tril_projection{p3}": 1,
          "quad_diag_product": 1, f"t_matmul_tril_out{p3}": 1}
    vm = {"rbf_K_batched": 1, "tril_projection": 2 + 2,
          "quad_diag_product": 1, f"t_matmul_tril_out{p3}": 1}
    vm[f"matmul_tril{p3}"] = 4
    vm["matmul_tril"] = vm.get("matmul_tril", 0) + 1
    for i in range(tc.ve_steps_per_vm + 1):
        with _OpCounts() as ops:
            state, _ = step(state, ttrain.slice_batch(ext, (0,) * 6, sizes,
                                                      batches), scales)
        assert ops.seen == (vm if i == tc.ve_steps_per_vm else ve), i
