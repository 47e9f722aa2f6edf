"""The blocked factorization on the card (marked ``card``; skips without
one).  A float32 stack wider than 128 is one launch of kernel 10
(``csrc/chol_blocked_kernel.cu``), whose every sum runs in an order fixed
by its tile task and in which no atomic enters the arithmetic: so a
stack's parts come back bitwise equal to the parts factored alone (as the
exact natural-gradient retraction stacks its two attempts' A), two calls
are bitwise equal and a replayed CUDA graph is bitwise the eager call,
with no ulp allowance.  Float64 keeps the chain of kernel 9 and cuBLAS's
float64 products, where cuBLAS may pick another algorithm for another
batch and move an element by at most one ulp of its dtype.  Kernel 10 is
held to float64 within 1.5x the errors of cuSOLVER's potrf (L) and of a
triangular solve against I (iL) at M = 777 (padded), 1024 and 4096, and
to NaN from a failing panel on.

No JAX here: on the card, ``python3 -m pytest
tests/test_torch_blocked_chol_card.py -m card --noconftest``."""

from __future__ import annotations

import pytest
import torch

from hetmogp_tpu_torch.ops import cuda_kernels, linalg

TILE = 128
ERR_VS_LIBRARY = 1.5


def _ulps(a, b):
    """Elementwise distance of two tensors of one float dtype in ulps."""
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    sign = torch.iinfo(bits).min

    def key(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, sign - i, i)
    return (key(a) - key(b)).abs()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")


def _spd(q, m, dtype=torch.float32, seed=None):
    g = torch.Generator(device="cuda").manual_seed(m if seed is None
                                                   else seed)
    X = torch.randn(q, m, m + 4, generator=g, device="cuda",
                    dtype=torch.float64)
    return (X @ X.mT / m + torch.eye(m, device="cuda",
                                     dtype=torch.float64)).to(dtype)


@pytest.mark.card
@pytest.mark.parametrize("m, nb", [(1024, None), (256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_a_stack_on_the_card_is_each_part_alone(m, nb, dtype):
    _card()
    K = _spd(8, m, dtype)
    L, iL = linalg.blocked_cholesky_inverse(K, nb)
    allowed = 0 if dtype == torch.float32 else 1
    for part in (slice(0, 4), slice(4, 8)):
        L_p, iL_p = linalg.blocked_cholesky_inverse(K[part], nb)
        for got, want in ((L[part], L_p), (iL[part], iL_p)):
            assert bool(torch.isfinite(want).all())
            assert int(_ulps(got, want).max()) <= allowed


@pytest.mark.card
@pytest.mark.parametrize("q, m", [(4, 777), (8, 1024), (2, 4096)])
def test_kernel_10_is_one_launch_repeatable_and_graphable(q, m):
    """One launch a call; two calls bitwise equal; a CUDA graph of the call
    replayed bitwise equal to the eager call."""
    _card()
    K = _spd(q, m)
    before = cuda_kernels.launch_counts()
    L, iL = linalg.blocked_cholesky_inverse(K)
    after = cuda_kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"chol_blocked": 1}
    L2, iL2 = linalg.blocked_cholesky_inverse(K)
    assert torch.equal(L, L2) and torch.equal(iL, iL2)
    static = K.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        linalg.blocked_cholesky_inverse(static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = linalg.blocked_cholesky_inverse(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], L) and torch.equal(captured[1], iL)


@pytest.mark.card
@pytest.mark.parametrize("q, m", [(4, 777), (4, 1024), (2, 4096)])
def test_kernel_10_is_as_accurate_as_the_library(q, m):
    """L within 1.5x potrf's normwise error against float64, iL within
    1.5x a float32 triangular solve's against I; exact zeros above the
    diagonal."""
    _card()
    K = _spd(q, m)
    L64 = torch.linalg.cholesky(K.double())
    eye = torch.eye(m, device="cuda", dtype=torch.float64).expand_as(L64)
    iL64 = torch.linalg.solve_triangular(L64, eye, upper=False)
    L, iL = linalg.blocked_cholesky_inverse(K)
    Lp = torch.linalg.cholesky(K)
    iLp = torch.linalg.solve_triangular(Lp, eye.float(), upper=False)

    def err(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())
    assert err(L, L64) <= ERR_VS_LIBRARY * err(Lp, L64)
    assert err(iL, iL64) <= ERR_VS_LIBRARY * err(iLp, iL64)
    assert not torch.triu(L, 1).any() and not torch.triu(iL, 1).any()


@pytest.mark.card
def test_kernel_10_gives_nan_from_the_failing_panel_on():
    """A pivot that fails in panel 3 of matrix 1: its L NaN on and below
    the diagonal from column 384 on, its iL NaN on and below the diagonal
    from row 384 on, zeros above the diagonal, the rest finite."""
    _card()
    K = _spd(4, 1024)
    K[1, 400, 400] = -1.0
    L, iL = linalg.blocked_cholesky_inverse(K)
    first = 400 // TILE * TILE
    rows, cols = torch.tril_indices(1024, 1024, device="cuda")
    right, below = cols >= first, rows >= first
    assert torch.isfinite(L[[0, 2, 3]]).all()
    assert torch.isfinite(iL[[0, 2, 3]]).all()
    assert torch.isnan(L[1][rows[right], cols[right]]).all()
    assert torch.isfinite(L[1][rows[~right], cols[~right]]).all()
    assert torch.isnan(iL[1][rows[below], cols[below]]).all()
    assert torch.isfinite(iL[1][rows[~below], cols[~below]]).all()
    assert not torch.triu(L[1], 1).any()
    assert not torch.triu(iL[1, :first], 1).any()
