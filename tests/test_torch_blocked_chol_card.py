"""The blocked factorization on the card (marked ``card``; skips without
one): a stack of matrices factored in one call of
``linalg.blocked_cholesky_inverse`` against its parts factored in calls of
their own, as the exact natural-gradient retraction stacks its two
attempts' A.  Kernel 9 factors a matrix a block and kernels A and 4 tile a
matrix at a time, so each part should come back bitwise; cuBLAS may pick
another algorithm for the float64 updates and the inverse's strips of the
larger batch, which moves an element by at most one ulp of its dtype.

No JAX here: on the card, ``python3 -m pytest
tests/test_torch_blocked_chol_card.py -m card --noconftest``."""

from __future__ import annotations

import pytest
import torch

from hetmogp_tpu_torch.ops import linalg


def _ulps(a, b):
    """Elementwise distance of two tensors of one float dtype in ulps."""
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    sign = torch.iinfo(bits).min

    def key(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, sign - i, i)
    return (key(a) - key(b)).abs()


@pytest.mark.card
@pytest.mark.parametrize("m, nb", [(1024, None), (256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_a_stack_on_the_card_is_each_part_alone(m, nb, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    g = torch.Generator(device="cuda").manual_seed(m)
    X = torch.randn(8, m, m + 4, generator=g, device="cuda",
                    dtype=torch.float64)
    K = (X @ X.mT / m + torch.eye(m, device="cuda",
                                  dtype=torch.float64)).to(dtype)
    L, iL = linalg.blocked_cholesky_inverse(K, nb)
    for part in (slice(0, 4), slice(4, 8)):
        L_p, iL_p = linalg.blocked_cholesky_inverse(K[part], nb)
        for got, want in ((L[part], L_p), (iL[part], iL_p)):
            assert bool(torch.isfinite(want).all())
            assert int(_ulps(got, want).max()) <= 1
