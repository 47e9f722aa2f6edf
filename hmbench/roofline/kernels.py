"""Operations and bytes of the program's hand kernels at one launch's
shapes, each as (least ms, device symbol).

Frozen copies of the bound arithmetic the repository's smoke run holds its
kernel table to (``proj_bound``, ``right_bound``, ``out_bound`` and kernel
9's lower-triangle count): inputs read once, outputs written once; a
triangular product of (q, n, m) against an (m, m) triangle does
q n m (m + 1) operations a pass, and a three-pass bf16 product three.
Kernels whose work depends on small tables (the likelihood term's rows,
adam's leaves) are bounded by their bytes alone, which never overstates a
share.
"""

from __future__ import annotations

from hmbench.roofline.peaks import BF16_PEAK, F32_PEAK, least_ms

F4 = 4  # bytes of a float32


def rbf(q, n, m, dx):
    """The RBF cross-covariance (q, n, m): bytes-bound."""
    return least_ms(F4 * (q * n * m + n * dx + q * m * dx + 2 * q), 0.0,
                    F32_PEAK), "rbf_cross_vec_kernel"


def proj(q, n, m, passes=1):
    """A tril(L)^T, A (q, n, m), L (q, m, m): kernel A (1 pass, float32) or
    kernel 3 (3 bf16 passes)."""
    ms = least_ms(F4 * (2 * q * n * m + q * m * m), passes * q * n * m * (m + 1),
                  BF16_PEAK if passes == 3 else F32_PEAK)
    return ms, "tril_proj3_tma_kernel" if passes == 3 else "tril_proj_tma_kernel"


def split(q, m):
    """Kernel 3's pre-pass: the lower triangle of (q, m, m) read in float32
    and written as two bf16 halves."""
    return least_ms((F4 + 4) * q * m * (m + 1) // 2, 0.0, F32_PEAK), \
        "tril_split_bf16_kernel"


def right(q, n, m, epilogue="product", passes=1, k=None):
    """A tril(L), A (q, n, k), L (q, k, k) with k = m unless given: kernel 4
    (float32, with quad_diag's row sums in the "both" and "rowsum"
    epilogues) or kernel 5 (3 bf16 passes)."""
    k = m if k is None else k
    out = {"product": q * n * k, "rowsum": q * n, "both": q * n * k + q * n}[epilogue]
    ms = least_ms(F4 * (q * n * k + q * k * k + out), passes * q * n * k * (k + 1),
                  BF16_PEAK if passes == 3 else F32_PEAK)
    return ms, "tril_right3_tma_kernel" if passes == 3 else "tril_right_tma_kernel"


def out(q, n, m, passes=1):
    """tril(A^T B), A and B (q, n, m), the (q, m, m) output: kernel 8."""
    ms = least_ms(F4 * (2 * q * n * m + q * m * m), passes * q * n * m * (m + 1),
                  BF16_PEAK if passes == 3 else F32_PEAK)
    return ms, "tril_out3_tma_kernel" if passes == 3 else "tril_out_tma_kernel"


def chol_panel(q, nb):
    """Kernel 9 on (q, nb, nb): the lower triangle read, L and its inverse
    written whole; nb^3 / 3 operations each for the factor and the
    inverse."""
    return least_ms(F4 * q * (nb * (nb + 1) // 2 + 2 * nb * nb),
                    2 * q * nb ** 3 / 3, F32_PEAK), "chol_panel_kernel"


def task_forward(rows, deriv=True):
    """Kernel 6's task table, forward: each task's rows read (y, m, v,
    mask), their values and, with ``deriv``, their gradient coefficients
    written.  ``rows``: (N_t, dim_y, J) per task."""
    nbytes = sum(n * (dy + 2 * j + 1 + 1 + (2 * j if deriv else 0)) for n, dy, j in rows)
    return least_ms(F4 * nbytes, 0.0, F32_PEAK), "ve_tasks_kernel"


def task_backward(rows):
    """Kernel 6's task table, backward: the coefficients read and (dM, dV)
    written."""
    nbytes = sum(n * 4 * j for n, dy, j in rows)
    return least_ms(F4 * nbytes, 0.0, F32_PEAK), "ve_tasks_grad_kernel"


def gh_sweep(n, dim_y=1, j=1, deriv=True):
    """Kernel 6 per engine on n rows of j output functions: (y, m, v) read,
    the value and, with ``deriv``, the two expectations written."""
    nbytes = n * (dim_y + 2 * j + 1 + (2 * j if deriv else 0))
    return least_ms(F4 * nbytes, 0.0, F32_PEAK), "gh_sweep_kernel"


def adam(free: int, frozen: int):
    """Kernel 7: a free element reads (p, g, mu, nu) and writes (p, mu, nu);
    a frozen one decays (mu, nu)."""
    return least_ms(F4 * (7 * free + 4 * frozen), 0.0, F32_PEAK), "adam_kernel"


def flops_least(ops: float, precision: str) -> float:
    """Least ms of ``ops`` products at the stated precision: "high" is
    three bf16 passes, "highest" float32."""
    if precision == "high":
        return 3 * ops / BF16_PEAK * 1e3
    return ops / F32_PEAK * 1e3
