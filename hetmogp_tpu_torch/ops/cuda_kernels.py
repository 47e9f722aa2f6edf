"""Hand-written CUDA kernels, their plain PyTorch versions and gradients.

Counterpart of ``hetmogp_tpu/ops/pallas_kernels.py``, of the two Pallas
projections of ``tools/probe_pallas_proj.py`` and of the JAX package's
hand-blocked triangular products (``hetmogp_tpu/ops/linalg.py``:
``matmul_tril``, ``quad_diag``, ``t_matmul_tril_out`` and the cached
adjoints at ``Precision.HIGH``).  The kernels are ``csrc/rbf_kernel.cu`` (the RBF
cross-covariance, in two designs chosen by shape, ``rbf_route``: float4
stores from blocks that walk rows, and the scalar one of the first port),
``csrc/tril_proj_kernel.cu`` (kernel A: the triangular projection
A tril(L)^T in float32), ``csrc/tril_proj3_kernel.cu`` (kernel 3: the same
projection as three bf16 tensor-core passes), ``csrc/tril_right3_kernel.cu``
(kernel 5: the mirror A tril(L) in
three passes, L split in shared memory, no pre-pass; its schedule, in
``csrc/tril_right3_plan.cuh``, is walked on the CPU by
``tests/test_torch_tril_right3_plan.py``), ``csrc/tril_right_kernel.cu`` (kernel 4:
A tril(L) in float32, with quad_diag's square and row sum fused; its
TMA-fed design gives each warp 32 columns of a tile, so a warp skips the
diagonal stages below them and masks one; its index arithmetic, in
``csrc/tril_right_plan.cuh``, is walked on the CPU by
``tests/test_torch_tril_right_plan.py``, and ``chip_smoke.py``'s
``right_products_phase`` holds its product bitwise to cuBLAS's on the
card), ``csrc/tril_out_kernel.cu`` (kernel 8: tril(A^T B), the lower
tiles alone, in float32 FFMA and in three bf16 wgmma passes, A split in
registers and B in shared memory; its schedule, in
``csrc/tril_out_plan.cuh``, is
walked on the CPU by ``tests/test_torch_tril_out_plan.py``), each
triangular product in one TMA-fed design (sharing ``csrc/tril_tma.cuh``
and the schedule of ``csrc/tril_tiles.cuh``), which ``_tma_operands``
brings every shape to; and,
for the XLA fusions of the JAX package's trainer,
``csrc/ve_tasks_kernel.cu`` (kernel 6: the ELBO's likelihood term of every
task in the task table, each row's variational expectation and
gradient coefficients and each task's masked, scaled sum in one launch,
every task's (dM, dV) in one more; ``task_var_exp``,
``task_var_exp_value``, ``task_var_exp_backward``), beside it
``csrc/gh_sweep_kernel.cu`` (kernel 6 per engine, for the families
outside the table: the one-pass Gauss-Hermite sweep, value, E[d1] and
E[d2] of every row in one launch; ``gh_sweep``, ``gh_sweep_value``), both
over the device functions of ``csrc/gh_sweep.cuh``, and
``csrc/adam_kernel.cu`` (kernel 7: the masked adam update of every leaf
in one launch; ``adam_update``), all in float32 and float64, launched by
``ops/quadrature.py`` and ``train.py`` directly (no operator: no exported
program trains); and ``csrc/chol_panel_kernel.cu`` (kernel 9: the
Cholesky factor of a (n, n) diagonal panel, n <= 128, and its inverse, in
float32 and float64; ``chol_panel``) and ``csrc/chol_blocked_kernel.cu``
(kernel 10: the blocked factor and inverse of a float32 stack wider than
128 in one persistent launch, kernel 9's panel routine on its diagonal
tiles; ``chol_blocked``; its schedule, in ``csrc/chol_blocked_plan.cuh``,
is walked on the CPU by ``tests/test_torch_chol_blocked_plan.py``),
launched by ``ops/linalg.py``'s blocked factorization (no operator: no
exported program factorizes through them); and
``csrc/span_stamp_kernel.cu``, not the port's work but its
spans' (``profiling.py``): the stamp of the device's clock
(``stamper``), the marks and census of a graph under capture
(``GraphMarks``), its stamped clone (``StampedGraph``) and the clocks'
offset (``clock_samples``), which no launch counter counts.
``ops/_build.py`` builds them when a CUDA tensor first reaches one, and
they are bound with ``ctypes``.  Importing this module builds and loads
nothing.

For each kernel:

* the raw launcher (``rbf_K_batched_vec``, ``rbf_K_batched_scalar``,
  ``tril_projection_tma``, ``tril_projection_3pass_tma``,
  ``tril_right_tma``, ``tril_right3_tma``, ``tril_out_tma``,
  ``tril_out3_tma``) runs it on float32 CUDA tensors, counts its launches
  in ``<launcher>.launches``, and refuses inputs that require grad: it
  records no graph; ``rbf_K_batched`` routes to the RBF launcher of the
  shape, and ``tril_projection``, ``tril_projection_3pass``,
  ``tril_right``, ``tril_right3``, ``tril_out`` and ``tril_out3`` hand
  their launcher the operands of ``_tma_operands`` and crop its result;
* the plain version (``*_plain``) is what CPU tensors take and what the
  kernel is checked against on the card;
* a custom operator (``hetmogp::rbf_K_batched``,
  ``hetmogp::tril_projection``, ``hetmogp::tril_projection_3pass``,
  ``hetmogp::matmul_tril``, ``hetmogp::matmul_tril_3pass``,
  ``hetmogp::quad_diag``, ``hetmogp::quad_diag_product``,
  ``hetmogp::t_matmul_tril_out``, ``hetmogp::t_matmul_tril_out_3pass``)
  whose CUDA implementation is the router and whose CPU implementation is
  the plain version, so that ``torch.export`` keeps the kernels in an
  exported graph;
* an ``autograd.Function`` (``RBFCrossCovariance``, ``TrilProjection``,
  ``TrilProjection3Pass``, ``MatmulTril``, ``MatmulTril3Pass``,
  ``QuadDiag``) runs the operator forward and a backward of plain PyTorch
  and the other triangular kernels (the projection's dA is kernel 4, the
  right product's and quad_diag's dA kernel A, every dL kernel 8 at the
  forward's precision).  The JAX package
  differentiates its Pallas RBF with XLA einsums (``_rbf_bwd``), so
  ``rbf_K_batched_bwd`` is that algebra on tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from hetmogp_tpu_torch.ops import _build, kernels, quadrature

# The scalar RBF kernel stages (128 + 32) * Dx floats of shared memory per
# block and stays under the 48 KiB that needs no opt-in; the vector kernel
# keeps a thread's four Z points in registers, for Dx up to 4
# (csrc/rbf_kernel.cu).
MAX_DX = 64
VEC_MAX_DX = 4


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build()))
    proj = [ctypes.c_void_p] * 3  # A, L, out
    shape = [ctypes.c_int] * 3  # Q, N, M
    # A and L, each with its row and plane strides
    strided = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
    # X, Z, lengthscale, variance, out; Q, N, M, Dx, lengthscale columns
    rbf = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    sweep = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    adam = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_double])
    # the task table: pointers, integers, tasks; deriv, partials, count
    tasks = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
             + [ctypes.c_longlong])
    panel = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 3 + [
        ctypes.c_int] * 2
    # K, its batch and row strides; L, iL, L's float64 copy, the float64
    # updates, the counters; batch, tiles a side
    blocked = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
               + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2)
    signatures = {
        "hetmogp_rbf_cross_vec_f32": rbf,
        "hetmogp_rbf_cross_f32": rbf,
        "hetmogp_empty_launch": [],
        # A, its row and plane strides, L, its strides, out; Q, N, M
        "hetmogp_tril_proj_strided_f32": strided + [ctypes.c_void_p] + shape,
        "hetmogp_tril_proj3_f32": proj + [ctypes.c_void_p] * 2 + shape,
        # A, L, each with its strides; out, partials, r; epilogue; Q, N, M
        "hetmogp_tril_right_strided_f32": strided + [ctypes.c_void_p] * 3
        + [ctypes.c_int] + shape,
        # A, L, out, partials; Q, N, M
        "hetmogp_tril_right3_f32": proj + [ctypes.c_void_p] + shape,
        # A, B, out, partials; Q, N, M
        "hetmogp_tril_out_f32": proj + [ctypes.c_void_p] + shape,
        "hetmogp_tril_out3_f32": proj + [ctypes.c_void_p] + shape,
        # family, J; m, v, y; their row strides; nodes, w; S, N; value,
        # Ed1, Ed2
        "hetmogp_gh_sweep_f32": sweep,
        "hetmogp_gh_sweep_f64": sweep,
        # the leaf table (7 pointers a leaf), sizes, leaves; count,
        # count_out, lr_ptr; lr_value
        "hetmogp_adam_f32": adam,
        "hetmogp_adam_f64": adam,
        "hetmogp_ve_tasks_f32": tasks,
        "hetmogp_ve_tasks_f64": tasks,
        # the backward's pointers, integers, tasks
        "hetmogp_ve_tasks_grad_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int],
        "hetmogp_ve_tasks_grad_f64": [ctypes.c_void_p] * 2 + [ctypes.c_int],
        # A, L and iL, each with its batch and row strides; batch, n
        "hetmogp_chol_panel_f32": panel,
        "hetmogp_chol_panel_f64": panel,
        "hetmogp_chol_blocked_f32": blocked,
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [ctypes.c_void_p]  # and the stream
        fn.restype = ctypes.c_int
    lib.hetmogp_adam_max_leaves.argtypes = []
    lib.hetmogp_adam_max_leaves.restype = ctypes.c_int
    lib.hetmogp_ve_tasks_max.argtypes = []
    lib.hetmogp_ve_tasks_max.restype = ctypes.c_int
    lib.hetmogp_ve_tasks_blocks.argtypes = ([ctypes.c_void_p] * 2
                                            + [ctypes.c_int] * 2)
    lib.hetmogp_ve_tasks_blocks.restype = ctypes.c_longlong
    lib.hetmogp_tril_right_partials.argtypes = [ctypes.c_int]
    lib.hetmogp_tril_right_partials.restype = ctypes.c_int
    lib.hetmogp_tril_right3_partials.argtypes = [ctypes.c_int] * 3
    lib.hetmogp_tril_right3_partials.restype = ctypes.c_longlong
    lib.hetmogp_tril_out_partials.argtypes = [ctypes.c_int] * 4
    lib.hetmogp_tril_out_partials.restype = ctypes.c_longlong
    lib.hetmogp_tril_out_schedule.argtypes = ([ctypes.c_int] * 5
                                              + [ctypes.c_void_p])
    lib.hetmogp_tril_out_schedule.restype = ctypes.c_int
    lib.hetmogp_chol_panel_smem.argtypes = [ctypes.c_int] * 2
    lib.hetmogp_chol_panel_smem.restype = ctypes.c_int
    lib.hetmogp_chol_blocked_flags.argtypes = [ctypes.c_int] * 2
    lib.hetmogp_chol_blocked_flags.restype = ctypes.c_int
    lib.hetmogp_chol_blocked_grid.argtypes = []
    lib.hetmogp_chol_blocked_grid.restype = ctypes.c_int
    # ring, slot, the ring's slots, stream
    lib.hetmogp_span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_void_p]
    lib.hetmogp_span_stamp.restype = ctypes.c_int
    lib.hetmogp_marks_new.argtypes = []
    lib.hetmogp_marks_new.restype = ctypes.c_void_p
    lib.hetmogp_marks_free.argtypes = [ctypes.c_void_p]
    lib.hetmogp_marks_free.restype = None
    # marks, stream, counts
    lib.hetmogp_graph_mark.argtypes = [ctypes.c_void_p] * 3
    lib.hetmogp_graph_mark.restype = ctypes.c_int
    # marks, graph, ring, pos, stride, slots, clone out, executable out
    lib.hetmogp_graph_stamped.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 2
    lib.hetmogp_graph_stamped.restype = ctypes.c_int
    lib.hetmogp_graph_launch.argtypes = [ctypes.c_void_p] * 2
    lib.hetmogp_graph_launch.restype = ctypes.c_int
    lib.hetmogp_graph_free.argtypes = [ctypes.c_void_p] * 2
    lib.hetmogp_graph_free.restype = None
    # n, host before, device, host after, stream
    lib.hetmogp_clock_samples.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 4
    lib.hetmogp_clock_samples.restype = ctypes.c_int
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library now, not at first use."""
    _library()


def loaded() -> bool:
    """Whether the kernel library is loaded (nothing is built or loaded)."""
    return _library.cache_info().currsize > 0


def _check_launch_inputs(name: str, tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the raw CUDA {name} launcher records no backward; "
            "differentiate through its autograd.Function (what the ops "
            "dispatch to), or call it under torch.no_grad()")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 only, got "
                        f"{[t.dtype for t in tensors]}")
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---- RBF cross-covariance --------------------------------------------------

def rbf_K_batched_plain(X: torch.Tensor, Z: torch.Tensor,
                        lengthscale: torch.Tensor,
                        variance: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (N, Dx), (Q, M, Dx) -> (Q, N, M)."""
    return kernels.rbf(X, Z, lengthscale, variance)


# Two kernels, chosen by shape alone (``rbf_route``): the vector kernel
# (float4 stores, Z in registers, blocks that walk rows) where the output's
# rows are whole float4s, the scalar kernel of the first port everywhere
# else.  Neither wrapper launches anything but its kernel: 1 / lengthscale
# is computed on the card, inside it.  Each counts its own launches; a
# failed launch raises, and nothing falls back from one route to the other.

def rbf_route(M: int, Dx: int) -> str:
    """The kernel an RBF cross-covariance with ``M`` columns and ``Dx``
    input dimensions takes on the card: ``"vec"`` when M % 4 == 0 and
    Dx <= 4, else ``"scalar"``.  The output is always a fresh allocation,
    which starts on a 16-byte boundary, so with M % 4 == 0 every row of it
    is whole float4s."""
    return "vec" if M % 4 == 0 and 0 < Dx <= VEC_MAX_DX else "scalar"


def _rbf_launch(wrapper, entry: str, X, Z, lengthscale, variance,
                route=None) -> torch.Tensor:
    """Check the inputs of the RBF launcher ``wrapper``, launch ``entry`` on
    the current stream and count the launch.  ``route`` is the route the
    kernel requires, None for any."""
    name = wrapper.__name__
    _check_launch_inputs(name, (X, Z, lengthscale, variance))
    if X.ndim != 2 or Z.ndim != 3 or Z.shape[-1] != X.shape[-1]:
        raise ValueError(f"X must be (N, Dx) and Z (Q, M, Dx); got "
                         f"{tuple(X.shape)} and {tuple(Z.shape)}")
    (N, Dx), (Q, M, _) = X.shape, Z.shape
    if variance.shape != (Q,) or lengthscale.shape not in ((Q, Dx), (Q, 1)):
        raise ValueError(
            f"lengthscale must be ({Q}, {Dx}) or ({Q}, 1) and variance "
            f"({Q},); got {tuple(lengthscale.shape)} and "
            f"{tuple(variance.shape)}")
    if not 0 < Dx <= MAX_DX or Q > 65535 or max(N, M) >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: Q={Q}, N={N}, "
                         f"M={M}, Dx={Dx} (Dx <= {MAX_DX}, Q <= 65535)")
    out = torch.empty((Q, N, M), dtype=torch.float32, device=X.device)
    if out.numel() == 0:
        return out
    if route is not None and rbf_route(M, Dx) != route:
        raise ValueError(
            f"{name} takes M % 4 == 0 and Dx <= {VEC_MAX_DX} (got M={M}, "
            f"Dx={Dx}); rbf_route sends other shapes to the scalar kernel")
    # no-ops on contiguous tensors: nothing is launched ahead of the kernel
    X, Z = X.contiguous(), Z.contiguous()
    lengthscale, variance = lengthscale.contiguous(), variance.contiguous()
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = getattr(lib, entry)(
            X.data_ptr(), Z.data_ptr(), lengthscale.data_ptr(),
            variance.data_ptr(), out.data_ptr(), Q, N, M, Dx,
            lengthscale.shape[1], stream)
    _raise_on(err, name)
    wrapper.launches += 1
    return out


def rbf_K_batched_vec(X: torch.Tensor, Z: torch.Tensor,
                      lengthscale: torch.Tensor,
                      variance: torch.Tensor) -> torch.Tensor:
    """The RBF vector kernel (``hetmogp_rbf_cross_vec_f32``): float4 stores,
    for M % 4 == 0 and Dx <= 4.  Counts its launches in
    ``rbf_K_batched_vec.launches``."""
    return _rbf_launch(rbf_K_batched_vec, "hetmogp_rbf_cross_vec_f32", X, Z,
                       lengthscale, variance, route="vec")


rbf_K_batched_vec.launches = 0


def rbf_K_batched_scalar(X: torch.Tensor, Z: torch.Tensor,
                         lengthscale: torch.Tensor,
                         variance: torch.Tensor) -> torch.Tensor:
    """The RBF scalar kernel of the first port (``hetmogp_rbf_cross_f32``),
    for any shape.  Counts its launches in
    ``rbf_K_batched_scalar.launches``."""
    return _rbf_launch(rbf_K_batched_scalar, "hetmogp_rbf_cross_f32", X, Z,
                       lengthscale, variance)


rbf_K_batched_scalar.launches = 0


def rbf_K_batched(X: torch.Tensor, Z: torch.Tensor, lengthscale: torch.Tensor,
                  variance: torch.Tensor) -> torch.Tensor:
    """Batched RBF cross-covariance on the card: (Q, N, M) float32.

    X: (N, Dx), Z: (Q, M, Dx), lengthscale: (Q, Dx) or isotropic (Q, 1),
    variance: (Q,); all float32 on one CUDA device.  Routed by ``rbf_route``
    to ``rbf_K_batched_vec`` or ``rbf_K_batched_scalar``; launches on the
    current stream and does not synchronise.  The CUDA implementation of
    the operator ``hetmogp::rbf_K_batched``.
    """
    route = rbf_route(Z.shape[-2], X.shape[-1]) if Z.ndim == 3 else None
    launcher = rbf_K_batched_vec if route == "vec" else rbf_K_batched_scalar
    return launcher(X, Z, lengthscale, variance)


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream: the floor
    under any kernel's device time (``chip_smoke.py`` times it beside the
    small shapes)."""
    _raise_on(_library().hetmogp_empty_launch(
        torch.cuda.current_stream().cuda_stream), "empty_launch")


# ---- span stamps (csrc/span_stamp_kernel.cu) ---------------------------------
#
# Not a launcher of the port's work: profiling.py's spans launch the stamp,
# and no launch counter counts it.

#: the classes of a graph's census, in the order of its counts
NODE_CLASSES = ("hand", "stamps", "library", "memory", "other")


def stamper(ring: torch.Tensor):
    """The stamps of one ring (int64 on the card, contiguous), checked
    once: returns ``stamp(slot)``, which writes the device's
    ``%globaltimer`` (ns) into slot ``slot`` of ``ring`` on the current
    stream of its device."""
    if ring.dtype != torch.int64 or not ring.is_cuda \
            or not ring.is_contiguous():
        raise ValueError("span_stamp writes a contiguous int64 CUDA ring")
    fn, ptr, n = _library().hetmogp_span_stamp, ring.data_ptr(), ring.numel()
    index, raw_stream = ring.device.index, torch._C._cuda_getCurrentRawStream

    def stamp(slot: int) -> None:
        _raise_on(fn(ptr, slot, n, raw_stream(index)), "span_stamp")

    stamp.ring = ring  # the pointer stays valid while the stamper lives
    return stamp


class GraphMarks:
    """The span boundaries of one graph while it is captured: each ``mark``
    notes where a stamp goes and returns the graph's census so far
    ({class: nodes}, ``NODE_CLASSES``: the port's hand kernels, stamps,
    library kernels, memset and memcpy nodes, other nodes)."""

    def __init__(self):
        self.lib = _library()
        self.handle = self.lib.hetmogp_marks_new()
        self.count = 0

    def mark(self, stream: torch.cuda.Stream) -> dict:
        counts = (ctypes.c_longlong * len(NODE_CLASSES))()
        _raise_on(self.lib.hetmogp_graph_mark(self.handle, stream.cuda_stream,
                                              counts), "graph_mark")
        self.count += 1
        return dict(zip(NODE_CLASSES, counts))

    def __del__(self):
        self.lib.hetmogp_marks_free(self.handle)


class StampedGraph:
    """A clone of a captured ``graph`` (``keep_graph=True``) with a stamp
    node at each of the first ``stride`` marks (mark b writes slot b of row
    ``pos[0]`` of ``ring``), instantiated on its own: ``launch()`` runs it
    on the current stream in the graph's place."""

    def __init__(self, marks: GraphMarks, graph: "torch.cuda.CUDAGraph",
                 ring: torch.Tensor, pos: torch.Tensor, stride: int):
        self.lib = _library()
        self.clone = self.exec = None  # what __del__ frees if this raises
        clone, execu = ctypes.c_void_p(), ctypes.c_void_p()
        _raise_on(self.lib.hetmogp_graph_stamped(
            marks.handle, graph.raw_cuda_graph(), ring.data_ptr(),
            pos.data_ptr(), stride, ring.numel(), ctypes.byref(clone),
            ctypes.byref(execu)), "graph_stamped")
        self.clone, self.exec, self.device = clone, execu, ring.device
        self.keep = (ring, pos)  # the clone's stamps write and read them

    def launch(self) -> None:
        _raise_on(self.lib.hetmogp_graph_launch(
            self.exec, torch.cuda.current_stream(self.device).cuda_stream),
            "graph_launch")

    def __del__(self):
        self.lib.hetmogp_graph_free(self.clone, self.exec)


def clock_samples(n: int, device) -> list:
    """(host before, device, host after) of n samples of the clocks: the
    device's ``%globaltimer`` stamped between the host's two readings of
    ``time.perf_counter_ns``'s clock, a PCIe round trip apart.  Synchronizes
    the device first."""
    torch.cuda.synchronize(device)
    rows = [(ctypes.c_longlong * n)() for _ in range(3)]
    _raise_on(_library().hetmogp_clock_samples(
        n, *rows, torch.cuda.current_stream(device).cuda_stream),
        "clock_samples")
    return [r for r in zip(*rows) if r[1] >= 0]


def rbf_K_batched_bwd(X, Z, lengthscale, variance, K, g):
    """Cotangents (dX, dZ, dlengthscale, dvariance) of K = rbf(X, Z, ls, var)
    for the cotangent g of K: the algebra of ``pallas_kernels._rbf_bwd``.

    With S = g * K and il2 = 1 / ls^2 (broadcast to (Q, Dx)):
      dvar[q]      = sum_nm S / var
      dX[n, d]     = -sum_q il2_qd (x_nd rowsum(S)_qn - (S_q Z_q)_nd)
      dZ[q, m, d]  = il2_qd ((S_q^T X)_md - colsum(S)_qm z_qmd)
      dls[q, d]    = ls^-3 sum_nm S (x - z)^2
    An isotropic (Q, 1) lengthscale gets the sum over d.
    """
    Q, Dx = Z.shape[0], X.shape[-1]
    S = g * K
    ls_full = lengthscale.expand(Q, Dx)
    il2 = 1.0 / torch.square(ls_full)
    dvar = torch.sum(S, dim=(1, 2)) / variance
    rowsum = torch.sum(S, dim=2)  # (Q, N)
    colsum = torch.sum(S, dim=1)  # (Q, M)
    SZ = S @ Z  # (Q, N, Dx)
    SX = S.mT @ X  # (Q, M, Dx)
    dX = -torch.einsum("qnd,qd->nd", rowsum[..., None] * X - SZ, il2)
    dZ = (SX - colsum[..., None] * Z) * il2[:, None, :]
    E = (rowsum @ torch.square(X)
         + torch.einsum("qm,qmd->qd", colsum, torch.square(Z))
         - 2.0 * torch.einsum("qnd,nd->qd", SZ, X))  # sum_nm S (x - z)^2
    dls = E / ls_full ** 3
    if lengthscale.shape != dls.shape:
        dls = torch.sum(dls, dim=-1, keepdim=True)
    return dX, dZ, dls, dvar


class RBFCrossCovariance(torch.autograd.Function):
    """The RBF cross-covariance with a gradient: the operator
    ``hetmogp::rbf_K_batched`` forward (the kernel for a CUDA tensor, the
    plain version for a CPU one), ``rbf_K_batched_bwd`` backward.
    ``backwards`` counts the backward passes on the card (those of CUDA
    tensors, whose forward launched the kernel)."""

    backwards = 0

    @staticmethod
    def forward(ctx, X, Z, lengthscale, variance):
        K = torch.ops.hetmogp.rbf_K_batched(
            X.detach(), Z.detach(), lengthscale.detach(), variance.detach())
        ctx.save_for_backward(X, Z, lengthscale, variance, K)
        return K

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            RBFCrossCovariance.backwards += 1
        return rbf_K_batched_bwd(*ctx.saved_tensors, g)


# ---- triangular projection -------------------------------------------------
#
# Each triangular product has one hand design per precision, fed by TMA,
# which addresses rows of a multiple of 16 bytes from 16-byte-aligned bases.
# Its router hands the launcher the operands of ``_tma_operands`` and crops
# the result back to M; each launcher counts its own launches and refuses
# operands TMA cannot address, and a failed launch raises.  The float32
# designs of kernels A and 4 read A and L where they lie, through their row
# and plane strides (the blocked factorization's panels and strips are
# views of its (M, M) buffers); the others read contiguous operands.

def _tma_strides(t: torch.Tensor):
    """(row, plane) strides, in elements, through which TMA reads the
    (Q, R, C) float32 ``t`` where it lies, or None where it cannot: the
    last stride 1, the base 16-byte aligned, rows and planes apart by
    multiples of 4 floats (16 bytes) and not overlapping.  A size-1
    dimension's stride is taken as the packed one."""
    Q, R, C = t.shape
    row = t.stride(1) if R > 1 else C
    plane = t.stride(0) if Q > 1 else row * R
    if (t.stride(2) != 1 or t.data_ptr() % 16 or row % 4 or plane % 4
            or row < C or plane < row * R):
        return None
    return row, plane


def _tma_ready(t: torch.Tensor, views: bool) -> bool:
    """Whether a TMA entry takes ``t`` as it is: a view TMA can address
    (``_tma_strides``) for an entry that takes strides (``views``), else a
    contiguous tensor on a 16-byte boundary."""
    if views:
        return _tma_strides(t) is not None
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _tma_operands(A: torch.Tensor, X: torch.Tensor, square: bool,
                  views: bool = False):
    """(A, X) as a TMA entry takes them, for A (..., N, M) and X either L
    (..., M, M; ``square``) or kernel 8's B (..., N, M).  With M % 4 == 0
    each passes as it is where ``_tma_ready``, else as a contiguous copy
    (a fresh allocation, 16-byte aligned).  Otherwise both are padded with
    zeros to M' = 4 ceil(M / 4): zero columns of A and B, zero rows and
    columns of L.  A zero operand adds +0 to every FMA chain, so the first
    M columns of the padded product are the design's own arithmetic on the
    unpadded operands; the router crops the rest (``_crop``)."""
    pad = -A.shape[-1] % 4
    if pad:
        return (torch.nn.functional.pad(A, (0, pad)),
                torch.nn.functional.pad(X, (0, pad, 0, pad if square else 0)))
    return tuple(t if _tma_ready(t, views)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (A, X))


def _crop(out: torch.Tensor, M: int, square: bool = False) -> torch.Tensor:
    """A padded product's first M columns (and rows, ``square``), as a
    contiguous tensor; ``out`` itself where nothing was padded."""
    if out.shape[-1] == M:
        return out
    return (out[..., :M, :M] if square else out[..., :M]).contiguous()


def tril_projection_plain(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: A tril(L)^T, (..., N, M), (..., M, M)."""
    return A @ torch.tril(L).mT


def _check_tril_shapes(name: str, A: torch.Tensor, L: torch.Tensor) -> None:
    _check_launch_inputs(name, (A, L))
    if A.ndim != 3 or L.ndim != 3 or L.shape != (A.shape[0], A.shape[2],
                                                  A.shape[2]):
        raise ValueError(f"A must be (Q, N, M) and L (Q, M, M); got "
                         f"{tuple(A.shape)} and {tuple(L.shape)}")
    Q, N, M = A.shape
    if Q > 65535 or N >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: Q={Q}, N={N}, "
                         f"M={M} (Q <= 65535)")


def _require_tma_operands(wrapper, tensors, views: bool = False) -> None:
    """Refuse operands a TMA entry cannot take as they are: M % 4 != 0, or
    one that is not ``_tma_ready``.  The routers bring every shape there
    (``_tma_operands``)."""
    M = tensors[0].shape[-1]
    if M % 4 or not all(_tma_ready(t, views) for t in tensors):
        raise ValueError(
            f"{wrapper.__name__} takes M % 4 == 0 and operands TMA can "
            f"address as they are (got M={M}, strides "
            f"{[t.stride() for t in tensors]}); its router pads or copies "
            "them there")


def _product_output(wrapper, A: torch.Tensor, L: torch.Tensor,
                     views: bool = False) -> torch.Tensor:
    """Check (A, L) for the projection launcher ``wrapper`` and return its
    (Q, N, M) output; an empty one needs no launch and takes any M."""
    _check_tril_shapes(wrapper.__name__, A, L)
    out = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    if out.numel():
        _require_tma_operands(wrapper, (A, L), views)
    return out


def _pointers(A: torch.Tensor, L: torch.Tensor, strided: bool) -> tuple:
    """A's and L's arguments to an entry: their pointers, each followed by
    its row and plane strides for a strided entry."""
    if not strided:
        return A.data_ptr(), L.data_ptr()
    return (A.data_ptr(), *_tma_strides(A), L.data_ptr(), *_tma_strides(L))


def _launch(wrapper, entry: str, A, L, out, *extra,
            strided: bool = False) -> torch.Tensor:
    """Launch the projection kernel ``entry`` on the current stream and
    count the launch on ``wrapper``; a ``strided`` entry takes A's and L's
    row and plane strides after each pointer."""
    Q, N, M = A.shape
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, entry)(*_pointers(A, L, strided), out.data_ptr(),
                                  *extra, Q, N, M, stream)
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def tril_projection_tma(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Kernel A (``hetmogp_tril_proj_strided_f32``): A tril(L)^T in full
    float32 for M % 4 == 0, A and L each read where it lies through its
    row and plane strides (``_tma_strides``: a row-strided view of a wider
    array passes).  Counts its launches in
    ``tril_projection_tma.launches``."""
    out = _product_output(tril_projection_tma, A, L, views=True)
    if out.numel() == 0:
        return out
    return _launch(tril_projection_tma, "hetmogp_tril_proj_strided_f32", A,
                   L, out, strided=True)


tril_projection_tma.launches = 0


def tril_projection(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """out[q, n, k] = sum_{m <= k} A[q, n, m] L[q, k, m] on the card.

    A: (Q, N, M), L: (Q, M, M), float32 on one CUDA device; L's strictly
    upper entries are not read.  Full float32 (no TF32): one FMA chain per
    output in increasing m.  ``tril_projection_tma`` on the operands of
    ``_tma_operands``, cropped to M; launches on the current stream and
    does not synchronise.
    """
    operands = _tma_operands(A, L, square=True, views=True)
    return _crop(tril_projection_tma(*operands), A.shape[-1])


def _backward_tril(ctx, g, precision="highest"):
    """dA = g tril(L) (kernel 4's operator, ``hetmogp::matmul_tril``),
    dL = tril(g^T A) (kernel 8's operator of ``precision``): the
    projection's backward."""
    A, L = ctx.saved_tensors
    dA = torch.ops.hetmogp.matmul_tril(g, L) if ctx.needs_input_grad[0] \
        else None
    dL = _tril_out_op(g, A.detach(), precision) \
        if ctx.needs_input_grad[1] else None
    return dA, dL


class TrilProjection(torch.autograd.Function):
    """A tril(L)^T with a gradient: the operator ``hetmogp::tril_projection``
    forward (the routed kernel for a CUDA tensor, the plain version for a
    CPU one); the backward dA = g tril(L) by kernel 4's operator,
    dL = tril(g^T A) by kernel 8's."""

    @staticmethod
    def forward(ctx, A, L):
        ctx.save_for_backward(A, L)
        return torch.ops.hetmogp.tril_projection(A.detach(), L.detach())

    backward = staticmethod(_backward_tril)


# ---- triangular projection in three bf16 passes -----------------------------

def split_bf16(x: torch.Tensor):
    """The bit-mask split of float32 ``x`` into (hi, lo), float32 tensors
    holding bf16 values: hi = x with its low 16 bits cleared, lo =
    bf16_rn(x - hi).  x - hi is exact, and hi + lo equals x to ~2^-16."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def bf16_row(M: int) -> int:
    """Row length of the split L's bf16 scratch: M rounded up to 8, so that
    rows are 16-byte multiples (TMA's stride rule)."""
    return -(-M // 8) * 8


def tril_split_bf16_plain(L: torch.Tensor):
    """Plain version of kernel 3's pre-pass: (hi, lo) of ``split_bf16(
    tril(L))`` as bf16 (Q, M, bf16_row(M)) arrays, the pad columns zero."""
    M = L.shape[-1]
    pad = (0, bf16_row(M) - M)
    return tuple(torch.nn.functional.pad(h, pad).to(torch.bfloat16)
                 for h in split_bf16(torch.tril(L)))


def tril_projection_3pass_plain(A: torch.Tensor,
                                L: torch.Tensor) -> torch.Tensor:
    """Plain version of the 3-pass kernel: A tril(L)^T as three float32
    matmuls of bf16-exact operands, (alo lhi^T + ahi llo^T) + ahi lhi^T,
    with the kernel's bit-mask split.  Float32 only: every product of two
    bf16 values is exact in float32, so only the sums round."""
    if A.dtype != torch.float32 or L.dtype != torch.float32:
        raise TypeError(f"the 3-pass projection splits float32 only, got "
                        f"{A.dtype} and {L.dtype}")
    ahi, alo = split_bf16(A.detach())
    lhi, llo = split_bf16(torch.tril(L.detach()))
    return (alo @ lhi.mT + ahi @ llo.mT) + ahi @ lhi.mT


def _bf16_scratch(A: torch.Tensor):
    """Two (Q, M, bf16_row(M)) bf16 arrays for the split of an L that
    goes with ``A`` (from the graph's pool under capture)."""
    Q, _, M = A.shape
    return tuple(torch.empty((Q, M, bf16_row(M)), dtype=torch.bfloat16,
                             device=A.device) for _ in range(2))


def tril_projection_3pass_tma(A: torch.Tensor,
                              L: torch.Tensor) -> torch.Tensor:
    """Kernel 3's wgmma and TMA design (``hetmogp_tril_proj3_f32``) for
    M % 4 == 0 and contiguous, 16-byte-aligned operands.  Its pre-pass
    writes ``tril_split_bf16_plain(L)`` into two scratch arrays taken with
    ``torch.empty`` (from the graph's pool under capture).  Counts its
    launches in ``tril_projection_3pass_tma.launches``."""
    out = _product_output(tril_projection_3pass_tma, A, L)
    if out.numel() == 0:
        return out
    lhi, llo = _bf16_scratch(A)
    return _launch(tril_projection_3pass_tma, "hetmogp_tril_proj3_f32", A, L,
                   out, lhi.data_ptr(), llo.data_ptr())


tril_projection_3pass_tma.launches = 0


def tril_projection_3pass(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """out[q, n, k] = sum_{m <= k} A[q, n, m] L[q, k, m] on the card's
    tensor cores, as lo*hi + hi*lo + hi*hi bf16 products of the bit-mask
    split with float32 accumulation (``ve_fwd_precision="high"``).

    A: (Q, N, M), L: (Q, M, M), float32 on one CUDA device; L's strictly
    upper entries are not read.  ``tril_projection_3pass_tma`` on the
    operands of ``_tma_operands``, cropped to M; launches on the current
    stream and does not synchronise.
    """
    operands = _tma_operands(A, L, square=True)
    return _crop(tril_projection_3pass_tma(*operands), A.shape[-1])


class TrilProjection3Pass(torch.autograd.Function):
    """A tril(L)^T in three bf16 passes with a gradient: the operator
    ``hetmogp::tril_projection_3pass`` forward (the routed 3-pass kernel
    for a CUDA tensor, the plain version for a CPU one; the plain version
    without the operator where ``use_kernel`` is False), and
    ``TrilProjection``'s backward with dL in three passes."""

    @staticmethod
    def forward(ctx, A, L, use_kernel=True):
        ctx.save_for_backward(A, L)
        fwd = torch.ops.hetmogp.tril_projection_3pass if use_kernel else \
            tril_projection_3pass_plain
        return fwd(A.detach(), L.detach())

    @staticmethod
    def backward(ctx, g):
        return (*_backward_tril(ctx, g, "high"), None)


# ---- A tril(L): the right product, and quad_diag ---------------------------
#
# Kernel 4 (csrc/tril_right_kernel.cu) in float32, with three epilogues
# (the product; the product and quad_diag's row sum of squares; the row
# sum alone), and kernel 5 (csrc/tril_right3_kernel.cu) in three bf16
# passes, each reached through ``_tma_operands`` as the projections are.

EPILOGUES = {"product": 0, "both": 1, "rowsum": 2}


def matmul_tril_plain(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4's product: A tril(L), (..., N, M),
    (..., M, M)."""
    return A @ torch.tril(L)


def quad_diag_plain(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4's row sum: diag(A tril(L) tril(L)^T A^T),
    (..., N)."""
    return torch.sum(torch.square(A @ torch.tril(L)), dim=-1)


def quad_diag_product_plain(A: torch.Tensor, L: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4's "both" epilogue: (A tril(L), its row
    sums of squares)."""
    AL = A @ torch.tril(L)
    return AL, torch.sum(torch.square(AL), dim=-1)


def matmul_tril_3pass_plain(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 5: A tril(L) as three float32 matmuls of
    bf16-exact operands, (alo lhi + ahi llo) + ahi lhi, with the bit-mask
    split (``tril_projection_3pass_plain`` on the other side).  Float32
    only."""
    if A.dtype != torch.float32 or L.dtype != torch.float32:
        raise TypeError(f"the 3-pass product splits float32 only, got "
                        f"{A.dtype} and {L.dtype}")
    ahi, alo = split_bf16(A.detach())
    lhi, llo = split_bf16(torch.tril(L.detach()))
    return (alo @ lhi + ahi @ llo) + ahi @ lhi


def _right_launch(wrapper, entry: str, A, L, epilogue: str):
    """Check (A, L), launch kernel 4's strided ``entry`` with ``epilogue``
    on the current stream and count the launch on ``wrapper``.  Returns
    the product, (product, row sums) or the row sums."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}, got "
                         f"{epilogue!r}")
    _check_tril_shapes(wrapper.__name__, A, L)
    Q, N, M = A.shape
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=A.device)
    out = new((Q, N, M)) if epilogue != "rowsum" else None
    r = new((Q, N)) if epilogue != "product" else None
    result = {"product": out, "both": (out, r), "rowsum": r}[epilogue]
    if Q * N == 0 or M == 0:
        if r is not None:
            r.zero_()
        return result
    _require_tma_operands(wrapper, (A, L), views=True)
    lib = _library()
    # the row sums' per-tile partials, added by the entry's second launch
    part = (None if r is None
            else new((Q, N, lib.hetmogp_tril_right_partials(M))))
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, entry)(
            *_pointers(A, L, True), *(None if t is None else t.data_ptr()
                                      for t in (out, part, r)),
            EPILOGUES[epilogue], Q, N, M, stream)
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1
    return result


def tril_right_tma(A: torch.Tensor, L: torch.Tensor,
                   epilogue: str = "product"):
    """Kernel 4 (``hetmogp_tril_right_strided_f32``) for M % 4 == 0, A and
    L each read where it lies through its row and plane strides
    (``_tma_strides``): A tril(L) in full float32, and with
    ``epilogue="both"`` or ``"rowsum"`` its row sums of squares (the
    second launch of the entry adds the per-tile partials).  Returns the
    product, (product, row sums) or the row sums.  Counts its launches in
    ``tril_right_tma.launches``."""
    return _right_launch(tril_right_tma, "hetmogp_tril_right_strided_f32",
                         A, L, epilogue)


tril_right_tma.launches = 0


def tril_right(A: torch.Tensor, L: torch.Tensor, epilogue: str = "product"):
    """out[q, n, k] = sum_{m >= k} A[q, n, m] L[q, m, k] on the card, and
    with ``epilogue`` "both" (out, r) or "rowsum" r alone, r[q, n] =
    sum_k out[q, n, k]^2 (deterministic: no atomics).

    A: (Q, N, M), L: (Q, M, M), float32 on one CUDA device; L's strictly
    upper entries are not read.  Full float32 (no TF32): one FMA chain per
    output in increasing m.  ``tril_right_tma`` on the operands of
    ``_tma_operands``, the product cropped to M (the padded columns add
    exact zeros to the row sums); launches on the current stream and does
    not synchronise.
    """
    M = A.shape[-1]
    operands = _tma_operands(A, L, square=True, views=True)
    result = tril_right_tma(*operands, epilogue)
    if epilogue == "both":
        return _crop(result[0], M), result[1]
    return result if epilogue == "rowsum" else _crop(result, M)


def tril_right3_tma(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Kernel 5's wgmma and TMA design (``hetmogp_tril_right3_f32``,
    ``csrc/tril_right3_kernel.cu``): A tril(L) in three bf16 passes for
    M % 4 == 0 and contiguous, 16-byte-aligned operands.  L arrives as
    float32 and is split in shared memory: no pre-pass, no bf16 scratch.
    Where its schedule runs column tile 0's reduction as two parts on two
    blocks, a float32 scratch of ``hetmogp_tril_right3_partials`` floats
    (``torch.empty``; the graph's pool under capture) carries one part's
    sum to the other.  Counts its launches in
    ``tril_right3_tma.launches``."""
    out = _product_output(tril_right3_tma, A, L)
    if out.numel() == 0:
        return out
    floats = _library().hetmogp_tril_right3_partials(*A.shape)
    part = (torch.empty(floats, dtype=torch.float32, device=A.device)
            if floats else None)
    return _launch(tril_right3_tma, "hetmogp_tril_right3_f32", A, L, out,
                   None if part is None else part.data_ptr())


tril_right3_tma.launches = 0


def tril_right3(A: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """A tril(L) on the card's tensor cores in three bf16 passes of the
    bit-mask split (lo*hi + hi*lo + hi*hi, float32 accumulation): the
    VM step's adjoint products at ``ve_fwd_precision="high"``.
    ``tril_right3_tma`` on the operands of ``_tma_operands``, cropped to
    M."""
    operands = _tma_operands(A, L, square=True)
    return _crop(tril_right3_tma(*operands), A.shape[-1])


def _backward_right(ctx, g, precision="highest"):
    """dA = g tril(L)^T (kernel A's operator, ``hetmogp::tril_projection``),
    dL = tril(A^T g) (kernel 8's operator of ``precision``): the right
    product's backward."""
    A, L = ctx.saved_tensors[:2]
    dA = torch.ops.hetmogp.tril_projection(g.contiguous(), L) \
        if ctx.needs_input_grad[0] else None
    dL = _tril_out_op(A.detach(), g, precision) \
        if ctx.needs_input_grad[1] else None
    return dA, dL


class MatmulTril(torch.autograd.Function):
    """A tril(L) with a gradient: the operator ``hetmogp::matmul_tril``
    forward (kernel 4 for a CUDA tensor, the plain version for a CPU one);
    backward dA = g tril(L)^T by kernel A's operator, dL = tril(A^T g) by
    kernel 8's."""

    @staticmethod
    def forward(ctx, A, L):
        ctx.save_for_backward(A, L)
        return torch.ops.hetmogp.matmul_tril(A.detach(), L.detach())

    backward = staticmethod(_backward_right)


class MatmulTril3Pass(torch.autograd.Function):
    """A tril(L) in three bf16 passes with a gradient: the operator
    ``hetmogp::matmul_tril_3pass`` forward (kernel 5 for a CUDA tensor, the
    plain version for a CPU one; the plain version without the operator
    where ``use_kernel`` is False), and ``MatmulTril``'s backward with dL
    in three passes."""

    @staticmethod
    def forward(ctx, A, L, use_kernel=True):
        ctx.save_for_backward(A, L)
        fwd = torch.ops.hetmogp.matmul_tril_3pass if use_kernel else \
            matmul_tril_3pass_plain
        return fwd(A.detach(), L.detach())

    @staticmethod
    def backward(ctx, g):
        return (*_backward_right(ctx, g, "high"), None)


class QuadDiag(torch.autograd.Function):
    """quad_diag(A, L) = sum_k (A tril(L))[..., k]^2 with a gradient: the
    operator ``hetmogp::quad_diag_product`` forward (kernel 4's "both"
    epilogue in float32, which keeps A tril(L) for the backward), and the
    backward of the JAX package's ``_quad_diag_train_bwd``: with
    dAL = 2 g AL, gA = dAL tril(L)^T by kernel A's operator, gL =
    tril(A^T dAL) by kernel 8's (``t_matmul_tril_out``) at ``precision``,
    the lower tiles alone.  Only the cotangents asked for are formed (a VE
    step asks for gL alone).  Without a gradient, ``hetmogp::quad_diag``
    (the "rowsum" epilogue, no product stored) takes its place."""

    @staticmethod
    def forward(ctx, A, L, precision="highest"):
        AL, r = torch.ops.hetmogp.quad_diag_product(A.detach(), L.detach())
        ctx.save_for_backward(A, L, AL)
        ctx.precision = precision
        return r

    @staticmethod
    def backward(ctx, g):
        AL = ctx.saved_tensors[2]
        return (*_backward_right(ctx, 2.0 * g[..., None] * AL,
                                 ctx.precision), None)


# ---- kernel 8: tril(A^T B), the lower tiles only ---------------------------
#
# csrc/tril_out_kernel.cu in float32 FFMA ("highest") and in three bf16
# wgmma passes ("high"), each reached through ``_tma_operands`` as the
# projections are.


def t_matmul_tril_out_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8: tril(A^T B), (..., N, M), (..., N, M) ->
    (..., M, M)."""
    return torch.tril(A.mT @ B)


def t_matmul_tril_out_3pass_plain(A: torch.Tensor,
                                  B: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8's three passes: tril of three float32
    products of the bit-mask split, (alo^T bhi + ahi^T blo) + ahi^T bhi
    (``split_bf16``).  Float32 only."""
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"the 3-pass product splits float32 only, got "
                        f"{A.dtype} and {B.dtype}")
    ahi, alo = split_bf16(A.detach())
    bhi, blo = split_bf16(B.detach())
    return torch.tril((alo.mT @ bhi + ahi.mT @ blo) + ahi.mT @ bhi)


def _tril_out_op(A: torch.Tensor, B: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """tril(A^T B) through kernel 8's operator: the three-pass one at
    ``"high"`` for float32, the float32 one otherwise (float64 ignores the
    precision).  The operators record no backward: a gradient through
    them raises."""
    three = precision == "high" and A.dtype == torch.float32
    op = (torch.ops.hetmogp.t_matmul_tril_out_3pass if three
          else torch.ops.hetmogp.t_matmul_tril_out)
    return op(A, B)


def _out_launch(wrapper, entry: str, A, B, three: bool) -> torch.Tensor:
    """Check (A, B), launch kernel 8's ``entry`` (float32 or three passes)
    on the current stream and count the launch on ``wrapper``."""
    name = wrapper.__name__
    _check_launch_inputs(name, (A, B))
    if A.ndim != 3 or B.shape != A.shape:
        raise ValueError(f"A and B must both be (Q, N, M); got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    Q, N, M = A.shape
    if Q > 65535 or N >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: Q={Q}, N={N}, "
                         f"M={M} (Q <= 65535)")
    out = torch.empty((Q, M, M), dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    if N == 0:  # a sum over no rows
        return out.zero_()
    _require_tma_operands(wrapper, (A, B))
    lib = _library()
    # the last turn's split partials (torch.empty: the graph's pool under
    # capture)
    floats = lib.hetmogp_tril_out_partials(Q, N, M, int(three))
    part = (torch.empty(floats, dtype=torch.float32, device=A.device)
            if floats else None)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, entry)(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                                  None if part is None else part.data_ptr(),
                                  Q, N, M, stream)
    _raise_on(err, name)
    wrapper.launches += 1
    return out


def tril_out_tma(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kernel 8's FFMA design (``hetmogp_tril_out_f32``,
    ``csrc/tril_out_kernel.cu``): tril(A^T B) in full float32 for
    M % 4 == 0 and contiguous, 16-byte-aligned operands, only the lower
    tiles formed.  Where its schedule cuts the last turn's tiles into
    parts, a float32 scratch of ``hetmogp_tril_out_partials`` floats, a
    tile for each part, carries the parts' sums to the parts that reduce
    the tile, each its own share.  Counts its launches in
    ``tril_out_tma.launches``."""
    return _out_launch(tril_out_tma, "hetmogp_tril_out_f32", A, B,
                       three=False)


tril_out_tma.launches = 0


def tril_out3_tma(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kernel 8's wgmma design (``hetmogp_tril_out3_f32``): tril(A^T B) in
    three bf16 passes of the bit-mask split for M % 4 == 0 and contiguous,
    16-byte-aligned operands; both operands arrive as float32, A is split
    in the consumers' registers and B in shared memory; the parts of split
    tiles meet as in ``tril_out_tma``.  Counts its launches in
    ``tril_out3_tma.launches``."""
    return _out_launch(tril_out3_tma, "hetmogp_tril_out3_f32", A, B,
                       three=True)


tril_out3_tma.launches = 0


def tril_out(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """out[q, m1, m2] = sum_n A[q, n, m1] B[q, n, m2] for m1 >= m2, exact
    zeros above the diagonal, on the card (deterministic: no atomics).

    A, B: (Q, N, M) float32 on one CUDA device.  Full float32 (no TF32).
    ``tril_out_tma`` on the operands of ``_tma_operands``, cropped to
    (M, M); launches on the current stream and does not synchronise.  The
    CUDA implementation of the operator ``hetmogp::t_matmul_tril_out``.
    """
    operands = _tma_operands(A, B, square=False)
    return _crop(tril_out_tma(*operands), A.shape[-1], square=True)


def tril_out3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """tril(A^T B) on the card's tensor cores in three bf16 passes of the
    bit-mask split (lo*hi + hi*lo + hi*hi, float32 accumulation): the
    backward's L cotangents at ``"high"``.  ``tril_out3_tma`` on the
    operands of ``_tma_operands``, cropped to (M, M)."""
    operands = _tma_operands(A, B, square=False)
    return _crop(tril_out3_tma(*operands), A.shape[-1], square=True)


# ---- kernel 6: the one-pass Gauss-Hermite sweep -----------------------------
#
# The plain version is the autograd engine of ``ops/quadrature.py``
# (``make_var_exp``), which sends a CUDA tensor of an engine in its
# ``SWEEP_FAMILIES`` table here.  Two launchers of the one kernel, each
# counting its own launches: the value with (Ed1, Ed2), and the value alone.

_SWEEP_ENTRIES = {torch.float32: "hetmogp_gh_sweep_f32",
                  torch.float64: "hetmogp_gh_sweep_f64"}


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (N, k) with each row's entries contiguous: the kernel reads
    rows at ``t.stride(0)``, so a column slice such as ``M[:, :1]`` is
    taken as it is."""
    return t if t.shape[1] == 1 or t.stride(1) == 1 else t.contiguous()


def _sweep_launch(wrapper, family: int, y, m, v, nodes, w, deriv: bool):
    """Check the inputs, launch kernel 6 on the current stream and count
    the launch on ``wrapper``: (value, Ed1, Ed2), or the value alone."""
    name = wrapper.__name__
    tensors = (y, m, v, nodes, w)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the raw CUDA {name} launcher records no backward; "
            "differentiate through quadrature.make_var_exp's engine")
    dtype = m.dtype
    if dtype not in _SWEEP_ENTRIES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or float64 tensors of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    dev = m.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if m.ndim != 2 or v.shape != m.shape or y.ndim != 2 \
            or y.shape[0] != m.shape[0] or y.shape[1] < 1 or nodes.ndim != 2 \
            or nodes.shape[1] != m.shape[1] or w.shape != nodes.shape[:1]:
        raise ValueError(
            f"{name} takes m, v (N, J), y (N, dim_y), nodes (S, J) and w "
            f"(S,); got {tuple(m.shape)}, {tuple(v.shape)}, "
            f"{tuple(y.shape)}, {tuple(nodes.shape)}, {tuple(w.shape)}")
    (N, J), S = m.shape, nodes.shape[0]
    if N >= 2 ** 28 or S >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: N={N}, S={S}")
    y, m, v = _rows(y), _rows(m), _rows(v)
    nodes, w = nodes.contiguous(), w.contiguous()
    val = torch.empty((N,), dtype=dtype, device=dev)
    ed1 = torch.empty((N, J), dtype=dtype, device=dev) if deriv else None
    ed2 = torch.empty((N, J), dtype=dtype, device=dev) if deriv else None
    result = (val, ed1, ed2) if deriv else val
    if N == 0:
        return result
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _SWEEP_ENTRIES[dtype])(
            family, J, m.data_ptr(), v.data_ptr(), y.data_ptr(), m.stride(0),
            v.stride(0), y.stride(0), nodes.data_ptr(), w.data_ptr(), S, N,
            val.data_ptr(), None if ed1 is None else ed1.data_ptr(),
            None if ed2 is None else ed2.data_ptr(), stream)
    _raise_on(err, name)
    wrapper.launches += 1
    return result


def gh_sweep(family: int, y: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             nodes: torch.Tensor, w: torch.Tensor):
    """Kernel 6 (``hetmogp_gh_sweep_f32``/``_f64``): for each row n the
    value sum_s w_s lp(F_ns), Ed1[n, j] = sum_s w_s d lp / dF_j and
    Ed2[n, j] = sum_s w_s d2 lp / dF_j^2 at F_ns = m_n + sqrt(2 v_n) t_s, in
    one launch; ``family`` the code of the log density
    (``quadrature.SWEEP_FAMILIES``).  m, v: (N, J); y: (N, dim_y); nodes:
    (S, J); w: (S,); float32 or float64 on one CUDA device.  Returns
    (value (N,), Ed1 (N, J), Ed2 (N, J)); launches on the current stream
    and does not synchronise.  Counts its launches in
    ``gh_sweep.launches``."""
    return _sweep_launch(gh_sweep, family, y, m, v, nodes, w, True)


gh_sweep.launches = 0


def gh_sweep_value(family: int, y: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, nodes: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Kernel 6's value alone, (N,), when no input needs a gradient.
    Counts its launches in ``gh_sweep_value.launches``."""
    return _sweep_launch(gh_sweep_value, family, y, m, v, nodes, w, False)


gh_sweep_value.launches = 0


# ---- kernel 7: the masked adam update -----------------------------------------
#
# The plain version is ``train._adam``; ``train.make_optimizer`` sends the
# leaves of a CUDA model here.

_ADAM_ENTRIES = {torch.float32: "hetmogp_adam_f32",
                 torch.float64: "hetmogp_adam_f64"}


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill its memory span once each (any order of
    its dimensions in memory): an elementwise kernel may then walk the
    span."""
    if any(st <= 0 for st, n in zip(t.stride(), t.shape) if n > 1):
        return False
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.numel() == 0 or span == t.numel()


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """t in ref's layout: t itself when the strides agree, else a copy."""
    return t if t.stride() == ref.stride() else torch.empty_like(ref).copy_(t)


def adam_leaf_table(tensors, grads) -> list:
    """Kernel 7's leaf table: (index in ``leaves`` order, element count,
    free) of every leaf with elements, a leaf free where it has a gradient
    (the step's mask gives None for the others)."""
    return [(i, t.numel(), g is not None)
            for i, (t, g) in enumerate(zip(tensors, grads)) if t.numel()]


def adam_update(tensors, grads, mu, nu, count: torch.Tensor, lr):
    """One masked adam step of every leaf on the card, ``train._adam``'s
    arithmetic to the bit: ``tensors``, ``mu`` and ``nu`` the leaves and
    their moments in ``leaves`` order, ``grads`` a gradient for each free
    leaf and None for the others, ``count`` adam's () int64 step count, and
    ``lr`` a float or a () tensor of the leaves' dtype (a schedule's rate,
    read on the device).  Returns (new leaves, new mu, new nu, count + 1):
    a frozen leaf is returned as it is, everything else is new.  One launch
    for up to ``hetmogp_adam_max_leaves()`` leaves with elements (32), one
    more for each 32 after; counts its launches in
    ``adam_update.launches``."""
    name = "adam_update"
    table = adam_leaf_table(tensors, grads)
    if not table:
        raise ValueError(f"{name}: no leaf has elements")
    present = [g for g in grads if g is not None]
    every = [*tensors, *present, *mu, *nu, count]
    if any(t.requires_grad for t in every):
        raise NotImplementedError(f"the raw CUDA {name} launcher records "
                                  "no backward; call it under no_grad")
    dtype, dev = tensors[0].dtype, tensors[0].device
    if dtype not in _ADAM_ENTRIES or any(
            t.dtype != dtype for t in (*tensors, *present, *mu, *nu)) \
            or count.dtype != torch.int64 or count.numel() != 1:
        raise TypeError(f"{name} takes float32 or float64 leaves of one "
                        "dtype and an int64 count")
    if not all(t.is_cuda and t.device == dev for t in every):
        raise ValueError(f"{name} takes tensors on one CUDA device")
    if isinstance(lr, torch.Tensor) and (lr.numel() != 1 or lr.dtype != dtype
                                         or lr.device != dev):
        raise ValueError(f"{name}: a tensor lr must be a () {dtype} tensor "
                         f"on {dev}, got {tuple(lr.shape)} {lr.dtype} on "
                         f"{lr.device}")
    for i, n, free in table:
        shapes = {tensors[i].shape, mu[i].shape, nu[i].shape}
        if free:
            shapes.add(grads[i].shape)
        if len(shapes) != 1:
            raise ValueError(f"{name}: leaf {i}'s tensors differ in shape: "
                             f"{sorted(map(tuple, shapes))}")
    # the kernel walks each leaf's elements in memory order: a leaf's
    # tensors share the layout of its parameter (a dense one, whatever its
    # strides: the flagship's Z and q_sqrt are not row-major), and a tensor
    # of another layout is copied into it
    p_in = [t if _dense(t) else t.contiguous() for t in tensors]
    g_in = [None if g is None else _like(g, p) for g, p in zip(grads, p_in)]
    mu_in = [_like(t, p) for t, p in zip(mu, p_in)]
    nu_in = [_like(t, p) for t, p in zip(nu, p_in)]
    new_p = [torch.empty_like(p) if g is not None else t
             for t, p, g in zip(tensors, p_in, grads)]
    new_mu = [torch.empty_like(p) for p in p_in]
    new_nu = [torch.empty_like(p) for p in p_in]
    new_count = torch.empty_like(count)
    lr_ptr = lr.data_ptr() if isinstance(lr, torch.Tensor) else None
    lr_value = 0.0 if lr_ptr is not None else float(lr)
    lib = _library()
    most = lib.hetmogp_adam_max_leaves()
    entry = getattr(lib, _ADAM_ENTRIES[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for start in range(0, len(table), most):
            chunk = table[start:start + most]
            ptrs = []
            for i, _, free in chunk:
                ptrs += [p_in[i].data_ptr(),
                         g_in[i].data_ptr() if free else None,
                         mu_in[i].data_ptr(), nu_in[i].data_ptr(),
                         new_p[i].data_ptr() if free else None,
                         new_mu[i].data_ptr(), new_nu[i].data_ptr()]
            err = entry(
                (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_longlong * len(chunk))(*(n for _, n, _ in chunk)),
                len(chunk), count.data_ptr(),
                new_count.data_ptr() if start == 0 else None, lr_ptr,
                lr_value, stream)
            _raise_on(err, name)
            adam_update.launches += 1
    return new_p, new_mu, new_nu, new_count


adam_update.launches = 0


# ---- kernel 6, redesigned: the likelihood term of every task ---------------
#
# The plain version is ``quadrature.task_var_exp_plain`` (each task's
# var_exp and its masked, scaled sum); ``quadrature.TaskVarExp`` sends the
# tasks of a CUDA model in ``TASK_FAMILIES`` here.  Three launchers, each
# counting its own launches: the forward with the gradient coefficients,
# the forward's value alone, and the backward.

_TASK_ENTRIES = {torch.float32: ("hetmogp_ve_tasks_f32",
                                 "hetmogp_ve_tasks_grad_f32"),
                 torch.float64: ("hetmogp_ve_tasks_f64",
                                 "hetmogp_ve_tasks_grad_f64")}
TASK_THREADS = 256  # csrc/ve_tasks_kernel.cu: THREADS
TASK_MAX_TERMS, TASK_MAX_CONSTS = 4, 2  # csrc/ve_tasks_kernel.cu
# the family codes whose var_exp holds a sweep (the kernel's has_sweep),
# and the multi-term ones among them
_SWEPT_TASKS = {code for code, _, sweep in quadrature.TASK_FAMILIES.values()
                if sweep is not None}
_TERM_TASKS = {code for code, _, sweep in quadrature.TASK_FAMILIES.values()
               if sweep == quadrature.TERMS}


def _float_bits(x: float) -> int:
    """A float64's bits as a signed 64-bit integer (the kernel's table
    carries the constants so)."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def task_lanes(S: int) -> int:
    """The lanes a row of a swept task takes by default: one node a lane,
    up to a block's TASK_THREADS (then the nodes are strided over them)."""
    return max(1, min(int(S), TASK_THREADS))


def _task_check(name, tasks, scales):
    """The dtype and device of a task table, after checking it."""
    if not tasks or len(scales) != len(tasks):
        raise ValueError(f"{name} takes one scale a task and at least one "
                         f"task; got {len(tasks)} tasks, {len(scales)} "
                         "scales")
    dtype, dev = tasks[0][2].dtype, tasks[0][2].device
    if dtype not in _TASK_ENTRIES:
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    for (family, y, m, v, mask, nodes, w, sizes, consts), scale in zip(
            tasks, scales):
        tensors = [y, m, v, mask, scale]
        if family in _SWEPT_TASKS:
            if nodes is None or w is None:
                raise ValueError(f"{name}: family {family} sweeps a node "
                                 "table; none was given")
            tensors += [nodes, w]
        if any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                f"the raw CUDA {name} launcher records no backward; "
                "differentiate through quadrature.task_var_exp")
        if any(t.dtype != dtype for t in tensors):
            raise TypeError(f"{name} takes tensors of one dtype, got "
                            f"{[t.dtype for t in tensors]}")
        if not all(t.is_cuda and t.device == dev for t in tensors):
            raise ValueError(f"{name} takes tensors on one CUDA device, got "
                             f"{[str(t.device) for t in tensors]}")
        N = m.shape[0]
        if m.ndim != 2 or v.shape != m.shape or y.ndim != 2 \
                or y.shape[0] != N or y.shape[1] < 1 or mask.shape != (N,) \
                or scale.numel() != 1 or N >= 2 ** 30:
            raise ValueError(
                f"{name} takes m, v (N, J), y (N, dim_y), mask (N,) and a "
                f"scalar scale; got {tuple(m.shape)}, {tuple(v.shape)}, "
                f"{tuple(y.shape)}, {tuple(mask.shape)}, "
                f"{tuple(scale.shape)}")
        if family in _SWEPT_TASKS and (
                nodes.ndim != 2 or w.shape != nodes.shape[:1]
                or nodes.shape[1] != (1 if family == 4 else m.shape[1])):
            raise ValueError(f"{name}: family {family}'s node table must be "
                             f"(S, J) and (S,); got {tuple(nodes.shape)}, "
                             f"{tuple(w.shape)}")
        if family in _TERM_TASKS and (
                not 1 <= len(sizes) <= TASK_MAX_TERMS
                or min(sizes) < 1 or sum(sizes) != nodes.shape[0]):
            raise ValueError(f"{name}: family {family}'s terms' node counts "
                             f"{tuple(sizes)} must make up its table of "
                             f"{nodes.shape[0]} nodes")
        if len(consts) > TASK_MAX_CONSTS:
            raise ValueError(f"{name}: at most {TASK_MAX_CONSTS} constants "
                             f"a task; got {tuple(consts)}")
    return dtype, dev


def _task_launch(wrapper, tasks, scales, deriv: bool, lanes=None):
    """Check the table, launch the forward on the current stream (one
    launch each ``hetmogp_ve_tasks_max()`` tasks) and count the launches
    on ``wrapper``: (sums, values, coefs), coefs None without ``deriv``."""
    name = wrapper.__name__
    dtype, dev = _task_check(name, tasks, scales)
    lanes = list(lanes) if lanes is not None else [
        task_lanes(t[5].shape[0]) if t[0] in _SWEPT_TASKS else 1
        for t in tasks]
    rows = [t[2].shape[0] for t in tasks]
    Js = [t[2].shape[1] for t in tasks]
    new = functools.partial(torch.empty, dtype=dtype, device=dev)
    # a task without rows adds nothing: its sum is 0 and it is no entry
    sums = (new(len(tasks)) if all(rows) else
            torch.zeros(len(tasks), dtype=dtype, device=dev))
    val = new(sum(rows))
    coef = new(sum(n * 2 * J for n, J in zip(rows, Js))) if deriv else None
    values, coefs, entries = [], [], []
    v_off = c_off = 0
    for i, ((family, y, m, v, mask, nodes, w, sizes, consts), scale) in (
            enumerate(zip(tasks, scales))):
        N, J = rows[i], Js[i]
        values.append(val[v_off:v_off + N])
        if deriv:
            coefs.append(coef[c_off:c_off + 2 * N * J].view(N, 2 * J))
        if N:
            swept = family in _SWEPT_TASKS
            y, m, v = _rows(y), _rows(m), _rows(v)
            if swept:
                nodes, w = nodes.contiguous(), w.contiguous()
            scale = scale.reshape(())
            ptrs = [y.data_ptr(), m.data_ptr(), v.data_ptr(), mask.data_ptr(),
                    scale.data_ptr(), nodes.data_ptr() if swept else None,
                    w.data_ptr() if swept else None, values[i].data_ptr(),
                    coefs[i].data_ptr() if deriv else None,
                    sums[i:i + 1].data_ptr()]
            ints = [y.stride(0), m.stride(0), v.stride(0), mask.stride(0),
                    family, J, lanes[i], nodes.shape[0] if swept else 0, N,
                    *(tuple(sizes) + (0,) * TASK_MAX_TERMS)[:TASK_MAX_TERMS],
                    *(_float_bits(c) for c in (
                        tuple(consts) + (0.0,) * TASK_MAX_CONSTS)[
                            :TASK_MAX_CONSTS])]
            # the views keep the (possibly copied) inputs alive to the launch
            entries.append((ptrs, ints, (y, m, v, nodes, w, scale)))
        v_off += N
        c_off += 2 * N * J
    lib = _library()
    most = lib.hetmogp_ve_tasks_max()
    entry = getattr(lib, _TASK_ENTRIES[dtype][0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for start in range(0, len(entries), most):
            chunk = entries[start:start + most]
            ptrs = [p for e in chunk for p in e[0]]
            ints = [q for e in chunk for q in e[1]]
            ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
            int_arr = (ctypes.c_longlong * len(ints))(*ints)
            blocks = lib.hetmogp_ve_tasks_blocks(ptr_arr, int_arr, len(chunk),
                                                 int(deriv))
            if blocks <= 0:
                raise ValueError(f"{name}: the kernel refused the table "
                                 f"(families, J, lanes, rows): "
                                 f"{[e[1][4:9] for e in chunk]}")
            partials = new(blocks)
            err = entry(ptr_arr, int_arr, len(chunk), int(deriv),
                        partials.data_ptr(), blocks, stream)
            _raise_on(err, name)
            wrapper.launches += 1
    return sums, values, (coefs if deriv else None)


def task_var_exp(tasks, scales, lanes=None):
    """Kernel 6's task table, forward (``hetmogp_ve_tasks_f32``/``_f64``,
    ``csrc/ve_tasks_kernel.cu``): for every row n of every task t the
    variational expectation ve_t[n] and its coefficients (dve/dm,
    dve/dv), and each task's sum scale_t sum_n mask_t[n] ve_t[n], in one
    launch.  ``tasks``: a sequence of (family code of
    ``quadrature.TASK_FAMILIES``, y (N, dim_y), m (N, J), v (N, J), mask
    (N,), nodes (S, J_sweep) and w (S,) of the family's GH sweep, or None
    for a closed form, sizes, a multi-term family's node count a term (its
    terms' nodes make up its (S, J) table one after another; () for the
    others), and consts, the family's constants (at most two floats; ()
    for none)); ``scales``: one () tensor a task, read on the device; float32 or float64 on one CUDA device.  ``lanes``: the lanes
    a row of each task (``task_lanes`` by default; a closed form takes
    one).  Returns (sums (T,), [ve_t (N_t,)], [coef_t (N_t, 2 J_t)], c_m
    then c_v); launches on the current stream and does not synchronise.
    Counts its launches in ``task_var_exp.launches``."""
    return _task_launch(task_var_exp, tasks, scales, True, lanes)


task_var_exp.launches = 0


def task_var_exp_value(tasks, scales, lanes=None):
    """The task table's forward, the value alone: (sums (T,), [ve_t]),
    when no input needs a gradient.  Counts its launches in
    ``task_var_exp_value.launches``."""
    sums, values, _ = _task_launch(task_var_exp_value, tasks, scales, False,
                                   lanes)
    return sums, values


task_var_exp_value.launches = 0


def task_var_exp_backward(coefs, masks, scales, g):
    """Kernel 6's task table, backward (``hetmogp_ve_tasks_grad_f32``/
    ``_f64``): from the forward's coefficients, the masks, the scales and
    the upstream gradient g (T,) of the sums, every task's
    dM_t = c_m (g_t scale_t) mask_t and dV_t = c_v (g_t scale_t) mask_t,
    (N_t, J_t) each, in one launch.  Returns [(dM_t, dV_t)].  Counts its
    launches in ``task_var_exp_backward.launches``."""
    name = "task_var_exp_backward"
    dtype, dev = coefs[0].dtype, coefs[0].device
    if dtype not in _TASK_ENTRIES or g.shape != (len(coefs),) \
            or len(masks) != len(coefs) or len(scales) != len(coefs):
        raise ValueError(f"{name} takes float32 or float64 coefficients, a "
                         "mask and a scale a task, and g (T,)")
    every = [*coefs, *masks, *scales, g]
    if any(t.dtype != dtype for t in every) or not all(
            t.is_cuda and t.device == dev for t in every):
        raise TypeError(f"{name} takes tensors of one dtype on one CUDA "
                        "device")
    grads, entries = [], []
    for i, (c, mask, scale) in enumerate(zip(coefs, masks, scales)):
        N, J = c.shape[0], c.shape[1] // 2
        dm = torch.empty((N, J), dtype=dtype, device=dev)
        dv = torch.empty((N, J), dtype=dtype, device=dev)
        grads.append((dm, dv))
        if N:
            gi = g[i:i + 1]
            entries.append(([c.data_ptr(), mask.data_ptr(),
                             scale.reshape(()).data_ptr(), gi.data_ptr(),
                             dm.data_ptr(), dv.data_ptr()],
                            [mask.stride(0), J, N]))
    lib = _library()
    most = lib.hetmogp_ve_tasks_max()
    entry = getattr(lib, _TASK_ENTRIES[dtype][1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for start in range(0, len(entries), most):
            chunk = entries[start:start + most]
            ptrs = [p for e in chunk for p in e[0]]
            ints = [q for e in chunk for q in e[1]]
            err = entry((ctypes.c_void_p * len(ptrs))(*ptrs),
                        (ctypes.c_longlong * len(ints))(*ints), len(chunk),
                        stream)
            _raise_on(err, name)
            task_var_exp_backward.launches += 1
    return grads


task_var_exp_backward.launches = 0


# ---- kernel 9: a diagonal panel's Cholesky factor and its inverse -----------
#
# csrc/chol_panel_kernel.cu, one thread block a matrix of the batch, float32
# and float64.  ``ops/linalg.py``'s blocked factorization hands it each
# (nb, nb) diagonal panel and lets it write the factor and the inverse
# straight into the panel's place in the (M, M) outputs: every operand is a
# (batch, n, n) view whose last stride is 1, passed with its strides, so no
# panel is copied to reach the kernel.

PANEL_MAX = 128  # the widest panel kernel 9 takes (csrc: NMAX)
_PANEL_ENTRIES = {torch.float32: "hetmogp_chol_panel_f32",
                  torch.float64: "hetmogp_chol_panel_f64"}


def chol_panel_plain(A: torch.Tensor):
    """Plain version of kernel 9: (L, L^{-1}) of (..., n, n) SPD ``A``,
    only its lower triangle read; a matrix whose factorization fails gets
    NaN in L's lower triangle and in all of L^{-1}
    (``torch.linalg.cholesky_ex``, then a triangular solve against I: the
    JAX package's ``jnp.linalg.cholesky`` and ``solve_triangular`` of the
    panel)."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")).tril(), L)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _panel_operand(name: str, what: str, t: torch.Tensor, shape, dtype,
                   device):
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {what} must be {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if t.stride(-1) != 1 or t.stride(-2) < shape[-1] or t.stride(0) < 0:
        raise ValueError(f"{name}: {what} must have rows of unit stride no "
                         f"closer than {shape[-1]} apart, got strides "
                         f"{t.stride()}")
    return (t.data_ptr(), t.stride(0), t.stride(1))


def _panel_launch(wrapper, entry: str, A, L, iL) -> None:
    """Check the operands of kernel 9, launch ``entry`` on the current
    stream and count the launch on ``wrapper``."""
    name = wrapper.__name__
    args = []
    for what, t in (("A", A), ("L", L), ("iL", iL)):
        args += _panel_operand(name, what, t, A.shape, A.dtype, A.device)
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, entry)(*args, A.shape[0], A.shape[-1], stream)
    _raise_on(err, name)
    wrapper.launches += 1


def chol_panel(A: torch.Tensor, L=None, iL=None):
    """Kernel 9 (``hetmogp_chol_panel_f32``/``_f64``,
    ``csrc/chol_panel_kernel.cu``): the Cholesky factor L of each (n, n)
    SPD matrix of ``A`` (batch, n, n), n <= 128, its lower triangle read,
    and L^{-1}, both with exact zeros above the diagonal; a pivot that is
    not positive fills that matrix's L on and below the diagonal, and all
    of its L^{-1}, with NaN.  Float32 or float64 on one CUDA device.
    ``L`` and ``iL`` are written where given (views of A's shape whose
    last stride is 1, such as a panel of the blocked factorization's
    (M, M) outputs), else allocated.  Returns (L, iL).  Launches on the
    current stream and does not synchronise; counts its launches in
    ``chol_panel.launches``."""
    name = "chol_panel"
    tensors = [t for t in (A, L, iL) if t is not None]
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"the raw CUDA {name} launcher records no "
                                  "backward; call it under no_grad")
    if A.dtype not in _PANEL_ENTRIES:
        raise TypeError(f"{name} takes float32 or float64, got {A.dtype}")
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    if A.ndim != 3 or A.shape[-1] != A.shape[-2] or not (
            0 < A.shape[-1] <= PANEL_MAX) or A.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} takes (batch, n, n) with 0 < n <= "
                         f"{PANEL_MAX}, got {tuple(A.shape)}")
    L = torch.empty_like(A, memory_format=torch.contiguous_format) \
        if L is None else L
    iL = torch.empty_like(A, memory_format=torch.contiguous_format) \
        if iL is None else iL
    if A.shape[0]:
        _panel_launch(chol_panel, _PANEL_ENTRIES[A.dtype], A, L, iL)
    return L, iL


chol_panel.launches = 0


def chol_panel_smem(dtype: torch.dtype, n: int) -> int:
    """The dynamic shared memory, in bytes, that kernel 9 asks for at
    width n (sized to n: ``csrc/chol_panel_kernel.cu::smem_bytes``)."""
    return _library().hetmogp_chol_panel_smem(int(dtype == torch.float64), n)


# ---- kernel 10: the blocked factor and inverse of a stack in one launch -----
#
# csrc/chol_blocked_kernel.cu, persistent blocks taking the 128 x 128 tile
# tasks of every matrix of the batch (csrc/chol_blocked_plan.cuh) by a
# ticket, float32.  ``ops/linalg.py``'s blocked factorization hands it a
# (batch, M, M) stack whose M is a multiple of 128 (a ragged M padded with
# an identity block); it allocates the outputs, the float64 scratch (L's
# copy and the updates) and the zeroed counters (a memset node in a
# captured graph).

CHOL_TILE = 128  # csrc/chol_blocked_plan.cuh: TILE
CHOL_PARTS, CHOL_BULK = 4, 2  # csrc/chol_blocked_plan.cuh: PARTS, BULK


def chol_blocked_tasks(batch: int, nt: int) -> int:
    """The tile tasks a launch over ``batch`` matrices of nt x nt tiles
    hands out (``csrc/chol_blocked_plan.cuh::total_tasks``): a matrix's
    nt POTRF, nt (nt - 1) / 2 INV and C(nt, 3) ACC, and its nt (nt - 1) /
    2 TRSM and C(nt + 1, 3) UPD in row parts: ``CHOL_PARTS`` each for the
    5 nt - 8 next to a panel (nt >= 2), ``CHOL_BULK`` for the rest."""
    near = 5 * nt - 8 if nt >= 2 else 0
    split = nt * (nt - 1) // 2 + math.comb(nt + 1, 3)
    return batch * (nt + nt * (nt - 1) // 2 + math.comb(nt, 3)
                    + CHOL_PARTS * near + CHOL_BULK * (split - near))


def chol_blocked_plain(K: torch.Tensor):
    """Plain version of kernel 10: (L, L^{-1}) of (..., M, M) SPD ``K``,
    only its lower triangle read, NaN where a factorization fails:
    ``chol_panel_plain``'s library calls, at any width."""
    return chol_panel_plain(K)


def _blocked_launch(wrapper, entry: str, K, L, iL, L64, C, flags) -> None:
    """Launch kernel 10's ``entry`` on the current stream and count the
    launch on ``wrapper``."""
    lib = _library()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = getattr(lib, entry)(
            K.data_ptr(), K.stride(0), K.stride(1), L.data_ptr(),
            iL.data_ptr(), L64.data_ptr(), C.data_ptr(), flags.data_ptr(),
            K.shape[0], K.shape[-1] // CHOL_TILE, stream)
    _raise_on(err, wrapper.__name__)
    wrapper.launches += 1


def chol_blocked(K: torch.Tensor):
    """Kernel 10 (``hetmogp_chol_blocked_f32``,
    ``csrc/chol_blocked_kernel.cu``): the Cholesky factor L of each (M, M)
    SPD matrix of ``K`` (batch, M, M), M a multiple of 128, its lower
    triangle read, and L^{-1}, both with exact zeros above the diagonal,
    in one launch; a pivot that fails fills L's columns from its panel on
    (on and below the diagonal) and L^{-1}'s rows from that panel on with
    NaN.  Float32 on one CUDA device, K's rows of unit stride and 16-byte
    aligned.  Returns new (L, iL).  Launches on the current stream and
    does not synchronise; counts its launches in
    ``chol_blocked.launches``."""
    name = "chol_blocked"
    if K.requires_grad:
        raise NotImplementedError(f"the raw CUDA {name} launcher records no "
                                  "backward; call it under no_grad")
    if K.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {K.dtype}")
    if not K.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors, got {K.device}")
    if K.ndim != 3 or K.shape[-1] != K.shape[-2] or not K.shape[-1] or \
            K.shape[-1] % CHOL_TILE:
        raise ValueError(f"{name} takes (batch, M, M) with M a multiple of "
                         f"{CHOL_TILE}, got {tuple(K.shape)}")
    m = K.shape[-1]
    if K.stride(-1) != 1 or K.stride(1) < m or K.stride(1) % 4 or \
            K.stride(0) % 4 or K.data_ptr() % 16:
        raise ValueError(f"{name}: K's rows must have unit stride, be at "
                         "least M apart and 16-byte aligned, got strides "
                         f"{K.stride()}")
    batch, nt = K.shape[0], m // CHOL_TILE
    L = torch.empty(K.shape, dtype=K.dtype, device=K.device)
    iL = torch.empty_like(L)
    if batch:
        if chol_blocked_tasks(batch, nt) >= 2 ** 31:
            raise ValueError(f"{name}: {tuple(K.shape)} is too many tasks")
        lib = _library()
        # float64 scratch: L's exact copy and the updates, 1.5 B M^2 + 64 B M
        L64 = torch.empty(K.shape, dtype=torch.float64, device=K.device)
        C = torch.empty((batch, nt * (nt + 1) // 2, CHOL_TILE, CHOL_TILE),
                        dtype=torch.float64, device=K.device)
        flags = torch.zeros(lib.hetmogp_chol_blocked_flags(batch, nt),
                            dtype=torch.int32, device=K.device)
        _blocked_launch(chol_blocked, "hetmogp_chol_blocked_f32", K, L, iL,
                        L64, C, flags)
    return L, iL


chol_blocked.launches = 0


# ---- the kernels as operators -----------------------------------------------
#
# Each routed forward is a custom operator of the ``hetmogp`` namespace: its
# CUDA implementation is the router above (the hand kernel, counted; a CUDA
# tensor launches or raises), its CPU implementation the plain version, and
# a fake implementation gives the output's shape to tracing.  The
# ``autograd.Function``s call the operators, so the trainer, the prediction
# entries and a ``torch.export``ed program reach the same kernels, and an
# exported graph holds ``hetmogp::`` nodes, never the plain versions.
# Registering builds and loads nothing.

def _register(name: str, cpu, cuda, out_shape) -> None:
    """``out_shape(*args)``: the output's shape, or a list of the
    outputs' shapes."""
    op = torch.library.custom_op(f"hetmogp::{name}", mutates_args=(),
                                 device_types="cpu")(cpu)
    op.register_kernel("cuda")(cuda)

    def fake(*args):
        shape = out_shape(*args)
        if isinstance(shape, list):
            return tuple(args[0].new_empty(s) for s in shape)
        return args[0].new_empty(shape)

    op.register_fake(fake)


_register("rbf_K_batched", rbf_K_batched_plain, rbf_K_batched,
          lambda X, Z, ls, var: (Z.shape[0], X.shape[0], Z.shape[1]))
_register("tril_projection", tril_projection_plain, tril_projection,
          lambda A, L: A.shape)
_register("tril_projection_3pass", tril_projection_3pass_plain,
          tril_projection_3pass, lambda A, L: A.shape)
_register("matmul_tril", matmul_tril_plain, tril_right, lambda A, L: A.shape)
_register("matmul_tril_3pass", matmul_tril_3pass_plain, tril_right3,
          lambda A, L: A.shape)
_register("quad_diag", quad_diag_plain,
          lambda A, L: tril_right(A, L, "rowsum"), lambda A, L: A.shape[:-1])
_register("quad_diag_product", quad_diag_product_plain,
          lambda A, L: tril_right(A, L, "both"),
          lambda A, L: [A.shape, A.shape[:-1]])
_register("t_matmul_tril_out", t_matmul_tril_out_plain, tril_out,
          lambda A, B: (*A.shape[:-2], A.shape[-1], A.shape[-1]))
_register("t_matmul_tril_out_3pass", t_matmul_tril_out_3pass_plain,
          tril_out3, lambda A, B: (*A.shape[:-2], A.shape[-1], A.shape[-1]))


_LAUNCHERS = (rbf_K_batched_vec, rbf_K_batched_scalar, tril_projection_tma,
              tril_projection_3pass_tma, tril_right_tma, tril_right3_tma,
              tril_out_tma, tril_out3_tma, gh_sweep, gh_sweep_value,
              task_var_exp, task_var_exp_value, task_var_exp_backward,
              adam_update, chol_panel, chol_blocked)


def launch_counts() -> dict:
    """Every kernel launcher's launch count, and the RBF backward passes."""
    counts = {f.__name__: f.launches for f in _LAUNCHERS}
    counts["rbf_backward"] = RBFCrossCovariance.backwards
    return counts


def zero_launch_counts() -> None:
    """Set every count of ``launch_counts`` to 0."""
    for f in _LAUNCHERS:
        f.launches = 0
    RBFCrossCovariance.backwards = 0
